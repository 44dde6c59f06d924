"""Brute-force nearest neighbours on masked clouds (counterpart of
icp_tpu.ops.nn: ``pairwise_sqdist`` and ``nn_query``).

All entry points are masked: invalid target slots never win an argmin and
invalid source slots report +BIG distance. Ties go to the lowest target
index (``torch.argmin`` returns the first minimal index, as ``jnp.argmin``
does). The CUDA kernel for the 2-D query of the ICP loop is in
``ops/hopper/nn_kernel.py``; this module is the plain distance-matrix form.
"""
from __future__ import annotations

import torch

from icp_tpu_torch.utils.masking import BIG, masked_centroid


def pairwise_sqdist(a, b, b_mask=None, center=None):
    """Squared L2 distances between rows of a (N, D) and b (M, D) -> (N, M),
    for low-D geometry (D <= 4), by broadcast difference (exact in f32, so
    argmin ties stay stable). Masked columns (b_mask False) are BIG.
    icp_tpu's D >= 8 expansion form serves the features port.
    """
    if a.shape[-1] > 4:
        raise NotImplementedError("pairwise_sqdist is ported for D <= 4")
    if center is not None:
        a = a - center
        b = b - center
    d = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    if b_mask is not None:
        d = torch.where(b_mask[None, :], d, BIG)
    return d


def nn_query(source, target, tgt_mask, src_mask=None):
    """Nearest valid target for every source point.

    Returns (dists, indices): Euclidean distance (N,) and target index
    (N,) int64. Invalid source rows get distance BIG.
    """
    center = masked_centroid(target, tgt_mask)
    d = pairwise_sqdist(source, target, tgt_mask, center=center)
    idx = torch.argmin(d, dim=-1)
    dist = torch.sqrt(torch.gather(d, 1, idx[:, None])[:, 0])
    if src_mask is not None:
        dist = torch.where(src_mask, dist, BIG)
    return dist, idx
