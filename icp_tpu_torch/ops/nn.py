"""Brute-force nearest neighbours on masked clouds (counterpart of
icp_tpu.ops.nn: ``pairwise_sqdist``, ``nn_query``, ``nn_query_chunked``
and ``knn_query``).

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
    """Squared L2 distances between rows of a (N, D) and b (M, D) -> (N, M).
    Masked columns (b_mask False) are BIG.

    Low-D geometry (D <= 4) takes the broadcast difference (exact in f32,
    so argmin ties stay stable); descriptor rows (D > 4) take the expansion
    ||a||^2 + ||b||^2 - 2 a.b, clamped at 0, as icp_tpu does. Its cross
    term is one f32 matrix product (TF32 is off package-wide). A row of
    BIG (1e30) entries squares to inf, so a masked row against a masked
    column gives inf - inf = NaN before the column mask replaces it.
    """
    if center is not None:
        a = a - center
        b = b - center
    if a.shape[-1] <= 4:
        d = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    else:
        a_sq = (a * a).sum(-1, keepdim=True)                 # (N, 1)
        b_sq = (b * b).sum(-1, keepdim=True)                 # (M, 1)
        d = torch.clamp(a_sq + b_sq.T - 2.0 * (a @ b.T), min=0.0)
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


def nn_query_chunked(source, target, tgt_mask, src_mask=None, *,
                     chunk: int = 2048):
    """nn_query for large N: source rows in chunks of ``chunk``, so the
    distance matrix never exceeds (chunk, M). The centroid shift is the
    whole target's, as in one nn_query call."""
    n = source.shape[0]
    if n <= chunk:
        return nn_query(source, target, tgt_mask, src_mask)
    center = masked_centroid(target, tgt_mask)
    dists, idxs = [], []
    for c0 in range(0, n, chunk):
        d = pairwise_sqdist(source[c0:c0 + chunk], target, tgt_mask,
                            center=center)
        idx = torch.argmin(d, dim=-1)
        dists.append(torch.sqrt(torch.gather(d, 1, idx[:, None])[:, 0]))
        idxs.append(idx)
    dist = torch.cat(dists)
    if src_mask is not None:
        dist = torch.where(src_mask, dist, BIG)
    return dist, torch.cat(idxs)


def knn_query(query, query_mask, points, points_mask, k: int):
    """k nearest valid ``points`` for each query row, nearest first.

    Returns (dists (Q, k), indices (Q, k) int64); rows whose query_mask is
    False get distance BIG. A stable sort puts the lower index first among
    equal distances, as icp_tpu's ``lax.top_k`` does (``torch.topk``
    promises no order among ties on CUDA).
    """
    center = masked_centroid(points, points_mask)
    d = pairwise_sqdist(query, points, points_mask, center=center)
    d_sorted, idx = torch.sort(d, dim=-1, stable=True)
    dist = torch.sqrt(torch.clamp(d_sorted[:, :k], min=0.0))
    if query_mask is not None:
        dist = torch.where(query_mask[:, None], dist, BIG)
    return dist, idx[:, :k]
