"""Correlative angle-sweep scoring (counterpart of icp_tpu.ops.sweep).

For each candidate angle a the source is placed as ``source @ R(a).T +
t_offset`` and scored by the masked mean over valid sources of the min
squared distance to any valid target. As in icp_tpu's TPU path
(``_sweep_scores_pallas``), the placement and the per-angle masked mean are
plain tensor ops, and the per-row min over targets is the streaming kernel
(``nn_min_cuda``), so the (A*N, M) distance matrix is never stored on the
card. Distances are taken by direct differencing, so no centroid shift is
needed for f32 stability.
"""
from __future__ import annotations

import torch

from icp_tpu_torch.ops.hopper.nn_kernel import nn_min_cuda
from icp_tpu_torch.utils.masking import masked_mean
from icp_tpu_torch.utils.se2 import rotmat


def sweep_scores(source, src_mask, target, tgt_mask, angles, t_offset):
    """Mean squared NN distance for every candidate angle.

    source (N, 2), src_mask (N,), target (M, 2), tgt_mask (M,), angles (A,),
    t_offset (2,). Returns scores (A,) f32.
    """
    A = angles.shape[0]
    N = source.shape[0]
    R = rotmat(angles)                                         # (A, 2, 2)
    placed = torch.einsum("nd,aed->ane", source, R) + t_offset  # (A, N, 2)
    dmin = nn_min_cuda(placed.reshape(A * N, 2), target, tgt_mask)
    return masked_mean(dmin.reshape(A, N), src_mask[None, :], dim=-1)
