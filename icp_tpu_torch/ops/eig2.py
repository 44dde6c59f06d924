"""Batched closed-form 2x2 symmetric eigensolve, normals and curvature
(counterpart of icp_tpu.ops.eig2: ``eigh2x2``, ``_neighbor_cov``,
``estimate_normals``, ``compute_curvature``).

Covariance uses ddof=1 (``np.cov``'s default) over the k+1 nearest
neighbours, self included.
"""
from __future__ import annotations

import torch

from icp_tpu_torch.ops.nn import pairwise_sqdist
from icp_tpu_torch.utils import spans
from icp_tpu_torch.utils.masking import masked_centroid


def eigh2x2(a, b, c):
    """Eigen-decomposition of batched symmetric [[a, b], [b, c]].

    Returns (lmin, lmax, vmin): vmin (..., 2) is the unit eigenvector of the
    smallest eigenvalue (sign arbitrary).
    """
    half_tr = 0.5 * (a + c)
    half_diff = 0.5 * (a - c)
    rad = torch.sqrt(half_diff * half_diff + b * b)
    lmin = half_tr - rad
    lmax = half_tr + rad
    # two candidate null-vectors of (cov - lmin I); keep the larger one
    v1 = torch.stack([b, lmin - a], dim=-1)
    v2 = torch.stack([lmin - c, b], dim=-1)
    n1 = (v1 * v1).sum(-1)
    n2 = (v2 * v2).sum(-1)
    v = torch.where((n1 >= n2)[..., None], v1, v2)
    norm = torch.sqrt(torch.clamp((v * v).sum(-1, keepdim=True), min=0.0))
    # isotropic neighbourhood (rad ~ 0): any direction is an eigenvector
    spans.count("sync.eig2.fallback")
    fallback = torch.tensor([1.0, 0.0], dtype=v.dtype, device=v.device).expand(v.shape)
    v = torch.where(norm > 1e-20, v / torch.clamp(norm, min=1e-20), fallback)
    return lmin, lmax, v


def _neighbor_cov(points, mask, k: int):
    """Batched ddof=1 covariance over each point's k+1 nearest neighbours.

    Returns (a, b, c, cnt). The (k+1)-th smallest distance per row is found
    with k+1 min-and-mask passes; every neighbour at or below it is kept,
    so all points tied at the threshold count (not ``topk``, which would
    pick among ties).
    """
    center = masked_centroid(points, mask)
    p = points - center                      # translation-invariant cov
    d0 = pairwise_sqdist(p, p, mask)         # (N, N); masked cols BIG
    d = d0
    thresh = None
    for _ in range(k + 1):
        thresh = d.amin(-1)
        d = torch.where(d <= thresh[:, None], torch.inf, d)
    w = ((d0 <= thresh[:, None]) & mask[None, :]).to(points.dtype)

    cnt = w.sum(-1)
    cntc = torch.clamp(cnt, min=1.0)
    mx = (w @ p[:, 0]) / cntc
    my = (w @ p[:, 1]) / cntc
    # second moments about each row's own neighbourhood mean
    dx = p[None, :, 0] - mx[:, None]
    dy = p[None, :, 1] - my[:, None]
    denom = torch.clamp(cnt - 1.0, min=1.0)
    a = (w * dx * dx).sum(-1) / denom
    b = (w * dx * dy).sum(-1) / denom
    c = (w * dy * dy).sum(-1) / denom
    return a, b, c, cnt


def estimate_normals(points, mask, k: int = 10):
    """Unit 2D normals via PCA of the k nearest neighbours (sign arbitrary)."""
    a, b, c, _ = _neighbor_cov(points, mask, k)
    _, _, v = eigh2x2(a, b, c)
    return v


def compute_curvature(points, mask, k: int = 10):
    """PCA curvature lmin / (lmax + 1e-10) in [0, 1] per point. Points with
    fewer than 3 valid neighbours, and masked points, get 0 (the
    reference's ``len(nbrs) < 3: continue``)."""
    a, b, c, cnt = _neighbor_cov(points, mask, k)
    lmin, lmax, _ = eigh2x2(a, b, c)
    curv = torch.clamp(lmin, min=0.0) / (lmax + 1e-10)
    return torch.where((cnt >= 3) & mask, curv, 0.0)
