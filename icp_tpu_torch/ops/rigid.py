"""Closed-form rigid-alignment solves (counterpart of icp_tpu.ops.rigid:
``p2p_solve_2d``, ``p2p_solve_3d``, ``solve3x3``, ``p2l_solve_2d``), plus
``p2p_solve_2d_batched``, the form of ``jax.vmap(p2p_solve_2d)`` that
RANSAC fits its hypotheses with."""
from __future__ import annotations

import torch

from icp_tpu_torch.utils.se2 import rotmat


def _weighted_centroids(src, dst, w):
    wsum = torch.clamp(w.sum(), min=1e-12)
    mu_s = (src * w[:, None]).sum(0) / wsum
    mu_d = (dst * w[:, None]).sum(0) / wsum
    return mu_s, mu_d


def p2p_solve_2d(src, dst, w):
    """Weighted 2D Procrustes: R, t minimising sum w_i ||R s_i + t - d_i||^2.

    The optimal proper rotation is theta = atan2(W01 - W10, W00 + W11) for
    the cross-covariance W = sum_i w_i s_i d_i^T (the det-fixed SVD result).
    """
    mu_s, mu_d = _weighted_centroids(src, dst, w)
    s = (src - mu_s) * w[:, None]
    d = dst - mu_d
    W = s.T @ d
    theta = torch.atan2(W[0, 1] - W[1, 0], W[0, 0] + W[1, 1])
    R = rotmat(theta)
    t = mu_d - R @ mu_s
    return R, t


def p2p_solve_3d(src, dst, w):
    """Weighted 3D Kabsch: the SVD of the 3 x 3 cross-covariance with the
    reflection fix on V's last column by sign(det(V U^T)).

    src, dst (N, 3); w (N,) nonnegative weights. ``torch.linalg.svd`` is a
    library call here as ``jnp.linalg.svd`` is in icp_tpu (one tiny
    factorisation per ICP iteration); on CUDA it may synchronise.
    """
    mu_s, mu_d = _weighted_centroids(src, dst, w)
    s = (src - mu_s) * w[:, None]
    d = dst - mu_d
    W = s.T @ d                                          # (3, 3)
    U, _, Vt = torch.linalg.svd(W)
    V = Vt.T
    det = torch.linalg.det(V @ U.T)
    V = torch.cat([V[:, :-1], V[:, -1:] * torch.sign(det)], dim=1)
    R = V @ U.T
    t = mu_d - R @ mu_s
    return R, t


def p2p_solve_2d_batched(src, dst, w):
    """``p2p_solve_2d`` over a leading batch: src, dst (..., P, 2), w (P,) or
    (..., P). Returns R (..., 2, 2), t (..., 2).

    The cross-covariance is summed elementwise, not by a matrix product,
    so each batch entry is computed as the single solve computes it."""
    w = w.expand(src.shape[:-1])
    wsum = torch.clamp(w.sum(-1), min=1e-12)[..., None]
    mu_s = (src * w[..., None]).sum(-2) / wsum
    mu_d = (dst * w[..., None]).sum(-2) / wsum
    s = (src - mu_s[..., None, :]) * w[..., None]
    d = dst - mu_d[..., None, :]
    W = (s[..., :, :, None] * d[..., :, None, :]).sum(-3)      # (..., 2, 2)
    theta = torch.atan2(W[..., 0, 1] - W[..., 1, 0], W[..., 0, 0] + W[..., 1, 1])
    R = rotmat(theta)
    t = mu_d - (R @ mu_s[..., None])[..., 0]
    return R, t


def solve3x3(M, v, eps=1e-12):
    """Cramer's-rule solve of M x = v for a 3x3 M.

    Returns (x, ok); ok is False when M is (near-)singular, which the
    reference treats as LinAlgError -> identity transform.
    """
    c0 = torch.linalg.cross(M[:, 1], M[:, 2])
    det = (M[:, 0] * c0).sum()
    scale = M.abs().max() ** 3 + eps
    ok = det.abs() > 1e-9 * scale
    safe_det = torch.where(ok, det, 1.0)
    x0 = (v * c0).sum() / safe_det
    x1 = (M[:, 0] * torch.linalg.cross(v, M[:, 2])).sum() / safe_det
    x2 = (M[:, 0] * torch.linalg.cross(M[:, 1], v)).sum() / safe_det
    return torch.stack([x0, x1, x2]), ok


def p2l_solve_2d(src, q, nrm, w):
    """One linearised point-to-line step.

    Minimises sum w_i (n_i . (R(theta) p_i + t - q_i))^2 under the
    small-angle approximation, then returns the exact R(theta), t.
    src (N, 2) source points; q (N, 2) matched targets; nrm (N, 2) unit
    normals at the matches; w (N,) weights.
    """
    nx, ny = nrm[:, 0], nrm[:, 1]
    px, py = src[:, 0], src[:, 1]
    dx, dy = px - q[:, 0], py - q[:, 1]
    c = ny * px - nx * py
    A = torch.stack([c, nx, ny], dim=1)                  # (N, 3)
    b = -(nx * dx + ny * dy)                             # (N,)
    Aw = A * w[:, None]
    ATA = A.T @ Aw
    ATb = Aw.T @ b
    x, ok = solve3x3(ATA, ATb)
    theta, t = x[0], x[1:]
    R = rotmat(torch.where(ok, theta, 0.0))
    t = torch.where(ok, t, torch.zeros_like(t))
    return R, t
