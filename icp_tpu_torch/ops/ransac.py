"""Batched RANSAC rigid alignment, all hypotheses at once (counterpart of
icp_tpu.ops.ransac: ``ransac_align``).

Two layers. ``ransac_from_uniforms`` is deterministic: given the two
uniform draws per hypothesis it samples two distinct pair indices, fits
every 2-point rigid transform in closed form, scores all (H, P) residuals,
takes the first hypothesis with the most inliers and refits on its inlier
set. ``ransac_align`` draws the uniforms from a ``torch.Generator`` and
calls it. torch cannot reproduce ``jax.random`` streams, so the parity tests
feed ``ransac_from_uniforms`` the uniforms icp_tpu derives from its key.
"""
from __future__ import annotations

import torch

from icp_tpu_torch.ops.rigid import p2p_solve_2d, p2p_solve_2d_batched
from icp_tpu_torch.utils.masking import take


def ransac_from_uniforms(src, dst, pair_mask, u1, u2, *, inlier_thresh=0.5):
    """RANSAC from matched pairs and H uniforms u1, u2 in [0, 1).

    src, dst (P, 2) matched pairs; ``pair_mask`` (P,) marks the valid pairs,
    which are compacted to the front (models/features.compact_matches).
    Returns (R (2, 2), t (2,), n_inliers int32): identity and 0 when fewer
    than 2 pairs are valid or no hypothesis scores an inlier (reference
    features.py:130-131,137-138).
    """
    n = pair_mask.sum(dtype=torch.int32)
    nf = n.to(torch.float32)
    last = torch.clamp(n - 1, min=0)
    # two distinct indices in [0, n): i2 skips i1
    i1 = torch.minimum((u1 * nf).to(torch.int32), last)
    i2r = torch.minimum((u2 * torch.clamp(nf - 1.0, min=1.0)).to(torch.int32),
                        torch.clamp(n - 2, min=0))
    i2 = torch.minimum(i2r + (i2r >= i1).to(torch.int32), last)
    pick = torch.stack([i1, i2], dim=1).long()                     # (H, 2)
    Rs, ts = p2p_solve_2d_batched(src[pick], dst[pick],
                                  torch.ones(2, dtype=src.dtype,
                                             device=src.device))

    # residual of every hypothesis on every pair: (H, P)
    px = src[None, :, 0] * Rs[:, 0, None, 0] + src[None, :, 1] * Rs[:, 0, None, 1]
    py = src[None, :, 0] * Rs[:, 1, None, 0] + src[None, :, 1] * Rs[:, 1, None, 1]
    proj = torch.stack([px, py], dim=-1) + ts[:, None, :]
    err = torch.linalg.norm(proj - dst[None], dim=-1)
    is_in = (err < inlier_thresh) & pair_mask[None, :]
    counts = is_in.sum(-1, dtype=torch.int32)                       # (H,)

    best = torch.argmax(counts)       # first max, the reference's strict >
    best_count = take(counts, best)
    mask_best = take(is_in, best)
    m_count = mask_best.sum(dtype=torch.int32)
    # refit on every inlier of the best model (features.py:152-158)
    R_refit, t_refit = p2p_solve_2d(src, dst, mask_best.to(src.dtype))
    use_refit = (best_count >= 2) & (m_count >= 2)
    R_out = torch.where(use_refit, R_refit, take(Rs, best))
    t_out = torch.where(use_refit, t_refit, take(ts, best))
    n_out = torch.where(use_refit, m_count, best_count)

    ok = (n >= 2) & (best_count > 0)
    R_out = torch.where(ok, R_out, torch.eye(2, dtype=src.dtype,
                                             device=src.device))
    t_out = torch.where(ok, t_out, 0.0)
    n_out = torch.where(ok, n_out, 0)
    return R_out, t_out, n_out


def ransac_align(src, dst, pair_mask, generator=None, *, n_iter: int = 1000,
                 inlier_thresh=0.5):
    """``ransac_from_uniforms`` with ``n_iter`` hypotheses whose uniforms are
    drawn from ``generator`` (None: the default one of src's device) on the
    generator's own device, then moved to src's: a mesh lane on another
    card draws what a one-device run draws. Returns (R, t, n_inliers)."""
    dev = src.device if generator is None else generator.device
    u1 = torch.rand(n_iter, generator=generator, device=dev).to(src.device)
    u2 = torch.rand(n_iter, generator=generator, device=dev).to(src.device)
    return ransac_from_uniforms(src, dst, pair_mask, u1, u2,
                                inlier_thresh=inlier_thresh)
