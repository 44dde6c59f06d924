"""Pre-alignment by correlative rotation search (counterpart of
icp_tpu.models.prealign: ``rotation_search``, ``_masked_percentile``,
``submap_rotation_search``).

The angle grids are built on the host with numpy exactly as icp_tpu builds
them, then moved to the device once; the coarse->fine schedule and the
80th-percentile translation refinement follow icp_tpu line for line.
"""
from __future__ import annotations

import numpy as np
import torch

from icp_tpu_torch.ops.nn import nn_query
from icp_tpu_torch.ops.sweep import sweep_scores
from icp_tpu_torch.ops.voxel import voxel_downsample
from icp_tpu_torch.utils import spans
from icp_tpu_torch.utils.masking import BIG, masked_centroid, masked_mean, take
from icp_tpu_torch.utils.se2 import rotmat


def _fine_count(step_coarse_deg: float, step_fine_deg: float) -> int:
    """Number of angles np.arange(lo, hi, fine) yields for hi-lo = 2*coarse."""
    lo = -np.deg2rad(step_coarse_deg)
    hi = np.deg2rad(step_coarse_deg)
    return int(np.ceil((hi - lo) / np.deg2rad(step_fine_deg) - 1e-9))


def _f32(x, device):
    spans.count("sync.prealign.const")
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def rotation_search(
    source, src_mask, target, tgt_mask,
    *,
    voxel_size=0.3,
    angle_step_coarse: float = 2.0,
    angle_step_fine: float = 0.2,
    src_cap: int | None = None,
    tgt_cap: int | None = None,
):
    """Brute-force global rotation search after centroid alignment.

    Returns (R (2,2), t (2,), score). Degenerate inputs (<5 valid points in
    either cloud after downsampling) return (I, 0, BIG).
    """
    dev = source.device
    src, sm = voxel_downsample(source, src_mask, voxel_size)
    tgt, tm = voxel_downsample(target, tgt_mask, voxel_size)
    if src_cap is not None and src_cap < src.shape[0]:
        src, sm = src[:src_cap], sm[:src_cap]
    if tgt_cap is not None and tgt_cap < tgt.shape[0]:
        tgt, tm = tgt[:tgt_cap], tm[:tgt_cap]

    mu_s = masked_centroid(src, sm)
    mu_t = masked_centroid(tgt, tm)
    src_c = src - mu_s

    coarse = _f32(np.deg2rad(np.arange(-180.0, 180.0, angle_step_coarse)), dev)
    scores_c = sweep_scores(src_c, sm, tgt, tm, coarse, mu_t)
    best_c = take(coarse, torch.argmin(scores_c))

    nf = _fine_count(angle_step_coarse, angle_step_fine)
    lo = best_c - np.float32(np.deg2rad(angle_step_coarse))
    fine = lo + torch.arange(nf, dtype=torch.float32, device=dev) \
        * np.float32(np.deg2rad(angle_step_fine))
    scores_f = sweep_scores(src_c, sm, tgt, tm, fine, mu_t)
    i_f = torch.argmin(scores_f)
    best = take(fine, i_f)
    best_score = take(scores_f, i_f)

    R = rotmat(best)
    t = mu_t - R @ mu_s

    ok = (sm.sum() >= 5) & (tm.sum() >= 5)
    R = torch.where(ok, R, torch.eye(2, dtype=torch.float32, device=dev))
    t = torch.where(ok, t, 0.0)
    best_score = torch.where(ok, best_score, BIG)
    return R, t, best_score


def _masked_percentile(values, mask, q: float):
    """np.percentile(values[mask], q) with linear interpolation, static shape."""
    n = values.shape[0]
    v_sorted = torch.sort(torch.where(mask, values, BIG)).values
    cnt = mask.to(torch.int64).sum()
    pos = torch.clamp((q / 100.0) * (cnt.to(torch.float32) - 1.0), min=0.0)
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.minimum(lo + 1, torch.clamp(cnt - 1, min=0))
    frac = pos - lo.to(torch.float32)
    vlo = take(v_sorted, torch.clamp(lo, 0, n - 1))
    vhi = take(v_sorted, torch.clamp(hi, 0, n - 1))
    return vlo * (1.0 - frac) + vhi * frac


def submap_rotation_search(
    source_local, src_mask, submap_global, submap_mask, predicted_pose,
    *,
    angle_range: float = 60.0,
    angle_step: float = 2.0,
    fine_step: float = 0.5,
    voxel_size=0.3,
    src_cap: int | None = None,
    tgt_cap: int | None = None,
    with_overflow: bool = False,
):
    """Rotation sweep around the predicted yaw with translation pinned to the
    predicted position, then one NN-centroid translation refinement over the
    closest 80% of correspondences (reference slam.py:111-183).

    Returns (R (2,2), t (2,)), plus (src_drop, tgt_drop) with
    ``with_overflow``: the valid sweep voxels cut off by ``src_cap`` /
    ``tgt_cap`` (voxel_downsample puts the valid voxels first, so the cut is
    lossless while n_unique <= cap).
    """
    dev = source_local.device
    src, sm = voxel_downsample(source_local, src_mask, voxel_size)
    tgt, tm = voxel_downsample(submap_global, submap_mask, voxel_size)
    src_drop = torch.zeros((), dtype=torch.int32, device=dev)
    tgt_drop = torch.zeros((), dtype=torch.int32, device=dev)
    if src_cap is not None and src_cap < src.shape[0]:
        src_drop = sm[src_cap:].to(torch.int32).sum()
        src, sm = src[:src_cap], sm[:src_cap]
    if tgt_cap is not None and tgt_cap < tgt.shape[0]:
        tgt_drop = tm[tgt_cap:].to(torch.int32).sum()
        tgt, tm = tgt[:tgt_cap], tm[:tgt_cap]

    pred_t = predicted_pose[:2, 2]
    pred_theta = torch.atan2(predicted_pose[1, 0], predicted_pose[0, 0])

    offsets = _f32(np.deg2rad(
        np.arange(-angle_range, angle_range + angle_step, angle_step)), dev)
    angles = pred_theta + offsets
    scores = sweep_scores(src, sm, tgt, tm, angles, pred_t)
    best = take(angles, torch.argmin(scores))

    nf = _fine_count(angle_step, fine_step)
    if nf > 0:
        lo = best - np.float32(np.deg2rad(angle_step))
        fine = lo + torch.arange(nf, dtype=torch.float32, device=dev) \
            * np.float32(np.deg2rad(fine_step))
        fscores = sweep_scores(src, sm, tgt, tm, fine, pred_t)
        best = take(fine, torch.argmin(fscores))

    R_best = rotmat(best)

    # translation refinement (slam.py:168-181): NN match at the predicted
    # placement, keep the closest 80% (squared-distance percentile), take
    # the centroid offset of those correspondences
    rotated = src @ R_best.T
    placed = rotated + pred_t
    nn_dists, nn_idx = nn_query(placed, tgt, tm, sm)
    d_sq = nn_dists * nn_dists
    thresh = _masked_percentile(d_sq, sm, 80.0)
    inlier = (d_sq <= thresh) & sm
    matched = tgt[nn_idx]
    refined_t = masked_mean(matched - rotated, inlier[:, None], dim=0)
    enough = inlier.to(torch.float32).sum() >= 5
    t_out = torch.where(enough, refined_t, pred_t)

    ok = (sm.sum() >= 5) & (tm.sum() >= 5)
    R_out = torch.where(ok, R_best, predicted_pose[:2, :2])
    t_out = torch.where(ok, t_out, pred_t)
    if with_overflow:
        return R_out, t_out, src_drop, tgt_drop
    return R_out, t_out
