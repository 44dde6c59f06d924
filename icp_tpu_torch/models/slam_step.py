"""Fused per-scan SLAM step on device tensors (counterpart of
icp_tpu.models.slam_step: ``SlamState``, ``StepOut``, ``init_state``,
``make_slam_step``).

One step runs the whole per-scan pipeline: scan-to-scan ICP seeded by the
IMU yaw (or a rotation search, feature alignment, both, or nothing), the
rejection gate, the submap
voxel merge, the submap rotation sweep + translation refine, gated
point-to-point submap ICP, the agreement gates, the map paint and the
submap-ring push. Accept/reject decisions are ``torch.where`` selects on
device, so a step reads nothing back to the host except the ICP loops' stop
flags (once per chunk of iterations, models/icp.py).

icp_tpu jits the step and ``lax.scan``s it over a batch with the state
donated (``donate_argnums``), so the grid is updated in place in device
memory. Here the batch is a Python loop over its scans and the state is
updated in place where icp_tpu donates it: the log-odds grid and the
submap ring are written in place, and the state passed to ``step`` or
``batch`` must not be used again afterwards.

Features mode without IMU caches the current scan's features as the next
pair's source (``SlamState.feat``). icp_tpu picks cached or fresh features
with a ``lax.cond`` on a device flag; here ``feat_valid`` is a host bool,
which changes only at ``init_state``, at a resync and at the first
non-degenerate step. The host that packs the scans knows which are
degenerate and passes that to ``step``/``batch``, so no step reads a flag
back for it. The RANSAC stream is a ``torch.Generator`` carried in the
state (``gen``), seeded as icp_tpu seeds its PRNG key.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from icp_tpu_torch.models.features import (FeatureSet, blank_features,
                                           extract_features,
                                           feature_based_alignment,
                                           match_and_align)
from icp_tpu_torch.models.icp import icp_core
from icp_tpu_torch.models.occupancy import world_to_cells
from icp_tpu_torch.models.prealign import rotation_search, submap_rotation_search
from icp_tpu_torch.ops.raytrace import raytrace_update, raytrace_update_batched
from icp_tpu_torch.ops.voxel import voxel_downsample, voxel_downsample_fixed
from icp_tpu_torch.utils import se2, spans


class SlamState(NamedTuple):
    """Device-resident streaming state. icp_tpu's PRNG key is the
    generator ``gen`` here, and ``feat_valid`` is a host bool."""
    prev_pts: torch.Tensor      # (cap, 2) previous scan (sensor frame)
    prev_mask: torch.Tensor     # (cap,)
    global_pose: torch.Tensor   # (3, 3)
    ring_pts: torch.Tensor      # (K, cap, 2) global-frame scans
    ring_mask: torch.Tensor     # (K, cap)
    ring_idx: torch.Tensor      # int32 scalar — next slot to write
    log_odds: torch.Tensor      # (ny, nx)
    # features mode without IMU: the previous scan's features (1-sized
    # dummies in every other mode), and whether they describe prev
    feat: FeatureSet | None = None
    feat_valid: bool = False
    gen: torch.Generator | None = None   # RANSAC stream (features, both)


class StepOut(NamedTuple):
    pose: torch.Tensor          # (3, 3) pose after this scan
    error: torch.Tensor         # registration error used (post-submap)
    accepted: torch.Tensor      # bool — scan advanced the trajectory
    sub_applied: torch.Tensor   # bool — submap correction replaced the pose
    err_inc: torch.Tensor       # raw scan-to-scan ICP error
    iters: torch.Tensor         # s2s ICP iterations
    sub_n: torch.Tensor         # valid submap voxels (== capacity: saturated)
    sweep_drop: torch.Tensor    # sweep voxels dropped by the src/tgt caps


def blank_feat_state(cap: int, feat_shapes=None, device="cpu"):
    """(FeatureSet, valid): the cache's real shapes in features mode
    (feat_shapes = (top_n, k_descriptor)), 1-sized dummies otherwise."""
    if feat_shapes is None:
        return blank_features(1, 1, 1, device), False
    top_n, kd = feat_shapes
    return blank_features(cap, int(top_n), int(kd), device), False


def make_generator(seed: int, device) -> torch.Generator:
    """The RANSAC stream: a torch.Generator on ``device`` seeded with
    ``seed`` (icp_tpu seeds its PRNG key with the same number)."""
    return torch.Generator(device=torch.device(device)).manual_seed(int(seed))


def init_state(first_scan, first_mask, log_odds, ring_k: int, seed: int = 0,
               feat_shapes=None) -> SlamState:
    """State after the first-scan initialisation. ``log_odds`` already holds
    the first scan's paint and is aliased, not copied: the engine's grid
    and the state share one tensor. ``feat_shapes``: (top_n,
    k_descriptor) to carry the features-mode cache, None otherwise."""
    cap = first_scan.shape[0]
    dev = first_scan.device
    ring_pts = torch.zeros((ring_k, cap, 2), dtype=torch.float32, device=dev)
    ring_mask = torch.zeros((ring_k, cap), dtype=torch.bool, device=dev)
    ring_pts[0] = first_scan          # slot 0 <- first scan (identity pose)
    ring_mask[0] = first_mask
    feat, feat_valid = blank_feat_state(cap, feat_shapes, dev)
    spans.count("sync.slam_step.upload")         # ring_idx, from the host
    return SlamState(
        prev_pts=first_scan,
        prev_mask=first_mask,
        global_pose=torch.eye(3, dtype=torch.float32, device=dev),
        ring_pts=ring_pts,
        ring_mask=ring_mask,
        ring_idx=torch.tensor(1, dtype=torch.int32, device=dev),
        log_odds=log_odds,
        feat=feat,
        feat_valid=feat_valid,
        gen=make_generator(seed, dev),
    )


def state_from_numpy(d: dict, device) -> SlamState:
    """SlamState from a dict of numpy arrays keyed by field name (e.g. built
    from an icp_tpu SlamState with ``np.asarray``). ``feat`` may be a
    FeatureSet of either package or a dict of its fields; without it the
    cache is a 1-sized dummy. icp_tpu's PRNG key is ignored: the state gets
    a new generator seeded with 0."""
    def t(x, dtype):
        return torch.as_tensor(np.array(x), dtype=dtype, device=device)

    f32, b = torch.float32, torch.bool
    feat, feat_valid = blank_feat_state(1, None, device)
    if d.get("feat") is not None:
        fd = d["feat"]
        fd = fd._asdict() if hasattr(fd, "_asdict") else fd
        feat = FeatureSet(*(t(fd[k], b if k.endswith("mask") else f32)
                            for k in FeatureSet._fields))
        feat_valid = bool(np.asarray(d.get("feat_valid", False)))
    return SlamState(
        prev_pts=t(d["prev_pts"], f32),
        prev_mask=t(d["prev_mask"], b),
        global_pose=t(d["global_pose"], f32),
        ring_pts=t(d["ring_pts"], f32),
        ring_mask=t(d["ring_mask"], b),
        ring_idx=t(d["ring_idx"], torch.int32),
        log_odds=t(d["log_odds"], f32),
        feat=feat,
        feat_valid=feat_valid,
        gen=make_generator(0, device),
    )


def state_to_numpy(state: SlamState) -> dict:
    """Dict of numpy arrays, one per tensor field of SlamState; ``feat`` is a
    dict of the FeatureSet's fields and ``feat_valid`` a numpy bool. The
    generator is not copied."""
    out = {k: v.detach().cpu().numpy() for k, v in state._asdict().items()
           if isinstance(v, torch.Tensor)}
    if state.feat is not None:
        out["feat"] = {k: v.cpu().numpy() for k, v in state.feat._asdict().items()}
    out["feat_valid"] = np.bool_(state.feat_valid)
    return out


def make_slam_step(
    *,
    use_imu: bool,
    prealign: str = "rotation_search",
    icp_method: str,
    icp_voxel: float,
    icp_max_iterations: int,
    icp_normal_k: int,
    icp_error_threshold: float,
    error_reject_threshold: float,
    rotation_voxel_size: float,
    angle_step_coarse: float,
    angle_step_fine: float,
    feat_voxel: float = 0.2,
    k_curvature: int = 10,
    top_n: int = 100,
    min_kp_dist: float = 0.3,
    k_descriptor: int = 30,
    ratio_threshold: float = 0.8,
    ransac_iterations: int = 1000,
    inlier_threshold: float = 0.5,
    min_inliers: int = 3,
    submap_enabled: bool,
    submap_voxel: float,
    submap_capacity: int,
    sub_rot_range: float,
    sub_rot_step: float,
    sub_rot_fine: float,
    sub_rot_voxel: float,
    sub_corr_dist: float,
    imu_narrow: float,
    sweep_src_cap: int | None = None,
    sweep_tgt_cap: int | None = None,
    grid_min_x: float,
    grid_min_y: float,
    grid_resolution: float,
    l_hit: float,
    l_miss: float,
    log_odds_min: float,
    log_odds_max: float,
    max_ray_cells: int,
    batched_map: bool = False,
    nn_impl: str = "auto",
):
    """Build (step, batch) for a fixed configuration and grid.

    ``prealign`` (without IMU): "rotation_search", "features", "both" or
    "none". ``batched_map``: ``batch`` skips the per-scan paint and paints
    the whole batch once.

    ``step(..., degenerate=)`` / ``batch(..., degenerate=)`` take the
    host's knowledge of which scans have fewer than 10 valid points (a bool,
    or one per scan); only the features cache reads it, and without it the
    step reads the mask's count back once.
    """
    # cache the previous scan's features across steps: exact only when the
    # source cloud reaches extraction unrotated, i.e. "features" without
    # IMU ("both" pre-rotates by the sweep, which changes the voxel bins)
    cache_feats = (not use_imu) and prealign == "features"
    feat_kw = dict(voxel_size=feat_voxel, k_curvature=k_curvature,
                   top_n=top_n, min_kp_dist=min_kp_dist,
                   k_descriptor=k_descriptor)
    ransac_kw = dict(ratio_threshold=ratio_threshold,
                     ransac_iterations=ransac_iterations,
                     inlier_threshold=inlier_threshold)

    def to_cells(xy):
        return world_to_cells(xy, grid_min_x, grid_min_y, grid_resolution)

    prealign_span = spans.span("engine.prealign")
    submap_span = spans.span("engine.submap")
    paint_span = spans.span("map.paint")

    @spans.spanned("engine.step")
    def step(state: SlamState, cur_pts, cur_mask, imu_delta, imu_yaw,
             paint_map: bool = True, degenerate: bool | None = None):
        dev = cur_pts.device
        eye2 = torch.eye(2, dtype=torch.float32, device=dev)
        zero2 = torch.zeros(2, dtype=torch.float32, device=dev)
        feat_cur = None
        # ── scan-to-scan odometry (slam.py:465-483) ─────────────────────
        with prealign_span:
            if use_imu:
                R0, t0 = se2.rotmat(imu_delta), zero2
            elif prealign == "none":
                R0, t0 = eye2, zero2
            elif cache_feats:
                # the current scan's features are extracted once, here, and
                # carried as the next step's source (the reference extracts
                # both clouds per pair, features.py:283-295: same output)
                feat_cur = extract_features(cur_pts, cur_mask, **feat_kw)
                feat_prev = (state.feat if state.feat_valid else
                             extract_features(state.prev_pts, state.prev_mask,
                                              **feat_kw))
                R_f, t_f, n_in = match_and_align(feat_prev, feat_cur,
                                                 state.gen, **ransac_kw)
                ok = n_in >= min_inliers
                R0 = torch.where(ok, R_f, eye2)
                t0 = torch.where(ok, t_f, zero2)
            else:
                R0, t0 = eye2, zero2
                if prealign in ("rotation_search", "both"):
                    R0, t0, _ = rotation_search(
                        state.prev_pts, state.prev_mask, cur_pts, cur_mask,
                        voxel_size=rotation_voxel_size,
                        angle_step_coarse=angle_step_coarse,
                        angle_step_fine=angle_step_fine,
                    )
                if prealign == "both":
                    # feature alignment on the pre-rotated source, composed as
                    # the reference composes it (slam.py:68-88)
                    R_f, t_f, n_in = feature_based_alignment(
                        state.prev_pts @ R0.T + t0, state.prev_mask, cur_pts,
                        cur_mask, state.gen, **feat_kw, **ransac_kw)
                    ok = n_in >= min_inliers
                    R0, t0 = (torch.where(ok, R_f @ R0, R0),
                              torch.where(ok, t0 @ R_f.T + t_f, t0))
        src_d, src_dm = voxel_downsample(state.prev_pts, state.prev_mask,
                                         icp_voxel)
        tgt_d, tgt_dm = voxel_downsample(cur_pts, cur_mask, icp_voxel)
        res = icp_core(
            src_d, src_dm, tgt_d, tgt_dm, R0, t0,
            method=icp_method, max_iterations=icp_max_iterations,
            normal_k=icp_normal_k, error_threshold=icp_error_threshold,
            nn_impl=nn_impl,
        )
        err_inc = res.error
        # degenerate scan (<10 valid points): skip entirely, carrying all
        # state including prev (slam.py:384-385); makes all-masked padding
        # scans exact no-ops
        degenerate_host = degenerate
        degenerate = cur_mask.sum() < 10
        accepted = ~degenerate & (err_inc <= error_reject_threshold)

        new_pose = se2.apply_incremental_pose(state.global_pose, res.R, res.t)
        new_pose = torch.where(accepted, new_pose, state.global_pose)
        error = err_inc

        # ── submap correction (slam.py:497-536) ─────────────────────────
        sub_applied = torch.zeros((), dtype=torch.bool, device=dev)
        sub_n = torch.zeros((), dtype=torch.int32, device=dev)
        sweep_drop = torch.zeros((), dtype=torch.int32, device=dev)
        if submap_enabled:
            with submap_span:
                sub_pts, sub_mask = voxel_downsample_fixed(
                    state.ring_pts.reshape(-1, 2), state.ring_mask.reshape(-1),
                    submap_voxel, submap_capacity)
                sub_n = sub_mask.sum().to(torch.int32)
                if use_imu:
                    pred = se2.make_pose(se2.rotmat(imu_yaw), new_pose[:2, 2])
                    a_range, a_step = imu_narrow, 0.5
                else:
                    pred = new_pose
                    a_range, a_step = sub_rot_range, sub_rot_step
                R_s, t_s, s_drop, t_drop = submap_rotation_search(
                    cur_pts, cur_mask, sub_pts, sub_mask, pred,
                    angle_range=a_range, angle_step=a_step,
                    fine_step=sub_rot_fine, voxel_size=sub_rot_voxel,
                    src_cap=sweep_src_cap, tgt_cap=sweep_tgt_cap,
                    with_overflow=True,
                )
                sweep_drop = s_drop + t_drop
                cur_d, cur_dm = voxel_downsample(cur_pts, cur_mask, icp_voxel)
                # the reference's ICP re-voxelises the (submap-voxel) submap at
                # the ICP voxel (icp.py:150-151 on top of slam.py:103-108)
                sub_d, sub_dm = voxel_downsample(sub_pts, sub_mask, icp_voxel)
                res_sub = icp_core(
                    cur_d, cur_dm, sub_d, sub_dm, R_s, t_s,
                    method="point_to_point", max_iterations=icp_max_iterations,
                    error_threshold=icp_error_threshold,
                    max_corr_dist=sub_corr_dist, use_gate=True,
                    nn_impl=nn_impl,
                )
                pos_diff = torch.linalg.norm(res_sub.t - new_pose[:2, 2])
                sub_yaw = torch.atan2(res_sub.R[1, 0], res_sub.R[0, 0])
                inc_yaw = se2.yaw_of_pose(new_pose)
                yaw_diff = torch.abs(se2.wrap_angle(sub_yaw - inc_yaw))
                sub_ok = (accepted
                          & (res_sub.error <= error_reject_threshold)
                          & (pos_diff < sub_corr_dist)
                          & (yaw_diff < np.float32(math.radians(15.0))))
                new_pose = torch.where(
                    sub_ok, se2.make_pose(res_sub.R, res_sub.t), new_pose)
                error = torch.where(sub_ok, res_sub.error, error)
                sub_applied = sub_ok

        # ── map update (slam.py:551-557) ────────────────────────────────
        gp = se2.transform_points(cur_pts, new_pose)
        if paint_map:
            with paint_span:
                raytrace_update(
                    state.log_odds, to_cells(new_pose[:2, 2]), to_cells(gp),
                    cur_mask & accepted, l_hit, l_miss, log_odds_min,
                    log_odds_max, max_steps=max_ray_cells)

        # ── submap ring push (slam.py:559-562), in place ────────────────
        K = state.ring_pts.shape[0]
        slot = (state.ring_idx % K).reshape(1).long()
        old_pts = state.ring_pts.index_select(0, slot)
        old_mask = state.ring_mask.index_select(0, slot)
        state.ring_pts.index_copy_(0, slot, torch.where(accepted, gp[None],
                                                        old_pts))
        state.ring_mask.index_copy_(0, slot, torch.where(accepted,
                                                         cur_mask[None],
                                                         old_mask))

        feat, feat_valid = state.feat, state.feat_valid
        if cache_feats:
            if degenerate_host is None:
                spans.count("sync.slam_step.degenerate")
                degenerate_host = bool(degenerate)      # one host read
            # a degenerate scan is skipped wholesale (prev unchanged), so
            # the cache keeps describing the old prev
            if not degenerate_host:
                feat, feat_valid = feat_cur, True
        new_state = SlamState(
            prev_pts=torch.where(degenerate, state.prev_pts, cur_pts),
            prev_mask=torch.where(degenerate, state.prev_mask, cur_mask),
            global_pose=new_pose,
            ring_pts=state.ring_pts,
            ring_mask=state.ring_mask,
            ring_idx=state.ring_idx + accepted.to(torch.int32),
            log_odds=state.log_odds,
            feat=feat,
            feat_valid=feat_valid,
            gen=state.gen,
        )
        out = StepOut(pose=new_pose, error=error, accepted=accepted,
                      sub_applied=sub_applied, err_inc=err_inc,
                      iters=res.iters, sub_n=sub_n, sweep_drop=sweep_drop)
        return new_state, out

    def batch(state: SlamState, scans, masks, imu_deltas, imu_yaws,
              degenerate=None):
        """A (B, cap, 2) batch of scans, one step after the other; with
        ``batched_map`` the map is painted once for the whole batch.
        ``degenerate``: one host bool per scan, or None."""
        outs = []
        for i in range(scans.shape[0]):
            state, out = step(state, scans[i], masks[i], imu_deltas[i],
                              imu_yaws[i], paint_map=not batched_map,
                              degenerate=(None if degenerate is None
                                          else bool(degenerate[i])))
            outs.append(out)
        outs = StepOut(*(torch.stack(f) for f in zip(*outs)))
        if batched_map:
            with paint_span:
                R = outs.pose[:, :2, :2]
                t = outs.pose[:, :2, 2]
                gp = scans @ R.transpose(-1, -2) + t[:, None, :]
                raytrace_update_batched(
                    state.log_odds, to_cells(t), to_cells(gp),
                    masks & outs.accepted[:, None], l_hit, l_miss,
                    log_odds_min, log_odds_max, max_steps=max_ray_cells)
        return state, outs

    return step, batch
