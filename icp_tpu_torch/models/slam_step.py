"""Fused per-scan SLAM step on device tensors (counterpart of
icp_tpu.models.slam_step: ``SlamState``, ``StepOut``, ``init_state``,
``make_slam_step``).

One step runs the whole per-scan pipeline: scan-to-scan ICP seeded by the
IMU yaw (or a rotation search / nothing), the rejection gate, the submap
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
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from icp_tpu_torch.models.icp import icp_core
from icp_tpu_torch.models.occupancy import world_to_cells
from icp_tpu_torch.models.prealign import rotation_search, submap_rotation_search
from icp_tpu_torch.ops.raytrace import raytrace_update, raytrace_update_batched
from icp_tpu_torch.ops.voxel import voxel_downsample, voxel_downsample_fixed
from icp_tpu_torch.utils import se2


class SlamState(NamedTuple):
    """Device-resident streaming state (icp_tpu's, less the PRNG key and
    the features-mode cache, which belong to the features branch)."""
    prev_pts: torch.Tensor      # (cap, 2) previous scan (sensor frame)
    prev_mask: torch.Tensor     # (cap,)
    global_pose: torch.Tensor   # (3, 3)
    ring_pts: torch.Tensor      # (K, cap, 2) global-frame scans
    ring_mask: torch.Tensor     # (K, cap)
    ring_idx: torch.Tensor      # int32 scalar — next slot to write
    log_odds: torch.Tensor      # (ny, nx)


class StepOut(NamedTuple):
    pose: torch.Tensor          # (3, 3) pose after this scan
    error: torch.Tensor         # registration error used (post-submap)
    accepted: torch.Tensor      # bool — scan advanced the trajectory
    sub_applied: torch.Tensor   # bool — submap correction replaced the pose
    err_inc: torch.Tensor       # raw scan-to-scan ICP error
    iters: torch.Tensor         # s2s ICP iterations
    sub_n: torch.Tensor         # valid submap voxels (== capacity: saturated)
    sweep_drop: torch.Tensor    # sweep voxels dropped by the src/tgt caps


def init_state(first_scan, first_mask, log_odds, ring_k: int) -> SlamState:
    """State after the first-scan initialisation. ``log_odds`` already holds
    the first scan's paint and is aliased, not copied: the engine's grid
    and the state share one tensor."""
    cap = first_scan.shape[0]
    dev = first_scan.device
    ring_pts = torch.zeros((ring_k, cap, 2), dtype=torch.float32, device=dev)
    ring_mask = torch.zeros((ring_k, cap), dtype=torch.bool, device=dev)
    ring_pts[0] = first_scan          # slot 0 <- first scan (identity pose)
    ring_mask[0] = first_mask
    return SlamState(
        prev_pts=first_scan,
        prev_mask=first_mask,
        global_pose=torch.eye(3, dtype=torch.float32, device=dev),
        ring_pts=ring_pts,
        ring_mask=ring_mask,
        ring_idx=torch.tensor(1, dtype=torch.int32, device=dev),
        log_odds=log_odds,
    )


def state_from_numpy(d: dict, device) -> SlamState:
    """SlamState from a dict of numpy arrays keyed by field name (e.g. built
    from an icp_tpu SlamState with ``np.asarray``; extra keys such as the
    PRNG key are ignored)."""
    def t(name, dtype):
        return torch.as_tensor(np.array(d[name]), dtype=dtype, device=device)

    return SlamState(
        prev_pts=t("prev_pts", torch.float32),
        prev_mask=t("prev_mask", torch.bool),
        global_pose=t("global_pose", torch.float32),
        ring_pts=t("ring_pts", torch.float32),
        ring_mask=t("ring_mask", torch.bool),
        ring_idx=t("ring_idx", torch.int32),
        log_odds=t("log_odds", torch.float32),
    )


def state_to_numpy(state: SlamState) -> dict:
    """Dict of numpy arrays, one per SlamState field."""
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}


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

    ``prealign`` (without IMU): "rotation_search" or "none"; "features" and
    "both" wait for the features port (ROADMAP Queue 1). ``batched_map``:
    ``batch`` skips the per-scan paint and paints the whole batch once.
    """
    if not use_imu and prealign not in ("rotation_search", "none"):
        raise NotImplementedError(
            f"prealign {prealign!r} (features/RANSAC) is not ported yet: "
            f"ROADMAP Queue 1, features/RANSAC branches")

    def to_cells(xy):
        return world_to_cells(xy, grid_min_x, grid_min_y, grid_resolution)

    def step(state: SlamState, cur_pts, cur_mask, imu_delta, imu_yaw,
             paint_map: bool = True):
        dev = cur_pts.device
        eye2 = torch.eye(2, dtype=torch.float32, device=dev)
        zero2 = torch.zeros(2, dtype=torch.float32, device=dev)
        # ── scan-to-scan odometry (slam.py:465-483) ─────────────────────
        if use_imu:
            R0, t0 = se2.rotmat(imu_delta), zero2
        elif prealign == "none":
            R0, t0 = eye2, zero2
        else:
            R0, t0, _ = rotation_search(
                state.prev_pts, state.prev_mask, cur_pts, cur_mask,
                voxel_size=rotation_voxel_size,
                angle_step_coarse=angle_step_coarse,
                angle_step_fine=angle_step_fine,
            )
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
                max_corr_dist=sub_corr_dist, use_gate=True, nn_impl=nn_impl,
            )
            pos_diff = torch.linalg.norm(res_sub.t - new_pose[:2, 2])
            sub_yaw = torch.atan2(res_sub.R[1, 0], res_sub.R[0, 0])
            inc_yaw = se2.yaw_of_pose(new_pose)
            yaw_diff = torch.abs(se2.wrap_angle(sub_yaw - inc_yaw))
            sub_ok = (accepted
                      & (res_sub.error <= error_reject_threshold)
                      & (pos_diff < sub_corr_dist)
                      & (yaw_diff < np.float32(math.radians(15.0))))
            new_pose = torch.where(sub_ok, se2.make_pose(res_sub.R, res_sub.t),
                                   new_pose)
            error = torch.where(sub_ok, res_sub.error, error)
            sub_applied = sub_ok

        # ── map update (slam.py:551-557) ────────────────────────────────
        gp = se2.transform_points(cur_pts, new_pose)
        if paint_map:
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

        new_state = SlamState(
            prev_pts=torch.where(degenerate, state.prev_pts, cur_pts),
            prev_mask=torch.where(degenerate, state.prev_mask, cur_mask),
            global_pose=new_pose,
            ring_pts=state.ring_pts,
            ring_mask=state.ring_mask,
            ring_idx=state.ring_idx + accepted.to(torch.int32),
            log_odds=state.log_odds,
        )
        out = StepOut(pose=new_pose, error=error, accepted=accepted,
                      sub_applied=sub_applied, err_inc=err_inc,
                      iters=res.iters, sub_n=sub_n, sweep_drop=sweep_drop)
        return new_state, out

    def batch(state: SlamState, scans, masks, imu_deltas, imu_yaws):
        """A (B, cap, 2) batch of scans, one step after the other; with
        ``batched_map`` the map is painted once for the whole batch."""
        outs = []
        for i in range(scans.shape[0]):
            state, out = step(state, scans[i], masks[i], imu_deltas[i],
                              imu_yaws[i], paint_map=not batched_map)
            outs.append(out)
        outs = StepOut(*(torch.stack(f) for f in zip(*outs)))
        if batched_map:
            R = outs.pose[:, :2, :2]
            t = outs.pose[:, :2, 2]
            gp = scans @ R.transpose(-1, -2) + t[:, None, :]
            raytrace_update_batched(
                state.log_odds, to_cells(t), to_cells(gp),
                masks & outs.accepted[:, None], l_hit, l_miss,
                log_odds_min, log_odds_max, max_steps=max_ray_cells)
        return state, outs

    return step, batch
