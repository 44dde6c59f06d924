"""Trajectory accuracy metrics: ATE and RPE.

A numpy copy of icp_tpu.utils.metrics (icp_tpu imports jax on import).

The reference never persists accuracy — it prints per-scan ICP error only
(reference slam.py:644-647) and leaves evaluation to eyeballing the
live map. This module is the quantitative replacement used by the bench
harnesses (bench.py, benchmarks/bench_suite.py, benchmarks/bench_scaled.py)
and the integration tests.

Conventions (shared by every caller):

* ground truth is an (N, 3) float array of [x, y, theta] world poses;
* estimated trajectories are positions (K, 2) or poses (K, 3) expressed in
  the frame of the FIRST ground-truth pose (the engine anchors scan 0 at
  the identity), so ground truth is rotated/translated into that frame
  before comparison rather than Umeyama-aligned — a SLAM system that
  drifts in absolute coordinates should pay for it here;
* the engine's `pose_trajectory` starts at scan 1 (scan 0 defines the
  frame and has no estimate), hence the default `gt_offset=1`.
"""
from __future__ import annotations

import warnings

import numpy as np


def _check_coverage(keep: np.ndarray, what: str) -> None:
    """Guard the ``indices=`` filtering: silently averaging over a heavily
    filtered set (out-of-range ground-truth rows) would report an ATE/RPE
    that covers a fraction of the trajectory while looking authoritative —
    and an EMPTY set would return NaN with only a NumPy RuntimeWarning.
    Raise when nothing survives; warn when more than half is dropped."""
    n = keep.size
    kept = int(np.count_nonzero(keep))
    if kept == 0:
        raise ValueError(
            f"{what}: all {n} estimate poses map outside the ground truth "
            f"(indices out of range) — nothing to score")
    if kept < n / 2:
        warnings.warn(
            f"{what}: {n - kept}/{n} estimate poses dropped (ground-truth "
            f"indices out of range); the score covers only {kept} poses",
            RuntimeWarning, stacklevel=3)


def poses_to_xyt(poses) -> np.ndarray:
    """Stack a sequence of 3x3 SE(2) matrices into an (N, 3) [x, y, theta]."""
    mats = np.asarray(poses)
    x = mats[:, 0, 2]
    y = mats[:, 1, 2]
    th = np.arctan2(mats[:, 1, 0], mats[:, 0, 0])
    return np.stack([x, y, th], axis=1)


def gt_relative(gt_xyt: np.ndarray) -> np.ndarray:
    """Ground-truth [x, y, theta] poses -> [x, y, theta] in the frame of
    the first pose (the frame the engine estimates in)."""
    gt_xyt = np.asarray(gt_xyt, dtype=np.float64)
    x0, y0, th0 = gt_xyt[0]
    c, s = np.cos(-th0), np.sin(-th0)
    rot = np.array([[c, -s], [s, c]])
    xy = (gt_xyt[:, :2] - [x0, y0]) @ rot.T
    th = _wrap(gt_xyt[:, 2] - th0)
    return np.concatenate([xy, th[:, None]], axis=1)


def ate(est_xy, gt_xyt, gt_offset: int = 1, indices=None) -> float:
    """RMSE translational Absolute Trajectory Error (meters).

    ``est_xy[k]`` is compared against ground-truth pose ``k + gt_offset``
    expressed in the first pose's frame. Extra poses on either side (an
    engine that stopped early, ground truth one longer than the estimate)
    are ignored via truncation to the common length.

    ``indices`` (optional, overrides ``gt_offset``): per-estimate
    ground-truth row ids. A SLAM engine that *rejects* scans appends no
    pose for them, so positional alignment drifts by one ground-truth row
    per rejection; ``SlamEngine.pose_scan_indices`` provides the exact
    mapping.
    """
    est_xy = np.asarray(est_xy, dtype=np.float64)
    if est_xy.ndim == 3:            # a stack of 3x3 poses
        est_xy = poses_to_xyt(est_xy)[:, :2]
    est_xy = est_xy[:, :2]
    gt_rel = gt_relative(gt_xyt)[:, :2]
    if indices is not None:
        indices = np.asarray(indices)
        n = min(len(est_xy), len(indices))
        keep = indices[:n] < len(gt_rel)
        _check_coverage(keep, "ate")
        d = est_xy[:n][keep] - gt_rel[indices[:n][keep]]
    else:
        n = min(len(est_xy), len(gt_rel) - gt_offset)
        d = est_xy[:n] - gt_rel[gt_offset:gt_offset + n]
    return float(np.sqrt(np.mean(np.sum(d * d, axis=1))))


def rpe(est_xyt, gt_xyt, delta: int = 1, gt_offset: int = 1, indices=None):
    """Relative Pose Error over windows of ``delta`` frames.

    For each i, the error transform is
    ``(gt_i^-1 gt_{i+delta})^-1 (est_i^-1 est_{i+delta})``; returns
    ``(trans_rmse_m, rot_rmse_rad)`` over all windows. Unlike ATE this is
    insensitive to slow global drift and measures local odometry quality —
    the submap correction moves ATE, scan-to-scan registration moves RPE.

    ``indices`` (optional): per-estimate ground-truth row ids (see ``ate``);
    windows then compare est pose pairs against the SAME ground-truth row
    pairs, so a rejected scan between two estimates doesn't misattribute
    the skipped motion as error.
    """
    est_xyt = np.asarray(est_xyt, dtype=np.float64)
    if est_xyt.ndim == 3:
        est_xyt = poses_to_xyt(est_xyt)
    gt_rel = gt_relative(gt_xyt)
    if indices is not None:
        indices = np.asarray(indices)
        n = min(len(est_xyt), len(indices))
        keep = indices[:n] < len(gt_rel)
        _check_coverage(keep, "rpe")
        est = est_xyt[:n][keep]
        gt = gt_rel[indices[:n][keep]]
        n = len(est)
    else:
        n = min(len(est_xyt), len(gt_rel) - gt_offset)
        est = est_xyt[:n]
        gt = gt_rel[gt_offset:gt_offset + n]
    if n <= delta:
        raise ValueError(f"need more than delta={delta} poses, got {n}")
    d_est = _rel(est[:-delta], est[delta:])
    d_gt = _rel(gt[:-delta], gt[delta:])
    err = _rel(d_gt, d_est)
    t_rmse = float(np.sqrt(np.mean(np.sum(err[:, :2] ** 2, axis=1))))
    r_rmse = float(np.sqrt(np.mean(err[:, 2] ** 2)))
    return t_rmse, r_rmse


def _wrap(a):
    return (a + np.pi) % (2 * np.pi) - np.pi


def _rel(a, b):
    """Batched relative SE(2) transform a^-1 * b for (N,3) [x,y,theta]."""
    dth = _wrap(b[:, 2] - a[:, 2])
    dxy = b[:, :2] - a[:, :2]
    c, s = np.cos(a[:, 2]), np.sin(a[:, 2])
    # rotate the world-frame delta into a's frame (R(a)^T @ dxy)
    dx = c * dxy[:, 0] + s * dxy[:, 1]
    dy = -s * dxy[:, 0] + c * dxy[:, 1]
    return np.stack([dx, dy, dth], axis=1)
