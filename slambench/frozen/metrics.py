"""Trajectory accuracy, frozen: ``ate`` and what it needs, copied from
``icp_tpu_torch/utils/metrics.py`` (index-aligned translational RMSE, the
ground truth taken into the frame of its first pose, no Umeyama
alignment)."""
from __future__ import annotations

import numpy as np


def _wrap(a):
    return (a + np.pi) % (2 * np.pi) - np.pi


def gt_relative(gt_xyt: np.ndarray) -> np.ndarray:
    """Ground-truth [x, y, theta] poses -> [x, y, theta] in the frame of
    the first pose (the frame the programs estimate in)."""
    gt_xyt = np.asarray(gt_xyt, dtype=np.float64)
    x0, y0, th0 = gt_xyt[0]
    c, s = np.cos(-th0), np.sin(-th0)
    rot = np.array([[c, -s], [s, c]])
    xy = (gt_xyt[:, :2] - [x0, y0]) @ rot.T
    th = _wrap(gt_xyt[:, 2] - th0)
    return np.concatenate([xy, th[:, None]], axis=1)


def ate(est_xy, gt_xyt, indices) -> float:
    """RMSE of the estimated positions ``est_xy`` (K, 2) against the
    ground-truth rows ``indices`` (K,), in metres."""
    est_xy = np.asarray(est_xy, dtype=np.float64)[:, :2]
    gt_rel = gt_relative(gt_xyt)[:, :2]
    indices = np.asarray(indices)
    if len(indices) != len(est_xy) or len(indices) == 0:
        raise ValueError(f"ate: {len(est_xy)} poses against "
                         f"{len(indices)} indices")
    if indices.max() >= len(gt_rel):
        raise ValueError("ate: an index lies outside the ground truth")
    d = est_xy - gt_rel[indices]
    return float(np.sqrt(np.mean(np.sum(d * d, axis=1))))
