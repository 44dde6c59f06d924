"""Orientation stream for yaw fusion, loaded once into flat arrays.

A numpy copy of icp_tpu.services.imu (icp_tpu imports jax on import).

Input is a semicolon CSV in the reference's fixed schema —
``timestamp_us;qx;qy;qz;qw`` (reference services/imu_service.py:1-9).
Unlike the reference's per-line Python parse and scalar binary-search lookup
(imu_service.py:21-65), this module slurps the whole file through a single
``np.fromstring`` pass (C tokenizer) and serves yaw queries in batch:
``yaws_at`` maps an arbitrary array of relative times to their
nearest-sample yaws with one vectorized ``searchsorted``, which is what the
fused batched SLAM step wants (one call per scan *batch*, not per scan).

Lookup semantics match the reference exactly: nearest sample by absolute
time distance, ties resolved to the right neighbor (imu_service.py:51-65),
so parity tests comparing against the reference see identical yaw picks.
"""
from __future__ import annotations

import numpy as np


def quat_to_yaw_np(qx, qy, qz, qw):
    """Z-axis (yaw) Euler angle from quaternion components, elementwise.

    Same formula the reference applies one row at a time
    (services/imu_service.py:14-18); here the inputs are arrays.
    """
    siny_cosp = 2.0 * (qw * qz + qx * qy)
    cosy_cosp = 1.0 - 2.0 * (qy * qy + qz * qz)
    return np.arctan2(siny_cosp, cosy_cosp)


def _wrap_pi(a):
    """Wrap angle(s) to (-pi, pi]."""
    return (a + np.pi) % (2.0 * np.pi) - np.pi


class IMUService:
    """In-memory yaw table over a recorded quaternion log.

    Construction cost is one file read plus one vectorized quaternion→yaw
    conversion; every query after that is array math against the sorted
    relative-timestamp axis. Exposes both the reference-shaped scalar API
    (``yaw_at`` / ``delta_yaw``, services/imu_service.py:51-75) and the
    batch API ``yaws_at`` used by the fused engine path.
    """

    def __init__(self, file_path):
        with open(file_path, "r") as f:
            text = f.read()
        # Fixed 5-field schema → one C-level tokenize of the whole file.
        flat = np.fromstring(text.replace(";", " "), sep=" ")
        if flat.size >= 5 and flat.size % 5 == 0:
            data = flat.reshape(-1, 5)
        else:
            # Ragged/malformed rows: salvage line-by-line.
            rows = []
            for line in text.splitlines():
                v = np.fromstring(line.strip().replace(";", " "), sep=" ")
                if v.size >= 5:
                    rows.append(v[:5])
            if not rows:
                raise ValueError(f"no IMU rows in {file_path}")
            data = np.stack(rows)
        self.timestamps = data[:, 0].astype(np.int64)
        self.yaws = quat_to_yaw_np(data[:, 1], data[:, 2], data[:, 3],
                                   data[:, 4])
        self._t0 = self.timestamps[0]
        self.rel_timestamps = self.timestamps - self._t0

    def _nearest_idx(self, rel_times_us: np.ndarray) -> np.ndarray:
        """Index of the time-nearest sample for each query, vectorized.

        ``searchsorted`` finds the insertion point; the sample actually
        nearest is either that or its left neighbor, whichever is strictly
        closer (right wins ties — matching imu_service.py:57-63).
        """
        rel = self.rel_timestamps
        t = np.asarray(rel_times_us, np.int64)
        idx = np.clip(np.searchsorted(rel, t), 0, rel.size - 1)
        has_left = idx > 0
        left = np.where(has_left, idx - 1, 0)
        take_left = has_left & (np.abs(rel[left] - t) < np.abs(rel[idx] - t))
        return np.where(take_left, left, idx)

    def yaws_at(self, rel_times_us) -> np.ndarray:
        """Batch lookup: yaw (rad) of the nearest sample per query time."""
        return self.yaws[self._nearest_idx(np.atleast_1d(rel_times_us))]

    def yaw_at(self, rel_time_us) -> float:
        """Scalar convenience wrapper over :meth:`yaws_at`."""
        return float(self.yaws_at(rel_time_us)[0])

    def delta_yaw(self, rel_a_us, rel_b_us) -> float:
        """Wrapped yaw change between two query times (imu_service.py:67-75)."""
        y = self.yaws_at(np.asarray([rel_a_us, rel_b_us]))
        return float(_wrap_pi(y[1] - y[0]))

    def delta_yaws(self, rel_a_us, rel_b_us) -> np.ndarray:
        """Batch wrapped yaw change: one value per (a, b) query pair."""
        return _wrap_pi(self.yaws_at(rel_b_us) - self.yaws_at(rel_a_us))
