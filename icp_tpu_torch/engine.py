"""Streaming SLAM engine (counterpart of icp_tpu.engine).

The host owns I/O, the scan history, the pose graph and the bookkeeping of
step results; every per-scan computation runs on ``device``. The first scan
initialises the grid bounds, the ray bound and the sweep caps and paints
the grid through ``OccupancyGrid2D.update_scan``. With ``tpu.fused: true``
it then builds the fused state of models/slam_step.py, which aliases the
grid, and later scans go through ``process_scan`` (one at a time) or
``process_scans_batched`` (B at a time, map painted once per batch). With
``tpu.fused: false`` every scan takes the modular path, icp_tpu's
reference-shaped pipeline of separate calls: ``_run_icp_pair`` (the
registration front end with its pre-alignment), ``_attempt_submap_icp``
against the host-side ``submap_buffer``, and a map paint per scan.

Loop closure (reference slam.py:565-620) follows icp_tpu: candidate gates
on node positions, verification of each (node, candidate) pair by rotation
search + ICP on the raw sensor-frame scans, the reference's accept-first
arbitration, a cooldown, then a pose-graph solve that rewrites the history
and resyncs the fused state; the map replay is deferred to the next read
(``sync_map``). Batched, each chunk is read and bookkept in the call that
hands it over; an accepted closure inside a chunk puts the chunk's later
scans back at the front of the backlog (``_run_backlog``).
``save_checkpoint`` /
``load_checkpoint`` use icp_tpu's npz keys, so a checkpoint of either
package loads into the other.

Pre-alignment without IMU is a rotation search, feature alignment
(curvature keypoints, descriptors, RANSAC), both, or none, on both paths and
in loop-closure verification. RANSAC draws from ``torch.Generator``
streams seeded as icp_tpu seeds its PRNG keys: the fused state's, and the
engine's own (``_gen``) for the modular path and verification.

``display.live_map`` refreshes a matplotlib window, or PNG snapshots where
there is no display, every ``snapshot_every`` scans (``maybe_snapshot``).

``tpu.distributed`` builds a device mesh (``parallel.mesh``) of the
engine's device kind, as icp_tpu does: true needs more than one visible
device, "auto" builds one wherever more than one is visible. On a mesh the
pose graph solves through the distributed Schur-complement GN from
``dist_node_threshold`` nodes up, and loop-closure verification runs pair k
on local shard k mod D.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from icp_tpu_torch.models.features import feature_based_alignment
from icp_tpu_torch.models.icp import icp
from icp_tpu_torch.models.occupancy import OccupancyGrid2D
from icp_tpu_torch.models.pose_graph import PoseGraph2D
from icp_tpu_torch.models.prealign import rotation_search, submap_rotation_search
from icp_tpu_torch.models.slam_step import (SlamState, blank_feat_state,
                                            init_state, make_generator,
                                            make_slam_step)
from icp_tpu_torch.ops.voxel import voxel_downsample_fixed
from icp_tpu_torch.parallel.mesh import make_mesh, visible_devices
from icp_tpu_torch.services.imu import IMUService
from icp_tpu_torch.services.lidar import LidarService
from icp_tpu_torch.utils import spans
from icp_tpu_torch.utils.config import SlamConfig
from icp_tpu_torch.utils.masking import next_pow2
from icp_tpu_torch.utils.se2 import pose_to_vec_np


def filter_and_flatten(points, z_min=0.2, z_max=2.0):
    """Keep z in [z_min, z_max], return x,y (reference slam.py:24-27)."""
    mask = (points[:, 2] >= z_min) & (points[:, 2] <= z_max)
    return np.ascontiguousarray(points[mask, :2], dtype=np.float32)


def compute_bounds_from_scan(points_2d, margin=50.0):
    """Grid bounds = first-scan bbox + margin (reference slam.py:30-35)."""
    return (
        float(points_2d[:, 0].min() - margin),
        float(points_2d[:, 0].max() + margin),
        float(points_2d[:, 1].min() - margin),
        float(points_2d[:, 1].max() + margin),
    )


def _relative_vec_np(Ti: np.ndarray, Tj: np.ndarray) -> np.ndarray:
    """vec(Ti^-1 Tj), on the host."""
    R = Ti[:2, :2]
    t = Ti[:2, 2]
    Tinv = np.eye(3, dtype=np.float64)
    Tinv[:2, :2] = R.T
    Tinv[:2, 2] = -R.T @ t
    return pose_to_vec_np(Tinv @ Tj)


def _pad_fixed(points: np.ndarray, capacity: int):
    """Pad/truncate an (n, 2) host array to capacity (numpy arrays); padding
    rows repeat the first point."""
    n = min(points.shape[0], capacity)
    out = np.zeros((capacity, 2), np.float32)
    if n > 0:
        out[:n] = points[:n]
        out[n:] = points[0]
    mask = np.zeros(capacity, bool)
    mask[:n] = True
    return out, mask


@dataclass
class ScanRecord:
    points: np.ndarray          # (n, 2) sensor-frame
    pose: np.ndarray            # (3, 3) global
    scan_idx: int = 0           # 0-based input-stream index (rejected scans
                                # leave gaps — used for honest ATE alignment)


@dataclass
class SlamStats:
    scans: int = 0
    rejected: int = 0
    submap_corrections: int = 0
    loop_closures: int = 0
    lc_checks: int = 0         # nodes whose candidate gates passed
    lc_pairs: int = 0          # (node, candidate) pairs verified
    lc_groups: int = 0         # verification groups of L pairs
    icp_iters: int = 0
    truncated_scans: int = 0   # scans out-ranging the auto ray bound
    sweep_dropped_voxels: int = 0  # sweep voxels lost to src/tgt caps
    wall_registration: float = 0.0
    wall_mapping: float = 0.0      # (the modular path's; 0 on the fused)
    wall_loop_closure: float = 0.0
    lc_requeued_scans: int = 0     # rollback re-registrations after accepts


class SlamEngine:
    """Streaming SLAM engine on ``device`` (and its mesh, if any). Feed
    scans through ``process_scan`` / ``process_scans_batched``, then
    ``finish()``; read ``global_pose``, ``pose_trajectory`` and
    ``mapper``."""

    def __init__(self, cfg: SlamConfig, imu: IMUService | None = None,
                 verbose: bool = True, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SlamEngine(device='cuda') but CUDA is not "
                               "available; pass device='cpu' explicitly")
        self.cfg = cfg
        self.imu = imu
        self.verbose = verbose

        self.global_pose = np.eye(3, dtype=np.float32)
        self.pose_trajectory: list[np.ndarray] = []
        self.scan_history: list[ScanRecord] = []
        self.prev_points: np.ndarray | None = None
        self.prev_rel_time = None
        self.mapper: OccupancyGrid2D | None = None
        self.submap_buffer: list[np.ndarray] = []   # modular path: global scans
        self.pose_graph = PoseGraph2D(self.device)
        self.pose_graph.robust_phi = float(cfg.lc_robust_phi)
        self.imu_yaw_offset = 0.0
        self.stats = SlamStats()
        # RANSAC stream of the modular path and of verification
        self._gen = make_generator(cfg.ransac_iterations, self.device)

        # a 1-D mesh over the visible devices of the engine's kind (virtual
        # shards included: parallel.mesh.set_virtual_devices) for the
        # pose-graph solve and the loop-closure lanes
        self.mesh = None
        n_dev = len(visible_devices(self.device.type))
        if cfg.distributed is True and n_dev < 2:
            raise RuntimeError(f"tpu.distributed=true needs >1 device, found "
                               f"{n_dev} of kind {self.device.type!r}")
        if cfg.distributed is True or (cfg.distributed == "auto"
                                       and n_dev > 1):
            self.mesh = make_mesh(device=self.device.type)
            self.pose_graph.set_mesh(self.mesh, cfg.dist_node_threshold)

        self._cap = cfg.scan_capacity
        self._sub_cap = cfg.submap_capacity
        # shapes of the fused features-mode cache (SlamState.feat)
        self._feat_shapes = (
            (int(cfg.top_n), int(cfg.k_descriptor))
            if (cfg.alignment_method == "features" and imu is None)
            else None
        )
        self._step_fn = None
        self._batch_fn = None
        self._state: SlamState | None = None
        self._backlog: list = []          # (scan, rel time) not yet run
        self._map_dirty = False           # closure happened; replay on read
        self._last_lc_accept = None       # node idx of last accepted closure
        self._ray_bound: int | None = None
        self._free_cap: int | None = None
        self._sweep_caps: tuple[int, int] | None = None
        self._warned_truncate = False
        self._sub_sat_warned = False
        self._sweep_drop_warned = False
        self.lidar_parser = None          # run_slam: "native" | "numpy"
        self._live_view = None            # interactive window (if display)
        self._snapshot_scans = 0          # stats.scans at the last refresh
        self._live_view_failed = False

    # ── static bounds resolved from the first scan ───────────────────────
    def _resolve_ray_bound(self, first_points: np.ndarray) -> int:
        """Bresenham step bound. "auto" sizes it from the first scan's max
        range with 1.5x headroom (multiple of 64); an int is used as-is."""
        mrc = self.cfg.max_ray_cells
        if isinstance(mrc, str):
            if mrc != "auto":
                raise ValueError(f"max_ray_cells must be int or 'auto', "
                                 f"got {mrc!r}")
            rmax = float(np.max(np.linalg.norm(first_points, axis=1)))
            cells = int(np.ceil(rmax / self.cfg.map_resolution)) + 2
            return max(64, int(np.ceil(cells * 1.5 / 64.0)) * 64)
        return int(mrc)

    def _resolve_free_cap(self, first_points: np.ndarray,
                          ray_bound: int) -> int | None:
        """``tpu.free_cells_cap`` resolved and checked as icp_tpu does, so
        one YAML is accepted or refused alike by both packages. icp_tpu uses
        it to size its sorted free-cell compaction; the port's plain
        accumulate-scatter needs no capacity, so the value is only kept
        (``self._free_cap``) as the count of free cells the first scan
        emits, with 1.5x headroom."""
        fcc = self.cfg.free_cells_cap
        if fcc in (None, 0, "none"):
            return None
        full = ray_bound * self.cfg.scan_capacity
        if isinstance(fcc, str):
            if fcc != "auto":
                raise ValueError(f"free_cells_cap must be int, 'auto' or "
                                 f"None, got {fcc!r}")
            cheb = np.max(np.abs(first_points[:, :2]), axis=1)
            est = float(np.sum(cheb)) / self.cfg.map_resolution
            cap = max(8192, int(np.ceil(est * 1.5 / 8192.0)) * 8192)
        else:
            cap = int(fcc)
        return None if cap >= full else cap

    def _resolve_sweep_caps(self, first_points: np.ndarray):
        """Capacities of the submap-sweep scoring clouds. "auto" sizes them
        from the first scan's occupied coarse-voxel count n0 (at
        sub_rot_voxel): 2x n0 for the one-scan source, 4x n0 for the merged
        submap target, rounded up to a multiple of 128 and clamped by the
        scan / submap capacities. Ints pass through; None keeps the
        capacity-derived defaults. Overflow later is counted and warned."""
        cfg = self.cfg
        n0 = None
        if isinstance(cfg.sweep_src_capacity, str) or \
                isinstance(cfg.sweep_tgt_capacity, str):
            v = float(cfg.sub_rot_voxel)
            k = np.floor(first_points[:, :2] / v).astype(np.int64)
            n0 = len(np.unique(k[:, 0] * 1000003 + k[:, 1]))

        def one(setting, default, factor, hard_cap):
            if setting in (None, 0):
                return int(default)
            if isinstance(setting, str):
                if setting != "auto":
                    raise ValueError(f"sweep capacity must be int, 'auto' "
                                     f"or None, got {setting!r}")
                cap = max(256, int(np.ceil(n0 * factor / 128.0)) * 128)
                return min(cap, int(hard_cap))
            return int(setting)

        self._sweep_caps = (
            one(cfg.sweep_src_capacity, max(256, cfg.scan_capacity // 2),
                2.0, cfg.scan_capacity),
            one(cfg.sweep_tgt_capacity, max(512, cfg.submap_capacity // 4),
                4.0, cfg.submap_capacity),
        )

    def _check_ray_bound(self, points_2d: np.ndarray):
        """Count (and warn once about) scans whose longest ray exceeds the
        Bresenham bound: their free-space marking is truncated."""
        if self._ray_bound is None or points_2d.shape[0] == 0:
            return
        rmax = float(np.max(np.linalg.norm(points_2d, axis=1)))
        if int(np.ceil(rmax / self.cfg.map_resolution)) + 2 > self._ray_bound:
            self.stats.truncated_scans += 1
            if not self._warned_truncate:
                self._warned_truncate = True
                print(f"  [warn] scan out-ranges max_ray_cells="
                      f"{self._ray_bound} ({rmax:.1f} m); free-space "
                      f"marking truncated (counted in stats)")

    # ── modular path: registration front end (reference slam.py:53-98) ──
    @spans.spanned("engine.prealign")
    def _prealign(self, sp, sm, tp, tm):
        """Initial (R, t) of source onto target by the configured method:
        rotation search, then (features, both) feature alignment on the
        pre-rotated source, composed when it finds min_inliers inliers
        (reference slam.py:68-88). "none" gives (I, 0). Runs on the clouds'
        device; RANSAC draws from ``_gen`` on the engine's device."""
        cfg = self.cfg
        method = cfg.alignment_method
        R0 = torch.eye(2, dtype=torch.float32, device=sp.device)
        t0 = torch.zeros(2, dtype=torch.float32, device=sp.device)
        if method in ("rotation_search", "both"):
            R0, t0, _ = rotation_search(
                sp, sm, tp, tm,
                voxel_size=cfg.rotation_voxel_size,
                angle_step_coarse=float(cfg.angle_step_coarse),
                angle_step_fine=float(cfg.angle_step_fine),
            )
        if method in ("features", "both"):
            R_f, t_f, n_in = feature_based_alignment(
                sp @ R0.T + t0, sm, tp, tm, self._gen,
                voxel_size=cfg.feat_voxel, k_curvature=int(cfg.k_curvature),
                top_n=int(cfg.top_n), min_kp_dist=cfg.min_kp_dist,
                k_descriptor=int(cfg.k_descriptor),
                ratio_threshold=cfg.ratio_threshold,
                ransac_iterations=int(cfg.ransac_iterations),
                inlier_threshold=cfg.inlier_threshold)
            ok = n_in >= int(cfg.min_inliers)
            R0 = torch.where(ok, R_f @ R0, R0)
            t0 = torch.where(ok, t0 @ R_f.T + t_f, t0)
        return R0, t0

    def _run_icp_pair(self, source: np.ndarray, target: np.ndarray):
        """Pre-alignment + ICP of one scan pair; returns (R, t, err) on the
        host and counts the ICP's iterations."""
        cfg = self.cfg
        sp, sm = self._to_device(*_pad_fixed(source, self._cap))
        tp, tm = self._to_device(*_pad_fixed(target, self._cap))
        R0, t0 = self._prealign(sp, sm, tp, tm)
        res = icp(
            sp, sm, tp, tm, R0, t0,
            voxel_size=cfg.icp_voxel,
            method=cfg.icp_method,
            max_iterations=int(cfg.icp_max_iterations),
            normal_k=int(cfg.icp_normal_k),
            error_threshold=cfg.icp_error_threshold,
            nn_impl=str(cfg.nn_impl),
        )
        self.stats.icp_iters += int(res.iters)
        return res.R.cpu().numpy(), res.t.cpu().numpy(), float(res.error)

    # ── modular path: submap (reference slam.py:103-225) ─────────────────
    def _build_submap(self):
        """Voxel-merged submap of ``submap_buffer`` on the device, at most
        ``submap_capacity`` voxels."""
        combined = np.concatenate(self.submap_buffer, axis=0)
        cap = min(next_pow2(combined.shape[0]), self._sub_cap * 4)
        pts, mask = self._to_device(*_pad_fixed(combined, cap))
        return voxel_downsample_fixed(pts, mask, self.cfg.submap_voxel,
                                      self._sub_cap)

    def _attempt_submap_icp(self, points: np.ndarray, predicted: np.ndarray,
                            imu_yaw):
        """Submap rotation sweep around ``predicted`` (its yaw replaced by
        the IMU's when given, with the narrow range), then gated
        point-to-point ICP against the submap; returns (R, t, err)."""
        cfg = self.cfg
        sub_pts, sub_mask = self._build_submap()
        sp, sm = self._to_device(*_pad_fixed(points, self._cap))
        pred = predicted.copy()
        if imu_yaw is not None:
            c, s = np.cos(imu_yaw), np.sin(imu_yaw)
            pred[:2, :2] = [[c, -s], [s, c]]
            angle_range, angle_step = cfg.imu_narrow, 0.5
        else:
            angle_range, angle_step = cfg.sub_rot_range, cfg.sub_rot_step
        R0, t0, s_drop, t_drop = submap_rotation_search(
            sp, sm, sub_pts, sub_mask, self._to_device(pred)[0],
            angle_range=float(angle_range),
            angle_step=float(angle_step),
            fine_step=float(cfg.sub_rot_fine),
            voxel_size=cfg.sub_rot_voxel,
            src_cap=self._sweep_caps[0], tgt_cap=self._sweep_caps[1],
            with_overflow=True,
        )
        self._check_sweep_drop(int(s_drop) + int(t_drop))
        res = icp(
            sp, sm, sub_pts, sub_mask, R0, t0,
            voxel_size=cfg.icp_voxel,
            method="point_to_point",
            max_iterations=int(cfg.icp_max_iterations),
            error_threshold=cfg.icp_error_threshold,
            max_corr_dist=cfg.sub_corr_dist,
            use_gate=True,
            nn_impl=str(cfg.nn_impl),
        )
        self.stats.icp_iters += int(res.iters)
        return res.R.cpu().numpy(), res.t.cpu().numpy(), float(res.error)

    # ── loop closure (reference slam.py:231-268, 565-620) ────────────────
    def _find_loop_candidates(self, cur_idx: int, cur_xy=None):
        """Candidate gates of node ``cur_idx`` at the current position
        (``global_pose`` unless ``cur_xy``) against the history."""
        poses = np.stack([r.pose[:2, 2] for r in self.scan_history])
        cur = self.global_pose[:2, 2] if cur_xy is None else cur_xy
        return self._gate_candidates(poses, cur_idx, cur)

    def _gate_candidates(self, xy: np.ndarray, cur_idx: int, cur_xy=None):
        """Loop-closure candidate gates (reference slam.py:231-268) on an
        (n, 2) array whose row k is node k's position: node gap >=
        min_interval, distance from ``cur_xy`` (default: row cur_idx) <
        distance_threshold, travel since >= min_cumulative_travel.
        Returns [(node, dist)] nearest first, at most max_candidates."""
        cfg = self.cfg
        n = xy.shape[0]
        steps = np.linalg.norm(np.diff(xy, axis=0), axis=1)
        cum = np.concatenate([[0.0], np.cumsum(steps)])
        idx = np.arange(n)
        cur = xy[cur_idx] if cur_xy is None else cur_xy
        dist = np.linalg.norm(xy - cur, axis=1)
        travel = cum[min(cur_idx, n - 1)] - cum
        ok = (
            (cur_idx - idx >= cfg.lc_min_interval)
            & (dist < cfg.lc_distance)
            & (travel >= cfg.lc_min_travel)
        )
        cand = [(int(i), float(dist[i])) for i in idx[ok]]
        cand.sort(key=lambda x: x[1])
        return cand[: cfg.lc_max_candidates]

    @spans.spanned("map.replay")
    def _rebuild_map(self):
        """Replay every keyframe at its current pose (reference
        slam.py:271-277) into a new grid bound to ``mapper.log_odds``.
        Keyframes are padded to the scan capacity and K to icp_tpu's
        power-of-two bucket (padding keyframes are no-ops)."""
        K = len(self.scan_history)
        if K == 0:
            self.mapper.reset()
            return
        cap = self._cap
        Kb = 1 << max(6, (K - 1).bit_length())
        if self.cfg.num_scans:
            Kb = max(Kb, 1 << (int(self.cfg.num_scans) - 1).bit_length())
        origins = np.zeros((Kb, 2), np.float32)
        hits = np.zeros((Kb, cap, 2), np.float32)
        masks = np.zeros((Kb, cap), bool)
        for i, rec in enumerate(self.scan_history):
            origins[i] = rec.pose[:2, 2]
            hits[i], masks[i] = _pad_fixed(
                rec.points @ rec.pose[:2, :2].T + rec.pose[:2, 2], cap)
        self.mapper.replay(origins, hits, masks)

    @spans.spanned("engine.lc_verify")
    def _lc_verify_pairs(self, pairs):
        """Verify (source scan, candidate scan) registration pairs.

        ``pairs``: [(src_points, cand_points)] raw sensor-frame host
        arrays. Returns [(R, t, err, iters)] in pair order. Each pair is
        padded to the scan capacity and registered by the configured
        pre-alignment (``_prealign``: rotation search and/or feature
        alignment) + ICP, as one lane of icp_tpu's vmapped verifier
        computes it; verification is pose-independent, which is what lets
        the batched path verify a whole chunk before its arbitration. Pair
        k runs on the engine's device, or on the mesh's local shard k mod
        D, its inputs moved there; a lane's RANSAC uniforms are drawn from
        the engine's generator on the engine's device (``ransac_align``),
        so a mesh run draws what a one-device run draws. Pairs are queued
        one after another from this thread, so lanes on different cards run
        one after another; every result is read after the last pair is
        queued. The groups of L = next_pow2(max_candidates) pairs (padded
        to a mesh multiple) that icp_tpu dispatches are counted in
        ``stats.lc_groups``.
        """
        cfg = self.cfg
        cap = self._cap
        L = max(int(cfg.lc_max_candidates), 1)
        L = 1 << (L - 1).bit_length()
        lanes = [self.device]
        if self.mesh is not None:
            L = -(-L // self.mesh.size) * self.mesh.size
            lanes = self.mesh.devices
        self.stats.lc_groups += -(-len(pairs) // L)
        res = []
        spans.count("sync.engine.upload", 4 * len(pairs))
        for k, (src, cand) in enumerate(pairs):
            dev = lanes[k % len(lanes)]
            sp, sm, cp, cm = (torch.as_tensor(a, device=dev) for a in (
                *_pad_fixed(src, cap), *_pad_fixed(cand, cap)))
            R0, t0 = self._prealign(sp, sm, cp, cm)
            res.append(icp(
                sp, sm, cp, cm, R0, t0,
                voxel_size=cfg.icp_voxel,
                method=cfg.icp_method,
                max_iterations=int(cfg.icp_max_iterations),
                normal_k=int(cfg.icp_normal_k),
                error_threshold=cfg.icp_error_threshold,
                nn_impl=str(cfg.nn_impl),
            ))
        spans.count("sync.engine.lc_read", 4 * len(res))
        return [(r.R.cpu().numpy(), r.t.cpu().numpy(), float(r.error),
                 int(r.iters)) for r in res]

    def _lc_verify_batched(self, points: np.ndarray, candidates):
        """Verify all candidates [(hist_idx, dist)] of one node."""
        return self._lc_verify_pairs(
            [(points, self.scan_history[ci].points) for ci, _ in candidates]
        )

    def _lc_find(self, points: np.ndarray, cur_idx: int, cur_xy=None):
        """Cooldown, candidate gates and verification, without mutating the
        engine's state. Returns (cand_idx, cand_dist, r_lc, t_lc, err_lc)
        of the first candidate under the error threshold (the reference's
        accept-first rule, slam.py:575-597), else None."""
        cfg = self.cfg
        if (cfg.lc_cooldown > 0 and self._last_lc_accept is not None
                and cur_idx - self._last_lc_accept < cfg.lc_cooldown):
            return None
        with spans.span("engine.lc_gates"):
            candidates = self._find_loop_candidates(cur_idx, cur_xy)
        if not candidates:
            return None
        if self.verbose:
            print(f"  LC candidates for scan {cur_idx}: "
                  + ", ".join(f"#{ci}({cd:.1f}m)" for ci, cd in candidates))
        verdicts = self._lc_verify_batched(points, candidates)
        for k, (cand_idx, cand_dist) in enumerate(candidates):
            r_lc, t_lc, err_lc, it_lc = verdicts[k]
            self.stats.icp_iters += it_lc
            if self.verbose:
                mark = "ok" if err_lc < cfg.lc_error_threshold else "x"
                print(f"    LC scan {cur_idx}<->{cand_idx}: "
                      f"icp_err={err_lc:.6f}  {mark}")
            if err_lc < cfg.lc_error_threshold:
                return cand_idx, cand_dist, r_lc, t_lc, err_lc
        return None

    def _lc_apply(self, cur_idx, cand_idx, cand_dist, r_lc, t_lc, err_lc):
        """Accept a verified closure: add the edge, optimize the graph,
        rewrite history and trajectory, and mark the map dirty (reference
        slam.py:583-620; the replay waits for the next ``sync_map``)."""
        cfg = self.cfg
        # edge z = vec(T_lc^-1)   (reference slam.py:583-593)
        T_lc = np.eye(3, dtype=np.float32)
        T_lc[:2, :2] = r_lc
        T_lc[:2, 2] = t_lc
        z_lc = _relative_vec_np(T_lc, np.eye(3, dtype=np.float32))
        w = cfg.lc_info_scale / max(err_lc, 1e-6)
        if cfg.lc_info_cap > 0:
            # bound the weight of a near-perfect re-match (the reference's
            # scale / err is uncapped)
            w = min(w, cfg.lc_info_cap)
        lc_info = np.eye(3, dtype=np.float32) * w
        self.pose_graph.add_edge(cur_idx, cand_idx, z_lc, lc_info,
                                 robust=bool(cfg.lc_robust))
        self._last_lc_accept = cur_idx
        if self.verbose:
            print(f"  * Loop closure accepted: scan {cur_idx} <-> "
                  f"scan {cand_idx} (dist={cand_dist:.2f}m, "
                  f"icp_err={err_lc:.6f})")
        self.stats.loop_closures += 1
        self.pose_graph.optimize(n_iterations=cfg.lc_opt_iters, fix_node=0)
        corrected = self.pose_graph.get_poses_as_matrices()
        for k, rec in enumerate(self.scan_history):
            rec.pose = corrected[k]
        self.global_pose = corrected[len(self.scan_history) - 1].copy()
        self.pose_trajectory = [r.pose for r in self.scan_history[1:]]
        if cfg.submap_enabled:
            self.submap_buffer = [
                rec.points @ rec.pose[:2, :2].T + rec.pose[:2, 2]
                for rec in self.scan_history[-cfg.submap_size:]
            ]
        if self.mapper is not None:
            # registration never reads the grid, and the replay repaints
            # every keyframe over a zeroed grid, so replaying at the next
            # read gives the map a replay per closure would
            if self.verbose:
                print("  Map rebuild deferred to next read ...")
            self._map_dirty = True

    def _try_loop_closure(self, points: np.ndarray, cur_idx: int,
                          cur_xy=None) -> bool:
        """Per-scan arbitration: find and verify, then apply on accept."""
        found = self._lc_find(points, cur_idx, cur_xy)
        if found is None:
            return False
        with spans.span("engine.lc_apply"):
            self._lc_apply(cur_idx, *found)
        return True

    def _resync_state_after_lc(self, points_2d: np.ndarray):
        """Rebuild the fused state from the corrected history: the ring from
        the last submap_size keyframes at their new poses, prev from
        ``points_2d``. The grid stays the live one (its replay is
        deferred), the RANSAC stream goes on, and the features cache is
        invalidated (the next step extracts prev's features afresh)."""
        cfg = self.cfg
        K = max(int(cfg.submap_size), 1)
        cap = self._cap
        ring_pts = np.zeros((K, cap, 2), np.float32)
        ring_mask = np.zeros((K, cap), bool)
        recent = self.scan_history[-K:]
        for i, rec in enumerate(recent):
            ring_pts[i], ring_mask[i] = _pad_fixed(
                rec.points @ rec.pose[:2, :2].T + rec.pose[:2, 2], cap)
        sp, sm = self._to_device(*_pad_fixed(points_2d, cap))
        rp, rm, gpose = self._to_device(ring_pts, ring_mask,
                                        self.global_pose.astype(np.float32))
        feat, feat_valid = blank_feat_state(cap, self._feat_shapes,
                                            self.device)
        self._state = SlamState(
            prev_pts=sp, prev_mask=sm, global_pose=gpose,
            ring_pts=rp, ring_mask=rm,
            ring_idx=self._upload_scalar(len(recent), torch.int32),
            log_odds=self._state.log_odds,
            feat=feat, feat_valid=feat_valid, gen=self._state.gen,
        )

    # ── fused path (models/slam_step.py) ─────────────────────────────────
    def _build_fused(self, first_points: np.ndarray):
        cfg = self.cfg
        m = self.mapper
        self._step_fn, self._batch_fn = make_slam_step(
            use_imu=self.imu is not None,
            prealign=cfg.alignment_method,
            icp_method=cfg.icp_method,
            icp_voxel=float(cfg.icp_voxel),
            icp_max_iterations=int(cfg.icp_max_iterations),
            icp_normal_k=int(cfg.icp_normal_k),
            icp_error_threshold=float(cfg.icp_error_threshold),
            error_reject_threshold=float(cfg.error_reject_threshold),
            rotation_voxel_size=float(cfg.rotation_voxel_size),
            angle_step_coarse=float(cfg.angle_step_coarse),
            angle_step_fine=float(cfg.angle_step_fine),
            feat_voxel=float(cfg.feat_voxel),
            k_curvature=int(cfg.k_curvature),
            top_n=int(cfg.top_n),
            min_kp_dist=float(cfg.min_kp_dist),
            k_descriptor=int(cfg.k_descriptor),
            ratio_threshold=float(cfg.ratio_threshold),
            ransac_iterations=int(cfg.ransac_iterations),
            inlier_threshold=float(cfg.inlier_threshold),
            min_inliers=int(cfg.min_inliers),
            submap_enabled=bool(cfg.submap_enabled),
            submap_voxel=float(cfg.submap_voxel),
            submap_capacity=int(cfg.submap_capacity),
            sub_rot_range=float(cfg.sub_rot_range),
            sub_rot_step=float(cfg.sub_rot_step),
            sub_rot_fine=float(cfg.sub_rot_fine),
            sub_rot_voxel=float(cfg.sub_rot_voxel),
            sub_corr_dist=float(cfg.sub_corr_dist),
            imu_narrow=float(cfg.imu_narrow),
            sweep_src_cap=int(self._sweep_caps[0]),
            sweep_tgt_cap=int(self._sweep_caps[1]),
            grid_min_x=m.min_x, grid_min_y=m.min_y,
            grid_resolution=m.resolution,
            l_hit=m.l_hit, l_miss=m.l_miss,
            log_odds_min=m.log_odds_min, log_odds_max=m.log_odds_max,
            max_ray_cells=m.max_ray_cells,
            batched_map=bool(cfg.batched_map) and cfg.batch_scans > 1,
            nn_impl=str(cfg.nn_impl),
        )
        sp, sm = self._to_device(*_pad_fixed(first_points, self._cap))
        # the state aliases the mapper's grid: paints land in mapper.log_odds
        self._state = init_state(sp, sm, m.log_odds,
                                 max(int(cfg.submap_size), 1),
                                 seed=int(cfg.ransac_iterations),
                                 feat_shapes=self._feat_shapes)

    def _to_device(self, *arrays):
        spans.count("sync.engine.upload", len(arrays))
        return tuple(torch.as_tensor(a, device=self.device) for a in arrays)

    def _upload_scalar(self, value, dtype):
        spans.count("sync.engine.upload")
        return torch.tensor(value, dtype=dtype, device=self.device)

    def sync_map(self):
        """Bring the mapper up to date (for export).

        The fused state paints its grid in place and the mapper aliases it,
        and the modular path paints the mapper itself, so without a closure
        this copies nothing. If a closure marked the map dirty, the history
        is replayed at the corrected poses into a new grid first (the
        reference's rebuild, slam.py:271-277, deferred to this read), and
        the fused state takes that grid, so later paints continue from it.
        The modular path replays too: icp_tpu's ``sync_map`` returns
        before its dirty check there (``_state`` is None), so its modular
        map keeps the paints at the pre-closure poses."""
        if self.mapper is None:
            return
        if self._map_dirty:
            self._rebuild_map()
            self._map_dirty = False
            if self._state is not None:
                self._state = self._state._replace(
                    log_odds=self.mapper.log_odds)
        elif self._state is not None:
            self.mapper.log_odds = self._state.log_odds

    def maybe_snapshot(self):
        """Live map (reference slam.py:416-452,622-639): an interactive
        matplotlib window when a display is available, otherwise periodic
        PNG snapshots ``map_NNNNN.png`` in ``cfg.snapshot_dir``. Both refresh
        once each time the processed-scan count passes a multiple of
        ``cfg.snapshot_every``: reading the map pulls the grid from the
        device, so refreshing every scan would serialise the batched
        stepping. Stepping one scan at a time that is icp_tpu's
        ``scans % snapshot_every == 0``; batched, the count moves a batch
        at a time, and the refresh comes with the batch that passes the
        multiple (icp_tpu refreshes only where a batch ends on one, and
        then once per submitted scan). Returns the PNG's path where one
        was written."""
        cfg = self.cfg
        if not cfg.live_map or self.mapper is None:
            return None
        every = max(int(cfg.snapshot_every), 1)
        if self.stats.scans // every <= self._snapshot_scans // every:
            return None
        self._snapshot_scans = self.stats.scans
        self.sync_map()
        traj = np.array([[p[0, 2], p[1, 2]] for p in self.pose_trajectory])

        from icp_tpu_torch.utils.liveview import LiveMapView
        if not self._live_view_failed and (
            self._live_view is not None or LiveMapView.available()
        ):
            try:
                if self._live_view is None:
                    self._live_view = LiveMapView(
                        self.mapper,
                        window_width=cfg.window_width,
                        window_height=cfg.window_height,
                        cmap=cfg.cmap, clim_min=cfg.clim_min,
                        clim_max=cfg.clim_max, background=cfg.background,
                        trajectory_color=cfg.trajectory_color,
                        pose_color=cfg.pose_color, pose_size=cfg.pose_size,
                    )
                self._live_view.update(traj)
                return None
            except Exception:
                # window died (user closed it / backend error): fall back
                self._live_view = None
                self._live_view_failed = True

        os.makedirs(cfg.snapshot_dir, exist_ok=True)
        path = os.path.join(cfg.snapshot_dir,
                            f"map_{self.stats.scans:05d}.png")
        self.mapper.save_png(path, trajectory=traj)
        return path

    def _bookkeep_fused(self, points_2d, out_pose, out_error, out_accepted,
                        out_sub, out_err_inc, out_iters) -> bool:
        """Host bookkeeping for one fused-step result; returns accepted."""
        self.stats.scans += 1
        self.stats.icp_iters += int(out_iters)
        if not out_accepted:
            if self.verbose:
                print(f"Scan {self.stats.scans}: S2S error "
                      f"{out_err_inc:.6f} too high, skipping")
            self.stats.rejected += 1
            return False
        self.global_pose = out_pose
        if out_sub:
            self.stats.submap_corrections += 1
        self.pose_trajectory.append(self.global_pose.copy())
        cur_idx = self.pose_graph.add_node(pose_to_vec_np(self.global_pose))
        z_odom = _relative_vec_np(self.scan_history[cur_idx - 1].pose,
                                  self.global_pose)
        self.pose_graph.add_edge(
            cur_idx - 1, cur_idx, z_odom,
            np.eye(3, dtype=np.float32) / max(out_error, 1e-6),
        )
        self.scan_history.append(
            ScanRecord(points_2d.copy(), self.global_pose.copy(),
                       scan_idx=self.stats.scans)
        )
        if self.verbose:
            pos = self.global_pose[:2, 2]
            yaw = np.degrees(np.arctan2(self.global_pose[1, 0],
                                        self.global_pose[0, 0]))
            print(f"Scan {self.stats.scans:4d}  err={out_error:.6f}  "
                  f"pos=({pos[0]:+.3f}, {pos[1]:+.3f})  yaw={yaw:+.2f} deg")
        return True

    def _verify_chunk(self, scans: list, poses, acc: list) -> dict:
        """Candidate gates and verification of a chunk's accepted scans, at
        the positions the chunk's results give them, before any of them is
        bookkept. Returns {chunk pos j: (node idx, candidates, verdicts)}
        for the scans with candidates."""
        cfg = self.cfg
        t2 = time.perf_counter()
        verdicts_by_j: dict[int, tuple] = {}
        n_hist = len(self.scan_history)
        with spans.span("engine.lc_gates"):
            hist_xy = (
                np.stack([r.pose[:2, 2] for r in self.scan_history])
                if n_hist else np.zeros((0, 2), np.float32)
            )
            chunk_nodes = []           # (chunk pos j, node idx, position)
            k = n_hist
            for j in range(len(scans)):
                if not acc[j]:
                    continue
                chunk_nodes.append(
                    (j, k, np.asarray(poses[j][:2, 2], np.float32))
                )
                k += 1
            jobs = []                  # (j, node_idx, candidates)
            if chunk_nodes:
                all_xy = np.concatenate(
                    [hist_xy] + [xy[None] for _, _, xy in chunk_nodes]
                )
                for j, ni, _ in chunk_nodes:
                    if ni < cfg.lc_min_interval:
                        continue
                    if (cfg.lc_cooldown > 0
                            and self._last_lc_accept is not None
                            and ni - self._last_lc_accept < cfg.lc_cooldown):
                        # in-chunk accepts roll back, so the pre-chunk
                        # accept is the cooldown reference of every node
                        continue
                    cands = self._gate_candidates(all_xy[: ni + 1], ni)
                    if cands:
                        jobs.append((j, ni, cands))
        if jobs:
            pts_of = {ni: scans[j] for j, ni, _ in chunk_nodes}

            def node_points(ci):
                return (self.scan_history[ci].points if ci < n_hist
                        else pts_of[ci])
            pairs = [
                (scans[j], node_points(ci))
                for j, ni, cands in jobs
                for ci, _ in cands
            ]
            self.stats.lc_checks += len(jobs)
            self.stats.lc_pairs += len(pairs)
            verd = self._lc_verify_pairs(pairs)
            off = 0
            for j, ni, cands in jobs:
                verdicts_by_j[j] = (ni, cands, verd[off:off + len(cands)])
                off += len(cands)
        self.stats.wall_loop_closure += time.perf_counter() - t2
        return verdicts_by_j

    def _bookkeep_chunk(self, scans: list, rel_times: list, outs_dev):
        """Read one chunk's results and bookkeep its scans in order, each
        through ``_bookkeep_fused``. Under loop closure the candidate gates
        and the verification of the whole chunk run first; then each
        accepted scan is arbitrated as the reference does (slam.py:565-620),
        and the first verdict under the error threshold is applied
        (``_lc_apply``), the fused state resynced from the corrected history
        and the bookkeeping stopped there. Returns (n_accepted, j): j is the
        chunk position of the accepted closure, whose later scans were
        registered against the state before it and are not bookkept, or
        None.

        Exact as icp_tpu's: before an accept inside the chunk no
        optimization has run, so the gates (pure functions of the node
        positions, all in the chunk's output) see what the reference sees;
        verification registers raw scans, so verdicts can be computed up
        front, and an accept discards every later verdict.
        """
        cfg = self.cfg
        outs = self._fetch(outs_dev)
        self._check_sub_saturation(outs.sub_n)
        self._check_sweep_drop(outs.sweep_drop)
        n = len(scans)
        acc = [bool(outs.accepted[j]) for j in range(n)]

        verdicts_by_j = (self._verify_chunk(scans, outs.pose, acc)
                         if cfg.lc_enabled else {})

        # ── bookkeeping + the reference's per-scan arbitration ───────────
        n_ok = 0
        hit = None
        with spans.span("engine.bookkeep"):
            for j in range(n):
                ok = self._bookkeep_fused(
                    scans[j],
                    np.asarray(outs.pose[j]), float(outs.error[j]),
                    acc[j], bool(outs.sub_applied[j]),
                    float(outs.err_inc[j]), int(outs.iters[j]),
                )
                self.prev_points = scans[j]
                self.prev_rel_time = rel_times[j]
                n_ok += bool(ok)
                if not ok or j not in verdicts_by_j:
                    continue
                ni, cands, verds = verdicts_by_j[j]
                t2 = time.perf_counter()
                if self.verbose:
                    print(f"  LC candidates for scan {ni}: "
                          + ", ".join(f"#{ci}({cd:.1f}m)"
                                      for ci, cd in cands))
                for kk, (ci, cd) in enumerate(cands):
                    r_lc, t_lc, err_lc, it_lc = verds[kk]
                    self.stats.icp_iters += it_lc
                    if self.verbose:
                        mark = ("ok" if err_lc < cfg.lc_error_threshold
                                else "x")
                        print(f"    LC scan {ni}<->{ci}: "
                              f"icp_err={err_lc:.6f}  {mark}")
                    if err_lc < cfg.lc_error_threshold:
                        hit = (ci, cd, r_lc, t_lc, err_lc)
                        break
                if hit is not None:
                    break
                self.stats.wall_loop_closure += time.perf_counter() - t2
        if hit is None:
            return n_ok, None
        with spans.span("engine.lc_apply"):
            self._lc_apply(ni, *hit)
            self._resync_state_after_lc(scans[j])
        self.stats.wall_loop_closure += time.perf_counter() - t2
        return n_ok, j

    @staticmethod
    @spans.spanned("engine.fetch")
    def _fetch(outs_dev):
        """A step's or a batch's results read to the host, one copy a
        field."""
        spans.count("sync.engine.fetch", len(outs_dev))
        return type(outs_dev)(*(f.cpu().numpy() for f in outs_dev))

    def process_scans_batched(self, scans: list, rel_times: list) -> int:
        """Fused batch path: the scans join the backlog and run through the
        chunk loop (``_run_backlog``), each chunk read and bookkept before
        the call returns. Without loop closure the scans of one call run as
        one batch; under loop closure chunks of ``batch_scans`` are taken
        from the backlog, and a shorter remainder waits for the next call
        or ``finish()``. Before the first scan and on the modular path the
        scans go through ``process_scan`` one by one. Returns the number of
        accepted scans bookkept by this call."""
        if self._state is None:
            return sum(bool(self.process_scan(p, r))
                       for p, r in zip(scans, rel_times))
        self._backlog.extend(zip(scans, rel_times))
        return self._run_backlog(flush=False)

    def finish(self):
        """Run and bookkeep the scans left in the backlog, a last chunk
        shorter than ``batch_scans`` included (call after the last batch).
        Returns the number of accepted scans it bookkept."""
        return self._run_backlog(flush=True)

    def _run_backlog(self, flush: bool) -> int:
        """The chunk loop: take a chunk from the front of the backlog (all
        of it without loop closure; ``batch_scans`` scans, or fewer only
        when ``flush``, under loop closure), dispatch it, then read and
        bookkeep it. An accepted closure at chunk position j puts the
        chunk's scans after j back at the front of the backlog, to run again
        against the corrected state at the head of the next chunk: the
        chunks take the scans icp_tpu's take, where the chunk it keeps in
        flight is re-queued too. A stale chunk may have painted the grid,
        but every accept marks the map dirty, so the next read replays the
        history over a zeroed grid."""
        lc = bool(self.cfg.lc_enabled)
        B = int(self.cfg.batch_scans) if lc else len(self._backlog)
        accepted = 0
        while self._backlog and (flush or len(self._backlog) >= B):
            chunk = self._backlog[:B]
            del self._backlog[:B]
            scans = [p for p, _ in chunk]
            rels = [r for _, r in chunk]
            outs = self._dispatch_chunk_async(scans, rels)
            t0 = time.perf_counter()
            n_ok, j = self._bookkeep_chunk(scans, rels, outs)
            if not lc:
                # registration's wall takes the read and the bookkeeping
                # where no loop-closure wall does
                self.stats.wall_registration += time.perf_counter() - t0
            accepted += n_ok
            if j is not None:
                self.stats.lc_requeued_scans += len(chunk) - j - 1
                self._backlog[:0] = chunk[j + 1:]
        return accepted

    def _pack_batch(self, scans: list, rel_times: list, prev_rel):
        """Pack B scans + their IMU lookups into fixed-shape host arrays
        (each scan padded to the scan capacity, padding masked out), plus
        which scans are degenerate (fewer than 10 valid points)."""
        B = len(scans)
        cap = self._cap
        pts = np.zeros((B, cap, 2), np.float32)
        msk = np.zeros((B, cap), bool)
        deltas = np.zeros(B, np.float32)
        yaws = np.zeros(B, np.float32)
        degenerate = []
        for i, p in enumerate(scans):
            self._check_ray_bound(p)
            n = min(p.shape[0], cap)
            pts[i, :n] = p[:n]
            if n > 0:
                pts[i, n:] = p[0]
            msk[i, :n] = True
            degenerate.append(n < 10)
        if self.imu is not None and all(r is not None for r in rel_times):
            # one vectorised IMU lookup for the batch: absolute yaws
            # (calibration-offset wrapped, slam.py:456-459) and scan-to-scan
            # deltas chained off prev_rel (slam.py:461-463)
            rels = np.asarray(rel_times, np.int64)
            raw = self.imu.yaws_at(rels)
            yaws[:len(scans)] = ((raw - self.imu_yaw_offset + np.pi)
                                 % (2 * np.pi) - np.pi)
            prevs = np.empty_like(rels)
            prevs[1:] = rels[:-1]
            prevs[0] = prev_rel if prev_rel is not None else rels[0]
            d = self.imu.delta_yaws(prevs, rels)
            if prev_rel is None:
                d[0] = 0.0
            deltas[:len(scans)] = d
        return (pts, msk, deltas, yaws), degenerate

    def _dispatch_chunk_async(self, scans: list, rel_times: list):
        """Pack, upload and run one fused batch; its results stay on the
        device until ``_bookkeep_chunk`` reads them. IMU deltas chain off
        the last bookkept scan (``prev_rel_time``). (icp_tpu pads a
        loop-closure chunk to B scans to reuse one compiled program;
        padding scans are no-ops, so the port runs the chunk as it is.)"""
        with spans.span("engine.pack"):
            arrays, degenerate = self._pack_batch(scans, rel_times,
                                                  self.prev_rel_time)
            t0 = time.perf_counter()
            arrays = self._to_device(*arrays)
        self._state, outs = self._batch_fn(self._state, *arrays,
                                           degenerate=degenerate)
        self.stats.wall_registration += time.perf_counter() - t0
        return outs

    def warmup(self):
        """Run every device path of the run once, so allocator and kernel
        build costs land before a timed run. Call after the first scan.

        The batch runs on all-masked padding scans (exact no-ops under the
        degenerate gate). With loop closure, as in icp_tpu: scan 0 is
        verified against itself (result discarded, one group counted), the
        map is replayed into the mapper, the graph's capacity is reserved
        for ``num_scans`` and the graph is optimized once (the odometry
        chain is consistent, so this moves nodes by rounding only); the
        closing ``sync_map`` then points the mapper back at the fused
        state's grid, as icp_tpu's does."""
        if self._state is None or not self.scan_history:
            return
        B, cap = self.cfg.batch_scans, self._cap
        z = torch.zeros((B, cap, 2), dtype=torch.float32, device=self.device)
        m = torch.zeros((B, cap), dtype=torch.bool, device=self.device)
        d = torch.zeros(B, dtype=torch.float32, device=self.device)
        self._state, _ = self._batch_fn(self._state, z, m, d, d,
                                        degenerate=[True] * B)
        if self.cfg.lc_enabled:
            self._lc_verify_batched(self.scan_history[0].points, [(0, 0.0)])
            if self.mapper is not None:
                self._rebuild_map()
            if self.cfg.num_scans:
                self.pose_graph.reserve(int(self.cfg.num_scans) + 1)
            if self.pose_graph.n_edges:
                self.pose_graph.optimize(n_iterations=self.cfg.lc_opt_iters,
                                         fix_node=0)
        self.sync_map()

    def _check_sub_saturation(self, sub_n) -> None:
        """Warn (once) when the submap voxel capacity saturates: the merged
        submap may then be truncated; raise tpu.submap_capacity."""
        if self._sub_sat_warned:
            return
        if int(np.max(sub_n)) >= self._sub_cap > 0:
            self._sub_sat_warned = True
            print(f"  [warn] submap voxel capacity saturated "
                  f"({self._sub_cap}); raise tpu.submap_capacity to avoid "
                  f"truncating the submap")

    def _check_sweep_drop(self, dropped) -> None:
        """Count (and warn once about) coarse-sweep voxels dropped by the
        static sweep caps (the following ICP still sees the full submap)."""
        d = int(np.sum(np.asarray(dropped)))
        if d <= 0:
            return
        self.stats.sweep_dropped_voxels += d
        if not self._sweep_drop_warned:
            self._sweep_drop_warned = True
            print(f"  [warn] submap sweep dropped {d} coarse voxels "
                  f"(tpu.sweep_src_capacity/sweep_tgt_capacity too small); "
                  f"counted in stats.sweep_dropped_voxels")

    def _process_scan_fused(self, points_2d, rel_time_us, imu_yaw,
                            imu_delta) -> bool:
        t0 = time.perf_counter()
        with spans.span("engine.pack"):
            sp, sm = self._to_device(*_pad_fixed(points_2d, self._cap))
            f32 = torch.float32
            delta = self._upload_scalar(
                imu_delta if imu_delta is not None else 0.0, f32)
            yaw = self._upload_scalar(
                imu_yaw if imu_yaw is not None else 0.0, f32)
        self._state, out = self._step_fn(
            self._state, sp, sm, delta, yaw,
            degenerate=min(points_2d.shape[0], self._cap) < 10,
        )
        out = self._fetch(out)             # one read per scan
        self._check_sub_saturation(out.sub_n)
        self._check_sweep_drop(out.sweep_drop)
        self.stats.wall_registration += time.perf_counter() - t0

        self.prev_points = points_2d
        self.prev_rel_time = rel_time_us
        with spans.span("engine.bookkeep"):
            ok = self._bookkeep_fused(
                points_2d, np.asarray(out.pose), float(out.error),
                bool(out.accepted), bool(out.sub_applied),
                float(out.err_inc), int(out.iters),
            )
        if not ok:
            return False

        cur_idx = self.pose_graph.n_nodes - 1
        if self.cfg.lc_enabled and cur_idx >= self.cfg.lc_min_interval:
            t2 = time.perf_counter()
            if self._try_loop_closure(points_2d, cur_idx):
                with spans.span("engine.lc_apply"):
                    self._resync_state_after_lc(points_2d)
            self.stats.wall_loop_closure += time.perf_counter() - t2
        return True

    @property
    def pose_scan_indices(self) -> np.ndarray:
        """0-based input-stream index of each pose in ``pose_trajectory``
        (rejected scans leave gaps); pass to ``utils.metrics.ate(...,
        indices=...)``."""
        return np.array([r.scan_idx for r in self.scan_history[1:]],
                        dtype=np.int64)

    # ── checkpoint / resume ──────────────────────────────────────────────
    def save_checkpoint(self, path: str):
        """Persist the SLAM state (poses, scans, graph with its robust
        flags, grid, counters, cooldown) to one npz with icp_tpu's keys."""
        self.finish()
        self.sync_map()
        n = len(self.scan_history)
        pg = self.pose_graph
        pts = [r.points for r in self.scan_history]
        np.savez_compressed(
            path,
            global_pose=self.global_pose,
            poses=np.stack([r.pose for r in self.scan_history])
            if n else np.zeros((0, 3, 3), np.float32),
            scan_lens=np.array([len(p) for p in pts], np.int64),
            scan_points=(np.concatenate(pts) if n
                         else np.zeros((0, 2), np.float32)),
            scan_indices=np.array([r.scan_idx for r in self.scan_history],
                                  np.int64),
            log_odds=(self.mapper.log_odds.cpu().numpy()
                      if self.mapper is not None else np.zeros((0, 0))),
            grid_meta=np.array(
                [self.mapper.min_x, self.mapper.max_x, self.mapper.min_y,
                 self.mapper.max_y, self.mapper.resolution]
                if self.mapper is not None else [0, 0, 0, 0, 0.1]),
            pg_nodes=np.stack(pg.nodes) if pg.n_nodes
            else np.zeros((0, 3), np.float32),
            pg_ei=np.array(pg._edges_i, np.int32),
            pg_ej=np.array(pg._edges_j, np.int32),
            pg_z=np.stack(pg._edges_z) if pg.n_edges
            else np.zeros((0, 3), np.float32),
            pg_om=np.stack(pg._edges_om) if pg.n_edges
            else np.zeros((0, 3, 3), np.float32),
            pg_rb=np.array(pg._edges_rb, bool),
            prev_rel_time=np.array(
                [self.prev_rel_time if self.prev_rel_time is not None else -1]),
            imu_yaw_offset=np.array([self.imu_yaw_offset]),
            # explicit counters (a run may end on rejections) and the
            # cooldown state (else a resume re-closes a just-closed loop)
            stats_scans=np.array([self.stats.scans], np.int64),
            stats_rejected=np.array([self.stats.rejected], np.int64),
            last_lc_accept=np.array(
                [self._last_lc_accept if self._last_lc_accept is not None
                 else -1], np.int64),
        )

    def load_checkpoint(self, path: str):
        """Restore a state saved by ``save_checkpoint`` (of either package)
        and rebuild the fused state (``tpu.fused: true``); streaming resumes
        after it. As in icp_tpu, the modular path's ``submap_buffer``
        starts empty after a resume and refills with the scans that
        follow."""
        cfg = self.cfg
        d = np.load(path)
        self.global_pose = d["global_pose"].astype(np.float32)
        lens = d["scan_lens"]
        flat = d["scan_points"]
        poses = d["poses"]
        idxs = (d["scan_indices"] if "scan_indices" in d
                else np.arange(len(lens)))
        self.scan_history = []
        off = 0
        for i, ln in enumerate(lens):
            self.scan_history.append(
                ScanRecord(flat[off:off + ln].astype(np.float32),
                           poses[i].astype(np.float32),
                           scan_idx=int(idxs[i])))
            off += ln
        self.pose_trajectory = [r.pose for r in self.scan_history[1:]]
        if "stats_scans" in d:
            self.stats.scans = int(d["stats_scans"][0])
            self.stats.rejected = int(d["stats_rejected"][0])
        else:
            # older checkpoints: infer from the last accepted scan's index
            self.stats.scans = int(idxs[-1]) if len(idxs) else 0
        if "last_lc_accept" in d:
            lla = int(d["last_lc_accept"][0])
            self._last_lc_accept = None if lla < 0 else lla
        first = (self.scan_history[0].points if self.scan_history
                 else np.ones((1, 2), np.float32))
        gm = d["grid_meta"]
        if d["log_odds"].size:
            if self._ray_bound is None:
                self._ray_bound = self._resolve_ray_bound(first)
            self._free_cap = self._resolve_free_cap(first, self._ray_bound)
            self.mapper = OccupancyGrid2D(
                gm[0], gm[1], gm[2], gm[3], resolution=gm[4],
                p_hit=cfg.p_hit, p_miss=cfg.p_miss,
                log_odds_min=cfg.log_odds_min, log_odds_max=cfg.log_odds_max,
                max_ray_cells=self._ray_bound, device=self.device,
            )
            self.mapper.log_odds = torch.as_tensor(
                d["log_odds"], dtype=torch.float32, device=self.device)
        self.pose_graph = PoseGraph2D(self.device)
        self.pose_graph.robust_phi = float(cfg.lc_robust_phi)
        if self.mesh is not None:
            self.pose_graph.set_mesh(self.mesh, cfg.dist_node_threshold)
        for v in d["pg_nodes"]:
            self.pose_graph.add_node(v)
        rbs = (d["pg_rb"] if "pg_rb" in d
               else np.zeros(len(d["pg_ei"]), bool))
        for i, j, z, om, rb in zip(d["pg_ei"], d["pg_ej"], d["pg_z"],
                                   d["pg_om"], rbs):
            self.pose_graph.add_edge(int(i), int(j), z, om, robust=bool(rb))
        prt = float(d["prev_rel_time"][0])
        self.prev_rel_time = None if prt < 0 else prt
        self.imu_yaw_offset = float(d["imu_yaw_offset"][0])
        if self.scan_history:
            self.prev_points = self.scan_history[-1].points
            if self._sweep_caps is None:
                self._resolve_sweep_caps(self.scan_history[0].points)
            if self.cfg.fused and self.mapper is not None:
                self._build_fused(self.scan_history[0].points)
                self._resync_state_after_lc(self.prev_points)

    # ── per-scan state machine ───────────────────────────────────────────
    def process_scan(self, points_2d: np.ndarray, rel_time_us=None) -> bool:
        """Process one z-filtered 2D scan. Returns True if it advanced the
        trajectory (False for init/skip/reject)."""
        cfg = self.cfg
        if points_2d.shape[0] < 10:        # degenerate (slam.py:384-385)
            if self.prev_points is not None:
                # consume the stream slot as the fused degenerate gate does
                self.stats.scans += 1
                self.stats.rejected += 1
            return False

        # first scan initialisation (slam.py:388-453)
        if self.prev_points is None:
            self.prev_points = points_2d
            self.prev_rel_time = rel_time_us
            if self.imu is not None and rel_time_us is not None:
                self.imu_yaw_offset = self.imu.yaw_at(rel_time_us)
                if self.verbose:
                    print(f"  [IMU] Calibrated initial yaw offset: "
                          f"{np.degrees(self.imu_yaw_offset):.1f} deg")
            bounds = compute_bounds_from_scan(points_2d, cfg.map_margin)
            self._ray_bound = self._resolve_ray_bound(points_2d)
            self._free_cap = self._resolve_free_cap(points_2d, self._ray_bound)
            self._resolve_sweep_caps(points_2d)
            self.mapper = OccupancyGrid2D(
                *bounds,
                resolution=cfg.map_resolution,
                p_hit=cfg.p_hit, p_miss=cfg.p_miss,
                log_odds_min=cfg.log_odds_min,
                log_odds_max=cfg.log_odds_max,
                max_ray_cells=self._ray_bound,
                device=self.device,
            )
            gp = points_2d @ self.global_pose[:2, :2].T + self.global_pose[:2, 2]
            self.mapper.update_scan(self.global_pose[:2, 2], gp)
            if cfg.submap_enabled:
                self.submap_buffer.append(gp.copy())
            self.scan_history.append(
                ScanRecord(points_2d.copy(), self.global_pose.copy(),
                           scan_idx=0)
            )
            self.pose_graph.add_node(pose_to_vec_np(self.global_pose))
            if cfg.fused:
                self._build_fused(points_2d)
            return False

        # IMU yaw for this scan (slam.py:455-463)
        imu_yaw = None
        imu_delta = None
        if self.imu is not None and rel_time_us is not None:
            raw_yaw = self.imu.yaw_at(rel_time_us)
            imu_yaw = (raw_yaw - self.imu_yaw_offset + np.pi) % (2 * np.pi) - np.pi
            if self.prev_rel_time is not None:
                imu_delta = self.imu.delta_yaw(self.prev_rel_time, rel_time_us)

        self._check_ray_bound(points_2d)
        if self._state is not None:
            return self._process_scan_fused(points_2d, rel_time_us, imu_yaw,
                                            imu_delta)
        return self._process_scan_modular(points_2d, rel_time_us, imu_yaw,
                                          imu_delta)

    def _process_scan_modular(self, points_2d, rel_time_us, imu_yaw,
                              imu_delta) -> bool:
        """One scan through the modular path (reference slam.py:465-620):
        odometry ICP, rejection gate, submap correction with its agreement
        gates, pose-graph node and edge, map paint, submap push, loop
        closure."""
        cfg = self.cfg
        # step 1: scan-to-scan odometry (slam.py:465-483)
        t0 = time.perf_counter()
        if imu_delta is not None:
            c, s = np.cos(imu_delta), np.sin(imu_delta)
            sp, sm, tp, tm, R0 = self._to_device(
                *_pad_fixed(self.prev_points, self._cap),
                *_pad_fixed(points_2d, self._cap),
                np.array([[c, -s], [s, c]], np.float32))
            res = icp(
                sp, sm, tp, tm, R0,
                torch.zeros(2, dtype=torch.float32, device=self.device),
                voxel_size=cfg.icp_voxel,
                method=cfg.icp_method,
                max_iterations=int(cfg.icp_max_iterations),
                normal_k=int(cfg.icp_normal_k),
                error_threshold=cfg.icp_error_threshold,
            )
            self.stats.icp_iters += int(res.iters)
            r_inc, t_inc, err_inc = (res.R.cpu().numpy(), res.t.cpu().numpy(),
                                     float(res.error))
        else:
            r_inc, t_inc, err_inc = self._run_icp_pair(self.prev_points,
                                                       points_2d)

        if err_inc > cfg.error_reject_threshold:     # (slam.py:485-490)
            if self.verbose:
                print(f"Scan {self.stats.scans}: S2S error {err_inc:.6f} "
                      f"too high, skipping")
            self.prev_points = points_2d
            self.prev_rel_time = rel_time_us
            self.stats.scans += 1
            self.stats.rejected += 1
            return False

        T_inv = np.eye(3, dtype=np.float32)
        T_inv[:2, :2] = r_inc.T
        T_inv[:2, 2] = -r_inc.T @ t_inc
        self.global_pose = (self.global_pose @ T_inv).astype(np.float32)
        error = err_inc

        # step 2: submap drift correction (slam.py:497-536)
        if cfg.submap_enabled and self.submap_buffer:
            r_sub, t_sub, err_sub = self._attempt_submap_icp(
                points_2d, self.global_pose.copy(), imu_yaw)
            if err_sub <= cfg.error_reject_threshold:
                pos_diff = float(np.linalg.norm(t_sub - self.global_pose[:2, 2]))
                sub_yaw = np.arctan2(r_sub[1, 0], r_sub[0, 0])
                inc_yaw = np.arctan2(self.global_pose[1, 0],
                                     self.global_pose[0, 0])
                yaw_diff = abs((sub_yaw - inc_yaw + np.pi) % (2 * np.pi)
                               - np.pi)
                if pos_diff < cfg.sub_corr_dist and yaw_diff < np.deg2rad(15.0):
                    submap_pose = np.eye(3, dtype=np.float32)
                    submap_pose[:2, :2] = r_sub
                    submap_pose[:2, 2] = t_sub
                    self.global_pose = submap_pose
                    error = err_sub
                    self.stats.submap_corrections += 1
                    if self.verbose:
                        print(f"  Submap correction applied "
                              f"(dpos={pos_diff:.3f}m, "
                              f"dyaw={np.degrees(yaw_diff):.1f} deg)")
        self.stats.wall_registration += time.perf_counter() - t0

        self.pose_trajectory.append(self.global_pose.copy())
        # pose-graph node + odometry edge (slam.py:542-549)
        cur_idx = self.pose_graph.add_node(pose_to_vec_np(self.global_pose))
        z_odom = _relative_vec_np(self.scan_history[cur_idx - 1].pose,
                                  self.global_pose)
        self.pose_graph.add_edge(cur_idx - 1, cur_idx, z_odom,
                                 np.eye(3, dtype=np.float32) / max(error, 1e-6))

        # map + history + submap push (slam.py:551-562)
        t1 = time.perf_counter()
        gp = points_2d @ self.global_pose[:2, :2].T + self.global_pose[:2, 2]
        self.scan_history.append(
            ScanRecord(points_2d.copy(), self.global_pose.copy(),
                       scan_idx=self.stats.scans + 1))
        if self.mapper is not None:
            self.mapper.update_scan(self.global_pose[:2, 2], gp)
        if cfg.submap_enabled:
            self.submap_buffer.append(gp.copy())
            if len(self.submap_buffer) > cfg.submap_size:
                self.submap_buffer.pop(0)
        self.stats.wall_mapping += time.perf_counter() - t1

        # loop closure (slam.py:564-620)
        if cfg.lc_enabled and cur_idx >= cfg.lc_min_interval:
            t2 = time.perf_counter()
            self._try_loop_closure(points_2d, cur_idx)
            self.stats.wall_loop_closure += time.perf_counter() - t2

        self.prev_points = points_2d
        self.prev_rel_time = rel_time_us
        self.stats.scans += 1
        if self.verbose:
            pos = self.global_pose[:2, 2]
            yaw = np.degrees(np.arctan2(self.global_pose[1, 0],
                                        self.global_pose[0, 0]))
            print(f"Scan {self.stats.scans:4d}  err={error:.6f}  "
                  f"pos=({pos[0]:+.3f}, {pos[1]:+.3f})  yaw={yaw:+.2f} deg")
        return True


def run_slam(cfg: SlamConfig | dict, verbose: bool = True, device="cuda",
             resume: str | None = None):
    """File-driven entry (reference slam.py:282-657).

    Returns (global_pose, pose_trajectory, mapper, engine). ``resume``
    restores a checkpoint saved with ``SlamEngine.save_checkpoint`` (by
    either package) before streaming.
    """
    if isinstance(cfg, dict):
        cfg = SlamConfig.from_dict(cfg)
    imu = None
    if cfg.imu_enabled and cfg.imu_file:
        imu = IMUService(cfg.imu_file)

    engine = SlamEngine(cfg, imu=imu, verbose=verbose, device=device)
    if resume:
        engine.load_checkpoint(resume)
    service = LidarService(cfg.data_file, sleep_s=cfg.sleep_s, loop=cfg.loop)
    batch_n = max(int(cfg.batch_scans), 1)

    submitted = 0          # scans handed to the engine (results may lag)
    scan_counter = 0
    pend_pts: list[np.ndarray] = []
    pend_rel: list = []

    def flush():
        if pend_pts and engine._state is not None:
            engine.process_scans_batched(pend_pts, pend_rel)
        else:
            for p, r in zip(pend_pts, pend_rel):
                engine.process_scan(p, r)
        pend_pts.clear()
        pend_rel.clear()

    try:
        for ts, rel_us, raw_points in service.scans():
            scan_counter += 1
            if cfg.process_every_n > 1 and (
                scan_counter % cfg.process_every_n
            ) != 1:
                continue
            points = filter_and_flatten(raw_points, cfg.z_min, cfg.z_max)
            if points.shape[0] < 10:
                continue
            init_scan = engine._state is None and engine.prev_points is None
            if engine._state is None or batch_n == 1:
                engine.process_scan(points, rel_us)
            else:
                pend_pts.append(points)
                pend_rel.append(rel_us)
                if len(pend_pts) >= batch_n:
                    flush()
            if not init_scan:
                submitted += 1   # init scan doesn't count (slam.py:388-453)
            engine.maybe_snapshot()
            if cfg.num_scans is not None and submitted >= cfg.num_scans:
                break
        flush()
    except KeyboardInterrupt:
        print("Stopping SLAM loop...")

    engine.finish()
    engine.sync_map()
    engine.lidar_parser = service.parser
    return engine.global_pose, engine.pose_trajectory, engine.mapper, engine
