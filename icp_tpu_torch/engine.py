"""Streaming SLAM engine (counterpart of icp_tpu.engine, fused path without
loop closure).

The host owns I/O, the scan history and the bookkeeping of step results;
every per-scan computation runs on ``device`` through the fused step of
models/slam_step.py. The first scan initialises the grid bounds, the ray
bound and the sweep caps, paints the grid through
``OccupancyGrid2D.update_scan`` and builds the fused state, which aliases
the grid. Later scans go through ``process_scan`` (one at a time) or
``process_scans_batched`` (B at a time, map painted once per batch).

Not ported yet (ROADMAP Queue 1): loop closure (``lc_enabled``), the
modular non-fused path (``fused: false``), the device mesh
(``distributed: true``), checkpoints and the live map view.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from icp_tpu_torch.models.occupancy import OccupancyGrid2D
from icp_tpu_torch.models.pose_graph import PoseGraph2D
from icp_tpu_torch.models.slam_step import SlamState, init_state, make_slam_step
from icp_tpu_torch.services.imu import IMUService
from icp_tpu_torch.services.lidar import LidarService
from icp_tpu_torch.utils.config import SlamConfig


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


def _pose_to_vec_np(T: np.ndarray) -> np.ndarray:
    """[x, y, theta] from a 3x3 pose, on the host."""
    return np.array([T[0, 2], T[1, 2], np.arctan2(T[1, 0], T[0, 0])],
                    np.float32)


def _relative_vec_np(Ti: np.ndarray, Tj: np.ndarray) -> np.ndarray:
    """vec(Ti^-1 Tj), on the host."""
    R = Ti[:2, :2]
    t = Ti[:2, 2]
    Tinv = np.eye(3, dtype=np.float64)
    Tinv[:2, :2] = R.T
    Tinv[:2, 2] = -R.T @ t
    return _pose_to_vec_np(Tinv @ Tj)


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
    icp_iters: int = 0
    truncated_scans: int = 0   # scans out-ranging the auto ray bound
    sweep_dropped_voxels: int = 0  # sweep voxels lost to src/tgt caps
    wall_registration: float = 0.0


class SlamEngine:
    """Streaming SLAM engine on one device. Feed scans through
    ``process_scan`` / ``process_scans_batched``, then ``finish()``; read
    ``global_pose``, ``pose_trajectory`` and ``mapper``."""

    def __init__(self, cfg: SlamConfig, imu: IMUService | None = None,
                 verbose: bool = True, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SlamEngine(device='cuda') but CUDA is not "
                               "available; pass device='cpu' explicitly")
        if cfg.lc_enabled:
            raise NotImplementedError(
                "loop closure is not ported yet (ROADMAP Queue 1: loop "
                "closure and the pose graph); set loop_closure.enabled: false")
        if not cfg.fused:
            raise NotImplementedError(
                "only the fused path is ported (tpu.fused: true)")
        if cfg.distributed is True:
            raise NotImplementedError(
                "tpu.distributed: true is not ported yet (ROADMAP Queue 1: "
                "parallel/)")
        self.cfg = cfg
        self.imu = imu
        self.verbose = verbose

        self.global_pose = np.eye(3, dtype=np.float32)
        self.pose_trajectory: list[np.ndarray] = []
        self.scan_history: list[ScanRecord] = []
        self.prev_points: np.ndarray | None = None
        self.prev_rel_time = None
        self.mapper: OccupancyGrid2D | None = None
        self.pose_graph = PoseGraph2D()
        self.imu_yaw_offset = 0.0
        self.stats = SlamStats()

        self._cap = cfg.scan_capacity
        self._sub_cap = cfg.submap_capacity
        self._step_fn = None
        self._batch_fn = None
        self._state: SlamState | None = None
        self._pending: list = []          # batches whose results are unread
        self._last_enq_rel = None         # rel time of last enqueued scan
        self._ray_bound: int | None = None
        self._free_cap: int | None = None
        self._sweep_caps: tuple[int, int] | None = None
        self._warned_truncate = False
        self._sub_sat_warned = False
        self._sweep_drop_warned = False

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
                                 max(int(cfg.submap_size), 1))

    def _to_device(self, *arrays):
        return tuple(torch.as_tensor(a, device=self.device) for a in arrays)

    def sync_map(self):
        """Point the mapper at the device grid (for export). The fused state
        updates the grid in place, so this copies nothing."""
        if self._state is not None and self.mapper is not None:
            self.mapper.log_odds = self._state.log_odds

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
        cur_idx = self.pose_graph.add_node(_pose_to_vec_np(self.global_pose))
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

    def process_scans_batched(self, scans: list, rel_times: list) -> int:
        """Fused batch path: B scans through one ``batch`` call. Results are
        bookkept one call later (``_drain_pending``) or at ``finish()``.
        Returns the number of accepted scans bookkept by this call."""
        return self._dispatch_batch(scans, rel_times)

    def _pack_batch(self, scans: list, rel_times: list, prev_rel):
        """Pack B scans + their IMU lookups into fixed-shape host arrays
        (each scan padded to the scan capacity, padding masked out)."""
        B = len(scans)
        cap = self._cap
        pts = np.zeros((B, cap, 2), np.float32)
        msk = np.zeros((B, cap), bool)
        deltas = np.zeros(B, np.float32)
        yaws = np.zeros(B, np.float32)
        for i, p in enumerate(scans):
            self._check_ray_bound(p)
            n = min(p.shape[0], cap)
            pts[i, :n] = p[:n]
            if n > 0:
                pts[i, n:] = p[0]
            msk[i, :n] = True
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
        return pts, msk, deltas, yaws

    def _dispatch_batch(self, scans: list, rel_times: list) -> int:
        """Run len(scans) scans through the fused batch; bookkeep the
        previous batch's results after this one is queued."""
        prev_rel = (self._last_enq_rel if self._last_enq_rel is not None
                    else self.prev_rel_time)
        arrays = self._pack_batch(scans, rel_times, prev_rel)
        t0 = time.perf_counter()
        self._state, outs = self._batch_fn(self._state,
                                           *self._to_device(*arrays))
        accepted = self._drain_pending()
        # snapshot the lists: callers may mutate/clear them after we return
        self._pending.append((list(scans), list(rel_times), outs))
        self._last_enq_rel = rel_times[-1]
        self.stats.wall_registration += time.perf_counter() - t0
        return accepted

    def finish(self):
        """Bookkeep the results still pending (call after the last batch)."""
        return self._drain_pending()

    def warmup(self):
        """Run the batch program once on all-masked padding scans (exact
        no-ops under the degenerate gate), so allocator and kernel build
        costs land before a timed run. Call after the first scan."""
        if self._state is None or not self.scan_history:
            return
        B, cap = self.cfg.batch_scans, self._cap
        z = torch.zeros((B, cap, 2), dtype=torch.float32, device=self.device)
        m = torch.zeros((B, cap), dtype=torch.bool, device=self.device)
        d = torch.zeros(B, dtype=torch.float32, device=self.device)
        self._state, _ = self._batch_fn(self._state, z, m, d, d)
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

    def _drain_pending(self) -> int:
        """Bookkeep every batch whose results are still on the device."""
        accepted = 0
        while self._pending:
            scans, rel_times, outs = self._pending.pop(0)
            outs = type(outs)(*(f.cpu().numpy() for f in outs))
            self._check_sub_saturation(outs.sub_n)
            self._check_sweep_drop(outs.sweep_drop)
            for i in range(len(scans)):
                ok = self._bookkeep_fused(
                    scans[i],
                    np.asarray(outs.pose[i]), float(outs.error[i]),
                    bool(outs.accepted[i]), bool(outs.sub_applied[i]),
                    float(outs.err_inc[i]), int(outs.iters[i]),
                )
                accepted += bool(ok)
                self.prev_points = scans[i]
                self.prev_rel_time = rel_times[i]
        return accepted

    def _process_scan_fused(self, points_2d, rel_time_us, imu_yaw,
                            imu_delta) -> bool:
        self._drain_pending()
        t0 = time.perf_counter()
        sp, sm = self._to_device(*_pad_fixed(points_2d, self._cap))
        self._state, out = self._step_fn(
            self._state, sp, sm,
            torch.tensor(imu_delta if imu_delta is not None else 0.0,
                         dtype=torch.float32, device=self.device),
            torch.tensor(imu_yaw if imu_yaw is not None else 0.0,
                         dtype=torch.float32, device=self.device),
        )
        out = type(out)(*(f.cpu().numpy() for f in out))  # one read per scan
        self._check_sub_saturation(out.sub_n)
        self._check_sweep_drop(out.sweep_drop)
        self.stats.wall_registration += time.perf_counter() - t0

        self.prev_points = points_2d
        self.prev_rel_time = rel_time_us
        return self._bookkeep_fused(
            points_2d, np.asarray(out.pose), float(out.error),
            bool(out.accepted), bool(out.sub_applied),
            float(out.err_inc), int(out.iters),
        )

    @property
    def pose_scan_indices(self) -> np.ndarray:
        """0-based input-stream index of each pose in ``pose_trajectory``
        (rejected scans leave gaps); pass to ``utils.metrics.ate(...,
        indices=...)``."""
        return np.array([r.scan_idx for r in self.scan_history[1:]],
                        dtype=np.int64)

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
            self.scan_history.append(
                ScanRecord(points_2d.copy(), self.global_pose.copy(),
                           scan_idx=0)
            )
            self.pose_graph.add_node(_pose_to_vec_np(self.global_pose))
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
        return self._process_scan_fused(points_2d, rel_time_us, imu_yaw,
                                        imu_delta)


def run_slam(cfg: SlamConfig | dict, verbose: bool = True, device="cuda"):
    """File-driven entry (reference slam.py:282-657).

    Returns (global_pose, pose_trajectory, mapper, engine).
    """
    if isinstance(cfg, dict):
        cfg = SlamConfig.from_dict(cfg)
    if cfg.live_map:
        print("  [warn] display.live_map is not ported yet; running headless")

    imu = None
    if cfg.imu_enabled and cfg.imu_file:
        imu = IMUService(cfg.imu_file)

    engine = SlamEngine(cfg, imu=imu, verbose=verbose, device=device)
    service = LidarService(cfg.data_file, sleep_s=cfg.sleep_s, loop=cfg.loop)
    batch_n = max(int(cfg.batch_scans), 1)

    submitted = 0          # scans handed to the engine (results may lag)
    scan_counter = 0
    pend_pts: list[np.ndarray] = []
    pend_rel: list = []

    def flush():
        if pend_pts:
            engine.process_scans_batched(pend_pts, pend_rel)
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
            init_scan = engine._state is None
            if init_scan or batch_n == 1:
                engine.process_scan(points, rel_us)
            else:
                pend_pts.append(points)
                pend_rel.append(rel_us)
                if len(pend_pts) >= batch_n:
                    flush()
            if not init_scan:
                submitted += 1   # init scan doesn't count (slam.py:388-453)
            if cfg.num_scans is not None and submitted >= cfg.num_scans:
                break
        flush()
    except KeyboardInterrupt:
        print("Stopping SLAM loop...")

    engine.finish()
    engine.sync_map()
    return engine.global_pose, engine.pose_trajectory, engine.mapper, engine
