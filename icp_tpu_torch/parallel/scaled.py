"""The scaled SLAM pipeline of BASELINE config #5 (counterpart of
icp_tpu.parallel.scaled: ``ScaledStats``, ``_mat``, ``_inv``, ``_ortho``,
``ScaledPipeline``).

One pipeline at the three scale axes the engine keeps apart:
* points per scan: each 10^5-point scan registers scan-to-submap through
  ``models.icp.icp_large`` (dense cell-grid correspondences) against the
  voxel-merged ring of the last ``submap_keyframes`` keyframes, seeded at
  the constant-velocity prediction and guarded by the agreement gate;
* map area: the occupancy grid is allocated up front (``ny`` rounded up to
  a multiple of 64, icp_tpu's shape), ROW-BLOCK-SHARDED over the mesh
  (``blocks``, one block a shard, never replicated; ``parallel.
  sharded_grid``) and stores the UNCLAMPED log-odds sum; the [lo_min,
  lo_max] clamp applies at read (``map_probability``), so every paint is
  additive and ``sync_map`` can un-paint a keyframe at its old pose and
  repaint it at the corrected one;
* keyframe count: loop closures are verified multi-candidate (rotation
  search, then two gated ``icp_core`` passes per candidate, accept-first in
  distance order) and bundle-adjusted online by ``PoseGraph2D``, through
  the distributed Schur-complement GN on a mesh of more than one shard,
  and the map is replayed incrementally from the corrected poses.

icp_tpu fuses each scan's registration into one jitted dispatch with the
pose carried on the device. Here the same steps run as eager ops on
``device``, the pose carry stays on the device, and the small per-scan
outputs come back by non-blocking copies that are read at the drain. Each
step drains the steps before it as soon as the card has finished them
(asked without waiting, after the step's registration has waited on the
card anyway), so a scan's pose is in the record when the next step
returns; a drain that waits comes only when 64 steps are pending and
before every loop-closure check. The candidate lanes that
icp_tpu vmaps (padding unused lanes with the last candidate) run here one
after another, the real candidates only.

Registration stays on the mesh's first local device, as icp_tpu keeps it
off the mesh. A device in place of the mesh means a one-shard mesh on it.
In a multi-process run every process runs the registration and the graph
on the same scans, holds only its own grid blocks, and gathers the blocks
(an all-gather) for ``log_odds``, ``map_probability`` and
``save_checkpoint``. Each step's registration and each closure check's
verification results are process 0's (``Mesh.broadcast``, one collective
each), so every process keeps the same trajectory and takes the same
decisions, as icp_tpu's deterministic programs do by themselves.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from icp_tpu_torch.models.icp import icp_core, icp_large
from icp_tpu_torch.models.pose_graph import PoseGraph2D
from icp_tpu_torch.models.prealign import rotation_search
from icp_tpu_torch.ops.nn import nn_query
from icp_tpu_torch.ops.voxel import voxel_downsample_fixed
from icp_tpu_torch.parallel.mesh import Mesh
from icp_tpu_torch.parallel.sharded_grid import (
    raytrace_replay_block_sharded, raytrace_update_block_sharded)
from icp_tpu_torch.utils import spans
from icp_tpu_torch.utils.masking import pad_points


@dataclass
class ScaledStats:
    scans: int = 0
    loop_closures: int = 0
    lc_checked: int = 0            # closure checks that had candidates
    lc_candidates: int = 0         # candidate lanes actually verified
    gate_fallbacks: int = 0        # submap registrations failing the gate
    reg_dropped_points: int = 0    # points lost to static ICP capacities
    ba_runs: int = 0               # online BA invocations
    replayed_keyframes: int = 0    # keyframes repainted by sync_map
    icp_iters: int = 0
    wall_registration: float = 0.0
    wall_mapping: float = 0.0
    wall_lc: float = 0.0
    wall_ba: float = 0.0
    wall_replay: float = 0.0
    wall_replay_fill: float = 0.0  # host chunk assembly inside ^
    ba_iterations: int = 0
    partition_wall: float = 0.0    # host time in partition_graph (Schur)


def _mat(R, t):
    T = np.eye(3, dtype=np.float32)
    T[:2, :2] = R
    T[:2, 2] = t
    return T


def _inv(T):
    R = T[:2, :2]
    t = T[:2, 2]
    out = np.eye(3, dtype=np.float32)
    out[:2, :2] = R.T
    out[:2, 2] = -R.T @ t
    return out


def _ortho(T):
    """Project the rotation part onto SO(2) via its yaw angle: the pose ->
    prediction -> ICP init loop would otherwise grow an f32
    non-orthonormality geometrically."""
    yaw = np.arctan2(T[1, 0], T[0, 0])
    c, s = np.cos(yaw), np.sin(yaw)
    out = np.eye(3, dtype=np.float32)
    out[0, 0] = c
    out[0, 1] = -s
    out[1, 0] = s
    out[1, 1] = c
    out[:2, 2] = T[:2, 2]
    return out


def _snap(R):
    """SO(2) projection of a (2, 2) device tensor via its yaw."""
    yaw = torch.atan2(R[1, 0], R[0, 0])
    c, s = torch.cos(yaw), torch.sin(yaw)
    return torch.stack([torch.stack([c, -s]), torch.stack([s, c])])


def _to_host(out):
    """Start non-blocking device-to-host copies of a step's outputs."""
    return tuple(x.to("cpu", non_blocking=True) for x in out)


class ScaledPipeline:
    """Streaming scaled SLAM: feed sensor-frame scans through ``step()``,
    then ``finish()`` (or ``optimize()``) before reading ``trajectory``,
    ``kf_points`` and ``stats``. All capacities are static. ``mesh`` is a
    ``parallel.mesh.Mesh`` of any size, or a device for a one-shard mesh
    on it (default cuda; raises without a card)."""

    _keyframe_span = spans.span("scaled.keyframe")

    def __init__(self, mesh="cuda", *,
                 scan_capacity: int = 131072,
                 extent: float = 100.0,
                 map_resolution: float = 0.25,
                 map_margin: float = 10.0,
                 max_range: float = 35.0,
                 icp_max_corr: float = 1.0,
                 icp_max_iterations: int = 30,
                 icp_grid_shape: tuple = (96, 96),
                 icp_cell_cap: int = 64,
                 icp_qcells: int = 4096,
                 icp_method: str = "point_to_point",
                 p_hit: float = 0.7, p_miss: float = 0.4,
                 log_odds_min: float = -5.0, log_odds_max: float = 5.0,
                 map_ray_stride: int = 1,
                 kf_capacity: int = 8192,
                 kf_voxel: float = 0.3,
                 submap_keyframes: int = 8,
                 gate_dist: float = 2.0,
                 gate_yaw_deg: float = 15.0,
                 error_reject_threshold: float = 0.5,
                 lc_every: int = 8,
                 lc_min_interval: int = 50,
                 lc_distance: float = 5.0,
                 lc_min_travel: float = 30.0,
                 lc_error_threshold: float = 0.05,
                 lc_max_corr: float = 6.0,
                 lc_iterations: int = 40,
                 lc_info_scale: float = 10.0,
                 lc_info_cap: float = 0.0,
                 lc_robust: bool = False,
                 lc_robust_phi: float = 1.0,
                 lc_max_candidates: int = 4,
                 lc_min_frac: float = 0.5,
                 lc_cooldown: int = 0,
                 ba_every: int = 1,
                 ba_iterations: int = 10,
                 replay_chunk: int = 64,
                 dist_node_threshold: int = 2):
        if not isinstance(mesh, Mesh):
            mesh = Mesh((torch.device(mesh),))
        self.mesh = mesh
        self.device = mesh.devices[0]
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ScaledPipeline(device='cuda') but CUDA is not "
                               "available; pass device='cpu' explicitly")
        self.cap = int(scan_capacity)
        # free-space rays per scan: a strided slice of the keyframe's hits
        # (hit cells are always painted from every point)
        self.map_ray_stride = max(int(map_ray_stride), 1)
        self.kf_cap = int(kf_capacity)
        self.kf_voxel = float(kf_voxel)
        self.max_range = float(max_range)
        self.submap_kf = int(submap_keyframes)
        self.gate_dist = float(gate_dist)
        self.gate_yaw = float(np.deg2rad(gate_yaw_deg))
        self.reject_threshold = float(error_reject_threshold)
        self.lc_every = int(lc_every)
        self.lc_min_interval = int(lc_min_interval)
        self.lc_distance = float(lc_distance)
        self.lc_min_travel = float(lc_min_travel)
        self.lc_error_threshold = float(lc_error_threshold)
        self.lc_info_scale = float(lc_info_scale)
        self.lc_info_cap = float(lc_info_cap)
        self.lc_robust = bool(lc_robust)
        self.lc_max_candidates = max(int(lc_max_candidates), 1)
        self.lc_min_frac = float(lc_min_frac)
        self.lc_cooldown = int(lc_cooldown)     # 0: re-check every time
        self._last_lc_accept = None
        self.ba_every = int(ba_every)
        self.ba_iters = int(ba_iterations)
        self.replay_chunk = max(int(replay_chunk), 1)
        # LC verification: a global rotation search, then a coarse gated
        # pull and a fine pass at the registration gate
        self._lc_coarse = float(lc_max_corr)
        self._lc_fine = float(icp_max_corr)
        self._lc_iters = int(lc_iterations)
        self._sweep_voxel = max(2.0 * self.kf_voxel, 0.5)
        self._icp_kw = dict(
            max_corr_dist=float(icp_max_corr),
            max_iterations=int(icp_max_iterations),
            error_threshold=0.0,
            grid_shape=tuple(icp_grid_shape),
            cap=int(icp_cell_cap), qcap=int(icp_cell_cap),
            qcells=int(icp_qcells),
            method=str(icp_method),
        )

        # ── occupancy grid, allocated up front ──────────────────────────
        lo = -extent - map_margin
        hi = extent + map_margin
        self.min_x = self.min_y = lo
        self.resolution = float(map_resolution)
        n_cells = int(np.ceil((hi - lo) / self.resolution))
        # rows rounded to a multiple of 64: the same grid shape (and so the
        # same results) for any mesh size up to 64 shards
        self.ny = -(-n_cells // 64) * 64
        assert self.ny % mesh.size == 0, (self.ny, mesh.size)
        self.nx = n_cells
        self.l_hit = float(np.log(p_hit / (1.0 - p_hit)))
        self.l_miss = float(np.log(p_miss / (1.0 - p_miss)))
        self.lo_min, self.lo_max = float(log_odds_min), float(log_odds_max)
        self.max_steps = int(np.ceil(
            1.2 * self.max_range / self.resolution / 64.0)) * 64
        self.blocks = self._zero_blocks()

        # ── rolling submap ring (device-resident, world frame) ───────────
        self._register = self.submap_kf > 0      # submap mode on
        if self._register:
            S = self.submap_kf
            self._ring_pts = torch.zeros((S, self.kf_cap, 2),
                                         dtype=torch.float32,
                                         device=self.device)
            self._ring_mask = torch.zeros((S, self.kf_cap), dtype=torch.bool,
                                          device=self.device)
            # device-resident pose carry (pose and last increment)
            self._set_dev_carry(np.eye(3, dtype=np.float32),
                                np.eye(3, dtype=np.float32))
        else:
            self._ring_pts = self._ring_mask = None
        self._pending: list = []                   # in-flight step outputs
        self._pending_event = None

        self._dist_threshold = int(dist_node_threshold)
        self.pose_graph = self._new_graph(float(lc_robust_phi))
        self.global_pose = np.eye(3, dtype=np.float32)
        self.trajectory: list[np.ndarray] = []
        self.kf_points: list[np.ndarray] = []   # downsampled, sensor frame
        # keyframe positions + cumulative travel, preallocated and doubled
        # when full: the LC gates read them every lc_every scans
        self._kf_xy = np.zeros((1024, 2), np.float32)
        self._trav = np.zeros(1024, np.float64)
        self._n_kf = 0
        self._gc_next = 4096                     # periodic gc freeze mark
        self._prev = None                        # (padded pts, mask) device
        self._prev_inc = np.eye(3, dtype=np.float32)   # last relative motion
        self._n_seen = 0                         # scans handed to step()
        self._accepts_since_ba = 0
        self._map_dirty = False
        self._painted_T: list[np.ndarray] = []   # pose each kf was painted at
        self.gn_step_strategy = None             # set by time_gn_step
        self.stats = ScaledStats()

    # ── the row-block-sharded grid ───────────────────────────────────────
    @property
    def log_odds(self) -> torch.Tensor:
        """The whole (ny, nx) grid on the first local device: the block
        itself on a one-shard mesh, else the blocks gathered (across
        processes too)."""
        if self.mesh.size == 1:
            return self.blocks[0]
        return self.mesh.all_gather(self.blocks)

    @log_odds.setter
    def log_odds(self, grid: torch.Tensor):
        self.blocks = self.mesh.split(grid)

    def _zero_blocks(self):
        rows = self.ny // self.mesh.size
        return [torch.zeros((rows, self.nx), dtype=torch.float32, device=d)
                for d in self.mesh.devices]

    def _new_graph(self, robust_phi: float) -> PoseGraph2D:
        pg = PoseGraph2D(self.device)
        pg.robust_phi = robust_phi
        if self.mesh.size > 1:
            pg.set_mesh(self.mesh, self._dist_threshold)
        return pg

    def _sync_devices(self):
        for d in dict.fromkeys(self.mesh.devices):
            if d.type == "cuda":
                spans.count("sync.scaled.sync_devices")
                torch.cuda.synchronize(d)

    # ── helpers ──────────────────────────────────────────────────────────
    def _t(self, a, dtype=None, site="sync.scaled.upload"):
        """``a`` on the device; a host array's copy counts at ``site``."""
        if not isinstance(a, torch.Tensor):
            spans.count(site)
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def _set_dev_carry(self, T, inc):
        site = "sync.scaled.carry_upload"
        self._dev_pR = self._t(T[:2, :2], site=site)
        self._dev_pt = self._t(T[:2, 2], site=site)
        self._dev_iR = self._t(inc[:2, :2], site=site)
        self._dev_it = self._t(inc[:2, 2], site=site)

    def _downsample_kf(self, pts_pad, mask):
        """Compact voxelized keyframe cloud (host array)."""
        d, dm = voxel_downsample_fixed(pts_pad, mask, self.kf_voxel,
                                       self.kf_cap)
        spans.count("sync.scaled.kf_read", 2)
        return d.cpu().numpy()[dm.cpu().numpy()]

    @property
    def kf_pos(self) -> np.ndarray:
        """(n, 2) keyframe positions view (row k = keyframe k)."""
        return self._kf_xy[:self._n_kf]

    def _append_kf_pos(self, xy: np.ndarray):
        n = self._n_kf
        if n == len(self._kf_xy):
            self._kf_xy = np.concatenate([self._kf_xy,
                                          np.zeros_like(self._kf_xy)])
            self._trav = np.concatenate([self._trav,
                                         np.zeros_like(self._trav)])
        self._kf_xy[n] = xy
        self._trav[n] = (0.0 if n == 0 else self._trav[n - 1]
                         + float(np.linalg.norm(xy - self._kf_xy[n - 1])))
        self._n_kf = n + 1

    def _set_kf_pos(self, xy_all: np.ndarray):
        """Rewrite positions/travel wholesale (post-BA correction)."""
        n = len(xy_all)
        cap = max(1024, 1 << (max(n, 1) - 1).bit_length())
        self._kf_xy = np.zeros((cap, 2), np.float32)
        self._trav = np.zeros(cap, np.float64)
        self._kf_xy[:n] = xy_all
        if n > 1:
            steps = np.linalg.norm(np.diff(xy_all.astype(np.float64),
                                           axis=0), axis=1)
            self._trav[1:n] = np.cumsum(steps)
        self._n_kf = n

    def _maybe_gc_freeze(self):
        """Collect and freeze the long-lived run history now and then, so
        gen-2 passes do not rescan it on every collection."""
        if self.stats.scans >= self._gc_next:
            import gc
            gc.collect()
            gc.freeze()
            self._gc_next += 4096

    def _add_node_edge(self, err):
        v = np.array([self.global_pose[0, 2], self.global_pose[1, 2],
                      np.arctan2(self.global_pose[1, 0],
                                 self.global_pose[0, 0])], np.float32)
        idx = self.pose_graph.add_node(v)
        if idx > 0:
            prev = self.pose_graph.nodes[idx - 1]
            c, s = np.cos(prev[2]), np.sin(prev[2])
            Rp = np.array([[c, -s], [s, c]], np.float32)
            dt_ = Rp.T @ (v[:2] - prev[:2])
            dth = (v[2] - prev[2] + np.pi) % (2 * np.pi) - np.pi
            self.pose_graph.add_edge(
                idx - 1, idx, np.array([dt_[0], dt_[1], dth], np.float32),
                np.eye(3, dtype=np.float32) / max(float(err), 1e-6))
        return idx

    def _cells(self, world):
        """World points (..., 2) -> integer map cells (..., 2)."""
        spans.count("sync.scaled.cells")
        return torch.floor(
            (world - torch.tensor([self.min_x, self.min_y],
                                  dtype=torch.float32, device=self.device))
            * (1.0 / self.resolution)).to(torch.int64)

    @spans.spanned("map.paint")
    def _paint(self, pts, mask, R, t):
        """Paint one voxelized keyframe at pose (R, t) into the blocks, in
        place: hits from every point, free space along every
        ``map_ray_stride``-th ray, into the unclamped grid."""
        hit_cells = self._cells(pts @ R.T + t)
        s = self.map_ray_stride
        raytrace_update_block_sharded(
            self.mesh, self.blocks, self._cells(t), hit_cells, mask,
            self.l_hit, self.l_miss, -np.inf, np.inf,
            max_steps=self.max_steps, ray_cells=hit_cells[::s],
            ray_valid=mask[::s])

    def _replay(self, kf_pts, kf_mask, Rs, ts, sign: float):
        """Paint (sign +1) or un-paint (sign -1) a chunk of keyframes at the
        given poses in one batched update of the unclamped blocks."""
        world = torch.einsum("bij,bnj->bni", Rs, kf_pts) + ts[:, None, :]
        hit_cells = self._cells(world)
        s = self.map_ray_stride
        raytrace_replay_block_sharded(
            self.mesh, self.blocks, self._cells(ts), hit_cells, kf_mask,
            sign * self.l_hit, sign * self.l_miss, -np.inf, np.inf,
            max_steps=self.max_steps, ray_cells=hit_cells[:, ::s],
            ray_valid=kf_mask[:, ::s])

    def _ring_push(self, kf_p, kf_m, R, t, slot: int):
        self._ring_pts[slot] = kf_p @ R.T + t
        self._ring_mask[slot] = kf_m

    def _rebuild_ring(self):
        """Recreate the submap ring from the last S keyframes at their
        current (post-BA) poses."""
        if not self._register:
            return
        S = self.submap_kf
        n = len(self.kf_points)
        self._ring_pts.zero_()
        self._ring_mask.zero_()
        site = "sync.scaled.ring_upload"
        for i in range(max(0, n - S), n):
            kf_p, kf_m = pad_points(self.kf_points[i], self.kf_cap)
            T = self.trajectory[i]
            self._ring_push(*(self._t(a, site=site) for a in (
                kf_p, kf_m, T[:2, :2], T[:2, 2])), i % S)

    def _fused_reg(self, sp, sm, slot: int):
        """One scan's registration with the pose carried on the device:
        constant-velocity prediction, scan-to-submap icp_large against the
        voxel-merged ring, the agreement gate, the keyframe voxelization
        and the ring push. Returns the step's outputs (device tensors)."""
        pR, pt = self._dev_pR, self._dev_pt
        Rp = pR @ self._dev_iR                      # predicted pose
        tp = pR @ self._dev_it + pt
        flat = self._ring_pts.reshape(-1, 2)
        fm = self._ring_mask.reshape(-1)
        tgt, tm = voxel_downsample_fixed(flat, fm, self.kf_voxel,
                                         flat.shape[0])
        res = icp_large(sp, sm, tgt, tm, Rp, tp, **self._icp_kw)

        d_pos = torch.linalg.norm(res.t - tp)
        yaw_n = torch.atan2(res.R[1, 0], res.R[0, 0])
        yaw_p = torch.atan2(Rp[1, 0], Rp[0, 0])
        d_yaw = torch.abs((yaw_n - yaw_p + np.pi) % (2 * np.pi) - np.pi)
        ok = ((res.error <= self.reject_threshold)
              & (d_pos <= self.gate_dist) & (d_yaw <= self.gate_yaw))
        Rn = _snap(torch.where(ok, res.R, Rp))
        tn = torch.where(ok, res.t, tp)
        with self._keyframe_span:
            kf_p, kf_m = voxel_downsample_fixed(sp, sm, self.kf_voxel,
                                                self.kf_cap)
        out = self.mesh.broadcast(
            (Rn, tn, res.error, res.iters, ok, res.dropped, kf_p, kf_m))
        Rn, tn, kf_p, kf_m = out[0], out[1], out[6], out[7]
        self._dev_iR = _snap(pR.T @ Rn)             # relative increment
        self._dev_it = pR.T @ (tn - pt)
        self._dev_pR, self._dev_pt = Rn, tn
        with self._keyframe_span:
            self._ring_push(kf_p, kf_m, Rn, tn, slot)
        return tuple(out)

    # ── per-scan step ────────────────────────────────────────────────────
    def step(self, points: np.ndarray):
        """One scan: register -> pose -> node/edge -> map paint -> periodic
        loop-closure check -> online BA. ``points`` is (n, 2) sensor frame.
        In submap mode a step's outputs are bookkept by a later drain,
        the next step's where the card has finished them; call finish()
        (or optimize()) after the last scan."""
        with spans.span("scaled.pack"):
            sp, sm = pad_points(points[:self.cap], self.cap)
            sp, sm = self._t(sp), self._t(sm)
        if self._register:
            return self._step_fused(sp, sm)
        return self._step_legacy(sp, sm)

    def _step_fused(self, sp, sm):
        idx = self._n_seen
        t0 = time.perf_counter()
        if idx == 0:
            # first scan: seed the ring at the identity pose
            with self._keyframe_span:
                kf_p, kf_m = voxel_downsample_fixed(sp, sm, self.kf_voxel,
                                                    self.kf_cap)
                self._ring_pts[0] = kf_p
                self._ring_mask[0] = kf_m
            out = (self._dev_pR, self._dev_pt, self._t(0.0, torch.float32),
                   self._t(0, torch.int32), self._t(True),
                   self._t(0, torch.int32), kf_p, kf_m)
        else:
            with spans.span("scaled.register"):
                out = self._fused_reg(sp, sm, idx % self.submap_kf)
        # paint the voxelized keyframe: the cloud sync_map can un-paint
        self._paint(out[6], out[7], out[0], out[1])
        # _drain adds its own time to the wall
        self.stats.wall_registration += time.perf_counter() - t0
        if self._pending:
            spans.count("scaled.ready_checks")
            if self._pending_done():
                spans.count("scaled.ready_drains")
                self._pending_event = None     # finished: nothing to wait on
                self._drain()
        t0 = time.perf_counter()
        self._pending.append(_to_host(out))
        if self.device.type == "cuda":
            self._pending_event = torch.cuda.Event()
            self._pending_event.record()
        self._n_seen += 1
        self.stats.wall_registration += time.perf_counter() - t0
        if len(self._pending) >= 64:       # bound in-flight buffers
            self._drain()

        cur_idx = idx
        if (cur_idx >= self.lc_min_interval
                and cur_idx % self.lc_every == 0):
            self._drain()
            self._check_loop(cur_idx)

    def _check_loop(self, cur_idx: int):
        t0 = time.perf_counter()
        accepted = self._try_loop_closure(cur_idx)
        self.stats.wall_lc += time.perf_counter() - t0
        if accepted:
            self._accepts_since_ba += 1
            if self.ba_every > 0 and self._accepts_since_ba >= self.ba_every:
                t1 = time.perf_counter()
                self._run_ba(self.ba_iters)
                self.stats.wall_ba += time.perf_counter() - t1

    def _pending_done(self) -> bool:
        """Whether the card has finished the pending steps, asked without
        waiting; on the CPU a step's work is done when its ops return."""
        return self._pending_event is None or self._pending_event.query()

    @spans.spanned("scaled.drain")
    def _drain(self):
        """Bookkeep in-flight step outputs (host mirror of poses,
        keyframes, graph nodes/edges, stats)."""
        t0 = time.perf_counter()
        if self._pending_event is not None:
            with spans.span("scaled.drain_wait"):
                spans.count("sync.scaled.drain_wait")
                self._pending_event.synchronize()
            self._pending_event = None
        self._bookkeep_pending()
        self._maybe_gc_freeze()
        self.stats.wall_registration += time.perf_counter() - t0

    @spans.spanned("scaled.bookkeep")
    def _bookkeep_pending(self):
        for out in self._pending:
            Rn, tn, err, iters, ok, dropped, kf_p, kf_m = (
                x.numpy() for x in out)
            err = float(err)
            if not bool(ok):
                self.stats.gate_fallbacks += 1
                err = self.reject_threshold        # weak odometry edge
            self.stats.icp_iters += int(iters)
            if int(dropped) > 0:
                self.stats.reg_dropped_points += int(dropped)
                # routine density subsampling is benign; warn only when a
                # large fraction of the scan vanishes from matching
                if (int(dropped) > 0.2 * self.cap
                        and not getattr(self, "_warned_dropped", False)):
                    self._warned_dropped = True
                    print(f"  [warn] registration dropped {int(dropped)} "
                          f"points (>20% of capacity) to static caps "
                          f"(icp_cell_cap/icp_qcells/grid extent); "
                          f"counted in stats.reg_dropped_points")
            self.global_pose = _mat(Rn, tn)
            idx = len(self.trajectory)
            self.trajectory.append(self.global_pose.copy())
            self._painted_T.append(self.global_pose.copy())
            self.kf_points.append(kf_p[kf_m])
            self._append_kf_pos(self.global_pose[:2, 2])
            self._add_node_edge(err if idx > 0 else 1.0)
            self.stats.scans += 1
        self._pending.clear()

    def finish(self):
        """Drain in-flight results; call after the last step() before
        reading trajectory / kf_points / stats."""
        if self._pending:
            self._drain()

    def _push_keyframe(self, sp, sm, err):
        """Scan-to-scan mode's per-scan bookkeeping: history, node/edge,
        paint."""
        self.trajectory.append(self.global_pose.copy())
        kf_p, kf_m = voxel_downsample_fixed(sp, sm, self.kf_voxel,
                                            self.kf_cap)
        spans.count("sync.scaled.kf_read", 2)
        self.kf_points.append(kf_p.cpu().numpy()[kf_m.cpu().numpy()])
        self._append_kf_pos(self.global_pose[:2, 2])
        cur_idx = self._add_node_edge(err)
        t0 = time.perf_counter()
        self._paint(kf_p, kf_m, self._t(self.global_pose[:2, :2]),
                    self._t(self.global_pose[:2, 2]))
        self._painted_T.append(self.global_pose.copy())
        self.stats.wall_mapping += time.perf_counter() - t0
        self.stats.scans += 1
        return cur_idx

    def _step_legacy(self, sp, sm):
        """Scan-to-scan mode (submap_keyframes=0), initialized with the
        previous increment (reference slam.py:465-494)."""
        if not self.trajectory:
            self._prev = (sp, sm)
            self._push_keyframe(sp, sm, 1.0)
            return
        t0 = time.perf_counter()
        pp, pm = self._prev
        inc_init = _inv(self._prev_inc)
        res = icp_large(pp, pm, sp, sm, self._t(inc_init[:2, :2]),
                        self._t(inc_init[:2, 2]), **self._icp_kw)
        R, t, err, iters, dropped = self.mesh.broadcast(
            (res.R, res.t, res.error, res.iters, res.dropped))
        spans.count("sync.scaled.legacy_read", 5)
        err = float(err)
        self.stats.icp_iters += int(iters)
        self.stats.reg_dropped_points += int(dropped)
        T_inc = _mat(R.cpu().numpy(), t.cpu().numpy())
        pose_new = (self.global_pose @ _inv(T_inc)).astype(np.float32)
        self.stats.wall_registration += time.perf_counter() - t0

        pose_new = _ortho(pose_new)
        self._prev_inc = _ortho(_inv(self.global_pose) @ pose_new)
        self.global_pose = pose_new
        self._prev = (sp, sm)
        cur_idx = self._push_keyframe(sp, sm, err)
        if (cur_idx >= self.lc_min_interval
                and cur_idx % self.lc_every == 0):
            self._check_loop(cur_idx)

    # ── loop closure (reference gates, slam.py:231-268) ──────────────────
    def _lc_verify(self, ap, am, bp, bm):
        """Verify one candidate keyframe b against the current keyframe a
        (both padded to kf_capacity, sensor frames). Returns (ICPResult
        with both passes' iterations, inlier error, inlier fraction)."""
        Rs, ts, _ = rotation_search(
            ap, am, bp, bm, voxel_size=self._sweep_voxel,
            angle_step_coarse=3.0, angle_step_fine=0.5)
        kw = dict(method="point_to_point", max_iterations=self._lc_iters,
                  use_gate=True)
        r1 = icp_core(ap, am, bp, bm, Rs, ts, max_corr_dist=self._lc_coarse,
                      **kw)
        r2 = icp_core(ap, am, bp, bm, r1.R, r1.t,
                      max_corr_dist=self._lc_fine, **kw)
        # keyframes metres apart overlap only partly: score the gated
        # inliers and their fraction, not the all-points mean error
        tr = ap @ r2.R.T + r2.t
        nn_d, _ = nn_query(tr, bp, bm, am)
        sq = nn_d * nn_d            # inf on masked rows (BIG squared)
        inl = (sq < self._lc_fine * self._lc_fine) & am
        n_in = inl.to(torch.float32).sum()
        # a select, not sq * inl: inf * 0 would be NaN (XLA turns icp_tpu's
        # product into this select)
        ierr = torch.where(inl, sq, 0.0).sum() / torch.clamp(n_in, min=1.0)
        frac = n_in / torch.clamp(am.to(torch.float32).sum(), min=1.0)
        return r2._replace(iters=r1.iters + r2.iters), ierr, frac

    @spans.spanned("scaled.closure_check")
    def _try_loop_closure(self, cur_idx: int) -> bool:
        if (self.lc_cooldown > 0 and self._last_lc_accept is not None
                and cur_idx - self._last_lc_accept < self.lc_cooldown):
            return False
        n = self._n_kf
        pos = self._kf_xy[:n]
        cur = pos[cur_idx]
        idx = np.arange(n)
        dist = np.linalg.norm(pos - cur, axis=1)
        travel = self._trav[cur_idx] - self._trav[:n]
        ok = ((cur_idx - idx >= self.lc_min_interval)
              & (dist < self.lc_distance)
              & (travel >= self.lc_min_travel))
        cands = idx[ok]
        if cands.size == 0:
            return False
        # sorted by distance, top max_candidates (reference slam.py:267-268)
        order = cands[np.argsort(dist[cands], kind="stable")]
        cands = [int(c) for c in order[:self.lc_max_candidates]]
        self.stats.lc_checked += 1
        self.stats.lc_candidates += len(cands)
        spans.count("scaled.lc_checks")
        spans.count("scaled.lc_lanes", len(cands))

        site = "sync.scaled.lc_upload"
        ap, am = (self._t(a, site=site) for a in pad_points(
            self.kf_points[cur_idx], self.kf_cap))
        lanes = []
        for c in cands:
            bp, bm = (self._t(a, site=site) for a in pad_points(
                self.kf_points[c], self.kf_cap))
            res, ierr, frac = self._lc_verify(ap, am, bp, bm)
            lanes.append(torch.cat([res.R.reshape(-1), res.t, ierr[None],
                                    frac[None], res.iters[None].float()]))
        lanes, = self.mesh.broadcast([torch.stack(lanes)])
        spans.count("sync.scaled.lc_read")
        lanes = lanes.cpu().numpy()                   # one read for all
        self.stats.icp_iters += int(lanes[:, 8].sum())

        # accept-first in candidate (distance) order (reference
        # slam.py:575-597)
        for k, cand in enumerate(cands):
            err = float(lanes[k, 6])
            if err >= self.lc_error_threshold or \
                    float(lanes[k, 7]) < self.lc_min_frac:
                continue
            r_lc, t_lc = lanes[k, :4].reshape(2, 2), lanes[k, 4:6]
            # edge z = vec(T_lc^-1) (reference slam.py:583-593)
            z = np.array([
                *(-r_lc.T @ t_lc),
                -np.arctan2(r_lc[1, 0], r_lc[0, 0]),
            ], np.float32)
            w = self.lc_info_scale / max(err, 1e-6)
            if self.lc_info_cap > 0:
                w = min(w, self.lc_info_cap)
            self.pose_graph.add_edge(
                cur_idx, cand, z, np.eye(3, dtype=np.float32) * w,
                robust=self.lc_robust)
            self.stats.loop_closures += 1
            spans.count("scaled.lc_accepts")
            self._last_lc_accept = cur_idx
            return True
        return False

    # ── bundle adjustment ────────────────────────────────────────────────
    @spans.spanned("scaled.ba")
    def _run_ba(self, n_iterations: int):
        """Optimize the graph and carry the corrections into the run state:
        trajectory, current pose, keyframe positions and travel, the submap
        ring, the device pose carry, and the map (marked dirty; repainted at
        the next read)."""
        spans.count("scaled.ba_nodes", self.pose_graph.n_nodes)
        self.pose_graph.optimize(n_iterations=n_iterations, fix_node=0)
        self.stats.ba_iterations += n_iterations
        self.stats.ba_runs += 1
        self._accepts_since_ba = 0
        corrected = self.pose_graph.get_poses_as_matrices()
        n = len(self.trajectory)
        self.trajectory = [m.copy() for m in corrected[:n]]
        self.global_pose = self.trajectory[-1].copy()
        self._set_kf_pos(np.stack(self.trajectory)[:, :2, 2])
        if n >= 2:
            self._prev_inc = (_inv(self.trajectory[-2])
                              @ self.trajectory[-1]).astype(np.float32)
        self._rebuild_ring()
        if self._register:
            self._set_dev_carry(self.trajectory[-1], self._prev_inc)
        self._map_dirty = True

    def optimize(self, n_iterations: int = 20):
        """Terminal BA over the whole keyframe graph, then the map repaint
        from the corrected poses (reference slam.py:601-620)."""
        self.finish()
        t0 = time.perf_counter()
        self._run_ba(n_iterations)
        self.stats.wall_ba += time.perf_counter() - t0
        self.sync_map()

    def warm_replay(self):
        """Run one replay chunk on throwaway blocks, so the first sync_map
        after BA does not pay the allocator's first growth to that size."""
        C = self.replay_chunk
        blocks = self.blocks
        self.blocks = self._zero_blocks()
        eye = torch.eye(2, dtype=torch.float32, device=self.device)
        self._replay(
            torch.zeros((C, self.kf_cap, 2), dtype=torch.float32,
                        device=self.device),
            torch.zeros((C, self.kf_cap), dtype=torch.bool,
                        device=self.device),
            eye.expand(C, 2, 2),
            torch.zeros((C, 2), dtype=torch.float32, device=self.device), 1.0)
        self.blocks = blocks
        self._sync_devices()

    def _replay_set(self, idxs, poses, sign: float):
        """Paint (sign=+1) or un-paint (sign=-1) the given keyframes at
        the given poses, in replay_chunk-sized batches. Host-side chunk
        assembly is timed apart (stats.wall_replay_fill)."""
        spans.count("scaled.replay_keyframes", len(idxs))
        C = self.replay_chunk
        site = "sync.scaled.replay_upload"
        for c0 in range(0, len(idxs), C):
            tf = time.perf_counter()
            group = idxs[c0:c0 + C]
            B = len(group)
            pts = np.zeros((B, self.kf_cap, 2), np.float32)
            msk = np.zeros((B, self.kf_cap), bool)
            Rs = np.zeros((B, 2, 2), np.float32)
            ts = np.zeros((B, 2), np.float32)
            for k, gi in enumerate(group):
                kf = self.kf_points[gi]
                pts[k, :len(kf)] = kf
                msk[k, :len(kf)] = True
                T = poses[gi]
                Rs[k] = T[:2, :2]
                ts[k] = T[:2, 2]
            self.stats.wall_replay_fill += time.perf_counter() - tf
            self._replay(*(self._t(a, site=site) for a in (pts, msk, Rs, ts)),
                         sign)

    @spans.spanned("scaled.replay")
    def sync_map(self):
        """Bring the grid in line with the corrected keyframe poses if BA
        has run since the last paint (the reference's _rebuild_map,
        slam.py:271-277), incrementally: keyframes whose pose moved past a
        tolerance (0.3 cell in translation, the equivalent arc at max range
        in rotation) are un-painted at the pose they were painted at and
        repainted at the new one; when more than half moved, the grid is
        zeroed and replayed whole, the steps still in flight bookkept
        first (their paint is in the grid dropped)."""
        if not self._map_dirty:
            return
        t0 = time.perf_counter()
        K = len(self.kf_points)
        if len(self._painted_T) != K:
            # unknown paint provenance (legacy checkpoint): full rebuild
            moved = np.arange(max(K, 1))
        elif K:
            cur = np.stack(self.trajectory[:K])
            old = np.stack(self._painted_T)
            d_t = np.linalg.norm(cur[:, :2, 2] - old[:, :2, 2], axis=1)
            d_yaw = np.abs((np.arctan2(cur[:, 1, 0], cur[:, 0, 0])
                            - np.arctan2(old[:, 1, 0], old[:, 0, 0])
                            + np.pi) % (2 * np.pi) - np.pi)
            tol_t = 0.3 * self.resolution
            tol_y = tol_t / max(self.max_range, 1e-6)
            moved = np.where((d_t > tol_t) | (d_yaw > tol_y))[0]
        else:
            moved = np.zeros(0, np.int64)
        full = len(moved) > 0.5 * K
        if full:
            if self._pending:
                self._drain()
                K = len(self.kf_points)
            self.blocks = self._zero_blocks()
            self._replay_set(list(range(K)), self.trajectory, +1.0)
            self._painted_T = [self.trajectory[k].copy() for k in range(K)]
        elif len(moved):
            mv = [int(k) for k in moved]
            self._replay_set(mv, self._painted_T, -1.0)   # exact un-paint
            self._replay_set(mv, self.trajectory, +1.0)
            for k in mv:
                self._painted_T[k] = self.trajectory[k].copy()
        self._sync_devices()                      # honest timing
        self.stats.wall_replay += time.perf_counter() - t0
        self.stats.replayed_keyframes += K if full else int(len(moved))
        self._map_dirty = False

    def time_gn_step(self, reps: int = 5) -> float:
        """Seconds a GN step on the current graph takes, the first call
        excluded, by the strategy ``PoseGraph2D.optimize`` would take on
        the mesh (``schur_within_limits``): the Schur step, else the PCG
        step (``gn_step_strategy`` says which), as a solve runs it: its
        segment plans built once, outside the timed steps. The host's
        partition time goes into ``stats.partition_wall``."""
        from icp_tpu_torch.parallel.dist_pose_graph import (
            _pad_edges, cg_plans, gn_step_cg_sharded, gn_step_schur_sharded,
            partition_graph, schur_shards, schur_within_limits)
        self.finish()
        pg = self.pose_graph
        nodes, node_mask, ei, ej, z, om, em, rb = pg._packed()
        t0 = time.perf_counter()
        part = partition_graph(nodes.shape[0], ei, ej, z, om, em,
                               self.mesh.size, 0, robust=rb)
        self.stats.partition_wall = time.perf_counter() - t0
        nd, nm = self._t(nodes), self._t(node_mask)
        rphi = float(pg.robust_phi)
        if not schur_within_limits(
                part, max_separators=pg._max_separators,
                cg_node_threshold=pg._cg_node_threshold,
                dense_budget=pg._schur_dense_budget):
            self.gn_step_strategy = "cg"
            ei_, ej_, z_, om_, em_, rb_ = _pad_edges(
                self.mesh, *pg._packed_device()[2:])
            plans = cg_plans(self.mesh, nd.shape[0], ei_, ej_, em_)

            def fn():
                return gn_step_cg_sharded(self.mesh, nd, nm, ei_, ej_, z_,
                                          om_, em_, 0, rb_, rphi,
                                          cg_iters=100, plans=plans)
        else:
            self.gn_step_strategy = "schur"
            shards = schur_shards(self.mesh, part, nd.shape[0])

            def fn():
                return gn_step_schur_sharded(self.mesh, nd, nm, part, rphi,
                                             shards=shards)
        fn().cpu()                           # first call, synchronized
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        out.cpu()
        return (time.perf_counter() - t0) / reps

    # ── checkpoint / resume (icp_tpu's npz keys) ─────────────────────────
    def save_checkpoint(self, path: str):
        """Persist the pipeline state (poses, keyframes, graph, grid, LC/BA
        bookkeeping) to one npz, in icp_tpu's keys: either package loads
        the other's checkpoints."""
        self.finish()
        n = len(self.kf_points)
        lens = np.array([len(p) for p in self.kf_points], np.int64)
        flat = (np.concatenate(self.kf_points) if n
                else np.zeros((0, 2), np.float32))
        pg = self.pose_graph
        # submap mode carries the increment on the device; derive the last
        # increment from the drained trajectory
        if n >= 2:
            prev_inc = _ortho(_inv(self.trajectory[-2])
                              @ self.trajectory[-1])
        else:
            prev_inc = self._prev_inc
        np.savez_compressed(
            path,
            poses=np.stack(self.trajectory)
            if n else np.zeros((0, 3, 3), np.float32),
            kf_lens=lens,
            kf_flat=flat,
            travel=self._trav[:self._n_kf].copy(),
            prev_inc=prev_inc,
            log_odds=self.log_odds.cpu().numpy(),
            map_dirty=np.array([self._map_dirty]),
            painted_T=(np.stack(self._painted_T) if self._painted_T
                       else np.zeros((0, 3, 3), np.float32)),
            pg_ei=np.array(pg._edges_i, np.int32),
            pg_ej=np.array(pg._edges_j, np.int32),
            pg_z=(np.stack(pg._edges_z) if pg.n_edges
                  else np.zeros((0, 3), np.float32)),
            pg_om=(np.stack(pg._edges_om) if pg.n_edges
                   else np.zeros((0, 3, 3), np.float32)),
            pg_rb=np.array(pg._edges_rb, bool),
            stats=np.array([self.stats.scans, self.stats.loop_closures,
                            self.stats.gate_fallbacks, self.stats.ba_runs,
                            self._accepts_since_ba,
                            self._last_lc_accept
                            if self._last_lc_accept is not None else -1,
                            self._n_seen,
                            self.stats.icp_iters, self.stats.lc_checked,
                            self.stats.lc_candidates,
                            self.stats.reg_dropped_points,
                            self.stats.ba_iterations], np.int64),
        )

    def load_checkpoint(self, path: str):
        """Restore state saved by save_checkpoint (of either package) and
        resume step() after it. The graph's nodes are rebuilt from the
        trajectory (nodes are the poses here), then the ring and the device
        pose carry."""
        d = np.load(path)
        poses = d["poses"].astype(np.float32)
        self.trajectory = [poses[k].copy() for k in range(len(poses))]
        self.kf_points = []
        off = 0
        flat = d["kf_flat"].astype(np.float32)
        for ln in d["kf_lens"]:
            self.kf_points.append(flat[off:off + ln])
            off += ln
        self._set_kf_pos(np.stack(self.trajectory)[:, :2, 2]
                         if self.trajectory
                         else np.zeros((0, 2), np.float32))
        self._prev_inc = d["prev_inc"].astype(np.float32)
        self.global_pose = (self.trajectory[-1].copy() if self.trajectory
                            else np.eye(3, dtype=np.float32))
        self.log_odds = self._t(d["log_odds"].astype(np.float32))
        self._map_dirty = bool(d["map_dirty"][0])
        if "painted_T" in d and len(d["painted_T"]) == len(self.trajectory):
            pt = d["painted_T"].astype(np.float32)
            self._painted_T = [pt[k].copy() for k in range(len(pt))]
        else:
            # paint provenance unknown: sync_map rebuilds the grid
            self._painted_T = []
            self._map_dirty = True
        self.pose_graph = self._new_graph(self.pose_graph.robust_phi)
        for T in self.trajectory:
            self.pose_graph.add_node(np.array(
                [T[0, 2], T[1, 2], np.arctan2(T[1, 0], T[0, 0])],
                np.float32))
        rbs = (d["pg_rb"] if "pg_rb" in d
               else np.zeros(len(d["pg_ei"]), bool))
        for i, j, z, om, rb in zip(d["pg_ei"], d["pg_ej"], d["pg_z"],
                                   d["pg_om"], rbs):
            self.pose_graph.add_edge(int(i), int(j), z, om,
                                     robust=bool(rb))
        st = d["stats"]
        self.stats.scans = int(st[0])
        self.stats.loop_closures = int(st[1])
        self.stats.gate_fallbacks = int(st[2])
        self.stats.ba_runs = int(st[3])
        self._accepts_since_ba = int(st[4])
        self._last_lc_accept = None if int(st[5]) < 0 else int(st[5])
        self._n_seen = int(st[6])
        if len(st) > 7:                    # counters added later
            self.stats.icp_iters = int(st[7])
            self.stats.lc_checked = int(st[8])
            self.stats.lc_candidates = int(st[9])
            self.stats.reg_dropped_points = int(st[10])
            self.stats.ba_iterations = int(st[11])
        self._pending = []
        self._pending_event = None
        self._rebuild_ring()
        if self._register and self.trajectory:
            self._set_dev_carry(self.trajectory[-1], self._prev_inc)
        elif self.trajectory:
            # scan-to-scan mode registers against the previous RAW scan,
            # which checkpoints do not keep
            raise NotImplementedError(
                "checkpoint resume requires submap mode "
                "(submap_keyframes > 0); scan-to-scan mode would need "
                "the last raw scan")

    def map_probability(self) -> np.ndarray:
        """The probability grid (host array) after replaying any pending
        post-BA corrections; the clamp to [lo_min, lo_max] applies here."""
        self.finish()
        self.sync_map()
        lo = np.clip(self.log_odds.cpu().numpy(), self.lo_min, self.lo_max)
        return 1.0 - 1.0 / (1.0 + np.exp(lo))
