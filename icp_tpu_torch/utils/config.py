"""YAML config system — the same schema as icp_tpu.utils.config.

One YAML file drives both packages: every knob, the ``tpu:`` section
included, is read with the same key and default as ``icp_tpu`` reads it
(which in turn follows the reference's ``cfg.get(key, default)``,
reference slam.py:283-346). ``yaml`` is imported only inside
``load_config``, so ``SlamConfig.from_dict`` works without PyYAML.
"""
from __future__ import annotations

from dataclasses import dataclass, field


def load_config(path: str = "config.yaml") -> dict:
    """Reference: load_config (reference slam.py:19-21)."""
    import yaml

    with open(path, "r") as f:
        return yaml.safe_load(f) or {}


def _get(cfg: dict, section: str, key: str, default):
    return (cfg.get(section) or {}).get(key, default)


@dataclass
class SlamConfig:
    """Flattened view of the YAML dict with reference defaults.

    Defaults match reference slam.py:283-346 (code defaults, which the
    reference prefers over config.yaml values when keys are absent).
    """

    raw: dict = field(default_factory=dict)

    # data
    data_file: str = "data/ugvlidar-full.csv"
    num_scans: int | None = None
    process_every_n: int = 1

    # imu
    imu_enabled: bool = False
    imu_file: str = ""
    imu_narrow: float = 5.0

    # icp
    icp_method: str = "point_to_line"
    icp_normal_k: int = 10
    icp_voxel: float = 0.06
    icp_error_threshold: float = 1e-7
    icp_max_iterations: int = 100
    error_reject_threshold: float = 0.5

    # features / pre-alignment
    alignment_method: str = "rotation_search"
    rotation_voxel_size: float = 0.3
    angle_step_coarse: float = 2.0
    angle_step_fine: float = 0.2
    feat_voxel: float = 0.2
    k_curvature: int = 10
    top_n: int = 100
    min_kp_dist: float = 0.3
    k_descriptor: int = 30
    ratio_threshold: float = 0.8
    ransac_iterations: int = 1000
    inlier_threshold: float = 0.5
    min_inliers: int = 3

    # submap
    submap_enabled: bool = True
    submap_size: int = 30
    submap_voxel: float = 0.06
    sub_rot_range: float = 90.0
    sub_rot_step: float = 1.0
    sub_rot_fine: float = 0.2
    sub_rot_voxel: float = 0.25
    sub_corr_dist: float = 0.5

    # loop closure
    lc_enabled: bool = False
    lc_distance: float = 3.0
    lc_min_interval: int = 20
    lc_max_candidates: int = 3
    lc_error_threshold: float = 0.03
    lc_opt_iters: int = 20
    lc_info_scale: float = 10.0
    lc_min_travel: float = 20.0
    # new vs reference: suppress further closures for this many keyframes
    # after an accepted one. The reference re-closes on EVERY scan while
    # the robot sits in a revisited area (slam.py:565-620), piling up
    # correlated edges whose measurement bias drags the optimized
    # trajectory; 0 keeps reference behavior.
    lc_cooldown: int = 0
    # new vs reference: robustify LC edges. The reference weights a
    # closure by scale/max(err, 1e-6) (slam.py:583-597) — a near-perfect
    # re-match (err ~ 1e-4) gets weight ~1e5 and single-handedly drags the
    # optimized trajectory. information_cap bounds that weight at edge
    # creation (0 = uncapped reference behavior); robust: true flags LC
    # edges for DCS reweighting inside the optimizer
    # (models.pose_graph.robust_omega), with chi2 scale robust_phi.
    lc_info_cap: float = 0.0
    lc_robust: bool = False
    lc_robust_phi: float = 1.0

    # filter
    z_min: float = 0.2
    z_max: float = 2.0

    # mapping
    map_resolution: float = 0.1
    map_margin: float = 50.0
    p_hit: float = 0.7
    p_miss: float = 0.4
    log_odds_min: float = -5.0
    log_odds_max: float = 5.0

    # service
    sleep_s: float = 0.0
    loop: bool = True

    # output
    out_csv: str = "tmp/occupancy_grid.csv"
    out_npy: str = "tmp/occupancy_grid.npy"

    # display: live_map=true opens an interactive matplotlib window when a
    # display is available (reference slam.py:416-452 PyVista window), and
    # falls back to periodic PNG snapshots when headless
    live_map: bool = False
    snapshot_every: int = 25
    snapshot_dir: str = "tmp/live"
    window_width: int = 1400
    window_height: int = 1000
    cmap: str = "gray"
    clim_min: float = 0.0
    clim_max: float = 1.0
    background: str = "black"
    trajectory_color: str = "cyan"
    pose_color: str = "lime"
    pose_size: int = 12

    # tpu-specific
    scan_capacity: int = 1024
    submap_capacity: int = 8192
    # int, or "auto" = size the Bresenham step bound from the first scan's
    # max range (x1.5, rounded up to a multiple of 64); later scans that
    # out-range the bound get their free-space marking truncated (counted
    # in stats.truncated_scans, warned once)
    max_ray_cells: int | str = 2048
    # static capacity for the sorted-compaction free-cell scatter (see
    # ops/raytrace._scatter_free): "auto" = 2x the first scan's total
    # Chebyshev ray cells (multiple of 8192); int = use as-is; None/0 =
    # disable compaction (always full-size scatter). Overflow falls back
    # to the exact full scatter in-graph, so this is a perf knob only.
    free_cells_cap: int | str | None = "auto"
    fused: bool = True
    batch_scans: int = 8
    # one deduplicated map update per scan batch instead of per scan
    # (clamp applies per batch; see ops/raytrace.raytrace_update_batched)
    batched_map: bool = True
    # static capacities for the submap rotation-sweep scoring clouds
    # (coarse-voxelized, so far fewer valid slots than the raw capacities;
    # see prealign.submap_rotation_search). "auto" (default) sizes both
    # from the first scan's coarse-voxel count (SlamEngine._resolve_sweep_
    # caps) so headline runs are drop-free; int = use as-is; None ->
    # legacy capacity-derived defaults.
    sweep_src_capacity: int | str | None = "auto"
    sweep_tgt_capacity: int | str | None = "auto"
    # distributed execution (icp_tpu's device mesh, parallel/mesh.py): True
    # needs more than one visible device of the engine's kind, "auto"
    # builds a mesh wherever more than one is visible, False never does
    distributed: bool | str = "auto"
    # node count at which PoseGraph2D.optimize switches from the
    # single-device dense solve to the distributed Schur-complement solve
    # (dense is faster for small graphs; Schur is exact, so the crossover
    # is purely a perf knob)
    dist_node_threshold: int = 1024
    # per-iteration ICP correspondence search. In the port every value but
    # "xla" runs the CUDA NN kernel (ops/hopper/nn_kernel.nn_cuda) on CUDA
    # tensors; "xla" selects the plain torch distance-matrix query.
    nn_impl: str = "auto"

    @classmethod
    def from_dict(cls, cfg: dict) -> "SlamConfig":
        c = cls(raw=cfg)
        c.data_file = cfg.get("data_file", c.data_file)
        c.num_scans = cfg.get("num_scans", None)
        c.process_every_n = cfg.get("process_every_n", 1)

        c.imu_enabled = _get(cfg, "imu", "enabled", False)
        c.imu_file = _get(cfg, "imu", "file", "")
        c.imu_narrow = _get(cfg, "imu", "narrow_search_range", 5.0)

        c.icp_method = _get(cfg, "icp", "method", "point_to_line")
        c.icp_normal_k = _get(cfg, "icp", "normal_k", 10)
        c.icp_voxel = _get(cfg, "icp", "voxel_size", 0.06)
        c.icp_error_threshold = _get(cfg, "icp", "error_threshold", 1e-7)
        c.icp_max_iterations = _get(cfg, "icp", "max_iterations", 100)
        c.error_reject_threshold = _get(cfg, "icp", "error_reject_threshold", 0.5)

        f = cfg.get("features") or {}
        c.alignment_method = f.get("method", "rotation_search")
        c.rotation_voxel_size = f.get("rotation_voxel_size", 0.3)
        c.angle_step_coarse = f.get("angle_step_coarse", 2.0)
        c.angle_step_fine = f.get("angle_step_fine", 0.2)
        c.feat_voxel = f.get("voxel_size", 0.2)
        c.k_curvature = f.get("k_curvature", 10)
        c.top_n = f.get("top_n", 100)
        c.min_kp_dist = f.get("min_kp_dist", 0.3)
        c.k_descriptor = f.get("k_descriptor", 30)
        c.ratio_threshold = f.get("ratio_threshold", 0.8)
        c.ransac_iterations = f.get("ransac_iterations", 1000)
        c.inlier_threshold = f.get("inlier_threshold", 0.5)
        c.min_inliers = f.get("min_inliers", 3)

        s = cfg.get("submap") or {}
        c.submap_enabled = s.get("enabled", True)
        c.submap_size = s.get("size", 30)
        c.submap_voxel = s.get("voxel_size", 0.06)
        c.sub_rot_range = s.get("rotation_range", 90.0)
        c.sub_rot_step = s.get("rotation_step", 1.0)
        c.sub_rot_fine = s.get("rotation_fine_step", 0.2)
        c.sub_rot_voxel = s.get("rotation_voxel_size", 0.25)
        c.sub_corr_dist = s.get("max_corr_dist", 0.5)

        lc = cfg.get("loop_closure") or {}
        c.lc_enabled = lc.get("enabled", False)
        c.lc_distance = lc.get("distance_threshold", 3.0)
        c.lc_min_interval = lc.get("min_interval", 20)
        c.lc_max_candidates = lc.get("max_candidates", 3)
        c.lc_error_threshold = lc.get("error_threshold", 0.03)
        c.lc_opt_iters = lc.get("optimization_iterations", 20)
        c.lc_info_scale = lc.get("information_scale", 10.0)
        c.lc_min_travel = lc.get("min_cumulative_travel", 20.0)
        c.lc_cooldown = lc.get("cooldown", 0)
        c.lc_info_cap = lc.get("information_cap", 0.0)
        c.lc_robust = lc.get("robust", False)
        c.lc_robust_phi = lc.get("robust_phi", 1.0)

        c.z_min = _get(cfg, "filter", "z_min", 0.2)
        c.z_max = _get(cfg, "filter", "z_max", 2.0)

        m = cfg.get("mapping") or {}
        c.map_resolution = m.get("resolution", 0.1)
        c.map_margin = m.get("margin", 50.0)
        c.p_hit = m.get("p_hit", 0.7)
        c.p_miss = m.get("p_miss", 0.4)
        c.log_odds_min = m.get("log_odds_min", -5.0)
        c.log_odds_max = m.get("log_odds_max", 5.0)

        c.sleep_s = _get(cfg, "service", "sleep_s", 0.0)
        c.loop = _get(cfg, "service", "loop", True)

        c.out_csv = _get(cfg, "output", "csv", "tmp/occupancy_grid.csv")
        c.out_npy = _get(cfg, "output", "npy", "tmp/occupancy_grid.npy")

        c.live_map = _get(cfg, "display", "live_map", False)
        c.snapshot_every = _get(cfg, "display", "snapshot_every", 25)
        c.snapshot_dir = _get(cfg, "display", "snapshot_dir", "tmp/live")
        c.window_width = _get(cfg, "display", "window_width", 1400)
        c.window_height = _get(cfg, "display", "window_height", 1000)
        c.cmap = _get(cfg, "display", "cmap", "gray")
        c.clim_min = _get(cfg, "display", "clim_min", 0.0)
        c.clim_max = _get(cfg, "display", "clim_max", 1.0)
        c.background = _get(cfg, "display", "background", "black")
        c.trajectory_color = _get(cfg, "display", "trajectory_color", "cyan")
        c.pose_color = _get(cfg, "display", "pose_color", "lime")
        c.pose_size = _get(cfg, "display", "pose_size", 12)

        t = cfg.get("tpu") or {}
        c.scan_capacity = t.get("scan_capacity", 1024)
        c.submap_capacity = t.get("submap_capacity", 8192)
        c.max_ray_cells = t.get("max_ray_cells", 2048)
        c.free_cells_cap = t.get("free_cells_cap", "auto")
        c.fused = t.get("fused", True)
        c.batch_scans = t.get("batch_scans", 8)
        c.batched_map = t.get("batched_map", True)
        c.sweep_src_capacity = t.get("sweep_src_capacity", "auto")
        c.sweep_tgt_capacity = t.get("sweep_tgt_capacity", "auto")
        c.distributed = t.get("distributed", "auto")
        c.dist_node_threshold = t.get("dist_node_threshold", 1024)
        c.nn_impl = t.get("nn_impl", "auto")
        return c

    @classmethod
    def from_yaml(cls, path: str) -> "SlamConfig":
        return cls.from_dict(load_config(path))
