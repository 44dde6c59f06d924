"""What the benchmarks of icp_tpu_torch share: the bench sequence, the
configurations of ``bench.py`` and of ``benchmarks/bench_suite.py``'s
pipeline rows, the card line, device resolution and the kernels' launch
counters. ``chip_smoke.py`` imports its configurations from here.
"""
from __future__ import annotations

import contextlib
import copy
import os
import subprocess
import sys

import numpy as np
import torch

# bench.py's sequence: 200 scans x 720 beams of the synthetic loop, seed 42
N_SCANS, N_BEAMS, BATCH = 200, 720, 16

# bench.py's configuration (BASELINE config #3: IMU + submap, no loop closure)
BENCH_CFG = {
    "imu": {"enabled": True, "narrow_search_range": 3.0},
    "icp": {"method": "point_to_line", "normal_k": 16, "voxel_size": 0.04,
            "error_threshold": 1e-10, "max_iterations": 150,
            "error_reject_threshold": 0.5},
    "features": {"method": "rotation_search", "rotation_voxel_size": 0.15,
                 "angle_step_coarse": 1.5, "angle_step_fine": 0.1},
    "submap": {"enabled": True, "size": 40, "voxel_size": 0.05,
               "max_corr_dist": 1.5, "rotation_range": 60.0,
               "rotation_step": 0.8, "rotation_fine_step": 0.05,
               "rotation_voxel_size": 0.15},
    "loop_closure": {"enabled": False},
    "filter": {"z_min": 0.5, "z_max": 2.0},
    "mapping": {"resolution": 0.05, "margin": 50.0},
    "service": {"loop": False},
    "display": {"live_map": False},
    "tpu": {"scan_capacity": 768, "submap_capacity": 4096,
            "max_ray_cells": 448, "batch_scans": BATCH, "nn_impl": "auto",
            # one card even where more are visible; chip_smoke's mesh phase
            # sets true
            "distributed": False},
}
# benchmarks/bench_suite.py's loop-closure section (its "lc" row)
LC_SECTION = {"enabled": True, "distance_threshold": 3.0, "min_interval": 80,
              "min_cumulative_travel": 6.0, "max_candidates": 5,
              "error_threshold": 0.08, "optimization_iterations": 30,
              "information_scale": 5.0, "cooldown": 30}
# benchmarks/bench_suite.py's features section (its "features" row runs it
# without IMU, submap on, loop closure off)
FEAT_SECTION = {"method": "features", "rotation_voxel_size": 0.15,
                "angle_step_coarse": 1.5, "angle_step_fine": 0.1,
                "voxel_size": 0.1, "k_curvature": 10, "top_n": 100,
                "min_kp_dist": 0.2, "k_descriptor": 16, "ratio_threshold": 0.8,
                "ransac_iterations": 512, "inlier_threshold": 0.3,
                "min_inliers": 4}

# launch-counter keys (read_counts) -> kernel names in the JSON lines
KERNEL_NAMES = {"nn": "nn_cuda", "nn_min": "nn_min_cuda",
                "segment_add": "icp_segment_add"}


def log(*a):
    """Progress to stderr: a benchmark's standard output is its JSON."""
    print(*a, file=sys.stderr, flush=True)


def gpu_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def card_line(dev: torch.device) -> str:
    """``gpu_line()`` on a card; on the CPU, says so with its core count."""
    if dev.type == "cuda":
        return gpu_line()
    return f"cpu ({os.cpu_count()} cores)"


def resolve_device(name: str = "cuda") -> torch.device:
    """The device a benchmark runs on: the card unless the caller asks for
    the CPU. Never falls back: without a card, "cuda" raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("this benchmark runs on a CUDA card and "
                           "torch.cuda.is_available() is False; pass "
                           "--device cpu to run it on the CPU")
    return dev


def synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sync_mesh(mesh) -> None:
    """``synchronize`` every device of a ``parallel.mesh.Mesh``."""
    for dev in dict.fromkeys(mesh.devices):
        synchronize(dev)


def add_device_args(ap) -> None:
    """The mesh entry points' device flags: ``--device`` (default cuda)
    and ``--virtual-devices N``, the counterpart of XLA's
    ``--xla_force_host_platform_device_count``."""
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    ap.add_argument("--virtual-devices", type=int, default=0, metavar="N",
                    help="run the mesh on N virtual shards of the device "
                         "(parallel.mesh.set_virtual_devices): correctness "
                         "and collective overhead, not scaling")


@contextlib.contextmanager
def virtual_shards(n: int, dev: torch.device):
    """``set_virtual_devices(n, dev)`` for the block (nothing if n is 0),
    cleared after it. A card without an index means the current one."""
    from icp_tpu_torch.parallel.mesh import set_virtual_devices

    if not n:
        yield
        return
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    set_virtual_devices(n, dev)
    try:
        yield
    finally:
        set_virtual_devices(0, dev)


def reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def peak_mb(dev: torch.device):
    """Peak device memory (MiB) since ``reset_peak``; None on the CPU."""
    return (torch.cuda.max_memory_allocated(dev) / 2**20
            if dev.type == "cuda" else None)


def sequence_paths(directory: str, n_scans: int = N_SCANS,
                   n_beams: int = N_BEAMS) -> tuple[str, str, str]:
    """(lidar csv, imu csv, ground-truth npy) of a bench sequence: bench.py's
    names for its own size, the size in the names for any other."""
    tag = "bench" if (n_scans, n_beams) == (N_SCANS, N_BEAMS) \
        else f"bench{n_scans}x{n_beams}"
    return tuple(os.path.join(directory, f"{tag}_{k}")
                 for k in ("lidar.csv", "imu.csv", "gt.npy"))


def load_sequence(directory: str, n_scans: int = N_SCANS,
                  n_beams: int = N_BEAMS):
    """The bench sequence (noise 0.005, "loop", seed 42), written into
    ``directory`` and reused where it is already there, as bench.py does.
    Returns (ground truth, filtered scans, relative times, IMUService)."""
    from icp_tpu_torch.engine import filter_and_flatten
    from icp_tpu_torch.services.imu import IMUService
    from icp_tpu_torch.services.lidar import LidarService
    from icp_tpu_torch.utils.synth import generate_sequence

    lidar_csv, imu_csv, gt_npy = sequence_paths(directory, n_scans, n_beams)
    if not all(os.path.exists(p) for p in (lidar_csv, imu_csv, gt_npy)):
        os.makedirs(directory, exist_ok=True)
        log(f"generating the bench sequence ({n_scans} x {n_beams}) in "
            f"{directory} ...")
        np.save(gt_npy, generate_sequence(
            lidar_csv, imu_csv, n_scans=n_scans, n_beams=n_beams,
            noise=0.005, trajectory="loop", seed=42))
    gt = np.load(gt_npy)
    scans, rels = [], []
    for _, rel, raw in LidarService(lidar_csv).scans():
        scans.append(filter_and_flatten(raw, BENCH_CFG["filter"]["z_min"],
                                        BENCH_CFG["filter"]["z_max"]))
        rels.append(rel)
    return gt, scans, rels, IMUService(imu_csv)


def _env_tpu() -> dict:
    """The tpu knobs bench.py and bench_suite.py read from the environment:
    BENCH_RAY (an int or "auto"), BENCH_BATCH, BENCH_NN ("auto": the hand
    kernels; "xla": the plain query, an A/B knob)."""
    ray = os.environ.get("BENCH_RAY", "448")
    return {"max_ray_cells": ray if ray == "auto" else int(ray),
            "batch_scans": int(os.environ.get("BENCH_BATCH", BATCH)),
            "nn_impl": os.environ.get("BENCH_NN", "auto")}


def headline_config(tpu: dict | None = None) -> dict:
    """bench.py's configuration with its environment knobs; ``tpu`` updates
    the tpu section (a smaller size)."""
    cfg = copy.deepcopy(BENCH_CFG)
    cfg["tpu"].update(_env_tpu(), **(tpu or {}))
    return cfg


def pipeline_config(submap: bool, lc: bool, method: str = "rotation_search",
                    use_imu: bool = True, tpu: dict | None = None) -> dict:
    """bench_suite._run_pipeline's configuration: bench.py's, with the
    features section (``method`` in it), the loop-closure section (enabled
    by ``lc``), the submap on or off and the IMU on or off; BENCH_NN only
    of the knobs, as the suite reads it."""
    cfg = copy.deepcopy(BENCH_CFG)
    cfg["imu"]["enabled"] = use_imu
    cfg["features"] = dict(FEAT_SECTION, method=method)
    cfg["submap"]["enabled"] = submap
    cfg["loop_closure"] = dict(LC_SECTION, enabled=lc)
    cfg["tpu"]["nn_impl"] = os.environ.get("BENCH_NN", "auto")
    cfg["tpu"].update(tpu or {})
    return cfg


def reset_counts():
    """Every kernel wrapper's launch counter to 0."""
    from icp_tpu_torch.ops import scatter as SC
    from icp_tpu_torch.ops.hopper import nn_kernel as K

    K.reset_launch_counts()
    SC.reset_launch_counts()


def read_counts() -> dict:
    """{kernel key: launches since reset_counts()}."""
    from icp_tpu_torch.ops import scatter as SC
    from icp_tpu_torch.ops.hopper import nn_kernel as K

    return {"nn": K.nn_launches, "nn_min": K.nn_min_launches,
            "segment_add": SC.segment_add_launches}


def launch_fields(counts: dict, n_scans: int | None = None) -> dict:
    """``kernel_launches`` ({kernel: launches}) of a JSON line and, given
    the scans they served, ``kernel_launches_per_scan``."""
    out = {"kernel_launches": {KERNEL_NAMES[k]: v for k, v in counts.items()}}
    if n_scans:
        out["kernel_launches_per_scan"] = {
            KERNEL_NAMES[k]: v / n_scans for k, v in counts.items()}
    return out


def large_world(n_points=100_000, seed=11):
    """benchmarks/bench_suite.py's 100k-point world: random wall segments in
    a 200 m arena (a copy: the port imports nothing of benchmarks/)."""
    rng = np.random.default_rng(seed)
    n_walls = 200
    starts = rng.uniform(-100, 100, (n_walls, 2))
    horiz = rng.integers(0, 2, n_walls).astype(bool)
    lengths = rng.uniform(10, 30, n_walls)
    per = n_points // n_walls
    pts = []
    for s, h, L in zip(starts, horiz, lengths):
        t = rng.uniform(0, L, per)
        pts.append(np.stack([s[0] + np.where(h, t, 0.0),
                             s[1] + np.where(h, 0.0, t)], axis=1))
    cloud = np.concatenate(pts).astype(np.float32)
    cloud += rng.normal(scale=0.02, size=cloud.shape).astype(np.float32)
    return cloud
