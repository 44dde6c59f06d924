"""ATE A/B harness (counterpart of tools/ab_ate.py): run bench.py's
configuration on the bench sequence with config overrides and print the
index-aligned ATE and the correction stats.

    python -m icp_tpu_torch.tools.ab_ate                  # base bench config
    python -m icp_tpu_torch.tools.ab_ate sub_rot_fine=0.05 submap_voxel=0.05
    python -m icp_tpu_torch.tools.ab_ate --scans 120 ...  # shorter sequence
    python -m icp_tpu_torch.tools.ab_ate --no-imu ...     # IMU-less A/B

Overrides are ``key=value`` pairs over SlamConfig's fields. The sequence
(200 scans x 720 beams, loop, seed 42) is read from ``data/`` and written
there first when it is missing, as bench.py does. Runs on ``--device``
(default cuda).
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

BENCH_CFG = {
    "data_file": "data/bench_lidar.csv",
    "imu": {"enabled": True, "file": "data/bench_imu.csv",
            "narrow_search_range": 3.0},
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
    "tpu": {"scan_capacity": 768, "submap_capacity": 4096,
            "max_ray_cells": 448, "batch_scans": 16},
}


def apply_overrides(cfg, pairs):
    """Set ``key=value`` pairs on a SlamConfig, each value cast to the
    type of the field's current value."""
    overrides = {}
    for arg in pairs:
        k, v = arg.split("=", 1)
        overrides[k] = v
        cur = getattr(cfg, k)
        if isinstance(cur, bool):
            setattr(cfg, k, v.lower() in ("1", "true"))
        elif isinstance(cur, int):
            setattr(cfg, k, int(v))
        elif isinstance(cur, float):
            setattr(cfg, k, float(v))
        else:
            setattr(cfg, k, v)
    return overrides


def main(argv=None):
    ap = argparse.ArgumentParser(description="ATE A/B on the bench sequence")
    ap.add_argument("overrides", nargs="*", help="key=value config overrides")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    ap.add_argument("--scans", type=int, default=None,
                    help="cut the sequence to its first N scans")
    ap.add_argument("--no-imu", action="store_true",
                    help="run IMU-less, as bench_suite's features row does")
    args = ap.parse_args(argv)

    from icp_tpu_torch.engine import SlamEngine, filter_and_flatten
    from icp_tpu_torch.services.imu import IMUService
    from icp_tpu_torch.services.lidar import LidarService
    from icp_tpu_torch.utils.config import SlamConfig
    from icp_tpu_torch.utils.metrics import ate as ate_fn
    from icp_tpu_torch.utils.synth import generate_sequence

    lidar_csv, imu_csv = BENCH_CFG["data_file"], BENCH_CFG["imu"]["file"]
    gt_npy = "data/bench_gt.npy"
    if not all(os.path.exists(p) for p in (lidar_csv, imu_csv, gt_npy)):
        os.makedirs("data", exist_ok=True)
        np.save(gt_npy, generate_sequence(
            lidar_csv, imu_csv, n_scans=200, n_beams=720, noise=0.005,
            trajectory="loop", seed=42))
    gt = np.load(gt_npy)

    cfg = SlamConfig.from_dict(BENCH_CFG)
    overrides = apply_overrides(cfg, args.overrides)

    scans, rels = [], []
    for _, rel, raw in LidarService(lidar_csv).scans():
        scans.append(filter_and_flatten(raw, cfg.z_min, cfg.z_max))
        rels.append(rel)
    n_scans = len(scans) if args.scans is None else args.scans
    scans, rels = scans[:n_scans], rels[:n_scans]
    imu = None if args.no_imu else IMUService(imu_csv)
    if imu is None:
        cfg.imu_enabled = False

    t0 = time.perf_counter()
    eng = SlamEngine(cfg, imu=imu, verbose=False, device=args.device)
    B = cfg.batch_scans
    eng.process_scan(scans[0], rels[0])
    for k in range(1, len(scans), B):
        eng.process_scans_batched(scans[k:k + B], rels[k:k + B])
    eng.finish()
    wall = time.perf_counter() - t0

    est = np.stack([p[:2, 2] for p in eng.pose_trajectory])
    a = ate_fn(est, gt, indices=eng.pose_scan_indices)
    print(f"overrides={overrides}  ATE={a:.4f} m  "
          f"poses={len(est)}  rejected={eng.stats.rejected}  "
          f"submap_corr={eng.stats.submap_corrections}  "
          f"sweep_drop={eng.stats.sweep_dropped_voxels}  "
          f"wall={wall:.0f}s", flush=True)


if __name__ == "__main__":
    main()
