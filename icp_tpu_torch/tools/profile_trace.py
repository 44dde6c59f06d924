"""Profile the steady-state fused batch step under torch.profiler
(counterpart of tools/profile_trace.py).

    python -m icp_tpu_torch.tools.profile_trace [--device cpu] [--batches N]

Runs the bench sequence (200 scans x 720 beams, written into ``data/`` when
missing) through ``SlamEngine``: N warm batches of 16 scans, then N more
under the profiler. Writes a Chrome trace into ``data/trace/`` and prints
the top ops by self time on the device (on the CPU with ``--device cpu``),
from the profiler's own table.
"""
from __future__ import annotations

import argparse
import os

import torch

TRACE_DIR = "data/trace"
CFG = {
    "imu": {"enabled": True, "narrow_search_range": 3.0},
    "icp": {"method": "point_to_line", "normal_k": 12, "voxel_size": 0.04,
            "error_threshold": 1e-10, "max_iterations": 150,
            "error_reject_threshold": 0.5},
    "features": {"method": "rotation_search"},
    "submap": {"enabled": True, "size": 40, "voxel_size": 0.04,
               "max_corr_dist": 1.5, "rotation_fine_step": 0.1,
               "rotation_voxel_size": 0.2},
    "loop_closure": {"enabled": False},
    "filter": {"z_min": 0.5, "z_max": 2.0},
    "mapping": {"resolution": 0.05, "margin": 50.0},
    "display": {"live_map": False},
    "tpu": {"scan_capacity": 768, "submap_capacity": 4096,
            "max_ray_cells": 640, "batch_scans": 16},
}


def main(argv=None):
    ap = argparse.ArgumentParser(description="Profile the fused batch step")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    ap.add_argument("--batches", type=int, default=4,
                    help="batches of 16 scans to warm up with, and to profile")
    args = ap.parse_args(argv)

    from torch.profiler import ProfilerActivity, profile

    from icp_tpu_torch.engine import SlamEngine, filter_and_flatten
    from icp_tpu_torch.services.imu import IMUService
    from icp_tpu_torch.services.lidar import LidarService
    from icp_tpu_torch.utils.config import SlamConfig
    from icp_tpu_torch.utils.synth import generate_sequence

    os.makedirs("data", exist_ok=True)
    lidar_csv, imu_csv = "data/bench_lidar.csv", "data/bench_imu.csv"
    if not (os.path.exists(lidar_csv) and os.path.exists(imu_csv)):
        generate_sequence(lidar_csv, imu_csv, n_scans=200, n_beams=720,
                          noise=0.005, trajectory="loop", seed=42)

    cfg = SlamConfig.from_dict(dict(CFG, data_file=lidar_csv,
                                    imu=dict(CFG["imu"], file=imu_csv)))
    scans, rels = [], []
    for _, rel, raw in LidarService(lidar_csv).scans():
        scans.append(filter_and_flatten(raw, cfg.z_min, cfg.z_max))
        rels.append(rel)

    B, n = cfg.batch_scans, args.batches
    on_card = torch.device(args.device).type == "cuda"
    engine = SlamEngine(cfg, imu=IMUService(imu_csv), verbose=False,
                        device=args.device)

    def run(k0):
        for k in range(k0, k0 + n * B, B):
            engine.process_scans_batched(scans[k:k + B], rels[k:k + B])
        engine.finish()
        if on_card:
            torch.cuda.synchronize()

    engine.process_scan(scans[0], rels[0])
    run(1)
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        run(1 + n * B)
    os.makedirs(TRACE_DIR, exist_ok=True)
    path = os.path.join(TRACE_DIR, "fused_batch_step.trace.json")
    prof.export_chrome_trace(path)
    print(f"trace captured: {path}", flush=True)

    averages = prof.key_averages()
    key = "self_cpu_time_total"
    if on_card:      # the attribute's name before torch 2.4 says "cuda"
        key = ("self_device_time_total"
               if hasattr(averages[0], "self_device_time_total")
               else "self_cuda_time_total")
    # on a card the table lists each kernel and, again, the op that launched
    # it: the total is over the kernels' own rows
    kind = (torch.autograd.DeviceType.CUDA if on_card
            else torch.autograd.DeviceType.CPU)
    total_us = sum(getattr(e, key) for e in averages if e.device_type == kind)
    where = (torch.cuda.get_device_name(0) if on_card else "the CPU")
    print(f"\ntotal self time on {where}: {total_us / 1e3:.2f} ms over "
          f"{n * B} scans ({total_us / 1e3 / (n * B):.3f} ms/scan)")
    print(averages.table(sort_by=key, row_limit=40, max_name_column_width=80))


if __name__ == "__main__":
    main()
