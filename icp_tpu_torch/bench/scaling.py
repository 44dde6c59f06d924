"""Scans/s of config #5 by mesh size on icp_tpu_torch
(benchmarks/bench_scaling.py): the same scaled-pipeline workload run at
each mesh size, one JSON line a mesh.

    python -m icp_tpu_torch.bench.scaling [--device cuda] [--virtual-devices N]

``parallel.mesh.init_distributed`` runs first: it joins a multi-process
run from JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID and
does nothing in one process. Each line has bench_scaling.py's keys
(``backend`` is the torch device type, ``n_processes`` the
torch.distributed world size or 1, ``virtual_devices`` whether
``--virtual-devices`` is in force: such lines show correctness and
collective overhead, NOT speedup, since the shards share one device) plus
``card``, the kernels' launches in the timed region and peak device
memory. ``efficiency_vs_smallest`` (scans/s over the first mesh's) is on
every mesh after the first.

Protocol (bench_scaling.run_one's): the scans are made once on the host
(``large_scan_stream``, seed 3, the loop); at each mesh size a fresh
pipeline takes them all, the clock starting after 3 warm scans with the
card synchronized and stopping after ``finish`` and a sync; then
``time_gn_step(reps=3)``. Knobs: BENCH_SCALING_MESHES ("1,2,4,8", clipped
to the visible devices of --device's kind, and in a run of W processes to
the multiples of W), BENCH_SCALING_SCANS (120), BENCH_SCALING_POINTS
(16384).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch.distributed as dist

from icp_tpu_torch.bench import common as C
from icp_tpu_torch.bench.scaled import WARM, guard_shapes

KF_CAPACITY = 4096


def pipeline_kwargs(n_scans: int, n_points: int) -> dict:
    """bench_scaling.run_one's ``ScaledPipeline`` keywords for ``n_scans``
    scans of ``n_points`` points (every keyword it leaves out keeps the
    pipeline's default, icp_tpu's)."""
    return dict(
        scan_capacity=1 << int(np.ceil(np.log2(n_points))), extent=100.0,
        map_resolution=0.25, map_margin=10.0, max_range=35.0,
        icp_max_corr=1.0, icp_max_iterations=30, icp_method="point_to_line",
        icp_grid_shape=(160, 160), icp_cell_cap=64, icp_qcells=8192,
        map_ray_stride=8, kf_capacity=KF_CAPACITY, kf_voxel=0.3,
        lc_every=8, lc_min_interval=max(50, n_scans // 10),
        lc_distance=15.0, lc_min_travel=60.0, lc_error_threshold=0.05,
        dist_node_threshold=2)


def run_one(dev, n_dev: int, scans, base_sps=None):
    """One mesh size: (line, scans/s, pipeline)."""
    from icp_tpu_torch.parallel.mesh import make_mesh, virtual_count
    from icp_tpu_torch.parallel.scaled import ScaledPipeline

    n_points = scans[0].shape[0]
    mesh = make_mesh(n_dev, device=dev)
    C.reset_peak(dev)
    pipe = ScaledPipeline(mesh, **pipeline_kwargs(len(scans), n_points))
    t0 = None
    for k, scan in enumerate(scans):
        pipe.step(scan)
        if k + 1 == WARM:
            C.sync_mesh(mesh)
            C.reset_counts()
            t0 = time.perf_counter()
    pipe.finish()
    C.sync_mesh(mesh)
    wall = time.perf_counter() - t0
    counts = C.read_counts()
    sps = (len(scans) - WARM) / wall
    gn_ms = pipe.time_gn_step(reps=3) * 1000
    line = {
        "metric": "scaling_efficiency", "n_devices": mesh.size, "value": sps,
        "unit": "scans/s", "gn_step_ms": gn_ms,
        "gn_step_strategy": pipe.gn_step_strategy, "n_scans": len(scans),
        "points_per_scan": int(n_points),
        "n_processes": dist.get_world_size() if dist.is_initialized() else 1,
        "backend": dev.type, "virtual_devices": virtual_count(dev.type) > 0,
        "card": C.card_line(dev), "timed_wall_s": wall,
        "loop_closures": pipe.stats.loop_closures,
        "peak_device_mb": C.peak_mb(dev),
        **C.launch_fields(counts, len(scans) - WARM)}
    if base_sps is not None:
        line["efficiency_vs_smallest"] = sps / base_sps
    return line, sps, pipe


def run(dev, env=None):
    """bench_scaling.py on ``dev``'s devices (knobs from ``env``, default
    ``os.environ``); prints a line a mesh as it goes. Returns [(line,
    pipeline)] in mesh order."""
    from icp_tpu_torch.bench import startup
    from icp_tpu_torch.bench.scaled import scan_stream
    from icp_tpu_torch.parallel.mesh import make_mesh

    env = os.environ if env is None else env
    avail = make_mesh(device=dev).size
    world = dist.get_world_size() if dist.is_initialized() else 1
    meshes = [int(x) for x in env.get("BENCH_SCALING_MESHES",
                                      "1,2,4,8").split(",")]
    # every process holds an equal share of a mesh's shards
    meshes = sorted({m for m in meshes if m <= avail and m % world == 0})
    n_scans = int(env.get("BENCH_SCALING_SCANS", 120))
    n_points = int(env.get("BENCH_SCALING_POINTS", 16384))
    C.log(f"devices available: {avail} ({dev.type}, {C.card_line(dev)}), "
          f"meshes {meshes}, {n_scans} scans x {n_points} pts")
    err = startup.check(dev, guard_shapes(KF_CAPACITY))
    C.log(f"kernel guard on {dev}: every kernel equals its plain version "
          f"(max abs err {err})")
    scans = [s for s, _ in scan_stream(n_scans, n_points)]

    out, base = [], None
    for m in meshes:
        line, sps, pipe = run_one(dev, m, scans, base)
        if base is None:
            base = sps
        C.log(f"  mesh={m}: {sps:.2f} scans/s  gn {line['gn_step_ms']:.3f} ms")
        print(json.dumps(line), flush=True)
        out.append((line, pipe))
    return out


def main(argv=None, env=None):
    """Joins a multi-process run if the environment names one, runs the
    sweep; returns what ``run`` returns."""
    from icp_tpu_torch.parallel.mesh import init_distributed

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    C.add_device_args(ap)
    a = ap.parse_args(argv)
    init_distributed()                      # nothing in one process
    dev = C.resolve_device(a.device)
    with C.virtual_shards(a.virtual_devices, dev):
        return run(dev, env)


if __name__ == "__main__":
    main()
