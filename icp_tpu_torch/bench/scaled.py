"""BASELINE config #5 end to end on icp_tpu_torch (benchmarks/bench_scaled.py):
one ``ScaledPipeline`` run of 100k-point scans registered scan-to-submap,
the occupancy grid row-block-sharded over the mesh, loop closures verified
multi-candidate and bundle-adjusted online, the map replayed from the
corrected poses.

    python -m icp_tpu_torch.bench.scaled [--device cuda] [--virtual-devices N]

Prints ONE JSON line with every key of bench_scaled.py's line (``backend``
is the torch device type) plus ``card`` (name and power limit), the
kernels' launches in the timed region, peak device memory, the pose
graph's LM retries and rejected solves (its divergence guard, coarse
solves included), the stats' walls, ``virtual_devices`` (the shards'
count where ``--virtual-devices`` is in force, else 0: such a line shows
correctness and collective overhead, not scaling), ``timed_wall_s`` and
``stream_ms_per_scan`` (the host's ms a timed scan inside the scan
stream, on the host's clock).

The protocol is bench_scaled.py's: the kernel guard (``startup.check``),
then ``warm_replay``; the scan stream (``large_scan_stream``, seed 3) is
made on the host inside the clock; the clock starts after 3 warm scans
with the card synchronized, the card is synchronized (and progress logged)
every 25 scans, then ``finish`` and a final sync stop it; the graph dump
(if asked), ``time_gn_step(reps=5)`` and ``optimize(n_iterations=15)``
follow. ATE is taken before and after that terminal BA.

One departure from bench_scaled.py's clock: the port's stream finds each
pose's points in range by culling the world's point runs by bounding box
(``utils.synth``) where bench_scaled.py's takes a distance to all 10^6
points. The scans are the same bytes; the stream's share of the clock is
smaller (``stream_ms_per_scan`` says how much it still takes), so rates
compare with bench_scaled.py's, or with this module's before the cull,
only after taking the stream out.

Knobs, read from the environment as bench_scaled.py reads them:
BENCH_SCALED_SCANS (1200), _POINTS (100000), _DEVICES (default: every
visible device of --device's kind, as ``make_mesh``), _METHOD, _SUBMAP,
_BA_EVERY, _TRAJ ("loop" or "eight"), _DUMP_GRAPH (an npz path: the pose
graph after ``finish``, in the keys ``bench.gt_init_ba`` and
benchmarks/gt_init_ba.py read), and the pipeline's own
(``pipeline_kwargs``).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from icp_tpu_torch.bench import common as C

WARM = 3
LOG_EVERY = 25


def pipeline_kwargs(n_scans: int, n_points: int, env=None) -> dict:
    """The ``ScaledPipeline`` keywords of bench_scaled.py (config #5) for
    ``n_scans`` scans of ``n_points`` points, with its environment knobs
    and their defaults (``env``: a mapping, default ``os.environ``)."""
    env = os.environ if env is None else env
    return dict(
        scan_capacity=1 << int(np.ceil(np.log2(n_points))), extent=100.0,
        map_resolution=0.25, map_margin=10.0, max_range=35.0,
        icp_max_corr=1.0, icp_max_iterations=30,
        icp_method=env.get("BENCH_SCALED_METHOD", "point_to_line"),
        icp_grid_shape=(160, 160),
        icp_cell_cap=int(env.get("BENCH_SCALED_CELL_CAP", 64)),
        icp_qcells=int(env.get("BENCH_SCALED_QCELLS", 8192)),
        map_ray_stride=int(env.get("BENCH_SCALED_RAY_STRIDE", 8)),
        kf_capacity=int(env.get("BENCH_SCALED_KF_CAP", 8192)),
        kf_voxel=0.3,
        submap_keyframes=int(env.get("BENCH_SCALED_SUBMAP", 8)),
        lc_every=int(env.get("BENCH_SCALED_LC_EVERY", 8)),
        lc_min_interval=max(50, n_scans // 10),
        lc_distance=15.0, lc_min_travel=60.0, lc_error_threshold=0.05,
        lc_max_candidates=4,
        ba_every=int(env.get("BENCH_SCALED_BA_EVERY", 1)),
        lc_info_cap=float(env.get("BENCH_SCALED_LC_CAP", 1e3)),
        lc_robust=bool(int(env.get("BENCH_SCALED_LC_ROBUST", 1))),
        lc_cooldown=int(env.get("BENCH_SCALED_LC_COOLDOWN", 25)),
        ba_iterations=int(env.get("BENCH_SCALED_BA_ITERS", 10)),
        replay_chunk=int(env.get("BENCH_SCALED_REPLAY_CHUNK", 64)),
        dist_node_threshold=2)


def scan_stream(n_scans: int, n_points: int, trajectory: str = "loop",
                start: int = 0, rng_state=None):
    """bench_scaled.py's scan stream: (sensor-frame scan, ground truth)
    pairs, made one at a time on the host; ``start`` and ``rng_state``
    (the stream's ``state`` after scan ``start - 1``) resume it."""
    from icp_tpu_torch.utils.synth import large_scan_stream

    return large_scan_stream(n_scans, n_points=n_points, extent=100.0,
                             max_range=35.0, noise=0.02, seed=3,
                             trajectory=trajectory, start=start,
                             rng_state=rng_state)


def guard_shapes(kf_capacity: int) -> dict:
    """The kernel guard's ``nn_min_cuda`` case on the scaled paths: one
    angle of a closure check's rotation search, keyframe against keyframe
    (the whole pass, 12 angles, would need a plain version of 12x the
    size)."""
    return {"scaled closure, one angle": (kf_capacity, kf_capacity)}


def dump_graph(path: str, pg, gt: np.ndarray) -> None:
    """The pose graph ``pg`` and ground truth, in bench_scaled.py's keys,
    dtypes and shapes."""
    np.savez_compressed(
        path, nodes=np.stack(pg.nodes),
        ei=np.array(pg._edges_i, np.int32), ej=np.array(pg._edges_j, np.int32),
        z=np.stack(pg._edges_z), om=np.stack(pg._edges_om),
        rb=np.array(pg._edges_rb, bool), robust_phi=np.float32(pg.robust_phi),
        gt=gt)


def run(dev, env=None, probe=None):
    """bench_scaled.py on ``dev`` (knobs from ``env``, default
    ``os.environ``). ``probe(k, pipe)`` runs after step k. Returns (line,
    pipeline, ground truth)."""
    from icp_tpu_torch.bench import startup
    from icp_tpu_torch.parallel.mesh import make_mesh, virtual_count
    from icp_tpu_torch.parallel.scaled import ScaledPipeline
    from icp_tpu_torch.utils.metrics import ate as ate_fn

    env = os.environ if env is None else env
    card = C.card_line(dev)
    n_scans = int(env.get("BENCH_SCALED_SCANS", 1200))
    n_points = int(env.get("BENCH_SCALED_POINTS", 100_000))
    n_dev = int(env.get("BENCH_SCALED_DEVICES", 0)) or make_mesh(
        device=dev).size
    traj = env.get("BENCH_SCALED_TRAJ", "loop")
    kw = pipeline_kwargs(n_scans, n_points, env)
    mesh = make_mesh(n_dev, device=dev)
    C.log(f"devices: {mesh} on {card}; {n_scans} scans x {n_points} pts, "
          f"{kw['icp_method']}, submap={kw['submap_keyframes']}, "
          f"ba_every={kw['ba_every']}, trajectory {traj}")

    t0 = time.perf_counter()
    err = startup.check(dev, guard_shapes(kw["kf_capacity"]))
    C.log(f"kernel guard on {dev}: every kernel equals its plain version "
          f"(max abs err {err}; {time.perf_counter() - t0:.2f} s)")
    C.reset_peak(dev)
    pipe = ScaledPipeline(mesh, **kw)
    pipe.warm_replay()

    def sync():
        pipe.log_odds[:1, :1].cpu()

    stream = scan_stream(n_scans, n_points, traj)
    gt, t0, t_stream = [], None, 0.0
    for k in range(n_scans):
        ts = time.perf_counter()
        scan, g = next(stream)
        if t0 is not None:
            t_stream += time.perf_counter() - ts
        gt.append(g)
        pipe.step(scan)
        if probe is not None:
            probe(k, pipe)
        if k + 1 == WARM:              # the first steps' costs landed
            sync()
            C.reset_counts()
            t0 = time.perf_counter()
        if (k + 1) % LOG_EVERY == 0:
            sync()                     # honest timing
            st = pipe.stats
            C.log(f"  scan {k + 1}/{n_scans}  lc={st.loop_closures}  "
                  f"ba={st.ba_runs}  fb={st.gate_fallbacks}  reg "
                  f"{st.wall_registration:.1f}s  map {st.wall_mapping:.1f}s")
    pipe.finish()
    sync()
    wall = time.perf_counter() - t0
    counts = C.read_counts()
    sps = (n_scans - WARM) / wall
    gt = np.stack(gt)
    ate_stream = ate_fn(np.stack(pipe.trajectory)[:, :2, 2], gt, gt_offset=0)

    dump = env.get("BENCH_SCALED_DUMP_GRAPH")
    if dump:
        pg = pipe.pose_graph
        dump_graph(dump, pg, gt)
        C.log(f"graph dumped to {dump} ({pg.n_nodes} nodes, "
              f"{pg.n_edges} edges)")
    gn_ms = pipe.time_gn_step(reps=5) * 1000
    pipe.optimize(n_iterations=15)
    ate = ate_fn(np.stack(pipe.trajectory)[:, :2, 2], gt, gt_offset=0)

    st = pipe.stats
    pg = pipe.pose_graph
    C.log(f"scans/s {sps:.2f}  reg {st.wall_registration:.1f}s  map "
          f"{st.wall_mapping:.1f}s  lc {st.wall_lc:.1f}s  ba "
          f"{st.wall_ba:.1f}s  replay {st.wall_replay:.1f}s (fill "
          f"{st.wall_replay_fill:.1f}s)  stream "
          f"{1000 * t_stream / (n_scans - WARM):.1f} ms/scan  ATE {ate_stream:.4f} -> {ate:.4f} m"
          f"  GN {gn_ms:.1f} ms  partition {st.partition_wall * 1000:.0f} ms"
          f"  LM retries {pg.lm_retries}, rejected {pg.rejected_solves}")
    line = {
        "metric": "scaled_pipeline_scans_per_sec", "value": sps,
        "unit": "scans/s", "n_scans": n_scans, "points_per_scan": n_points,
        "n_keyframes": len(pipe.kf_points), "n_devices": mesh.size,
        "icp_method": kw["icp_method"],
        "submap_keyframes": kw["submap_keyframes"], "gn_step_ms": gn_ms,
        "partition_ms": st.partition_wall * 1000,
        "ba_strategy": pg.last_strategy,
        "gn_step_strategy": pipe.gn_step_strategy,
        "ate_m": ate, "ate_stream_m": ate_stream,
        "loop_closures": st.loop_closures, "lc_checked": st.lc_checked,
        "ba_runs": st.ba_runs, "gate_fallbacks": st.gate_fallbacks,
        "reg_dropped_points": st.reg_dropped_points,
        "wall_replay_s": st.wall_replay,
        "wall_replay_fill_s": st.wall_replay_fill,
        "replayed_keyframes": st.replayed_keyframes,
        "map_cells": pipe.ny * pipe.nx, "trajectory": traj,
        "backend": dev.type, "card": card,
        "virtual_devices": virtual_count(dev.type),
        "timed_wall_s": wall,
        "stream_ms_per_scan": 1000 * t_stream / (n_scans - WARM),
        "wall_registration_s": st.wall_registration,
        "wall_mapping_s": st.wall_mapping, "wall_lc_s": st.wall_lc,
        "wall_ba_s": st.wall_ba, "lc_candidates": st.lc_candidates,
        "lm_retries": pg.lm_retries, "rejected_solves": pg.rejected_solves,
        "peak_device_mb": C.peak_mb(dev),
        **C.launch_fields(counts, n_scans - WARM)}
    if st.lc_checked:
        line["kernel_launches_per_lc_check"] = {
            C.KERNEL_NAMES[k]: v / st.lc_checked for k, v in counts.items()}
    return line, pipe, gt


def main(argv=None, env=None):
    """Runs the benchmark, prints its line; returns (line, pipeline,
    ground truth)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    C.add_device_args(ap)
    a = ap.parse_args(argv)
    dev = C.resolve_device(a.device)
    with C.virtual_shards(a.virtual_devices, dev):
        out = run(dev, env)
    print(json.dumps(out[0]), flush=True)
    return out


if __name__ == "__main__":
    main()
