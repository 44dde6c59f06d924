"""benchmarks/bench_suite.py's rows on icp_tpu_torch, one JSON line a row,
each with its original keys plus ``card`` and the kernels' launches in its
timed region.

    python -m icp_tpu_torch.bench.suite [names...] [--device cuda]

Rows (default: all, in this order):
  teapot        3-D point-to-point ICP of a known-transformed 418-point
                cloud (``icp``, 300 iterations at most), 20 timed repeats;
  teapot_batch  64 such alignments through ``icp_core``, 100 iterations
                each (error_threshold 0.0). icp_core reads its stop flag on
                the host, so the batch is a Python loop, not a vmap
                (``"batched": "loop"``); 3-D ICP runs on the plain query and
                ``torch.linalg.svd``;
  scan2scan     BASELINE config #2: submap off, loop closure off;
  full          bench.py's pipeline (config #3);
  lc            full plus the loop-closure section, beside the same run
                without it, with the timed region's wall deltas;
  features      no IMU: curvature keypoints, descriptors and RANSAC,
                beside the rotation search;
  icp_large     gated point-to-point ICP at 100k points on the dense grid,
                beside a SciPy cKDTree ICP of the same iterations;
  dist          ``python -m icp_tpu_torch.bench.distributed`` in a
                subprocess, BENCH_PG_NODES 50000 unless the environment
                sets it;
  scaled        ``python -m icp_tpu_torch.bench.scaled`` in a subprocess,
                BENCH_SCALED_SCANS 600 unless the environment sets it.

The pipeline rows run bench_suite's protocol on the 200 x 720 bench
sequence (``data/``): 6 single scans, ``warmup``, 3 warm batches, then
the timed region (full batches; all remaining scans under loop closure).
``dist`` and ``scaled`` get ``--device`` and a 580 s limit; the
subprocess's last line of output is the row, and a subprocess that fails
or runs past the limit is the row's error. A row that fails prints its
error and the suite goes on; the exit code is non-zero if any row failed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from icp_tpu_torch.bench import common as C

REPO = Path(__file__).resolve().parents[2]
SUBPROCESS_TIMEOUT_S = 580
WARM_SCANS, WARM_BATCHES = 6, 3
TEAPOT_CAP, TEAPOT_BATCH = 512, 64


def seq_ate(eng, gt):
    from icp_tpu_torch.utils.metrics import ate

    traj = np.stack(eng.pose_trajectory)
    return ate(traj[:, :2, 2], gt, indices=eng.pose_scan_indices)


def run_pipeline(dev, seq, *, submap, lc, method="rotation_search",
                 use_imu=True, tpu=None):
    """bench_suite._run_pipeline on ``seq`` = (gt, scans, rels, imu).
    Returns (scans/s, engine, its stats at the timed region's start,
    kernel launches in the timed region, scans timed)."""
    from icp_tpu_torch.engine import SlamEngine
    from icp_tpu_torch.utils.config import SlamConfig

    _, scans, rels, imu = seq
    cfg = SlamConfig.from_dict(C.pipeline_config(submap, lc, method,
                                                 use_imu, tpu))
    cfg.num_scans = len(scans)        # lets warmup pin capacity buckets
    eng = SlamEngine(cfg, imu=imu if use_imu else None, verbose=False,
                     device=dev)
    B = cfg.batch_scans
    for k in range(WARM_SCANS):
        eng.process_scan(scans[k], rels[k])
    eng.warmup()
    start = WARM_SCANS + WARM_BATCHES * B
    for k in range(WARM_SCANS, start, B):
        eng.process_scans_batched(scans[k:k + B], rels[k:k + B])
    eng.finish()
    # under loop closure every remaining scan, else full batches only
    n = len(scans) - start if lc else ((len(scans) - start) // B) * B
    s0 = dataclasses.replace(eng.stats)
    C.synchronize(dev)
    C.reset_counts()
    t0 = time.perf_counter()
    for k in range(start, start + n, B):
        eng.process_scans_batched(scans[k:k + B], rels[k:k + B])
    eng.finish()
    C.synchronize(dev)
    wall = time.perf_counter() - t0
    return n / wall, eng, s0, C.read_counts(), n


def _rotation(th):
    return np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                     [-np.sin(th), 0, np.cos(th)]], np.float32)


def bench_teapot(dev, seq=None):
    from icp_tpu_torch.models.icp import icp, identity_init
    from icp_tpu_torch.utils.masking import pad_points

    rng = np.random.default_rng(7)
    target = rng.uniform(-1.5, 1.5, (418, 3)).astype(np.float32)
    src = (target - [0.3, -0.2, 0.25]) @ _rotation(np.deg2rad(25.0))
    sp, sm, tp, tm = (torch.as_tensor(a, device=dev) for a in (
        *pad_points(src.astype(np.float32), TEAPOT_CAP),
        *pad_points(target, TEAPOT_CAP)))
    eye, zero = identity_init(3, dev)

    def align():
        return icp(sp, sm, tp, tm, eye, zero, voxel_size=0.005,
                   method="point_to_point", max_iterations=300,
                   error_threshold=1e-12)

    res = align()
    C.synchronize(dev)
    C.reset_counts()
    t0 = time.perf_counter()
    total_iters = 0
    reps = 20
    for _ in range(reps):
        res = align()
        total_iters += int(res.iters)
    dt = (time.perf_counter() - t0) / reps
    return {"metric": "teapot_icp_iters_per_sec",
            "value": total_iters / reps / dt, "unit": "iters/s",
            "ms_per_align": dt * 1e3, "error": float(res.error),
            **C.launch_fields(C.read_counts())}


def teapot_batch_inputs(B, n=418, cap=TEAPOT_CAP):
    """bench_suite's batch: B clouds of n points in cap slots, each turned
    15-35 degrees about Y and shifted up to 0.3, drawn from rng 7 in its
    order. Returns numpy (src, src mask, tgt, tgt mask), each (B, cap, ...)."""
    from icp_tpu_torch.utils.masking import pad_points

    rng = np.random.default_rng(7)
    out = []
    for _ in range(B):
        t = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
        R = _rotation(np.deg2rad(rng.uniform(15, 35)))
        s = (t - rng.uniform(-0.3, 0.3, 3).astype(np.float32)) @ R
        out.append((*pad_points(s, cap), *pad_points(t, cap)))
    return tuple(np.stack(a) for a in zip(*out))


def teapot_batch_align(dev, sp, sm, tp, tm):
    """The batch's alignments, one icp_core call each (point-to-point, 100
    iterations, error_threshold 0.0); returns their ICPResults."""
    from icp_tpu_torch.models.icp import icp_core, identity_init

    eye, zero = identity_init(3, dev)
    return [icp_core(sp[b], sm[b], tp[b], tm[b], eye, zero,
                     method="point_to_point", max_iterations=100,
                     error_threshold=0.0)
            for b in range(sp.shape[0])]


def bench_teapot_batch(dev, seq=None, reps=5):
    B = TEAPOT_BATCH
    args = [torch.as_tensor(a, device=dev) for a in teapot_batch_inputs(B)]
    res = teapot_batch_align(dev, *args)
    torch.stack([r.error for r in res]).cpu()         # host sync
    C.reset_counts()
    t0 = time.perf_counter()
    for _ in range(reps):
        res = teapot_batch_align(dev, *args)
    errors = torch.stack([r.error for r in res]).cpu().numpy()
    dt = (time.perf_counter() - t0) / reps
    total_iters = int(torch.stack([r.iters for r in res]).sum())
    return {"metric": "teapot_batch_icp_iters_per_sec",
            "value": total_iters / dt, "unit": "iters/s", "batch": B,
            "batched": "loop", "ms_per_batch": dt * 1e3,
            "ms_per_alignment": dt * 1e3 / B,
            "mean_error": float(np.mean(errors)),
            **C.launch_fields(C.read_counts())}


def bench_scan2scan(dev, seq):
    sps, eng, _, counts, n = run_pipeline(dev, seq, submap=False, lc=False)
    return {"metric": "scan2scan_scans_per_sec", "value": sps,
            "unit": "scans/s", "n_scans": n, "ate_m": seq_ate(eng, seq[0]),
            "poses_kept": len(eng.pose_trajectory),
            **C.launch_fields(counts, n)}


def bench_full(dev, seq):
    sps, eng, _, counts, n = run_pipeline(dev, seq, submap=True, lc=False)
    return {"metric": "full_pipeline_scans_per_sec", "value": sps,
            "unit": "scans/s",
            "submap_corrections": eng.stats.submap_corrections,
            "ate_m": seq_ate(eng, seq[0]), "n_scans": n,
            "poses_kept": len(eng.pose_trajectory),
            **C.launch_fields(counts, n)}


def bench_lc(dev, seq):
    """ATE with and without loop closure on the same sequence, and the
    timed region's walls and counters (the warm region's subtracted)."""
    sps, eng, s0, counts, n = run_pipeline(dev, seq, submap=True, lc=True)
    ate_lc = seq_ate(eng, seq[0])
    _, eng_off, _, _, _ = run_pipeline(dev, seq, submap=True, lc=False)
    ate_off = seq_ate(eng_off, seq[0])

    def d(f):
        return getattr(eng.stats, f) - getattr(s0, f)

    return {"metric": "full_config_lc_scans_per_sec", "value": sps,
            "unit": "scans/s", "loop_closures": eng.stats.loop_closures,
            "ate_m": ate_lc, "ate_no_lc_m": ate_off,
            "ate_improvement_m": ate_off - ate_lc,
            "wall_lc_s": d("wall_loop_closure"),
            "lc_requeued_scans": d("lc_requeued_scans"),
            "lc_checks": d("lc_checks"), "lc_pairs": d("lc_pairs"),
            "lc_groups": d("lc_groups"),
            "wall_registration_s": d("wall_registration"), "n_scans": n,
            **C.launch_fields(counts, n)}


def bench_features(dev, seq):
    """features against rotation search, both without IMU."""
    sps_rs, eng_rs, _, _, _ = run_pipeline(dev, seq, submap=True, lc=False,
                                           use_imu=False)
    sps_f, eng, _, counts, n = run_pipeline(dev, seq, submap=True, lc=False,
                                            method="features", use_imu=False)
    return {"metric": "features_pipeline_scans_per_sec", "value": sps_f,
            "unit": "scans/s", "rotation_search_scans_per_sec": sps_rs,
            "ratio_vs_rotation_search": sps_f / sps_rs,
            "ate_m": seq_ate(eng, seq[0]),
            "ate_rotation_search_no_imu_m": seq_ate(eng_rs, seq[0]),
            "n_scans": n, **C.launch_fields(counts, n)}


def bench_icp_large(dev, seq=None):
    """Gated ICP at 100k points on the dense grid (config #5's point
    scale), and a SciPy cKDTree ICP of the same iterations."""
    from scipy.spatial import cKDTree

    from icp_tpu_torch.models.icp import icp_large
    from icp_tpu_torch.utils.masking import pad_points

    base = C.large_world()
    th = 0.04
    R_true = np.array([[np.cos(th), -np.sin(th)],
                       [np.sin(th), np.cos(th)]], np.float32)
    src = (base - np.array([0.4, -0.25], np.float32)) @ R_true
    sp, sm, tp, tm = (torch.as_tensor(a, device=dev) for a in (
        *pad_points(src, 131072), *pad_points(base, 131072)))
    kw = dict(max_corr_dist=1.0, max_iterations=30, error_threshold=0.0,
              grid_shape=(160, 160), cap=64, qcap=64, qcells=4096)
    args = (sp, sm, tp, tm, torch.eye(2, device=dev),
            torch.zeros(2, device=dev))
    res = icp_large(*args, **kw)
    got_th = float(torch.atan2(res.R[1, 0], res.R[0, 0]))
    assert abs(got_th - th) < 2e-3, got_th          # bench_suite's check
    reps = 3
    C.synchronize(dev)
    C.reset_counts()
    t0 = time.perf_counter()
    for _ in range(reps):
        res = icp_large(*args, **kw)
        float(res.error)
    dt = (time.perf_counter() - t0) / reps
    counts = C.read_counts()
    iters = int(res.iters)

    tree = cKDTree(base)
    T_src = src.copy()
    t0 = time.perf_counter()
    for _ in range(iters):
        d, i = tree.query(T_src, distance_upper_bound=1.0)
        ok = np.isfinite(d)
        a, b = T_src[ok], base[i[ok]]
        ma, mb = a.mean(0), b.mean(0)
        U, _, Vt = np.linalg.svd((b - mb).T @ (a - ma))
        Rr = U @ np.diag([1.0, np.linalg.det(U @ Vt)]) @ Vt
        T_src = T_src @ Rr.T + (mb - ma @ Rr.T)
    base_dt = time.perf_counter() - t0
    return {"metric": "icp_large_100k_ms_per_alignment", "value": dt * 1e3,
            "unit": "ms", "iters": iters, "iters_per_sec": iters / dt,
            "baseline_scipy_ms": base_dt * 1e3, "vs_baseline": base_dt / dt,
            "yaw": got_th, **C.launch_fields(counts)}


def run_entry_point(module: str, dev, defaults: dict) -> dict:
    """``python -m module --device dev`` in a subprocess (the package from
    this tree, ``defaults`` under the environment), bench_suite's dist /
    scaled protocol; returns its last line of output. Raises if it fails
    or runs past SUBPROCESS_TIMEOUT_S."""
    env = {**defaults, **os.environ}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    out = subprocess.run(
        [sys.executable, "-m", module, "--device", str(dev)],
        capture_output=True, text=True, env=env,
        timeout=SUBPROCESS_TIMEOUT_S)
    if out.returncode != 0:
        err = out.stderr.strip().splitlines()
        raise RuntimeError(f"{module} exited {out.returncode}: "
                           f"{err[-1] if err else 'no output'}")
    lines = out.stdout.strip().splitlines()
    if not lines:
        raise RuntimeError(f"{module} printed no line")
    return json.loads(lines[-1])


def bench_dist(dev, seq=None):
    return run_entry_point("icp_tpu_torch.bench.distributed", dev,
                           {"BENCH_PG_NODES": "50000"})


def bench_scaled(dev, seq=None):
    return run_entry_point("icp_tpu_torch.bench.scaled", dev,
                           {"BENCH_SCALED_SCANS": "600"})


ROWS = {
    "teapot": bench_teapot,
    "teapot_batch": bench_teapot_batch,
    "scan2scan": bench_scan2scan,
    "full": bench_full,
    "lc": bench_lc,
    "features": bench_features,
    "icp_large": bench_icp_large,
    "dist": bench_dist,
    "scaled": bench_scaled,
}
NEEDS_SEQUENCE = {"scan2scan", "full", "lc", "features"}


def main(argv=None) -> int:
    """Runs the named rows (all by default); returns the exit code: 0 only
    if every row ran."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", help=f"rows: {', '.join(ROWS)}")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    names = a.names or list(ROWS)
    failed = []
    for name in names:
        if name not in ROWS:
            print(json.dumps({"config": name, "error": f"unknown row; rows: "
                              f"{', '.join(ROWS)}"}), flush=True)
            failed.append(name)
    if failed:
        return 1
    dev = C.resolve_device(a.device)
    card = C.card_line(dev)
    seq = C.load_sequence("data") if NEEDS_SEQUENCE & set(names) else None
    for name in names:
        C.log(f"--- {name} ---")
        try:
            row = ROWS[name](dev, seq)
        except Exception as e:    # report it, run the next row, exit non-zero
            traceback.print_exc()
            print(json.dumps({"config": name, "card": card,
                              "error": f"{type(e).__name__}: {e}"}), flush=True)
            failed.append(name)
            continue
        print(json.dumps({**row, "config": name, "card": card}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
