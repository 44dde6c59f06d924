"""Headline benchmark of icp_tpu_torch: bench.py's full-pipeline scans/s
against the NumPy/SciPy baseline, on the card.

    python -m icp_tpu_torch.bench.headline [--device cuda]

Prints ONE JSON line with every key of bench.py's line (``metric``,
``value``, ``unit``, ``timing``, ``mean_scans_per_sec``, ``vs_baseline``,
``baseline_scans_per_sec``, ``ate_m``, ``rpe_trans_m``, ``rpe_rot_deg``,
``baseline_ate_m``, ``n_scans``, ``backend``) plus ``card`` (name and
power limit), ``poses_kept``, ``nn_impl``, the kernels' launches in the
timed region (``kernel_launches``, and per timed scan), and each pass's
rate.

The protocol is bench.py's (BASELINE config #3 on the 200 x 720 bench
sequence, ``data/bench_*``, written once and reused):

* the kernel guard (``startup.check``) before any timing;
* a pass: a fresh ``SlamEngine``, scan 0 alone, 3 warm batches of B,
  ``finish``; then only full batches are timed, ``finish`` included, the
  device synchronized before each clock read;
* 3 passes; the line gives the best and the mean;
* the baseline (``benchmarks/baseline_np.py``, loaded by its path) warmed
  on 44 scans, timed on 20 and run to the end for its ATE.

Knobs, read from the environment as bench.py reads them: BENCH_RAY,
BENCH_BATCH, BENCH_NN (``xla`` runs the plain query: an A/B knob, never the
default) and BENCH_ENGINE_ONLY (no baseline; the line's metric is
``engine_only_scans_per_sec``).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import time
from pathlib import Path

import numpy as np

from icp_tpu_torch.bench import common as C

BASELINE_PATH = Path(__file__).resolve().parents[2] / "benchmarks" / "baseline_np.py"
# bench.py's baseline configuration: the engine's accuracy profile
BASELINE_CFG = {
    "method": "point_to_line", "normal_k": 16, "voxel_size": 0.04,
    "error_threshold": 1e-10, "max_iterations": 150,
    "error_reject_threshold": 0.5,
    "rotation_voxel_size": 0.15, "angle_step_coarse": 1.5,
    "angle_step_fine": 0.1,
    "submap_enabled": True, "submap_size": 40, "submap_voxel": 0.05,
    "sub_corr_dist": 1.5, "sub_rot_range": 60.0, "sub_rot_step": 0.8,
    "sub_rot_fine": 0.05, "sub_rot_voxel": 0.15, "imu_narrow": 3.0,
}
WARM_BATCHES = 3


def load_baseline():
    """benchmarks/baseline_np.py (NumPy and SciPy only), by its path."""
    if not BASELINE_PATH.exists():
        raise FileNotFoundError(f"the NumPy baseline is not at {BASELINE_PATH}")
    spec = importlib.util.spec_from_file_location("baseline_np", BASELINE_PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_pass(cfg, imu, scans, rels, dev):
    """One pass of bench.py's protocol on a fresh engine. Returns (engine,
    scans timed, scans/s, kernel launches in the timed region)."""
    from icp_tpu_torch.engine import SlamEngine

    B = cfg.batch_scans
    eng = SlamEngine(cfg, imu=imu, verbose=False, device=dev)
    eng.process_scan(scans[0], rels[0])
    for k in range(1, 1 + WARM_BATCHES * B, B):
        eng.process_scans_batched(scans[k:k + B], rels[k:k + B])
    eng.finish()
    start = 1 + WARM_BATCHES * B
    n = ((len(scans) - start) // B) * B     # full batches only
    C.synchronize(dev)
    C.reset_counts()
    t0 = time.perf_counter()
    for k in range(start, start + n, B):
        eng.process_scans_batched(scans[k:k + B], rels[k:k + B])
    eng.finish()
    C.synchronize(dev)
    wall = time.perf_counter() - t0
    return eng, n, n / wall, C.read_counts()


def run(dev, *, n_scans=C.N_SCANS, n_beams=C.N_BEAMS, base_warm=44,
        base_scans=20, passes=3, data_dir="data", engine_only=False,
        tpu=None) -> dict:
    """bench.py on ``dev``; returns the line. ``tpu`` updates the
    configuration's tpu section (a smaller size)."""
    from icp_tpu_torch.bench import startup
    from icp_tpu_torch.utils.config import SlamConfig
    from icp_tpu_torch.utils.metrics import ate, rpe

    card = C.card_line(dev)
    gt, scans, rels, imu = C.load_sequence(data_dir, n_scans, n_beams)
    C.log(f"{len(scans)} scans, mean {np.mean([len(s) for s in scans]):.0f} "
          f"points; {card}")
    cfg = SlamConfig.from_dict(C.headline_config(tpu))

    t0 = time.perf_counter()
    err = startup.check(dev, startup.main_sweep_shapes(cfg, scans[0], dev))
    C.log(f"kernel guard on {dev}: every kernel equals its plain version "
          f"(max abs err {err}; {time.perf_counter() - t0:.2f} s)")

    rates = []
    for _ in range(passes):
        eng, n_timed, rate, counts = run_pass(cfg, imu, scans, rels, dev)
        rates.append(rate)
    best, mean = max(rates), float(np.mean(rates))
    C.log(f"engine: best {best:.2f} / mean {mean:.2f} scans/s over {passes} "
          f"passes of {n_timed} scans (submap_corr="
          f"{eng.stats.submap_corrections}); launches {counts}")

    traj = np.stack(eng.pose_trajectory)
    ate_m = ate(traj[:, :2, 2], gt, indices=eng.pose_scan_indices)
    rpe_t, rpe_r = rpe(traj, gt, indices=eng.pose_scan_indices)
    shared = {"ate_m": ate_m, "rpe_trans_m": rpe_t,
              "rpe_rot_deg": float(np.degrees(rpe_r)),
              "n_scans": n_timed, "poses_kept": len(traj),
              "pass_scans_per_sec": rates, "nn_impl": cfg.nn_impl,
              **C.launch_fields(counts, n_timed),
              "backend": dev.type, "card": card}
    if engine_only:
        return {"metric": "engine_only_scans_per_sec", "value": best,
                "unit": "scans/s", "mean": mean, **shared}

    baseline = load_baseline()
    imu_yaws = np.array([imu.yaw_at(r) for r in rels])
    base = baseline.BaselineSlam(BASELINE_CFG, imu_yaws=imu_yaws)
    for k in range(base_warm):
        base.step(scans[k])
    t0 = time.perf_counter()
    for k in range(base_warm, base_warm + base_scans):
        base.step(scans[k])
    base_wall = time.perf_counter() - t0
    for k in range(base_warm + base_scans, len(scans)):
        base.step(scans[k])
    base_rate = base_scans / base_wall
    base_ate = ate(np.stack([p[:2, 2] for p in base.trajectory]), gt,
                   indices=base.traj_indices)
    C.log(f"numpy baseline: {base_rate:.2f} scans/s ({base_wall:.1f} s for "
          f"{base_scans} scans), ATE {base_ate:.4f} m; ours {ate_m:.4f} m")
    return {"metric": "full_pipeline_scans_per_sec", "value": best,
            "unit": "scans/s",
            "timing": f"best of {passes} passes (fresh engine each)",
            "mean_scans_per_sec": mean, "vs_baseline": best / base_rate,
            "baseline_scans_per_sec": base_rate, "baseline_ate_m": base_ate,
            **shared}


def main(argv=None, *, tpu=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    ap.add_argument("--scans", type=int, default=C.N_SCANS,
                    help="length of the bench sequence")
    ap.add_argument("--beams", type=int, default=C.N_BEAMS)
    ap.add_argument("--base-warm", type=int, default=44,
                    help="baseline scans before its timed ones")
    ap.add_argument("--base-scans", type=int, default=20,
                    help="baseline scans timed")
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--data-dir", default="data")
    a = ap.parse_args(argv)
    line = run(C.resolve_device(a.device), n_scans=a.scans, n_beams=a.beams,
               base_warm=a.base_warm, base_scans=a.base_scans,
               passes=a.passes, data_dir=a.data_dir,
               engine_only=bool(os.environ.get("BENCH_ENGINE_ONLY")), tpu=tpu)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
