"""Closed loop of dense scans through ``ScaledPipeline``: a robot with a
dense lidar streaming one ``step`` a scan.

The scans are the first ones of a lap of the configuration's named scale
(``frozen.synth.LapStream``), made on the card in set-up: the
configuration's ``keyframes`` of them, more than a window reaches. The
first ``ate_scans`` of them, over which ATE is taken, are the same in
every run; the rest draw their points from ``--seed``. A warm pipeline of
its own steps the first ``warm_scans`` of them. The window steps a fresh
pipeline from scan 0 until ``seconds`` have passed, then ``finish`` and a
device synchronize.

The harness wraps the pipeline object's bound ``_drain`` (never the
program's code): the wrapper times the wait for the pending steps' event
that ``_drain`` starts with, by making that same wait first, and notes
each drained step's gate flag.
"""
from __future__ import annotations

import gc
import time

import numpy as np

from slambench import harness as H
from slambench.frozen import synth
from slambench.frozen.metrics import ate
from slambench.trace import Tracer


def _watch(pipe, walls: dict, gate_ok: list):
    drain = pipe._drain

    def drain_noted():
        ev = pipe._pending_event
        if ev is not None:
            t = time.perf_counter()
            ev.synchronize()
            walls["scaled.drain_wait"] += time.perf_counter() - t
        pending = list(pipe._pending)
        drain()
        gate_ok.extend(bool(out[4]) for out in pending)

    pipe._drain = drain_noted


def run(*, config, traffic, limits, seed, seconds, trace, device,
        t_process, control=False):
    import torch

    from icp_tpu_torch.parallel.scaled import ScaledPipeline

    from slambench.compare.scaled import check

    dev = torch.device(device)
    if dev.type == "cuda":
        from icp_tpu_torch.ops.hopper import build
        build.load_all()
    kw = dict(config["program"])
    kw["icp_grid_shape"] = tuple(kw["icp_grid_shape"])
    # the keyframes a run can reach: the scans made for it
    n = int(config["keyframes"])
    w = config["world"]
    stream = synth.LapStream(seed & (2**63 - 1), config["lap_scans"],
                             n_points=config["points_per_scan"],
                             extent=w["extent"], max_range=w["max_range"],
                             noise=w["noise"], world_seed=w["seed"],
                             world_points=w["points"], walls=w["walls"],
                             head=traffic["ate_scans"],
                             trajectory=traffic["trajectory"], device=dev)
    scans = stream.scans(0, n)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    warm = ScaledPipeline(dev, **kw)
    for k in range(traffic["warm_scans"]):
        warm.step(scans[k])
    warm.finish()
    sync()
    del warm
    # the harness's own set-up objects leave the collector's rounds
    gc.collect()
    gc.freeze()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    out = H.Run()
    walls = {"scaled.drain_wait": 0.0}
    gate_ok: list = []
    pipe = ScaledPipeline(dev, **kw)
    _watch(pipe, walls, gate_ok)

    def snapshot():
        return {"scaled.wall_registration": pipe.stats.wall_registration,
                "scaled.drain_wait": walls["scaled.drain_wait"],
                "scaled.scans": len(pipe.trajectory)}

    tracer = Tracer(trace, dev, start=traffic["trace_start_call"],
                    count=traffic["trace_calls"], snapshot=snapshot)
    handed, acc = [], []

    def mark(t):
        acc.extend([t] * (len(pipe.trajectory) - len(acc)))

    t0 = time.perf_counter()
    out.setup_s = t0 - t_process
    deadline = t0 + seconds
    for k in range(n):
        th = time.perf_counter()
        with tracer.call("scaled.step", 1):
            pipe.step(scans[k])
        tr = time.perf_counter()
        handed.append(th)
        mark(tr)
        if tr >= deadline:
            break
    else:
        raise RuntimeError(f"the run stepped all {n} scans made for it "
                           f"before {seconds} s: raise the configuration's "
                           f"keyframes")
    with tracer.call("scaled.finish"):
        pipe.finish()
    mark(time.perf_counter())
    sync()
    out.window_s = time.perf_counter() - t0
    tracer.close()
    if dev.type == "cuda":
        out.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)

    out.handed = np.asarray(handed)
    out.accounted = np.full(len(handed), np.nan)
    out.accounted[:len(acc)] = acc[:len(handed)]
    out.attempted = len(handed)
    out.failed = int((~np.isfinite(out.accounted)).sum())
    st = pipe.stats
    out.rejected = st.gate_fallbacks
    out.walls = tracer.without_slice(snapshot())
    out.trace = tracer.summary
    note = tracer.slowdown_note(out.window_s, out.attempted)
    if note:
        out.notes.append(note)
    n_ate = int(traffic["ate_scans"])
    traj = np.stack(pipe.trajectory)
    # a traced run reports no ATE: its profiled slice may take the time
    # the window would have reached the ATE scans in
    if not trace:
        if len(traj) < n_ate:
            raise RuntimeError(f"ATE is taken over the first {n_ate} scans "
                               f"and the window accounted for {len(traj)}")
        out.ate_m = ate(traj[:n_ate, :2, 2], stream.gt, np.arange(n_ate))
    out.notes.append(
        f"{out.attempted} scans stepped, {out.failed} not accounted for, "
        f"{st.gate_fallbacks} gate fallbacks, {st.loop_closures} closures, "
        f"{st.lc_checked} closure checks")
    pipe.sync_map()
    grid = pipe.log_odds.cpu().numpy()
    del pipe
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    check(out, traj, grid, scans, gate_ok, config, traffic, limits, seed,
          dev, control)
    return out
