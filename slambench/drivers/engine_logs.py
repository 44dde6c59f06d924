"""Closed loop over recorded logs through ``SlamEngine``: an offline
mapping service working through drives.

The logs are a fixed pool of drives (``frozen.synth.generate_log``, each
from its own seed counted from the traffic's ``pool_seed``): the first
``ate_logs`` in order, then the ``cycle`` others round after round, each
round in an order drawn from ``--seed``, so every run maps the same
drives and its ATE is of the same ones. A fresh
engine maps each log: scan 0 alone (``process_scan``), then batches of
``batch`` scans (``process_scans_batched``), then ``finish``; the next log
starts at once. The window runs from the first hand-over until
``seconds`` have passed, then ends with ``finish`` on the log in hand and a
device synchronize.

The engine's host-side record is read, never changed: the harness wraps
the engine object's bound ``_bookkeep_fused`` and ``_lc_apply`` to note
each scan's outputs and each accepted closure as the program produces
them. After the window ``compare.engine`` judges them against the plain
reference.
"""
from __future__ import annotations

import gc
import math
import os
import tempfile
import time

import numpy as np

from slambench import harness as H
from slambench.frozen import synth
from slambench.frozen.metrics import ate
from slambench.trace import Tracer


def _imu_service(IMUService, text: str):
    """The program's IMU service over a log's IMU CSV."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "imu.csv")
        with open(path, "w") as f:
            f.write(text)
        return IMUService(path)


class LogRecord:
    """One log's inputs and what the program reported on it."""

    def __init__(self, seed, scans, rel, imu_csv, gt):
        self.seed, self.scans, self.rel, self.gt = seed, scans, rel, gt
        self.imu_csv = imu_csv
        self.engine = None
        self.batches = []          # scan indices of each hand-over call
        self.steps = {}            # scan -> outputs at bookkeeping
        self.closures = []         # accepted closures, in order
        self.handed = []           # per scan handed: host time
        self.accounted = []        # per scan handed: host time (or nan)
        self.complete = False
        self.marked = 0            # scans with an accounted time
        self.history = []          # (scan, pose) of each node, at the end


def _watch(eng, rec: LogRecord, ring: int):
    """Note each bookkept scan's outputs, the ring of keyframes its
    registration saw, and each accepted closure with the poses before and
    after it, by wrapping the engine object's bound methods."""
    bookkeep, lc_apply = eng._bookkeep_fused, eng._lc_apply

    def bookkeep_noted(points_2d, out_pose, out_error, out_accepted,
                       out_sub, out_err_inc, out_iters):
        prev = eng.scan_history[-1]
        ring_now = [(r.scan_idx, r.pose) for r in eng.scan_history[-ring:]]
        ok = bookkeep(points_2d, out_pose, out_error, out_accepted, out_sub,
                      out_err_inc, out_iters)
        rec.steps[eng.stats.scans] = dict(
            pose=np.array(out_pose, np.float64), err=float(out_error),
            accepted=bool(ok), sub=bool(out_sub), ring=ring_now,
            prev=(prev.scan_idx, prev.pose))
        return ok

    def lc_apply_noted(cur_idx, cand_idx, cand_dist, r_lc, t_lc, err_lc):
        hist = eng.scan_history
        pre = [(r.scan_idx, r.pose) for r in hist]
        out = lc_apply(cur_idx, cand_idx, cand_dist, r_lc, t_lc, err_lc)
        rec.closures.append(dict(
            cur=int(cur_idx), cand=int(cand_idx),
            r=np.array(r_lc, np.float64), t=np.array(t_lc, np.float64),
            err=float(err_lc), pre=pre,
            post=[(r.scan_idx, r.pose) for r in hist]))
        return out

    eng._bookkeep_fused = bookkeep_noted
    eng._lc_apply = lc_apply_noted


def run(*, config, traffic, limits, seed, seconds, trace, device,
        t_process, control=False):
    import torch

    from icp_tpu_torch.engine import SlamEngine
    from icp_tpu_torch.services.imu import IMUService
    from icp_tpu_torch.utils.config import SlamConfig

    from slambench.compare.engine import check

    dev = torch.device(device)
    if dev.type == "cuda":
        from icp_tpu_torch.ops.hopper import build
        build.load_all()
    cfg = SlamConfig.from_dict(config["program"])
    B = int(cfg.batch_scans)
    per_log = int(traffic["scans_per_log"])
    n_logs = int(math.ceil(seconds * traffic["max_scans_per_s"] / per_log))
    # a pool of recorded drives, the same for every run: the warm log, the
    # first ``ate_logs`` logs in that order, then the ``cycle`` other logs
    # over and over, each round in an order drawn from --seed: every seed
    # maps the same drives, in another order
    n_ate, n_cycle = int(traffic["ate_logs"]), int(traffic["cycle"])
    pool = traffic["pool_seed"] + np.arange(1 + n_ate + n_cycle)
    rng = np.random.default_rng(seed & (2**63 - 1))
    rounds = -(-max(n_logs - n_ate, 0) // n_cycle)
    seeds = np.concatenate([pool[:1 + n_ate]] + [
        rng.permutation(pool[1 + n_ate:]) for _ in range(rounds)])
    made = {}
    for s in pool:
        made[int(s)] = synth.generate_log(
            int(s), n_scans=per_log, n_beams=traffic["beams"],
            noise=traffic["noise"], world=traffic["world"],
            trajectory=traffic["trajectory"])
    logs = [LogRecord(int(s), *made[int(s)]) for s in seeds]
    imu_of = {s: _imu_service(IMUService, made[s][2]) for s in made}
    imus = [imu_of[lg.seed] for lg in logs]
    warm, logs, warm_imu, imus = logs[0], logs[1:], imus[0], imus[1:]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # warm-up on an engine of its own: scan 0, a batch, and the engine's
    # own warm-up of every device path (a closure's verification, the map
    # replay, a pose-graph solve)
    eng = SlamEngine(cfg, imu=warm_imu, verbose=False, device=dev)
    eng.process_scan(warm.scans[0], int(warm.rel[0]))
    eng.process_scans_batched(warm.scans[1:1 + B],
                              [int(r) for r in warm.rel[1:1 + B]])
    eng.finish()
    eng.warmup()
    sync()
    del eng
    # the harness's own set-up objects leave the collector's rounds
    gc.collect()
    gc.freeze()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    def walls():
        engines = [lg.engine for lg in logs if lg.engine is not None]
        return {"engine.wall_registration": sum(
                    e.stats.wall_registration for e in engines),
                "engine.wall_loop_closure": sum(
                    e.stats.wall_loop_closure for e in engines),
                "engine.scans": sum(lg.marked for lg in logs)}

    tracer = Tracer(trace, dev, start=traffic["trace_start_call"],
                    count=traffic["trace_calls"], snapshot=walls)
    ring = int(cfg.submap_size)
    out = H.Run()
    t0 = time.perf_counter()
    out.setup_s = t0 - t_process
    deadline = t0 + seconds
    done = False
    used = 0
    for lg, imu in zip(logs, imus):
        used += 1
        with tracer.call("logs.new_engine"):
            eng = SlamEngine(cfg, imu=imu, verbose=False, device=dev)
        _watch(eng, lg, ring)
        lg.engine = eng
        calls = [[0]] + [list(range(k, min(k + B, per_log)))
                         for k in range(1, per_log, B)]
        for idx in calls:
            th = time.perf_counter()
            with tracer.call("logs.process_scan" if idx == [0] else
                             "logs.process_scans_batched", len(idx)):
                if idx == [0]:
                    eng.process_scan(lg.scans[0], int(lg.rel[0]))
                else:
                    eng.process_scans_batched(
                        [lg.scans[i] for i in idx],
                        [int(lg.rel[i]) for i in idx])
            tr = time.perf_counter()
            lg.batches.append(idx)
            lg.handed += [th] * len(idx)
            _mark(lg, eng, tr)
            if tr >= deadline:
                done = True
                break
        with tracer.call("logs.finish"):
            eng.finish()
        _mark(lg, eng, time.perf_counter())
        lg.complete = len(lg.handed) == per_log
        st = eng.stats
        out.notes.append(
            f"log {used}: {len(lg.handed)} scans in "
            f"{time.perf_counter() - lg.handed[0]:.3f} s, "
            f"{st.icp_iters} ICP iterations, {st.lc_checks} closure checks "
            f"of {st.lc_pairs} pairs, {st.lc_requeued_scans} scans "
            f"re-queued, {st.loop_closures} closures, {st.rejected} "
            f"rejected")
        if done:
            break
    else:
        raise RuntimeError(
            f"the run used all {len(logs)} logs made for it before "
            f"{seconds} s: raise the traffic's max_scans_per_s")
    sync()
    t1 = time.perf_counter()
    tracer.close()
    out.window_s = t1 - t0
    if dev.type == "cuda":
        out.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    logs = logs[:used]

    handed = np.concatenate([lg.handed for lg in logs])
    acc = np.concatenate([lg.accounted for lg in logs])
    out.handed, out.accounted = handed, acc
    out.attempted = len(handed)
    out.failed = int((~np.isfinite(acc)).sum())
    out.rejected = sum(e.stats.rejected for e in
                       (lg.engine for lg in logs))
    out.walls = tracer.without_slice(walls())
    out.trace = tracer.summary
    note = tracer.slowdown_note(out.window_s, out.attempted)
    if note:
        out.notes.append(note)
    # a traced run reports no ATE: its profiled slice may take the time
    # the window would have completed the ATE logs in
    if not trace:
        if sum(lg.complete for lg in logs[:n_ate]) < n_ate:
            raise RuntimeError(
                f"ATE is taken over the first {n_ate} logs and the window "
                f"completed {sum(lg.complete for lg in logs)}")
        sq, n = 0.0, 0
        for lg in logs[:n_ate]:
            e = lg.engine
            a = ate(np.stack(e.pose_trajectory)[:, :2, 2], lg.gt,
                    e.pose_scan_indices)
            k = len(e.pose_trajectory)
            sq += a * a * k
            n += k
        out.ate_m = math.sqrt(sq / n)
    out.notes.append(
        f"{len(logs)} logs ({sum(lg.complete for lg in logs)} complete), "
        f"{out.attempted} scans handed over, {out.failed} not accounted "
        f"for, {out.rejected} rejected by the gate, "
        f"{sum(len(lg.closures) for lg in logs)} closures")
    eng = None          # the check frees the engines once it has read them
    check(out, logs, config, traffic, limits, seed, dev, control)
    return out


def _mark(lg: LogRecord, eng, t: float) -> None:
    """Scans the engine now accounts for (scan 0 and each bookkept one)
    take ``t`` if they had no time yet."""
    lg.accounted += [math.nan] * (len(lg.handed) - len(lg.accounted))
    n = min(1 + eng.stats.scans, len(lg.handed))
    for i in range(lg.marked, n):
        lg.accounted[i] = t
    lg.marked = max(lg.marked, n)
