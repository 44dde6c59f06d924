"""Closed loop of dense scans through ``ScaledPipeline`` on a patrol: a
robot with a dense lidar lapping the same small loop again and again, so
that every lap revisits the last one and the closure checks, the bundle
adjustments (BA) and the map's replay run in the window.

The path is an ellipse of ``lap_scans`` poses (``frozen.synth.
lap_trajectory(lap_scans, extent=path_extent)``) in the configuration's
world; scan k stands at lap pose k mod ``lap_scans`` and draws its points
from (seed, k) (``frozen.synth.LapStream``), made on the card in set-up:
the configuration's ``keyframes`` of them, more than a window reaches. The
scans up to the ATE step draw from the world seed, so every run sees the
same first laps.

Set-up: one pipeline warms its replay (``warm_replay``), steps the first
``setup_scans`` scans (a lap and more), refreshes the map once and calls
``finish``; it must have accepted a closure and run a BA by then, so
every kernel build, CUDA-graph capture and allocator growth of the
closure path lies before the window. The window: the same pipeline steps
on, one ``step`` a scan, and after every ``refresh_every``-th step a map
consumer (a navigation planner refreshing its global map) calls
``sync_map`` and copies ``log_odds`` to the host, until ``seconds`` have
passed and step ``ate_scans`` has returned. ATE is taken over the first
``ate_scans`` poses as they stand when that step returns (it drains and
checks a closure itself).

The harness wraps the pipeline object's bound methods (never the
program's code) to note what the comparison needs: each drained step's
pose, gate flag and the ring it registered against (``_drain``,
``_rebuild_ring``), each accepted closure with the keyframe positions at
its check (``_try_loop_closure``), each BA's graph before and after
(``_run_ba``) and the trajectory at each replay (``sync_map``).
"""
from __future__ import annotations

import gc
import time

import numpy as np

from slambench import harness as H
from slambench.frozen import synth
from slambench.frozen.metrics import ate
from slambench.trace import Tracer

# the program's counters and spans of the closure, BA and replay path,
# noted from a traced slice where the program keeps them
SLICE_COUNTS = ("scaled.lc_checks", "scaled.lc_lanes", "scaled.lc_accepts",
                "scaled.ba_nodes", "scaled.replay_keyframes")
SLICE_SPANS = ("scaled.closure_check", "scaled.ba", "pose_graph.solve",
               "scaled.replay", "icp.core", "icp.large")
# ScaledStats counters reported over the whole window
WINDOW_COUNTS = ("lc_checked", "loop_closures", "ba_runs",
                 "replayed_keyframes")


class PatrolStream(synth.LapStream):
    """``LapStream``'s scans on a lap of ``lap_scans`` poses sized to
    ``path_extent``, repeated: scan k at lap pose k mod ``lap_scans``."""

    def __init__(self, seed, lap_scans, path_extent, n_scans, **kw):
        super().__init__(seed, lap_scans, **kw)
        lap = synth.lap_trajectory(lap_scans, path_extent, kw["trajectory"])
        self.gt = lap[np.arange(int(n_scans)) % int(lap_scans)]


def slice_calls(first: int, start_step: int, steps: int,
                every: int) -> tuple[int, int]:
    """(first call, calls) of the traced slice: ``steps`` step calls from
    the window's ``start_step``-th (from 0) and the refreshes between
    them, where the window's calls are its steps from scan ``first`` and
    a refresh after each scan k with (k + 1) % ``every`` == 0."""
    def refreshes(a, b):          # refreshes after scans a .. b - 1
        return (b // every) - (a // every)
    k0 = first + start_step
    return (start_step + refreshes(first, k0),
            steps + refreshes(k0, k0 + steps - 1))


def _watch(pipe, rec):
    """Wrap ``pipe``'s bound methods to fill ``rec`` (a
    ``compare.patrol.Record``)."""
    S = pipe.submap_kf
    ring: dict = {}
    drain, rebuild = pipe._drain, pipe._rebuild_ring
    closure, ba = pipe._try_loop_closure, pipe._run_ba
    sync_map = pipe.sync_map

    def drain_noted():
        pending = list(pipe._pending)
        k0 = len(pipe.trajectory)
        drain()
        for i, out in enumerate(pending):
            k = k0 + i
            T = pipe.trajectory[k].copy()
            rec.poses[k] = T
            rec.gate_ok[k] = bool(out[4])
            rec.rings[k] = [(j, ring[j]) for j in range(max(0, k - S), k)]
            ring[k] = T

    def rebuild_noted():
        rebuild()
        n = len(pipe.trajectory)
        for i in range(max(0, n - S), n):
            ring[i] = pipe.trajectory[i].copy()

    def closure_noted(cur_idx):
        xy = pipe.kf_pos.astype(np.float64)
        pg = pipe.pose_graph
        n_edges = pg.n_edges
        accepted = closure(cur_idx)
        if accepted:
            e = n_edges
            rec.closures.append({
                "cur": int(pg._edges_i[e]), "cand": int(pg._edges_j[e]),
                "z": pg._edges_z[e].copy(), "xy": xy})
        return accepted

    def ba_noted(n_iterations):
        # the graph's node arrays are replaced, never written, by a solve,
        # and its edge lists only grow: keep references, stacked at the end
        pg = pipe.pose_graph
        nodes, n_edges = list(pg.nodes), pg.n_edges
        out = ba(n_iterations)
        rec.bas.append({"pg": pg, "before": nodes, "after": list(pg.nodes),
                        "edges": n_edges, "phi": float(pg.robust_phi),
                        "iterations": int(n_iterations),
                        "strategy": pg.last_strategy})
        return out

    def sync_map_noted():
        if pipe._map_dirty:
            # the trajectory's pose arrays are replaced, never written
            rec.replays.append(list(pipe.trajectory))
        return sync_map()

    pipe._drain = drain_noted
    pipe.sync_map = sync_map_noted
    pipe._rebuild_ring = rebuild_noted
    pipe._try_loop_closure = closure_noted
    pipe._run_ba = ba_noted


def run(*, config, traffic, limits, seed, seconds, trace, device,
        t_process, control=False):
    import torch

    from icp_tpu_torch.parallel.scaled import ScaledPipeline

    from slambench.compare.patrol import Record, check

    dev = torch.device(device)
    if dev.type == "cuda":
        from icp_tpu_torch.ops.hopper import build
        build.load_all()
    kw = dict(config["program"])
    kw["icp_grid_shape"] = tuple(kw["icp_grid_shape"])
    n = int(config["keyframes"])
    n_ate = int(traffic["ate_scans"])
    first = int(traffic["setup_scans"])
    every = int(traffic["refresh_every"])
    w = config["world"]
    # the scans up to the ATE step (which checks a closure with its own
    # keyframe) are the same in every run
    stream = PatrolStream(seed & (2**63 - 1), traffic["lap_scans"],
                          traffic["path_extent"], n,
                          n_points=config["points_per_scan"],
                          extent=w["extent"], max_range=w["max_range"],
                          noise=w["noise"], world_seed=w["seed"],
                          world_points=w["points"], walls=w["walls"],
                          head=n_ate + 1, trajectory=traffic["trajectory"],
                          device=dev)
    scans = stream.scans(0, n)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rec = Record(first=first)
    pipe = ScaledPipeline(dev, **kw)
    _watch(pipe, rec)
    grid_host = []

    def refresh():
        pipe.sync_map()
        grid_host[:] = [pipe.log_odds.cpu()]

    # a replay chunk on throwaway blocks: the replay's allocations, which
    # set-up's BAs may not move the map far enough to reach
    pipe.warm_replay()
    for k in range(first):
        pipe.step(scans[k])
    refresh()
    pipe.finish()
    sync()
    st = pipe.stats
    if not (st.loop_closures and st.ba_runs):
        raise RuntimeError(
            f"set-up ({first} scans) accepted {st.loop_closures} closures "
            f"and ran {st.ba_runs} BAs: it must reach one of each before "
            f"the window")
    gc.collect()
    gc.freeze()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    out = H.Run()

    def walls():
        return {"scaled.wall_lc": st.wall_lc, "scaled.wall_ba": st.wall_ba,
                "scaled.wall_replay": st.wall_replay,
                "scaled.scans": len(pipe.trajectory)}

    walls0 = walls()
    counts0 = {k: getattr(st, k) for k in WINDOW_COUNTS}
    replays = [0]

    def snapshot():
        return {k: v - walls0[k] for k, v in walls().items()}

    t_start, t_count = slice_calls(first, traffic["trace_start_step"],
                                   traffic["trace_steps"], every)
    tracer = Tracer(trace, dev, start=t_start, count=t_count,
                    snapshot=snapshot)
    handed, acc = [], []
    traj_ate = None

    def mark(t):
        acc.extend([t] * (len(pipe.trajectory) - first - len(acc)))

    t0 = time.perf_counter()
    out.setup_s = t0 - t_process
    deadline = t0 + seconds
    for k in range(first, n):
        th = time.perf_counter()
        with tracer.call("scaled.step", 1):
            pipe.step(scans[k])
        tr = time.perf_counter()
        handed.append(th)
        mark(tr)
        if k == n_ate:
            if len(pipe.trajectory) < n_ate:
                raise RuntimeError(f"step {n_ate} returned with "
                                   f"{len(pipe.trajectory)} poses drained")
            traj_ate = np.stack(pipe.trajectory[:n_ate])
        if (k + 1) % every == 0:
            done = st.replayed_keyframes
            with tracer.call("scaled.map_refresh"):
                refresh()
            replays[0] += st.replayed_keyframes > done
            mark(time.perf_counter())
        if time.perf_counter() >= deadline and k >= n_ate:
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
    out.rejected = st.gate_fallbacks
    whole = snapshot()
    out.walls = tracer.without_slice(whole)
    # counts over the whole window
    out.walls.update({f"scaled.window_{k}": getattr(st, k) - v
                      for k, v in counts0.items()})
    out.walls["scaled.window_replays"] = replays[0]
    out.trace = tracer.summary
    note = tracer.slowdown_note(out.window_s, out.attempted)
    if note:
        out.notes.append(note)
    if trace:
        _note_slice_counts(out)
    # a traced run reports no ATE: its profiled slice may take the time
    # the window would have reached the ATE step in
    if not trace:
        if traj_ate is None:
            raise RuntimeError(f"ATE is taken when step {n_ate} returns and "
                               f"the window ended at scan {k}")
        out.ate_m = ate(traj_ate[:, :2, 2], stream.gt, np.arange(n_ate))
    ww = out.walls
    share = {k: 100.0 * whole[f"scaled.{k}"] / out.window_s
             for k in ("wall_lc", "wall_ba", "wall_replay")}
    out.notes.append(
        f"{out.attempted} scans stepped (scans {first}-{k}), {out.failed} "
        f"not accounted for, {st.gate_fallbacks} gate fallbacks; in the "
        f"window {ww['scaled.window_lc_checked']} closure checks with "
        f"candidates, {ww['scaled.window_loop_closures']} closures, "
        f"{ww['scaled.window_ba_runs']} BAs, {ww['scaled.window_replays']} "
        f"replays of {ww['scaled.window_replayed_keyframes']} keyframes; "
        f"share of the window in wall_lc {share['wall_lc']:.2f} %, wall_ba "
        f"{share['wall_ba']:.2f} %, wall_replay {share['wall_replay']:.2f} "
        f"%; {len(pipe.trajectory)} keyframes at the end")
    shift = [1000.0 * float(np.abs(np.stack(b["after"])[:, :2]
                                   - np.stack(b["before"])[:, :2]).max())
             for b in rec.bas]
    out.notes.append(
        f"largest node shift of each BA (mm): "
        f"{', '.join(f'{v:.2f}' for v in shift)}; map reads after a BA: "
        f"{len(rec.replays)}")
    pipe.sync_map()
    traj = np.stack(pipe.trajectory)
    grid = pipe.log_odds.cpu().numpy()
    del pipe, grid_host
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    check(out, rec, traj, grid, scans, config, traffic, limits, seed, dev,
          control)
    return out


def _note_slice_counts(out):
    """The program's closure, BA and replay counters and spans (host ms a
    scan at the profiled pace) over the traced slice, where it keeps
    them."""
    try:
        from icp_tpu_torch.utils import spans
        rec = spans.profiled()
    except (ImportError, AttributeError):
        return
    if not rec:
        return
    got = {k: rec["counts"][k] for k in SLICE_COUNTS if k in rec["counts"]}
    if got:
        out.notes.append("traced slice counters: " + ", ".join(
            f"{k} {v}" for k, v in got.items()))
    n = out.trace["scans"] if out.trace else 0
    got = {k: rec["spans"][k] for k in SLICE_SPANS if k in rec["spans"]}
    if got and n:
        out.notes.append("traced slice spans, ms a scan (self): " + ", ".join(
            f"{k} {v['ms'] / n:.2f} ({v['self_ms'] / n:.2f})"
            for k, v in got.items()))
