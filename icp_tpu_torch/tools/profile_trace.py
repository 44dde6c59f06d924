"""Profile one path of the port with its stages on the kernels' clock, and
say where the card waits.

    python -m icp_tpu_torch.tools.profile_trace [--path engine|scaled]
        [--steps N] [--device cpu] [--trace-dir DIR]

``engine``: the bench sequence (200 scans x 720 beams, written into
``data/`` when missing) through ``SlamEngine`` with loop closure, as the
benchmark's engine cell runs it (``bench.common``'s BENCH_CFG and
LC_SECTION): one warm log, then one whole log (scan 0, batches of 16,
``finish``) profiled. ``scaled``: config #5's pipeline
(``bench.scaled.pipeline_kwargs``, 100k points): N warm steps, then N
profiled.

The profiled part runs under ``torch.profiler`` and under
``utils.spans.record(device, ranges=True)``, so every span of the program
is a range on the profiler's host timeline. It writes the Chrome trace
into DIR (hundreds of MiB for a log), then prints each span's host, self
and card ms, the share of the host time in the program's calls that the
top-level spans cover, the counters, the top kernels by device time, and
the card's idle time by the innermost program span the host was in
(``idle_by_stage``: the union of the kernel intervals, each gap split at
the spans' edges).
"""
from __future__ import annotations

import argparse
import os
import time

import torch

TRACE_DIR = "data/trace"
OUTSIDE = "outside spans"


def stage_segments(ranges, w0, w1):
    """[(start, end, innermost range name)] covering [w0, w1], from
    properly nested host ranges (start, end, name); time in no range is
    ``OUTSIDE``."""
    edges = []
    for s, e, name in ranges:
        edges.append((s, 1, -e, name))      # opens sort after closes at a tie
        edges.append((e, 0, 0, name))
    edges.sort()
    segs, stack, t = [], [], w0
    for x, kind, _, name in edges:
        x = min(max(x, w0), w1)
        if x > t:
            segs.append((t, x, stack[-1] if stack else OUTSIDE))
            t = x
        if kind:
            stack.append(name)
        elif name in stack:
            del stack[len(stack) - 1 - stack[::-1].index(name)]
    if w1 > t:
        segs.append((t, w1, stack[-1] if stack else OUTSIDE))
    return segs


def idle_by_stage(kernels, ranges, window):
    """Idle time of the card by the innermost host range it fell in.

    ``kernels``: [(start, end)] on the card; ``ranges``: [(start, end,
    name)] on the host; ``window`` (w0, w1); one clock for all. Returns
    ({name: idle time}, busy time): the gaps between the union of the
    kernel intervals, each split at the ranges' edges."""
    w0, w1 = window
    busy, merged = 0.0, []
    for s, e in sorted(kernels):
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    gaps, edge = [], w0
    for s, e in merged + [[w1, w1]]:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    idle: dict[str, float] = {}
    segs = stage_segments(ranges, w0, w1)
    k = 0
    for a, b in gaps:
        while k < len(segs) and segs[k][1] <= a:
            k += 1
        j = k
        while j < len(segs) and segs[j][0] < b:
            s, e, name = segs[j]
            d = min(e, b) - max(s, a)
            if d > 0:
                idle[name] = idle.get(name, 0.0) + d
            j += 1
    return idle, busy


def _us(ev):
    start = ev.start_ns() / 1e3 if hasattr(ev, "start_ns") else ev.start_us()
    dur = (ev.duration_ns() / 1e3 if hasattr(ev, "duration_ns")
           else ev.duration_us())
    return start, start + dur


def reduce_profile(prof, names):
    """(kernels, ranges, window, device ms by kernel name) of a finished
    profile whose program ranges are ``names``: kernels are the card's
    events less copies, fills and the ranges' own annotations."""
    cuda = torch.autograd.DeviceType.CUDA
    kernels, ranges, by_name = [], [], {}
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() == cuda:
            if name in names or name.startswith(("Memcpy", "Memset")) \
                    or "memcpy" in name.lower():
                continue
            s, e = _us(ev)
            kernels.append((s, e))
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e3
        elif name in names:
            ranges.append((*_us(ev), name))
    if not ranges:
        return kernels, ranges, (0.0, 0.0), by_name
    window = (min(r[0] for r in ranges), max(r[1] for r in ranges))
    return kernels, ranges, window, by_name


def _engine(dev, steps):
    from icp_tpu_torch.bench.common import (BENCH_CFG, LC_SECTION,
                                            load_sequence)
    from icp_tpu_torch.engine import SlamEngine
    from icp_tpu_torch.utils.config import SlamConfig

    _, scans, rels, imu = load_sequence("data")
    cfg = SlamConfig.from_dict(dict(BENCH_CFG, loop_closure=LC_SECTION))
    B = cfg.batch_scans

    def one_log():
        eng = SlamEngine(cfg, imu=imu, verbose=False, device=dev)
        t0 = time.perf_counter()
        eng.process_scan(scans[0], rels[0])
        for k in range(1, len(scans), B):
            eng.process_scans_batched(scans[k:k + B], rels[k:k + B])
        eng.finish()
        return time.perf_counter() - t0

    return one_log, one_log, len(scans)


def _scaled(dev, steps):
    from icp_tpu_torch.bench import scaled as BS
    from icp_tpu_torch.parallel.scaled import ScaledPipeline

    n_points = 100_000
    kw = BS.pipeline_kwargs(50_000, n_points, env={})
    pipe = ScaledPipeline(dev, **kw)
    stream = BS.scan_stream(50_000, n_points)       # the lap's first scans
    scans = [scan for _, (scan, _gt) in zip(range(2 * steps), stream)]

    def run(part):
        def go():
            t0 = time.perf_counter()
            for scan in part:
                pipe.step(scan)
            pipe.finish()
            return time.perf_counter() - t0
        return go

    return run(scans[:steps]), run(scans[steps:]), steps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("engine", "scaled"), default="engine")
    ap.add_argument("--steps", type=int, default=64,
                    help="scaled steps to warm up with, and to profile")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace-dir", default=TRACE_DIR)
    args = ap.parse_args(argv)

    from torch.profiler import ProfilerActivity, profile

    from icp_tpu_torch.utils import spans

    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    if on_card:
        from icp_tpu_torch.ops.hopper import build
        build.load_all()
    warm, timed, n = (_engine if args.path == "engine" else _scaled)(
        dev, args.steps)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    warm()
    sync()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    with profile(activities=acts) as prof:
        with spans.record(dev, ranges=True) as spent:
            calls_s = timed()
            sync()
    os.makedirs(args.trace_dir, exist_ok=True)
    path = os.path.join(args.trace_dir, f"{args.path}.trace.json")
    prof.export_chrome_trace(path)
    print(f"trace: {path}", flush=True)

    tot = spent.record.totals()
    names = set(tot["spans"])
    kernels, ranges, window, by_name = reduce_profile(prof, names)
    where = torch.cuda.get_device_name(dev) if on_card else "the CPU"
    print(f"\n{args.path}: {n} scans profiled on {where}")
    print(f"{'span':32s} {'ms/scan':>9s} {'self':>9s} {'card':>9s} "
          f"{'calls':>7s}")
    for name, s in sorted(tot["spans"].items(), key=lambda kv: -kv[1]["ms"]):
        card = "" if s["event_ms"] is None else f"{s['event_ms'] / n:9.3f}"
        print(f"{name:32s} {s['ms'] / n:9.3f} {s['self_ms'] / n:9.3f} "
              f"{card:>9s} {s['calls']:7d}")
    top = sum(e[3] - e[2] for e in spent.record.entries if e[1] < 0)
    print(f"top-level spans: {1e3 * top / n:.3f} ms a scan, "
          f"{100 * top / calls_s:.1f} % of the host time in the program's "
          f"calls ({1e3 * calls_s / n:.3f} ms a scan, profiled)")
    print("counters a scan: " + ", ".join(
        f"{k} {v / n:.2f}" for k, v in sorted(tot["counts"].items())))
    if not on_card:
        return
    idle, busy = idle_by_stage(kernels, ranges, window)
    span_s = (window[1] - window[0]) / 1e6
    print(f"\ncard busy {busy / 1e3:.1f} ms of {1e3 * span_s:.1f} ms "
          f"({100 * busy / 1e6 / span_s:.1f} %); idle by the stage the host "
          f"was in (ms a scan, share of the idle time):")
    total_idle = sum(idle.values()) or 1.0
    for name, t in sorted(idle.items(), key=lambda kv: -kv[1]):
        print(f"  {name:32s} {t / 1e3 / n:9.3f} {100 * t / total_idle:6.1f} %")
    print("top kernels by device time (ms a scan):")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {ms / n:9.4f}  {name[:100]}")


if __name__ == "__main__":
    main()
