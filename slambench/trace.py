"""The traced run's profile: a fixed slice of the window's calls under
``torch.profiler``, kept in memory and reduced to the device's busy time,
its kernel launches, the kernels that took most time and the longest idle
gaps, each labelled by the harness's range the host was in.

Every call into the program goes through ``Tracer.call(label)``, which
wraps it in a ``record_function`` range of that name; the profiler runs
from call ``start`` for ``count`` calls, with the device synchronized at
both ends so that the slice's kernels end inside it. The profiler slows
the calls it records, so ``snapshot`` (the program's counters and walls,
read on the host) is taken at both ends of the slice and ``slice_walls``
holds what the slice added: the per-layer walls leave it out.
"""
from __future__ import annotations

import contextlib
import time

import torch

WINDOW = "trace.window"
# prefixes of the harness's ranges around its calls into the program
LABELS = ("trace.", "logs.", "scaled.")
# the host's calls that put a kernel on the card
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
            "cudaLaunchCooperativeKernel")


class Tracer:
    def __init__(self, enabled: bool, device, start: int, count: int,
                 snapshot=None):
        self.enabled = bool(enabled)
        self.snapshot = snapshot
        self.slice_walls = {}
        self.device = torch.device(device)
        self.start, self.count = int(start), int(count)
        self.calls = 0
        self.scans = 0                 # scans handed over inside the slice
        self.host_s = 0.0              # the slice's host time, profiler start
                                       # included
        self.reduce_s = 0.0            # the profile's stop and reduction
        self.prof = None
        self._range = None
        self.summary = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _open(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._sync()
        self._walls0 = self.snapshot() if self.snapshot else {}
        self.prof = torch.profiler.profile(activities=acts)
        self._t_open = time.perf_counter()
        self.prof.start()
        self._range = torch.autograd.profiler.record_function(WINDOW)
        self._range.__enter__()

    def without_slice(self, walls: dict) -> dict:
        """``walls`` less what the profiled slice added to each."""
        return {k: v - self.slice_walls.get(k, 0) for k, v in walls.items()}

    def close(self):
        """End the slice (if open) and reduce it."""
        if self.prof is None:
            return
        self._sync()
        t = time.perf_counter()
        self.host_s = t - self._t_open
        self._range.__exit__(None, None, None)
        self.prof.stop()
        if self.snapshot:
            now = self.snapshot()
            self.slice_walls = {k: now[k] - v for k, v in self._walls0.items()}
        self.summary = reduce(self.prof, self.scans)
        self.prof = None
        self.reduce_s = time.perf_counter() - t

    def slowdown_note(self, window_s: float, scans: int) -> str | None:
        """How far the profiler slowed the slice: the traced window's time
        a scan against the rest of the window's (less the profile's start,
        stop and reduction), and the idle share that the slice's device
        time would leave at the unprofiled pace."""
        t = self.summary
        rest = scans - self.scans
        if not t or not self.scans or rest <= 0:
            return None
        fast = (window_s - self.host_s - self.reduce_s) / rest
        slow = t["window_s"] / self.scans
        idle = 100.0 * (1.0 - t["busy_s"] / (fast * self.scans))
        by = ", ".join(f"{k} {v / self.scans:.1f}"
                       for k, v in sorted(t["launches_by_range"].items()))
        return (f"traced slice: {self.scans} scans, {1e3 * slow:.2f} ms a "
                f"scan profiled against {1e3 * fast:.2f} ms in the rest of "
                f"the window ({slow / fast:.2f}x); device busy "
                f"{1e3 * t['busy_s'] / self.scans:.3f} ms a scan, so "
                f"{idle:.1f} % idle at the unprofiled pace; launches a scan "
                f"by range: {by}")

    @contextlib.contextmanager
    def call(self, label: str, scans: int = 0):
        """One call into the program, handing over ``scans`` scans."""
        if self.enabled and self.prof is None and self.summary is None \
                and self.calls == self.start:
            self._open()
        if self.prof is not None:
            self.scans += scans
        with torch.autograd.profiler.record_function(label):
            yield
        self.calls += 1
        if self.prof is not None and self.calls >= self.start + self.count:
            self.close()


def _span(ev):
    """(start, end) of a kineto event in microseconds."""
    start = ev.start_ns() / 1e3 if hasattr(ev, "start_ns") else ev.start_us()
    dur = (ev.duration_ns() / 1e3 if hasattr(ev, "duration_ns")
           else ev.duration_us())
    return start, start + dur


def reduce(prof, scans: int) -> dict:
    """busy_s, window_s, launches, scans and the breakdown of a finished
    profile."""
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    window = None
    ranges, kernels, launched = [], [], []
    by_name: dict[str, float] = {}
    for ev in events:
        name = ev.name()
        if name in LAUNCHES and ev.device_type() != cuda:
            launched.append(_span(ev)[0])
        elif ev.device_type() == cuda:
            # copies and fills are not kernels; the harness's own ranges
            # appear on the device's timeline too (as annotations)
            if (name.startswith(("Memcpy", "Memset", *LABELS))
                    or "memcpy" in name.lower()):
                continue
            s, e = _span(ev)
            kernels.append((s, e))
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
        elif name == WINDOW:
            window = _span(ev)
        elif name.startswith(LABELS[1:]):
            ranges.append((*_span(ev), name))
    if window is None:
        raise RuntimeError("the profile holds no trace window range")
    w0, w1 = window
    kernels.sort()
    merged = []
    for s, e in kernels:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy_us = sum(e - s for s, e in merged)
    gaps = []
    edge = w0
    for s, e in merged + [[w1, w1]]:
        if s > edge:
            gaps.append((s - edge, edge, s))
        edge = max(edge, e)
    gaps.sort(reverse=True)

    def label(t):
        inside = [r for r in ranges if r[0] <= t <= r[1]]
        # the innermost range: the latest to start
        return max(inside)[2] if inside else "between calls"

    by_range: dict[str, int] = {}
    for t in launched:
        if w0 <= t <= w1:
            k = label(t)
            by_range[k] = by_range.get(k, 0) + 1
    return {
        "busy_s": busy_us / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "launches": len(kernels),
        "launches_by_range": by_range,
        "scans": scans,
        "device_ops": sorted(([n, s] for n, s in by_name.items()),
                             key=lambda x: -x[1])[:10],
        "idle_gaps": [[label((a + b) / 2), g / 1e6]
                      for g, a, b in gaps[:10]],
    }
