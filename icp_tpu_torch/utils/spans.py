"""Named time spans inside a solve, off unless a caller records them.

    with spans.record(device) as spent:
        pg.optimize(15)
    spent   # {"coarse_correct": ms, "coarse_correct_calls": 1, ...}

Code marks its parts with ``with spans.span("name"):``; outside
``record`` a span costs one global read. Inside it, on a card, each end of
a span records a CUDA event on the device's current stream: nothing waits,
so the solve runs as it would unrecorded, and ``record`` reads the events
once, after one synchronize at its end. A span's time is then the card's
from reaching its start to finishing the work queued before its end, which
is the host's time where the host waits for the card (a ``.cpu()`` read)
and the card's where the host runs ahead. On the CPU a span reads the
host clock. Spans may nest and repeat: each name sums its entries' ms and
counts them under ``<name>_calls``.
"""
from __future__ import annotations

import contextlib
import time

import torch

_marks: list | None = None      # (name, start, end) while recording
_device: torch.device | None = None


def _mark():
    if _device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(_device))
        return ev
    return time.perf_counter()


@contextlib.contextmanager
def span(name: str):
    """Add the body's time to ``name`` while a ``record`` is open."""
    if _marks is None:
        yield
        return
    marks, start = _marks, _mark()
    try:
        yield
    finally:
        marks.append((name, start, _mark()))


@contextlib.contextmanager
def record(device):
    """Record the spans entered in the body on ``device``; the yielded dict
    holds their ms and counts once the body has ended."""
    global _marks, _device
    if _marks is not None:
        raise RuntimeError("spans.record does not nest")
    spent: dict = {}
    _marks, _device = [], torch.device(device)
    try:
        yield spent
    finally:
        marks, dev = _marks, _device
        _marks = _device = None
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        for name, a, b in marks:
            ms = a.elapsed_time(b) if dev.type == "cuda" else 1e3 * (b - a)
            spent[name] = spent.get(name, 0.0) + ms
            spent[f"{name}_calls"] = spent.get(f"{name}_calls", 0) + 1
