"""The port's one record of named spans and counters, off unless a caller
or a profiler opens it.

    with spans.record(device) as spent:
        pg.optimize(15)
    spent            # {"pose_graph.pcg": ms, "pose_graph.pcg_calls": 1, ...}
    spent.record.totals()    # each span's total, self and event ms and
                             # calls; the counters

Code marks its stages with ``with spans.span("<layer>.<stage>"):`` and
counts events with ``spans.count("<name>", n)``. A span is live while
``record`` is open, or while a torch profiler runs
(``torch.autograd.profiler._is_profiler_enabled``): then the process-wide
record of that profiler session takes it, which starts fresh when a
session starts, outlives the profiler and is read with ``profiled()``
(``record`` takes precedence while both are open). Outside both, a span
and a count cost one or two global reads.

A live span records its name, its host start and end
(``time.perf_counter``), the span that encloses it and, on a card, a CUDA
event at each end on the device's current stream: nothing waits, and the
events are read once, after one synchronize, when the record is read. Its
self time is its host time less the host time of its child spans. Its
event time is the card's, from reaching its start to finishing the work
queued before its end: the host's time where the host waits for the card,
the card's where the host runs ahead.

A count ``n`` is a host number, a tensor or a tuple of tensors (their
product): a tensor is kept as it is, with no sync, and summed on its
device when the record is read. Code that would compute a tensor only to
count it asks ``live()`` first.

``record(device, ranges=True)`` also opens each span as a
``record_function`` range of the same name, so the stages lie on a
profiler's host timeline on the kernels' clock. A profiler alone opens no
ranges: a range is an annotation on the device's timeline too, and costs
~10 us a call.

Names are ``<layer>.<stage>``; PERF.md §3 lists every span and counter
with what reads it. Device-to-host reads, and host-to-device copies from
pageable memory, are counted as ``sync.<site>`` where they are made.
"""
from __future__ import annotations

import contextlib
import functools
import time

import torch
import torch.autograd.profiler as _prof

_rec = None         # the Record that ``record`` opened
_prec = None        # the Record of the current or last profiler session
_open = None        # the Record whose innermost span is open
_session = 0        # profiler sessions started in this process


def _on_profiler_start(start=_prof._run_on_profiler_start):
    global _session
    _session += 1
    start()


# every torch profiler calls this when it starts: a new session is known
# at once, with nothing read on the span's own path
if not getattr(_prof._run_on_profiler_start, "_spans_hook", False):
    _on_profiler_start._spans_hook = True
    _prof._run_on_profiler_start = _on_profiler_start


class Record:
    """The spans and counts of one ``record`` or one profiler session."""

    def __init__(self, device, ranges: bool = False, session=None):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.ranges = bool(ranges)
        self.session = session
        # [span, parent index, t0, t1, event0, event1, range]
        self.entries: list = []
        self.stack: list[int] = []
        self.counts: dict = {}          # name -> host number
        self.tensors: dict = {}         # name -> [tensor or tuple]
        self.adds = 0                   # count() calls
        self._totals = None

    def _event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def open(self, span) -> None:
        global _open
        rng = None
        if self.ranges:
            rng = torch.autograd.profiler.record_function(span.name)
            rng.__enter__()
        parent = self.stack[-1] if self.stack else -1
        self.stack.append(len(self.entries))
        self.entries.append([span, parent, time.perf_counter(), None,
                             self._event() if self.cuda else None, None,
                             rng])
        self._totals = None
        _open = self

    def close(self, span) -> None:
        global _open
        if not self.stack or self.entries[self.stack[-1]][0] is not span:
            return
        e = self.entries[self.stack.pop()]
        e[3] = time.perf_counter()
        if self.cuda:
            e[5] = self._event()
        if e[6] is not None:
            e[6].__exit__(None, None, None)
        if not self.stack:
            _open = None

    def add(self, name: str, n) -> None:
        self.adds += 1
        if isinstance(n, (torch.Tensor, tuple)):
            self.tensors.setdefault(name, []).append(n)
        else:
            self.counts[name] = self.counts.get(name, 0) + n
        self._totals = None

    def empty(self) -> bool:
        return not (self.entries or self.counts or self.tensors)

    def totals(self) -> dict:
        """{"spans": {name: {"ms", "self_ms", "calls", "event_ms"}},
        "counts": {name: value}} over the closed spans; ``event_ms`` is
        None off a card. The first read synchronizes the card once."""
        if self._totals is not None:
            return self._totals
        closed = [e for e in self.entries if e[3] is not None]
        if self.cuda and (closed or self.tensors):
            torch.cuda.synchronize(self.device)
        child = [0.0] * len(self.entries)
        for e in closed:
            if e[1] >= 0:
                child[e[1]] += e[3] - e[2]
        spans: dict = {}
        for i, e in enumerate(self.entries):
            if e[3] is None:
                continue
            s = spans.setdefault(e[0].name, {
                "ms": 0.0, "self_ms": 0.0, "calls": 0,
                "event_ms": 0.0 if self.cuda else None})
            s["ms"] += 1e3 * (e[3] - e[2])
            s["self_ms"] += 1e3 * (e[3] - e[2] - child[i])
            s["calls"] += 1
            if self.cuda:
                s["event_ms"] += e[4].elapsed_time(e[5])
        counts = dict(self.counts)
        for name, items in self.tensors.items():
            total = counts.get(name, 0)
            by_dev: dict = {}
            for it in items:
                fs = it if isinstance(it, tuple) else (it,)
                v = fs[0].double()
                for f in fs[1:]:
                    v = v * f.to(v.device, torch.float64)
                by_dev.setdefault(v.device, []).append(v.reshape(()))
            for vs in by_dev.values():
                total += float(torch.stack(vs).sum().cpu())
            counts[name] = (int(total) if float(total).is_integer()
                            else total)
        self._totals = {"spans": spans, "counts": counts}
        return self._totals


def _current_device() -> torch.device:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _profiled_record() -> Record:
    global _prec
    if _prec is None or _prec.session != _session:
        _prec = Record(_current_device(), session=_session)
    return _prec


class _Span:
    """A reusable context manager: ``span(name)`` returns one per name."""
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        r = _rec
        if r is None:
            if not _prof._is_profiler_enabled:
                return self
            r = _profiled_record()
        r.open(self)
        return self

    def __exit__(self, *exc):
        r = _open
        if r is not None:
            r.close(self)
        return False


_spans: dict[str, _Span] = {}


def span(name: str) -> _Span:
    """The span ``name``: ``with span(name):`` adds the body's time to it
    while a record is live."""
    s = _spans.get(name)
    if s is None:
        s = _spans[name] = _Span(name)
    return s


def spanned(name: str):
    """Decorator: each call of the function is the span ``name``."""
    s = span(name)

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with s:
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name`` while a record is live."""
    r = _rec
    if r is None:
        if not _prof._is_profiler_enabled:
            return
        r = _profiled_record()
    r.add(name, n)


def live() -> bool:
    """Whether a span or a count would be recorded now."""
    return _rec is not None or _prof._is_profiler_enabled


def profiled() -> dict | None:
    """The totals (``Record.totals``) of the last profiler session's
    record, or None if that session recorded nothing. Readable any number
    of times; only the first read synchronizes (the card current when the
    session's first span opened, which holds its events)."""
    r = _prec
    if r is None or r.session != _session or r.empty():
        return None
    return r.totals()


class Spent(dict):
    """What ``record`` yields: once its body has ended, each span name's ms
    (the CUDA-event time on a card, the host's elsewhere) and its count
    under ``<name>_calls``; ``record`` is the Record, for the counters and
    the host and self times."""
    record: Record


@contextlib.contextmanager
def record(device, ranges: bool = False):
    """Record the spans and counts of the body on ``device``; with
    ``ranges`` each span is a ``record_function`` range too."""
    global _rec, _open
    if _rec is not None:
        raise RuntimeError("spans.record does not nest")
    spent = Spent()
    spent.record = _rec = Record(device, ranges=ranges)
    try:
        yield spent
    finally:
        rec = _rec
        _rec = None
        while rec.stack:            # spans left open by an exception
            rec.close(rec.entries[rec.stack[-1]][0])
        _open = _prec if _prec is not None and _prec.stack else None
        for name, s in rec.totals()["spans"].items():
            spent[name] = s["ms"] if s["event_ms"] is None else s["event_ms"]
            spent[f"{name}_calls"] = s["calls"]
