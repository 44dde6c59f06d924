"""Host ms a scan reading results back and keeping the host's record
(the spans ``engine.fetch`` and ``engine.bookkeep``, or
``scaled.bookkeep``), from the program's span record of the traced slice
(``utils.spans.profiled``), at the profiled pace, over the slice's scans.
None where the slice saw no kernel run or the program keeps no such
record."""

SPANS = ("engine.fetch", "engine.bookkeep", "scaled.bookkeep")


def _profiled(run):
    t = run.trace
    if not t or not t["scans"] or not t["launches"]:
        return None
    try:
        from icp_tpu_torch.utils import spans
        return spans.profiled()
    except (ImportError, AttributeError):
        return None


def read(run):
    rec = _profiled(run)
    if not rec:
        return None
    s = rec["spans"]
    return sum(s[k]["ms"] for k in SPANS if k in s) / run.trace["scans"]
