"""Host ms a scan painting the map (the spans ``map.paint``, each scan's
or batch's paint, and ``map.replay``, the engine's repaint of its history
after a closure), from the program's span record of the traced slice
(``utils.spans.profiled``), at the profiled pace, over the slice's scans.
None where the slice saw no kernel run or the program keeps no such
record."""


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
    ms = sum(s[k]["ms"] for k in ("map.paint", "map.replay") if k in s)
    return ms / run.trace["scans"]
