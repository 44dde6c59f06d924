"""Host ms a scan inside the port's ICP calls, their own time (the spans
``icp.core`` and ``icp.large`` less the spans inside them), from the
program's span record of the traced slice (``utils.spans.profiled``), at
the profiled pace, over the slice's scans. None where the slice saw no
kernel run or the program keeps no such record."""


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
    ms = sum(s[k]["self_ms"] for k in ("icp.core", "icp.large") if k in s)
    return ms / run.trace["scans"]
