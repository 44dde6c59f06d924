"""Host ms a scan making keyframes (the span ``scaled.keyframe``: the
scan's voxelization and its push onto the submap ring), from the
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
    s = rec["spans"].get("scaled.keyframe")
    return (s["ms"] if s else 0.0) / run.trace["scans"]
