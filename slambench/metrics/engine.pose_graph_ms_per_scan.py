"""Host ms a scan in the pose-graph solves (the span ``pose_graph.solve``,
each ``PoseGraph2D.optimize`` with its packing, dense or PCG solve and
chi2 guard), from the program's span record of the traced slice
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
    s = rec["spans"].get("pose_graph.solve")
    return (s["ms"] if s else 0.0) / run.trace["scans"]
