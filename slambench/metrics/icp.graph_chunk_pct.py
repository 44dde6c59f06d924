"""Share of the ICP chunks that ``icp_core`` ran in the traced slice by
replaying a captured CUDA graph: 100 x the program's ``icp.graph_replays``
over ``icp.graph_replays`` + ``icp.eager_chunks`` (chunks the Python loop
ran), from ``utils.spans.profiled``. None where the slice saw no kernel
run, ran no ``icp_core`` chunk or the program keeps no such record."""


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
    replays = rec["counts"].get("icp.graph_replays", 0)
    chunks = replays + rec["counts"].get("icp.eager_chunks", 0)
    if not chunks:
        return None
    return 100.0 * replays / chunks
