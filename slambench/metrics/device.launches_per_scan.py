"""Kernels the profiler saw run on the card in the traced slice, over the
scans handed over in that slice: the host's launch path."""


def read(run):
    t = run.trace
    if not t or not t["scans"] or t["launches"] == 0:
        return None
    return t["launches"] / t["scans"]
