"""Host ms a scan in ``ScaledPipeline``'s loop-closure checks (the gates,
the verification lanes' rotation search and two gated ``icp_core``
passes, the one read of the lanes, the accept: ``ScaledStats.wall_lc``),
over the window less the traced slice, over the scans accounted for
there."""


def read(run):
    n = run.walls.get("scaled.scans")
    if not n or "scaled.wall_lc" not in run.walls:
        return None
    return 1000.0 * run.walls["scaled.wall_lc"] / n
