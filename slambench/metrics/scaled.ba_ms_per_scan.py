"""Host ms a scan in ``ScaledPipeline``'s online bundle adjustments (the
DCS-robust ``PoseGraph2D.optimize``, the trajectory's rewrite, the submap
ring's rebuild and the device pose carry: ``ScaledStats.wall_ba``), over
the window less the traced slice, over the scans accounted for there."""


def read(run):
    n = run.walls.get("scaled.scans")
    if not n or "scaled.wall_ba" not in run.walls:
        return None
    return 1000.0 * run.walls["scaled.wall_ba"] / n
