"""Host ms a scan in ``ScaledPipeline``'s registration and drain
(``ScaledStats.wall_registration``), over the scans accounted for."""


def read(run):
    n = run.walls.get("scaled.scans")
    if not n or "scaled.wall_registration" not in run.walls:
        return None
    return 1000.0 * run.walls["scaled.wall_registration"] / n
