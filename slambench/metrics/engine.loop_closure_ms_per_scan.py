"""Host ms a scan in the engine's loop closure (gates, verification, the
pose-graph solve, rollback: the sum of ``SlamStats.wall_loop_closure``
over the window's engines), over the scans accounted for."""


def read(run):
    n = run.walls.get("engine.scans")
    if not n or "engine.wall_loop_closure" not in run.walls:
        return None
    return 1000.0 * run.walls["engine.wall_loop_closure"] / n
