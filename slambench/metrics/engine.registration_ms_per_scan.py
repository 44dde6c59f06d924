"""Host ms a scan inside the engine's fused registration calls (the sum of
``SlamStats.wall_registration`` over the window's engines), over the scans
accounted for: the engine layer (models/slam_step, models/icp)."""


def read(run):
    n = run.walls.get("engine.scans")
    if not n or "engine.wall_registration" not in run.walls:
        return None
    return 1000.0 * run.walls["engine.wall_registration"] / n
