"""Host ms a scan in ``ScaledPipeline.sync_map``'s replays of the map (the
keyframes that moved un-painted and repainted, or the whole map replayed,
in chunks, and the synchronize at its end: ``ScaledStats.wall_replay``),
over the window less the traced slice, over the scans accounted for
there."""


def read(run):
    n = run.walls.get("scaled.scans")
    if not n or "scaled.wall_replay" not in run.walls:
        return None
    return 1000.0 * run.walls["scaled.wall_replay"] / n
