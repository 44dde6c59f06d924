"""Host ms a scan spent waiting, at each drain, for the card to finish the
pending steps (the event wait at the start of ``ScaledPipeline._drain``,
timed by the harness around that same wait), over the scans accounted
for."""


def read(run):
    n = run.walls.get("scaled.scans")
    if not n or "scaled.drain_wait" not in run.walls:
        return None
    return 1000.0 * run.walls["scaled.drain_wait"] / n
