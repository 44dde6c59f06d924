"""Share of the window's loop-closure checks that had candidates which
accepted a closure: 100 x the program's accepted closures
(``ScaledStats.loop_closures``, the counter ``scaled.lc_accepts``) over
its checks with candidates (``ScaledStats.lc_checked``,
``scaled.lc_checks``), both over the whole window. A change that makes
closures rarer lowers it. None where the window checked no candidate."""


def read(run):
    n = run.walls.get("scaled.window_lc_checked")
    if not n or "scaled.window_loop_closures" not in run.walls:
        return None
    return 100.0 * run.walls["scaled.window_loop_closures"] / n
