"""Scans accounted for in the window over the whole window (host clock):
every call, every scan and every wait of the window counted."""
from slambench import stats


def read(run):
    return stats.rate(run.accounted_scans, run.window_s)
