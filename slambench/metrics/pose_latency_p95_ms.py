"""95th percentile over the window's scans of the time from the start of
the call that handed a scan over to the return of the first call after
which the program's host-side record held its pose or its rejection (host
clock). A scan never accounted for is a failure, not a latency."""
import numpy as np

from slambench import stats


def read(run):
    lat = stats.latencies_ms(run.handed, run.accounted)
    lat = lat[np.isfinite(lat)]
    return stats.percentile(lat, 95) if lat.size else None
