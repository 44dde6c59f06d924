"""The benchmark's arithmetic on host timestamps: rates and latency
percentiles."""
from __future__ import annotations

import numpy as np


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between order
    statistics (numpy's default)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def latencies_ms(handed, accounted) -> np.ndarray:
    """Per scan: from the start of the call that handed it over to the
    return of the first call after which the program accounted for it, in
    ms. ``accounted`` is NaN for a scan never accounted for."""
    return 1000.0 * (np.asarray(accounted, np.float64)
                     - np.asarray(handed, np.float64))


def rate(count: int, window_s: float) -> float:
    """Work per second over the whole window."""
    if window_s <= 0:
        raise ValueError(f"window of {window_s} s")
    return count / window_s
