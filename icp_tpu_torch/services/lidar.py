"""Lidar CSV ingestion (counterpart of icp_tpu.services.lidar).

Format (reference services/lidar_service.py:5-19): semicolon-delimited rows
``timestamp;x1;y1;z1;x2;y2;z2;...`` with variable point counts per row;
all-zero (0,0,0) triples are padding and dropped. Whole files parse in one
native pass (``runtime.loader``, C++ built at first use); on a machine with
no C++ compiler each line is parsed with ``np.fromstring``. Both read a
double and round it to f32, so they give the same scans. They differ on
malformed input only: the native parser skips a line with no leading
number and ends a line at its first incomplete triple, where
``parse_lidar_line`` raises ValueError.
"""
from __future__ import annotations

import time

import numpy as np


def parse_lidar_line(line: str):
    """One CSV row -> (timestamp_raw int, (N, 3) float32 points, padding dropped)."""
    vals = np.fromstring(line.strip().replace(";", " "), sep=" ")
    if vals.size < 1 + 3 or (vals.size - 1) % 3 != 0:
        raise ValueError("Invalid lidar line: expected timestamp + xyz triples")
    ts = int(vals[0])
    pts = vals[1:].reshape(-1, 3).astype(np.float32)
    keep = ~np.all(pts == 0, axis=1)
    return ts, pts[keep]


class LidarService:
    """Streams scans from a reference-format CSV.

    Yields (timestamp_raw, rel_time_us, points) with optional sleep pacing
    and file looping (reference services/lidar_service.py:22-47).
    ``parser`` says which parser the last ``scans()`` call used: "native"
    or "numpy" (None before the first call).
    """

    def __init__(self, file_path, sleep_s=0.0, loop=False):
        self.file_path = file_path
        self.sleep_s = sleep_s
        self.loop = loop
        self.parser = None

    def _lines(self):
        with open(self.file_path, "r") as f:
            for line in f:
                if line.strip():
                    yield parse_lidar_line(line)

    def scans(self):
        from icp_tpu_torch.runtime.loader import get_lib, load_lidar_csv

        # numpy only where the machine has no compiler; a failed build or
        # load raises out of get_lib
        native = (load_lidar_csv(self.file_path)
                  if get_lib() is not None else None)
        self.parser = "numpy" if native is None else "native"
        first_ts = None
        while True:
            for ts, pts in (self._lines() if native is None else native):
                if first_ts is None:
                    first_ts = ts
                yield ts, ts - first_ts, pts
                if self.sleep_s > 0:
                    time.sleep(self.sleep_s)
            if not self.loop:
                break
