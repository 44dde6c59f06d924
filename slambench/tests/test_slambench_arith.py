"""The end-to-end arithmetic on synthetic timestamps and poses: the rate,
the latency tail, ATE, and the metric readers on a hand-made record."""
from __future__ import annotations

import math

import numpy as np
import pytest

from slambench import harness as H
from slambench import stats
from slambench.frozen import metrics as FM


def _run(handed, accounted, window_s):
    r = H.Run(setup_s=12.5, window_s=window_s, attempted=len(handed))
    r.handed, r.accounted = np.asarray(handed), np.asarray(accounted)
    r.failed = int((~np.isfinite(r.accounted)).sum())
    return r


def test_rate_counts_every_accounted_scan_over_the_whole_window():
    # 100 scans, accounted in batches of 10 every second, window 10.5 s
    handed = np.repeat(np.arange(10.0), 10)
    acc = handed + 1.0
    r = _run(handed, acc, 10.5)
    assert H.metric_reader("scans_per_s").read(r) == pytest.approx(100 / 10.5)


def test_latency_p95_over_all_scans():
    # latencies 1..100 ms: numpy's linear p95 is 95.05 ms
    handed = np.zeros(100)
    acc = np.arange(1, 101) / 1000.0
    r = _run(handed, acc, 1.0)
    assert H.metric_reader("pose_latency_p95_ms").read(r) == \
        pytest.approx(95.05)
    assert stats.percentile(np.arange(1, 101), 50) == pytest.approx(50.5)


def test_a_scan_never_accounted_is_a_failure_not_a_latency():
    acc = np.array([0.1, 0.2, math.nan, 0.4])
    r = _run(np.zeros(4), acc, 1.0)
    assert r.failed == 1 and r.accounted_scans == 3
    assert not r.correct
    assert H.metric_reader("pose_latency_p95_ms").read(r) == pytest.approx(
        stats.percentile([100, 200, 400], 95))


def test_pipelined_accounting_latency():
    """The engine bookkeeps a batch one call later: with calls of 1 s, a
    batch handed at t waits for the return at t + 2."""
    handed = np.repeat([0.0, 1.0, 2.0], 4)
    acc = np.repeat([2.0, 3.0, 3.5], 4)
    lat = stats.latencies_ms(handed, acc)
    assert lat.tolist() == [2000.0] * 8 + [1500.0] * 4


def test_ate_index_aligned_in_the_first_pose_frame():
    gt = np.array([[1.0, 2.0, np.pi / 2], [1.0, 3.0, np.pi / 2],
                   [0.0, 3.0, np.pi]])
    # in the first pose's frame: (0, 0), (1, 0), (1, 1)
    est = np.array([[1.0, 0.0], [1.0, 1.3]])
    got = FM.ate(est, gt, np.array([1, 2]))
    assert got == pytest.approx(math.sqrt((0 + 0.09) / 2))
    with pytest.raises(ValueError):
        FM.ate(est, gt, np.array([1]))


def test_ate_matches_the_programs_copy():
    from icp_tpu_torch.utils.metrics import ate

    rng = np.random.default_rng(3)
    gt = np.cumsum(rng.normal(size=(50, 3)), 0)
    idx = np.sort(rng.choice(np.arange(1, 50), 30, replace=False))
    est = rng.normal(size=(30, 2))
    assert FM.ate(est, gt, idx) == ate(est, gt, indices=idx)


def test_per_layer_readers_on_a_record():
    r = _run(np.zeros(10), np.ones(10), 2.0)
    r.walls = {"engine.wall_registration": 0.4,
               "engine.wall_loop_closure": 0.05, "engine.scans": 10,
               "scaled.wall_registration": 1.0, "scaled.drain_wait": 0.2,
               "scaled.scans": 20}
    r.trace = {"busy_s": 0.25, "window_s": 1.0, "launches": 5000,
               "scans": 2}
    read = {n: H.metric_reader(n).read(r) for n in (
        "engine.registration_ms_per_scan", "engine.loop_closure_ms_per_scan",
        "scaled.registration_ms_per_scan", "scaled.drain_wait_ms_per_scan",
        "device.idle_pct", "device.launches_per_scan", "setup_s")}
    assert read == pytest.approx({
        "engine.registration_ms_per_scan": 40.0,
        "engine.loop_closure_ms_per_scan": 5.0,
        "scaled.registration_ms_per_scan": 50.0,
        "scaled.drain_wait_ms_per_scan": 10.0,
        "device.idle_pct": 75.0, "device.launches_per_scan": 2500.0,
        "setup_s": 12.5})
    # a trace with no kernel has nothing to read: the metric is left out
    r.trace = {"busy_s": 0.0, "window_s": 1.0, "launches": 0, "scans": 2}
    assert H.metric_reader("device.idle_pct").read(r) is None
    assert H.metric_reader("device.launches_per_scan").read(r) is None
