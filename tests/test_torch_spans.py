"""The port's span and counter record (``icp_tpu_torch.utils.spans``): when
a span is live, what it records, the record a profiler opens, the sync
counters against the sites the paths pass, the benchmark's readers of the
record, and ``tools.profile_trace``'s idle reduction.

The sync counters are held to a CPU emulation of torch's sync debug mode
(``SyncProbe``): every call that reads a tensor back to the host, copies a
host value to the device, or indexes by a boolean mask is noted at the
innermost line of the package that made it. On a card ``chip_smoke.py``
phase 20 holds them to torch's own sync warnings.
"""
from __future__ import annotations

import collections
import copy
import os
import time
import traceback

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import profile  # noqa: E402

from icp_tpu_torch.utils import spans  # noqa: E402

PACKAGE = os.sep + "icp_tpu_torch" + os.sep
# the plain versions' own host steps: they run on the CPU only, never on a
# card (the segment adds' kept rows)
CPU_ONLY = ("icp_tpu_torch/ops/scatter.py",)


def _site():
    for f in reversed(traceback.extract_stack()[:-3]):
        if PACKAGE in f.filename:
            rel = "icp_tpu_torch/" + f.filename.split(PACKAGE)[-1]
            return None if rel.startswith(CPU_ONLY) else f"{rel}:{f.lineno}"
    return None


class SyncProbe:
    """Counts, by site, the calls of the package that would sync on a card:
    a tensor read back (``item``, ``tolist``, ``bool``, ``int``,
    ``float``, ``cpu``), ``nonzero``, indexing by a boolean mask, a host
    scalar put at tensor indices (torch copies it to the card first), and
    ``torch.tensor`` / ``torch.as_tensor`` of host data onto a device."""

    READS = ("item", "tolist", "__bool__", "__int__", "__float__",
             "__index__", "cpu", "nonzero")

    def __init__(self, monkeypatch):
        self.sites = collections.Counter()
        self.on = False
        for name in self.READS:
            monkeypatch.setattr(torch.Tensor, name,
                                self._wrap(getattr(torch.Tensor, name)))
        getitem = torch.Tensor.__getitem__

        def masked(t, idx):
            ids = idx if isinstance(idx, tuple) else (idx,)
            if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                   for i in ids):
                self._note()
            return getitem(t, idx)
        monkeypatch.setattr(torch.Tensor, "__getitem__", masked)
        setitem = torch.Tensor.__setitem__

        def put(t, idx, value):
            ids = idx if isinstance(idx, tuple) else (idx,)
            if isinstance(value, (bool, int, float)) and any(
                    isinstance(i, torch.Tensor) for i in ids):
                self._note()
            return setitem(t, idx, value)
        monkeypatch.setattr(torch.Tensor, "__setitem__", put)
        monkeypatch.setattr(torch, "nonzero", self._wrap(torch.nonzero))
        tensor, as_tensor = torch.tensor, torch.as_tensor

        def new(data, *a, **k):
            self._note()
            return tensor(data, *a, **k)

        def as_(data, *a, **k):
            if not isinstance(data, torch.Tensor):
                self._note()
            return as_tensor(data, *a, **k)
        monkeypatch.setattr(torch, "tensor", new)
        monkeypatch.setattr(torch, "as_tensor", as_)

    def _note(self):
        if self.on:
            site = _site()
            if site is not None:
                self.sites[site] += 1

    def _wrap(self, fn):
        def call(*a, **k):
            self._note()
            return fn(*a, **k)
        return call


def _syncs(rec) -> dict:
    return {k: v for k, v in rec.totals()["counts"].items()
            if k.startswith("sync.")}


def test_nothing_is_recorded_with_neither_open():
    n = len(spans._prec.entries) if spans._prec is not None else 0
    with spans.span("test.off"):
        spans.count("test.off")
    assert not spans.live()
    assert (len(spans._prec.entries) if spans._prec is not None else 0) == n
    with spans.record("cpu") as spent:
        pass
    assert dict(spent) == {} and spent.record.empty()


def test_spans_nest_with_parents_and_self_time():
    with spans.record("cpu") as spent:
        with spans.span("test.outer"):
            time.sleep(0.002)
            for _ in range(2):
                with spans.span("test.inner"):
                    time.sleep(0.003)
    rec = spent.record
    outer, inner = rec.entries[0], rec.entries[1:]
    assert outer[1] == -1 and all(e[1] == 0 for e in inner)
    s = rec.totals()["spans"]
    assert s["test.outer"]["calls"] == 1 and s["test.inner"]["calls"] == 2
    assert s["test.inner"]["ms"] >= 6.0
    assert s["test.outer"]["self_ms"] == pytest.approx(
        s["test.outer"]["ms"] - s["test.inner"]["ms"], abs=1e-9)
    assert s["test.outer"]["self_ms"] >= 2.0
    assert s["test.inner"]["self_ms"] == s["test.inner"]["ms"]
    assert s["test.outer"]["event_ms"] is None          # no card here


def test_counters_sum_host_numbers_tensors_and_products():
    with spans.record("cpu") as spent:
        spans.count("test.n")
        spans.count("test.n", 4)
        spans.count("test.t", torch.tensor(3))
        spans.count("test.t", torch.tensor([2.0]).sum())
        spans.count("test.p", (torch.tensor(6.0), torch.tensor(7),
                               torch.tensor(2, dtype=torch.int32)))
        spans.count("test.p", 1)
    assert spent.record.totals()["counts"] == {
        "test.n": 5, "test.t": 5, "test.p": 85}
    assert spent.record.adds == 6


def test_a_profiler_opens_a_record_alone():
    """Under a running torch profiler with no record open a span is live,
    its record outlives the profiler, reads the same twice, and the next
    profiler session starts a fresh one."""
    assert not spans.live()
    with profile():
        assert spans.live()
        with spans.span("test.profiled"):
            with spans.span("test.child"):
                spans.count("test.c", torch.tensor(2))
        spans.count("test.c", 3)
    assert not spans.live()
    first = spans.profiled()
    assert first["spans"]["test.profiled"]["calls"] == 1
    assert first["spans"]["test.child"]["calls"] == 1
    assert first["counts"] == {"test.c": 5}
    assert spans.profiled() is first
    with spans.span("test.profiled"):          # off again
        pass
    assert spans.profiled()["spans"]["test.profiled"]["calls"] == 1
    with profile():
        spans.count("test.d")
    assert spans.profiled() == {"spans": {}, "counts": {"test.d": 1}}
    with profile():
        pass
    assert spans.profiled() is None            # nothing in that session


def test_record_takes_precedence_over_a_profiler():
    with profile():
        with spans.record("cpu") as spent:
            with spans.span("test.recorded"):
                pass
        with spans.span("test.profiled"):
            pass
    assert spent["test.recorded_calls"] == 1
    assert set(spans.profiled()["spans"]) == {"test.profiled"}


@pytest.mark.parametrize("ranges", [False, True])
def test_ranges_only_when_asked(ranges):
    """With ``ranges`` each span is a ``record_function`` range among the
    profiler's events; a profiler alone opens none."""
    with profile() as prof:
        with spans.record("cpu", ranges=ranges):
            with spans.span("test.ranged"):
                torch.ones(4).sum()
        with spans.span("test.unranged"):
            torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert ("test.ranged" in names) == ranges
    assert "test.unranged" not in names


LC_CFG = {
    "icp": {"voxel_size": 0.08, "max_iterations": 20,
            "error_reject_threshold": 5.0},
    "features": {"method": "rotation_search", "rotation_voxel_size": 0.3,
                 "angle_step_coarse": 6.0, "angle_step_fine": 1.0},
    "submap": {"enabled": True, "size": 4, "voxel_size": 0.08,
               "rotation_range": 6.0, "rotation_step": 2.0,
               "rotation_fine_step": 1.0, "rotation_voxel_size": 0.3},
    "loop_closure": {"enabled": True, "distance_threshold": 3.0,
                     "min_interval": 20, "min_cumulative_travel": 6.0,
                     "max_candidates": 3, "error_threshold": 0.1,
                     "optimization_iterations": 20, "information_scale": 5.0,
                     "cooldown": 5},
    "filter": {"z_min": 0.0, "z_max": 3.0},
    "mapping": {"resolution": 0.2, "margin": 5.0},
    "tpu": {"scan_capacity": 256, "submap_capacity": 1024,
            "max_ray_cells": 256, "batch_scans": 4, "distributed": False},
}
ENGINE_TOP = {"engine.pack", "engine.step", "engine.fetch", "engine.bookkeep",
              "engine.lc_gates", "engine.lc_verify", "engine.lc_apply"}
ENGINE_ALL = ENGINE_TOP | {
    "engine.prealign", "engine.submap", "icp.core", "map.paint",
    "pose_graph.solve", "pose_graph.pack", "pose_graph.dense_build",
    "pose_graph.dense_solve", "pose_graph.store", "pose_graph.total_error"}


def test_engine_log_spans_and_syncs(tmp_path, monkeypatch):
    """A 40-scan loop through SlamEngine (batches of 4, one closure, its
    rollback) records every stage's span, and its sync counters equal the
    sites the CPU probe saw it pass."""
    from icp_tpu_torch.engine import SlamEngine, filter_and_flatten
    from icp_tpu_torch.services.imu import IMUService
    from icp_tpu_torch.services.lidar import LidarService
    from icp_tpu_torch.utils.config import SlamConfig
    from icp_tpu_torch.utils.synth import generate_sequence

    lidar_f, imu_f = str(tmp_path / "lidar.csv"), str(tmp_path / "imu.csv")
    generate_sequence(lidar_f, imu_f, n_scans=40, n_beams=180, noise=0.005,
                      trajectory="loop", seed=5)
    scans, rels = [], []
    for _, rel, raw in LidarService(lidar_f).scans():
        scans.append(filter_and_flatten(raw, 0.0, 3.0))
        rels.append(rel)
    eng = SlamEngine(SlamConfig.from_dict(copy.deepcopy(LC_CFG)),
                     imu=IMUService(imu_f), verbose=False, device="cpu")
    probe = SyncProbe(monkeypatch)
    with spans.record("cpu") as spent:
        probe.on = True
        eng.process_scan(scans[0], rels[0])
        for k in range(1, len(scans), 4):
            eng.process_scans_batched(scans[k:k + 4], rels[k:k + 4])
        eng.finish()
        probe.on = False
    assert eng.stats.loop_closures == 1 and eng.stats.lc_requeued_scans > 0
    rec = spent.record
    tot = rec.totals()["spans"]
    assert ENGINE_ALL <= set(tot), sorted(ENGINE_ALL - set(tot))
    top = {e[0].name for e in rec.entries if e[1] < 0}
    assert top == ENGINE_TOP | {"map.paint"}, top      # the batch's paint
    counts = _syncs(rec)
    assert sum(counts.values()) == sum(probe.sites.values()), (
        counts, dict(probe.sites))
    c = rec.totals()["counts"]
    assert 0 < c["nn.pairs_valid"] < c["nn.pairs_computed"], c


def test_scaled_steps_spans_and_syncs(monkeypatch):
    """The scaled pipeline (small widths) through its closure checks, an
    online bundle adjustment and the map's replay records every stage's
    span, and its sync counters equal the sites the CPU probe saw it
    pass."""
    from icp_tpu_torch.parallel.scaled import ScaledPipeline
    from icp_tpu_torch.utils.synth import large_scan_stream, make_dense_world

    rng = np.random.default_rng(0)
    world = make_dense_world(rng, n_points=120_000, extent=10.0, n_walls=60)
    pts = [s for s, _ in large_scan_stream(
        40, n_points=1536, extent=10.0, max_range=9.0, noise=0.01, seed=1,
        world_points=world)]
    pipe = ScaledPipeline(
        "cpu", scan_capacity=1536, extent=10.0, map_resolution=0.25,
        map_margin=4.0, max_range=9.0, icp_max_corr=1.5,
        icp_max_iterations=25, icp_grid_shape=(32, 32), icp_cell_cap=64,
        icp_qcells=1024, kf_capacity=1024, kf_voxel=0.2, lc_every=2,
        lc_min_interval=16, lc_distance=3.0, lc_min_travel=8.0,
        lc_error_threshold=0.08, dist_node_threshold=2)
    probe = SyncProbe(monkeypatch)
    with spans.record("cpu") as spent:
        probe.on = True
        for p in pts:
            pipe.step(p)
        pipe.optimize(5)
        probe.on = False
    assert pipe.stats.loop_closures >= 1 and pipe.stats.ba_runs >= 1
    rec = spent.record
    tot = rec.totals()["spans"]
    want = {"scaled.pack", "scaled.register", "scaled.keyframe", "icp.large",
            "map.paint", "scaled.drain", "scaled.bookkeep",
            "scaled.closure_check", "scaled.ba", "scaled.replay",
            "icp.core", "pose_graph.solve"}
    assert want <= set(tot), sorted(want - set(tot))
    top = {e[0].name for e in rec.entries if e[1] < 0}
    assert {"scaled.pack", "scaled.register", "map.paint", "scaled.drain",
            "scaled.keyframe", "scaled.closure_check", "scaled.ba",
            "scaled.replay"} <= top, top
    c = rec.totals()["counts"]
    # on the CPU every step that finds steps pending drains them at once
    assert c["scaled.ready_drains"] == c["scaled.ready_checks"] > 20, c
    counts = _syncs(rec)
    assert "sync.scaled.drain_wait" not in counts      # no event on the CPU
    assert sum(counts.values()) == sum(probe.sites.values()), (
        counts, dict(probe.sites))


READERS = {
    # metric: (the hand-made record's spans and counts, the value a scan)
    "icp.ms_per_scan": 6.0,
    "map.paint_ms_per_scan": 4.0,
    "host.syncs_per_scan": 3.0,
    "host.bookkeep_ms_per_scan": 3.5,
    "engine.submap_ms_per_scan": 1.5,
    "engine.pose_graph_ms_per_scan": 2.0,
    "scaled.keyframe_ms_per_scan": 0.5,
    "kernel.nn_cuda.valid_pair_pct": 25.0,
    "icp.graph_chunk_pct": 75.0,
    "scaled.ready_drain_pct": 80.0,
}


def _hand_made_record():
    """A profiler session's record of 2 scans, each span's times set by
    hand (host ms; self ms less the children)."""
    with profile():
        for name in ("engine.submap", "icp.core", "icp.large", "map.paint",
                     "map.replay", "engine.fetch", "engine.bookkeep",
                     "scaled.bookkeep", "pose_graph.solve",
                     "scaled.keyframe"):
            spans.count("test.seen")
            with spans.span(name):
                pass
        spans.count("sync.a", 4)
        spans.count("sync.b", torch.tensor(2))
        spans.count("nn.pairs_computed", 400)
        spans.count("nn.pairs_valid", (torch.tensor(10.0), torch.tensor(10)))
        spans.count("icp.graph_replays", 3)
        spans.count("icp.eager_chunks")
        spans.count("scaled.ready_checks", 5)
        spans.count("scaled.ready_drains", 4)
    rec = spans._prec
    ms = {"engine.submap": 5.0, "icp.core": 2.0, "icp.large": 10.0,
          "map.paint": 3.0, "map.replay": 5.0, "engine.fetch": 1.0,
          "engine.bookkeep": 2.0, "scaled.bookkeep": 4.0,
          "pose_graph.solve": 4.0, "scaled.keyframe": 1.0}
    t = 0.0
    for e in rec.entries:
        e[2], e[3] = t, t + ms[e[0].name] / 1e3
        t = e[3]
    # icp.core (2 ms) inside engine.submap (5 ms): submap's own time is 3
    rec.entries[1][1] = 0
    rec._totals = None


@pytest.mark.parametrize("metric", sorted(READERS))
def test_metric_readers(metric):
    """Each of the benchmark's readers of the span record: None without a
    traced slice, without a kernel in it, or without a record; its value
    over the slice's scans on a hand-made record."""
    from slambench import harness as H

    read = H.metric_reader(metric).read
    assert read(H.Run()) is None
    _hand_made_record()
    slice_ = {"scans": 2, "launches": 10}
    assert read(H.Run(trace=dict(slice_, launches=0))) is None
    assert read(H.Run(trace=slice_)) == pytest.approx(READERS[metric])
    with profile():
        pass                                   # an empty session
    assert read(H.Run(trace=slice_)) is None


def test_idle_by_stage_on_hand_made_events():
    """The card's idle time split by the innermost host range, from the
    union of the kernel intervals; time in no range is 'outside spans'."""
    from icp_tpu_torch.tools.profile_trace import OUTSIDE, idle_by_stage

    kernels = [(10, 20), (15, 25), (40, 45), (90, 95)]
    ranges = [(0, 60, "a.outer"), (30, 50, "a.inner"), (70, 100, "b.next")]
    idle, busy = idle_by_stage(kernels, ranges, (0, 100))
    assert busy == 15 + 5 + 5
    assert idle == {"a.outer": 10 + 5 + 10, "a.inner": 10 + 5,
                    OUTSIDE: 10, "b.next": 20 + 5}
    assert sum(idle.values()) + busy == 100
