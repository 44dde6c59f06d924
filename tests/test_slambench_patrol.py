"""The benchmark's patrol cell (``scaled_100k_patrol.patrol``) at a tiny size
on the CPU, and its plain DCS reference.

* ``slambench/reference/robust_graph.py`` against ``PoseGraph2D.optimize``
  on seeded 60-node loops with robust closure edges, one of them an
  outlier: they agree with the flags on, and a solve with the flags off
  lands far outside the tolerance;
* whole runs through ``slambench.run.measure`` (the harness's look for a
  card skipped): a sound run is ``correct``; a closure edge's ``z``
  altered where it is produced, a BA solved without its robust flags and
  a ``sync_map`` that skips the un-paint each make a run not correct; the
  bfloat16 control fails the comparison.

The tiny runs keep the cell's structure (a lap in set-up, closures, BAs
and replays in the window, the map refreshed on a cadence) at small
widths. Two of their values make the faults visible at that size: a DCS
scale ``lc_robust_phi`` of 3e-3 (at the cell's 1.0 the sound closures end
inside it, DCS leaves every solve as it is and dropping the flags changes
no output), and a 0.1 m map (the replay's tolerance of 0.3 cell then
lets a BA's corrections reach the map).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from slambench import run as R
from slambench.drivers import patrol_stream as D
from slambench.reference import robust_graph as RG

WORKLOAD = "scaled_100k_patrol.patrol"
SEED = 2**31 + 977
TRAFFIC = {"lap_scans": 32, "path_extent": 8.0, "setup_scans": 40,
           "refresh_every": 8, "ate_scans": 56, "check_scans": 8,
           "check_closures": 4, "check_bas": 16, "trace_start_step": 4,
           "trace_steps": 8}
CONFIG = {"points_per_scan": 512, "keyframes": 120,
          "world": {"points": 100_000, "extent": 12.0, "walls": 40},
          "program": {"scan_capacity": 512, "kf_capacity": 512,
                      "icp_grid_shape": [48, 48], "icp_qcells": 512,
                      "icp_cell_cap": 32, "map_resolution": 0.1,
                      "lc_every": 4, "lc_min_interval": 16,
                      "lc_distance": 5.0, "lc_min_travel": 22.0,
                      "lc_cooldown": 6, "lc_max_candidates": 2,
                      "lc_robust_phi": 3e-3}}
CHECKS = {"reg_gap_mm", "lc_gate_misses", "lc_err_excess", "lc_gap_mm",
          "traj_gap_mm", "map_diff_pct"}


def patrol_run(trace=False, control=False, seconds=1.0):
    return R.measure(WORKLOAD, SEED, seconds, trace, device="cpu",
                     traffic=TRAFFIC, config=CONFIG, control=control)


# ── the DCS reference ───────────────────────────────────────────────────
def _rel(a, b):
    c, s = np.cos(a[2]), np.sin(a[2])
    d = b[:2] - a[:2]
    return np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1],
                     (b[2] - a[2] + np.pi) % (2 * np.pi) - np.pi])


def _loop_graph(seed, n=60):
    """A noisy odometry chain round a 12 x 8 m ellipse (nodes by dead
    reckoning), three robust closures near its ends and one robust
    closure 1.5 m off."""
    rng = np.random.default_rng(seed)
    s = np.linspace(0, 2 * np.pi, n, endpoint=False)
    gt = np.stack([6 * np.cos(s), 4 * np.sin(s), s + np.pi / 2], 1)
    edges = [(i, i + 1, _rel(gt[i], gt[i + 1])
              + rng.normal(scale=[0.02, 0.02, 0.005]), 100.0, False)
             for i in range(n - 1)]
    nodes = [gt[0]]
    for _, _, z, _, _ in edges:
        a = nodes[-1]
        c, sn = np.cos(a[2]), np.sin(a[2])
        nodes.append(np.array([a[0] + c * z[0] - sn * z[1],
                               a[1] + sn * z[0] + c * z[1], a[2] + z[2]]))
    for i, j in ((n - 1, 0), (n - 2, 1), (n - 3, 2)):
        edges.append((i, j, _rel(gt[i], gt[j])
                      + rng.normal(scale=0.005, size=3), 1000.0, True))
    z = _rel(gt[n // 2 + 4], gt[3])
    z[:2] += 1.5
    edges.append((n // 2 + 4, 3, z, 1000.0, True))
    return np.array(nodes, np.float32), edges


# float32 carries 7 digits: 6e-7 m at these coordinates, grown by ten GN
# steps through a 180-unknown solve to the 1e-6 - 4e-6 m the flagged
# solves read; 1e-4 m leaves room above that and lies 10^4 times below
# the 1.6-1.8 m a solve without the flags moves the loop by
TOL_M = 1e-4


@pytest.mark.parametrize("flags", ["dcs_on", "dcs_off"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dcs_solve_matches_reference(seed, flags):
    from icp_tpu_torch.models.pose_graph import PoseGraph2D

    nodes, edges = _loop_graph(seed)
    pg = PoseGraph2D("cpu")
    for v in nodes:
        pg.add_node(v)
    for i, j, z, w, rb in edges:
        pg.add_edge(i, j, z.astype(np.float32),
                    np.eye(3, dtype=np.float32) * w,
                    robust=rb and flags == "dcs_on")
    pg.optimize(n_iterations=10, fix_node=0)
    prog = np.stack(pg.nodes).astype(np.float64)
    ref, iters = RG.solve(
        torch.as_tensor(nodes, dtype=torch.float64),
        [e[0] for e in edges], [e[1] for e in edges],
        np.stack([e[2] for e in edges]).astype(np.float32),
        np.stack([np.eye(3) * e[3] for e in edges]).astype(np.float32),
        [e[4] for e in edges], phi=pg.robust_phi, cap=1000.0, iters=10)
    assert 1 <= iters <= 10
    gap = float(np.linalg.norm(prog[:, :2] - ref.numpy()[:, :2],
                               axis=1).max())
    if flags == "dcs_on":
        assert gap < TOL_M, gap
    else:
        assert gap > 100 * TOL_M, gap


def test_dcs_scale():
    chi2 = torch.tensor([0.0, 1.0, 3.0, 99.0], dtype=torch.float64)
    assert RG.dcs_scale(chi2, 1.0).tolist() == [1.0, 1.0, 0.5, 0.02]


# ── whole runs ───────────────────────────────────────────────────────────
@pytest.fixture(scope="module")
def sound():
    return patrol_run(trace=True, control=True)


def test_patrol_sound_run(sound):
    run, metrics, _ = sound
    assert run.correct, run.checks
    assert run.attempted > 0 and run.failed == 0
    assert {n for n, _, _ in run.checks} == CHECKS
    assert set(metrics) == {"scaled.closure_ms_per_scan",
                            "scaled.ba_ms_per_scan",
                            "scaled.replay_ms_per_scan",
                            "scaled.closure_accept_pct"}
    assert 0 < metrics["scaled.closure_accept_pct"]["value"] <= 100
    notes = "\n".join(run.notes)
    assert "traced slice counters: scaled.lc_checks" in notes, notes


def test_patrol_control_fails(sound):
    run, _, _ = sound
    lim = {n: lim for n, _, lim in run.checks}
    assert set(run.control) == CHECKS
    assert any(v > lim[n] for n, v in run.control.items()), run.control


def _z_altered(monkeypatch):
    """Each robust (closure) edge's z moved by 5 cm as it enters the
    graph."""
    from icp_tpu_torch.models.pose_graph import PoseGraph2D

    orig = PoseGraph2D.add_edge

    def add_edge(self, i, j, z, information=None, robust=False):
        if robust:
            z = np.asarray(z, np.float32).copy()
            z[0] += 0.05
        return orig(self, i, j, z, information, robust)
    monkeypatch.setattr(PoseGraph2D, "add_edge", add_edge)


def _flags_dropped(monkeypatch):
    """Each solve runs with every robust flag off; the graph keeps them."""
    from icp_tpu_torch.models.pose_graph import PoseGraph2D

    orig = PoseGraph2D.optimize

    def optimize(self, *a, **k):
        flags = self._edges_rb
        self._edges_rb = [False] * len(flags)
        try:
            return orig(self, *a, **k)
        finally:
            self._edges_rb = flags
    monkeypatch.setattr(PoseGraph2D, "optimize", optimize)


def _unpaint_skipped(monkeypatch):
    """sync_map repaints the keyframes that moved without un-painting
    them."""
    from icp_tpu_torch.parallel.scaled import ScaledPipeline

    orig = ScaledPipeline._replay_set

    def replay_set(self, idxs, poses, sign):
        if sign > 0:
            return orig(self, idxs, poses, sign)
    monkeypatch.setattr(ScaledPipeline, "_replay_set", replay_set)


@pytest.mark.parametrize("fault", [_z_altered, _flags_dropped,
                                   _unpaint_skipped])
def test_patrol_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    run, _, _ = patrol_run()
    assert not run.correct, run.checks


def test_trace_slice_calls():
    """The traced slice's calls: the window's steps 128-191 (from 0: scans
    416-479) and the 3 refreshes between them, after 128 steps and 8
    refreshes."""
    assert D.slice_calls(288, 128, 64, 16) == (136, 67)
    assert D.slice_calls(40, 4, 8, 8) == (4, 9)
