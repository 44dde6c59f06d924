"""Loop closure in icp_tpu_torch against icp_tpu (JAX on the CPU): the map
replay, the verification of candidate pairs, the candidate gates and the
cooldown, the slice as a whole on a 40-scan loop (batched with rollback and
per scan), and checkpoints carried across the two packages.

The sequence is a 40-scan x 180-beam ``trajectory="loop"`` run (seed 5)
with the dryrun config of test_torch_slam.py, ICP capped at 20 iterations,
reduced capacities and a loop-closure section that closes the loop once
(node 37 to node 0) and exercises the rollback. The engines run once per
module and every test reads their results. The same loop also runs with
``features.method: "both"`` (verification by rotation search, feature
alignment and ICP, with icp_tpu's RANSAC uniforms injected) and through
the modular path (``tpu.fused: false``). The `gpu`-marked test runs the
loop-closure path on a card against the same path on the CPU
(``python -m pytest --noconftest -m gpu tests/test_torch_loop_closure.py``;
JAX is imported only inside the tests that use it).
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from icp_tpu_torch.engine import SlamEngine as TEngine, filter_and_flatten  # noqa: E402
from icp_tpu_torch.models.occupancy import OccupancyGrid2D as TGrid  # noqa: E402
from icp_tpu_torch.services.imu import IMUService as TIMU  # noqa: E402
from icp_tpu_torch.services.lidar import LidarService  # noqa: E402
from icp_tpu_torch.utils.config import SlamConfig as TConfig  # noqa: E402
from icp_tpu_torch.utils.metrics import ate  # noqa: E402
from icp_tpu_torch.utils.synth import generate_sequence  # noqa: E402
from test_torch_features import JaxRansacStream, uninstall_stream  # noqa: E402

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
WARM_AT = 3          # batched runs call warmup() after this many batches


# features.method "both": the knobs of test_torch_slam.py's features runs
BOTH_SECTION = {"method": "both", "voxel_size": 0.15, "ransac_iterations": 128,
                "top_n": 32, "k_descriptor": 8, "min_kp_dist": 0.2}


def _cfg(B, features=None, fused=True):
    d = copy.deepcopy(LC_CFG)
    d["tpu"]["batch_scans"] = B
    d["tpu"]["fused"] = fused
    if features:
        d["features"].update(features)
    return d


def _engines(B, imu_f, features=None, fused=True):
    from icp_tpu.engine import SlamEngine
    from icp_tpu.services.imu import IMUService
    from icp_tpu.utils.config import SlamConfig

    d = _cfg(B, features, fused)
    return (TEngine(TConfig.from_dict(d), imu=TIMU(imu_f), verbose=False,
                    device="cpu"),
            SlamEngine(SlamConfig.from_dict(d), imu=IMUService(imu_f),
                       verbose=False))


def _host(grid):
    """A grid of either package as a numpy copy."""
    if isinstance(grid, torch.Tensor):
        return grid.cpu().numpy().copy()
    return np.array(grid, copy=True)


def _drive(eng, scans, rels, B, record=None):
    """First scan, then batches of B (warmup() after WARM_AT batches) or
    single scans (warmup() right after the first), finish, sync_map."""
    eng.process_scan(scans[0], rels[0])
    if B == 1:
        eng.warmup()
        for p, r in zip(scans[1:], rels[1:]):
            eng.process_scan(p, r)
    else:
        for n, k in enumerate(range(1, len(scans), B)):
            if n == WARM_AT:
                eng.sync_map()
                before = _host(eng.mapper.log_odds)
                eng.warmup()
                if record is not None:
                    record.update(before=before,
                                  after=_host(eng.mapper.log_odds),
                                  aliased=eng.mapper.log_odds
                                  is getattr(eng._state, "log_odds", None))
            eng.process_scans_batched(scans[k:k + B], rels[k:k + B])
    eng.finish()
    eng.sync_map()
    return eng


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    td = tmp_path_factory.mktemp("lcloop")
    lidar_f, imu_f = str(td / "lidar.csv"), str(td / "imu.csv")
    gt = generate_sequence(lidar_f, imu_f, n_scans=40, n_beams=180,
                           noise=0.005, trajectory="loop", seed=5)
    scans, rels = [], []
    for _, rel, raw in LidarService(lidar_f).scans():
        scans.append(filter_and_flatten(raw, 0.0, 3.0))
        rels.append(rel)
    return gt, scans, rels, imu_f


@pytest.fixture(scope="module")
def runs(seq):
    """{B: (port engine, icp_tpu engine, warmup record)} for B = 4, 1."""
    gt, scans, rels, imu_f = seq
    out = {}
    for B in (4, 1):
        et, ej = _engines(B, imu_f)
        rec = {}
        _drive(et, scans, rels, B, record=rec)
        _drive(ej, scans, rels, B)
        out[B] = (et, ej, rec)
    return out


@pytest.fixture(scope="module")
def runs_both(seq):
    """(port engine, icp_tpu engine) on the loop, batches of 4, with
    features.method "both"; the port's verification draws icp_tpu's
    per-lane RANSAC uniforms."""
    gt, scans, rels, imu_f = seq
    et, ej = _engines(4, imu_f, BOTH_SECTION)
    stream = JaxRansacStream(int(BOTH_SECTION["ransac_iterations"])).install()
    try:
        stream.wrap_verification(et)
        _drive(et, scans, rels, 4)
    finally:
        uninstall_stream()
    assert not stream.lanes
    _drive(ej, scans, rels, 4)
    return et, ej


@pytest.fixture(scope="module")
def runs_modular(seq):
    """(port engine, icp_tpu engine) on the loop through the modular path
    (tpu.fused: false), scan by scan; icp_tpu's map is read after
    sync_map, as it leaves it."""
    gt, scans, rels, imu_f = seq
    et, ej = _engines(4, imu_f, fused=False)
    _drive(et, scans, rels, 1)
    for p, r in zip(scans, rels):
        ej.process_scan(p, r)
    ej.sync_map()
    return et, ej


def _lc_edges(pg):
    return [(i, j) for i, j in zip(pg._edges_i, pg._edges_j) if abs(i - j) != 1]


# ── (e) map replay ────────────────────────────────────────────────────────
def test_replay_matches_icp_tpu_and_leaves_aliases_alone():
    """replay() of 6 keyframes (a padding keyframe, repeated hits that
    saturate a cell, per-scan clamps) against icp_tpu's to 1e-5; the grid
    is a new tensor, so a tensor that aliased the old grid keeps its
    values; reset() zeroes into a new tensor too."""
    from icp_tpu.models.occupancy import OccupancyGrid2D as JGrid

    rng = np.random.default_rng(0)
    K, N = 6, 120
    origins = rng.uniform(-2, 2, (K, 2)).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, (K, N))
    r = rng.uniform(1, 8, (K, N))
    hits = (origins[:, None, :]
            + np.stack([r * np.cos(ang), r * np.sin(ang)], -1)).astype(np.float32)
    hits[:, :12] = np.float32([3.05, 3.05])     # one cell hit 12x per scan
    masks = rng.random((K, N)) < 0.9
    masks[:, :12] = True
    masks[4] = False                            # a padding keyframe
    jg = JGrid(-10, 10, -10, 10, resolution=0.2, max_ray_cells=128,
               free_cells_cap=8192)
    tg = TGrid(-10, 10, -10, 10, resolution=0.2, max_ray_cells=128,
               device="cpu")
    alias = tg.log_odds
    alias.fill_(1.5)
    jg.replay(origins, hits, masks)
    tg.replay(origins, hits, masks)
    got = tg.log_odds.numpy()
    np.testing.assert_allclose(got, np.asarray(jg.log_odds), atol=1e-5)
    assert got.max() == np.float32(tg.log_odds_max)     # saturated, clamped
    assert (got < 0).any()
    assert bool((alias == 1.5).all())
    old = tg.log_odds
    tg.reset()
    assert tg.log_odds is not old and not bool(tg.log_odds.any())
    assert bool((old.numpy() == got).all())


# ── (f) verification of candidate pairs ───────────────────────────────────
def test_lc_verify_pairs_matches_icp_tpu(seq):
    """5 (source, candidate) pairs of raw scans: R to 1e-4, t to 1e-3,
    error to rtol 1e-3, equal iterations, and ceil(5 / 4) = 2 groups in
    both packages."""
    gt, scans, rels, imu_f = seq
    et, ej = _engines(4, imu_f)
    pairs = [(scans[37], scans[0]), (scans[38], scans[1]),
             (scans[36], scans[2]), (scans[20], scans[0]),
             (scans[5], scans[5])]
    vt = et._lc_verify_pairs(pairs)
    vj = ej._lc_verify_pairs(pairs)
    assert et.stats.lc_groups == ej.stats.lc_groups == 2
    for (Rt, tt, errt, itt), (Rj, tj, errj, itj) in zip(vt, vj):
        np.testing.assert_allclose(Rt, Rj, atol=1e-4)
        np.testing.assert_allclose(tt, tj, atol=1e-3)
        np.testing.assert_allclose(errt, errj, rtol=1e-3, atol=1e-9)
        assert itt == itj
    errs = [v[2] for v in vt]
    assert errs[0] < 0.1 < errs[3]             # a true and a false closure


# ── (g) gates and cooldown ────────────────────────────────────────────────
def _unit_engine(cooldown):
    return TEngine(TConfig.from_dict({
        "icp": {"voxel_size": 0.08},
        "submap": {"enabled": False},
        "loop_closure": {"enabled": True, "min_interval": 2,
                         "cooldown": cooldown},
        "filter": {"z_min": 0.0, "z_max": 3.0},
        "tpu": {"distributed": False},
    }), verbose=False, device="cpu")


def _spy(eng):
    calls = []
    eng._find_loop_candidates = lambda cur_idx, cur_xy=None: (
        calls.append(cur_idx), [])[1]
    return calls


def test_cooldown_suppresses_search_window():
    eng = _unit_engine(cooldown=10)
    calls = _spy(eng)
    pts = np.zeros((32, 2), np.float32)
    eng._last_lc_accept = 100
    assert eng._lc_find(pts, 105) is None       # inside the window
    assert calls == []
    assert eng._lc_find(pts, 110) is None       # window expired
    assert calls == [110]


def test_cooldown_zero_is_reference_behavior():
    eng = _unit_engine(cooldown=0)
    calls = _spy(eng)
    eng._last_lc_accept = 100
    eng._lc_find(np.zeros((32, 2), np.float32), 101)
    assert calls == [101]


def test_accept_arms_the_cooldown():
    """_lc_apply records the accepting node, flags the edge robust when
    configured, caps its information and optimizes the graph."""
    eng = _unit_engine(cooldown=10)
    eng.cfg.lc_robust, eng.cfg.lc_info_cap = True, 50.0
    eng.pose_graph.add_node(np.zeros(3, np.float32))
    eng.pose_graph.add_node(np.array([1.0, 0.0, 0.0], np.float32))
    assert eng._last_lc_accept is None
    eng._lc_apply(1, 0, 1.0, np.eye(2, dtype=np.float32),
                  np.array([1.0, 0.0], np.float32), 0.01)
    assert eng._last_lc_accept == 1 and eng.stats.loop_closures == 1
    assert eng.pose_graph._edges_rb == [True]
    np.testing.assert_allclose(eng.pose_graph._edges_om[0], np.eye(3) * 50.0)
    np.testing.assert_allclose(eng.pose_graph._edges_z[0], [-1.0, 0.0, 0.0],
                               atol=1e-6)
    assert eng.pose_graph.last_strategy == "dense"


def test_cooldown_survives_checkpoint(tmp_path):
    eng = _unit_engine(cooldown=10)
    eng.pose_graph.add_node(np.zeros(3, np.float32))
    eng._last_lc_accept = 7
    eng.stats.scans, eng.stats.rejected = 9, 2
    ck = str(tmp_path / "ck.npz")
    eng.save_checkpoint(ck)
    eng2 = _unit_engine(cooldown=10)
    eng2.load_checkpoint(ck)
    assert eng2._last_lc_accept == 7
    assert eng2.stats.scans == 9 and eng2.stats.rejected == 2
    calls = _spy(eng2)
    pts = np.zeros((32, 2), np.float32)
    assert eng2._lc_find(pts, 12) is None
    assert calls == []
    assert eng2._lc_find(pts, 17) is None
    assert calls == [17]


@pytest.mark.parametrize("seed", [0, 1])
def test_candidate_gates_match_icp_tpu(seed):
    """_gate_candidates and _find_loop_candidates on a random walk that
    revisits its start: the same (node, distance) lists as icp_tpu's."""
    from icp_tpu.engine import SlamEngine, ScanRecord as JRec
    from icp_tpu.utils.config import SlamConfig
    from icp_tpu_torch.engine import ScanRecord as TRec

    d = {"loop_closure": {"enabled": True, "distance_threshold": 2.5,
                          "min_interval": 5, "min_cumulative_travel": 3.0,
                          "max_candidates": 3},
         "tpu": {"distributed": False}}
    et = TEngine(TConfig.from_dict(d), verbose=False, device="cpu")
    ej = SlamEngine(SlamConfig.from_dict(d), verbose=False)
    rng = np.random.default_rng(seed)
    ang = np.linspace(0, 2 * np.pi, 40) + rng.normal(0, 0.05, 40)
    xy = (np.stack([np.cos(ang), np.sin(ang)], 1) * 4
          + rng.normal(0, 0.3, (40, 2))).astype(np.float32)
    for k in range(40):
        pose = np.eye(3, dtype=np.float32)
        pose[:2, 2] = xy[k]
        et.scan_history.append(TRec(np.zeros((1, 2), np.float32), pose))
        ej.scan_history.append(JRec(np.zeros((1, 2), np.float32), pose))
    found = 0
    for cur in range(10, 40):
        a = et._gate_candidates(xy[: cur + 1], cur)
        assert a == ej._gate_candidates(xy[: cur + 1], cur)
        et.global_pose = ej.global_pose = et.scan_history[cur].pose
        assert et._find_loop_candidates(cur) == ej._find_loop_candidates(cur)
        found += bool(a)
    assert found > 0


# ── (h) the slice as a whole ──────────────────────────────────────────────
@pytest.mark.parametrize("B", [4, 1], ids=["batched", "per_scan"])
def test_loop_slice_matches_icp_tpu(seq, runs, B):
    """The 40-scan loop through both engines: the same closure (node 37 to
    node 0), equal loop-closure counters and pose indices, positions within
    5 mm, the same ATE to 1e-4 m, and the map after sync_map within 1e-3.

    ``lc_requeued_scans`` is the port's own count: it re-queues only the
    accepted chunk's tail, while icp_tpu re-queues the chunk it keeps in
    flight behind it too. The closure lies at position 0 of the last chunk
    (scans 37-39), behind which nothing is in flight, so both count 2
    here; per scan nothing is re-queued.

    Measured gap: positions differ by at most 5.7e-6 m. One map cell of
    the final replay differs, by 0.207 log-odds (-5.0 against -4.79): a
    ray end that lies on a cell boundary falls into the next cell under
    the 5.7e-6 m pose difference. Replaying the port's history at
    icp_tpu's poses gives icp_tpu's map to 1e-3, and that is what the map
    check holds, beside a bound of one differing cell."""
    gt, scans, rels, imu_f = seq
    et, ej, _ = runs[B]
    for f in ("scans", "rejected", "submap_corrections", "loop_closures",
              "lc_checks", "lc_pairs", "lc_groups", "icp_iters"):
        assert getattr(et.stats, f) == getattr(ej.stats, f), f
    assert et.stats.loop_closures == 1
    assert et.stats.lc_requeued_scans == (2 if B > 1 else 0)
    if B > 1:
        assert et.stats.lc_pairs == 6
    assert _lc_edges(et.pose_graph) == _lc_edges(ej.pose_graph) == [(37, 0)]
    assert et._last_lc_accept == ej._last_lc_accept == 37
    np.testing.assert_array_equal(et.pose_scan_indices, ej.pose_scan_indices)
    pt, pj = np.stack(et.pose_trajectory), np.stack(ej.pose_trajectory)
    np.testing.assert_allclose(pt[:, :2, 2], pj[:, :2, 2], atol=5e-3)
    yt = np.arctan2(pt[:, 1, 0], pt[:, 0, 0])
    yj = np.arctan2(pj[:, 1, 0], pj[:, 0, 0])
    np.testing.assert_allclose(yt, yj, atol=1e-3)
    at = ate(pt[:, :2, 2], gt, indices=et.pose_scan_indices)
    aj = ate(pj[:, :2, 2], gt, indices=ej.pose_scan_indices)
    assert abs(at - aj) < 1e-4 and at < 0.2
    lt, lj = et.mapper.log_odds.numpy(), np.asarray(ej.mapper.log_odds)
    assert int((np.abs(lt - lj) > 1e-3).sum()) <= 1
    assert et.mapper.log_odds is et._state.log_odds
    hist = [r.pose.copy() for r in et.scan_history]
    for r, rj in zip(et.scan_history, ej.scan_history):
        r.pose = rj.pose.copy()
    et._rebuild_map()
    np.testing.assert_allclose(et.mapper.log_odds.numpy(), lj, atol=1e-3)
    for r, p in zip(et.scan_history, hist):
        r.pose = p
    et._map_dirty = True
    et.sync_map()                              # restore the fixture's map


def test_loop_with_both_alignment_matches_icp_tpu(seq, runs_both):
    """features.method "both" (IMU on, so features run only in
    verification): both packages accept the same closure (37 to 0) with
    equal loop-closure counters; positions within 5 mm and the ATE to
    1e-4 m. ``lc_requeued_scans`` is the port's own count, the accepted
    chunk's tail (2: see test_loop_slice_matches_icp_tpu)."""
    gt, scans, rels, imu_f = seq
    et, ej = runs_both
    for f in ("scans", "rejected", "submap_corrections", "loop_closures",
              "lc_checks", "lc_pairs", "lc_groups"):
        assert getattr(et.stats, f) == getattr(ej.stats, f), f
    assert et.stats.lc_requeued_scans == 2
    assert _lc_edges(et.pose_graph) == _lc_edges(ej.pose_graph) == [(37, 0)]
    pt, pj = np.stack(et.pose_trajectory), np.stack(ej.pose_trajectory)
    np.testing.assert_allclose(pt[:, :2, 2], pj[:, :2, 2], atol=5e-3)
    at = ate(pt[:, :2, 2], gt, indices=et.pose_scan_indices)
    aj = ate(pj[:, :2, 2], gt, indices=ej.pose_scan_indices)
    assert abs(at - aj) < 1e-4 and at < 0.2


def test_modular_loop_replays_map_after_closure(seq, runs_modular):
    """The modular path (tpu.fused: false) on the loop: the same closure
    and counters as icp_tpu's modular path, positions within 5 mm. After
    sync_map the port's map is the replay at the corrected poses: icp_tpu's
    own sync_map skips that replay on this path (its map keeps the
    pre-closure paints), and once icp_tpu's _rebuild_map() is called by
    hand the two maps agree within 1e-3 in all but at most one cell (the
    cell-boundary flip of test_loop_slice_matches_icp_tpu)."""
    gt, scans, rels, imu_f = seq
    et, ej = runs_modular
    assert et._state is None and ej._state is None
    for f in ("scans", "rejected", "submap_corrections", "loop_closures",
              "lc_checks", "icp_iters"):
        assert getattr(et.stats, f) == getattr(ej.stats, f), f
    assert _lc_edges(et.pose_graph) == _lc_edges(ej.pose_graph) == [(37, 0)]
    pt, pj = np.stack(et.pose_trajectory), np.stack(ej.pose_trajectory)
    np.testing.assert_allclose(pt[:, :2, 2], pj[:, :2, 2], atol=5e-3)
    lt = et.mapper.log_odds.numpy()
    stale = _host(ej.mapper.log_odds)
    ej._rebuild_map()
    lj = _host(ej.mapper.log_odds)
    assert int((np.abs(stale - lj) > 1e-3).sum()) > 100   # icp_tpu's stale map
    assert int((np.abs(lt - lj) > 1e-3).sum()) <= 1
    assert not et._map_dirty


def test_warmup_keeps_the_fused_grid(runs):
    """warmup() mid-run replays the map into the mapper and then points the
    mapper back at the fused state's grid, as icp_tpu's does: the grid is
    unchanged and still aliased afterwards."""
    rec = runs[4][2]
    assert rec["aliased"]
    np.testing.assert_array_equal(rec["after"], rec["before"])


def test_lc_off_is_worse_on_the_loop(seq, runs):
    """With loop closure off the same port engine ends with a larger ATE,
    so the closure does correct the loop."""
    gt, scans, rels, imu_f = seq
    d = _cfg(4)
    d["loop_closure"]["enabled"] = False
    eng = _drive(TEngine(TConfig.from_dict(d), imu=TIMU(imu_f),
                         verbose=False, device="cpu"), scans, rels, 4)
    p_off = np.stack(eng.pose_trajectory)[:, :2, 2]
    et = runs[4][0]
    a_on = ate(np.stack(et.pose_trajectory)[:, :2, 2], gt,
               indices=et.pose_scan_indices)
    a_off = ate(p_off, gt, indices=eng.pose_scan_indices)
    assert eng.stats.loop_closures == 0 and a_on < a_off


# ── (i) checkpoints across the packages ───────────────────────────────────
def _run_to_first_closure(eng, scans, rels):
    eng.process_scan(scans[0], rels[0])
    for k in range(1, len(scans)):
        eng.process_scan(scans[k], rels[k])
        if eng.stats.loop_closures:
            return k
    raise AssertionError("no closure")


def test_icp_tpu_checkpoint_resumes_in_port(seq, runs, tmp_path):
    """icp_tpu checkpoints right after the first closure; the port loads it
    (grid, graph with robust flags, history, counters, cooldown) and
    finishes the sequence on the trajectory of icp_tpu's uninterrupted run
    to 5e-3."""
    gt, scans, rels, imu_f = seq
    _, ej_full, _ = runs[1]
    ej = _engines(1, imu_f)[1]
    cut = _run_to_first_closure(ej, scans, rels)
    ck = str(tmp_path / "jax.npz")
    ej.save_checkpoint(ck)

    et = _engines(1, imu_f)[0]
    et.load_checkpoint(ck)
    assert et._last_lc_accept == ej._last_lc_accept == 37
    assert et.stats.scans == ej.stats.scans
    assert et.pose_graph._edges_rb == ej.pose_graph._edges_rb
    np.testing.assert_array_equal(et.mapper.log_odds.numpy(),
                                  np.asarray(ej.mapper.log_odds))
    assert et.mapper.log_odds is et._state.log_odds
    for p, r in zip(scans[cut + 1:], rels[cut + 1:]):
        et.process_scan(p, r)
    et.finish()
    et.sync_map()
    assert et.stats.loop_closures == 0          # inside the cooldown window
    a = np.stack(ej_full.pose_trajectory)[:, :2, 2]
    b = np.stack(et.pose_trajectory)[:, :2, 2]
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, atol=5e-3)


def test_port_checkpoint_resumes_in_icp_tpu(seq, runs, tmp_path):
    """The port checkpoints right after its first closure; icp_tpu loads it
    and finishes the sequence on the port's uninterrupted trajectory to
    5e-3, with the port's keys, grid and graph."""
    from icp_tpu.engine import SlamEngine

    gt, scans, rels, imu_f = seq
    et_full = runs[1][0]
    et = _engines(1, imu_f)[0]
    cut = _run_to_first_closure(et, scans, rels)
    ck = str(tmp_path / "port.npz")
    et.save_checkpoint(ck)
    keys = set(np.load(ck).files)
    j_ck = str(tmp_path / "jax_keys.npz")
    ej0 = _engines(1, imu_f)[1]
    ej0.save_checkpoint(j_ck)
    assert keys == set(np.load(j_ck).files)

    ej = _engines(1, imu_f)[1]
    assert isinstance(ej, SlamEngine)
    ej.load_checkpoint(ck)
    assert ej._last_lc_accept == et._last_lc_accept
    assert ej.pose_graph._edges_rb == et.pose_graph._edges_rb
    np.testing.assert_array_equal(np.asarray(ej.mapper.log_odds),
                                  et.mapper.log_odds.numpy())
    for p, r in zip(scans[cut + 1:], rels[cut + 1:]):
        ej.process_scan(p, r)
    a = np.stack(et_full.pose_trajectory)[:, :2, 2]
    b = np.stack(ej.pose_trajectory)[:, :2, 2]
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, atol=5e-3)


# ── on the card ───────────────────────────────────────────────────────────
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m gpu)")
    return torch.device("cuda:0")


@pytest.mark.gpu
def test_loop_closure_on_card_matches_cpu(seq, cuda_device):
    """The loop-closure path on the card against the same path on the CPU:
    pose-graph solves (dense and PCG), the map replay, the verification of
    three pairs (through both kernels), and the 40-scan loop batched, with
    the same closure and positions within 5 mm."""
    from icp_tpu_torch.models.pose_graph import PoseGraph2D
    from icp_tpu_torch.ops.hopper import nn_kernel as K

    gt, scans, rels, imu_f = seq
    for thr, tol in ((2000, 1e-4), (2, 5e-4)):      # dense, then PCG
        out = []
        for dev in ("cpu", cuda_device):
            pg = PoseGraph2D(dev)
            pg._cg_node_threshold = thr
            rng = np.random.default_rng(2)
            for k in range(64):
                pg.add_node([k * 0.5 + rng.normal(0, 0.05), rng.normal(0, 0.05),
                             rng.normal(0, 0.01)])
            for k in range(1, 64):
                pg.add_edge(k - 1, k, [0.5, 0.0, 0.0], np.eye(3))
            pg.add_edge(63, 0, [-31.4, 0.2, 0.0], np.eye(3) * 50.0,
                        robust=True)
            pg.optimize(n_iterations=20)
            out.append(np.stack(pg.nodes))
        np.testing.assert_allclose(out[1], out[0], atol=tol)

    rng = np.random.default_rng(0)
    origins = rng.uniform(-2, 2, (5, 2)).astype(np.float32)
    hits = (origins[:, None] + rng.uniform(-8, 8, (5, 300, 2))).astype(np.float32)
    masks = rng.random((5, 300)) < 0.9
    grids = []
    for dev in ("cpu", cuda_device):
        g = TGrid(-10, 10, -10, 10, resolution=0.2, max_ray_cells=128,
                  device=dev)
        g.replay(origins, hits, masks)
        grids.append(g.log_odds.cpu().numpy())
    np.testing.assert_allclose(grids[1], grids[0], atol=1e-4)

    et_cpu, _ = _engines(4, imu_f)
    et_gpu = TEngine(TConfig.from_dict(_cfg(4)), imu=TIMU(imu_f),
                     verbose=False, device=cuda_device)
    pairs = [(scans[37], scans[0]), (scans[20], scans[0]), (scans[5], scans[5])]
    K.reset_launch_counts()
    vg = et_gpu._lc_verify_pairs(pairs)
    assert K.nn_launches > 0 and K.nn_min_launches > 0
    for (Rg, tg, eg, _), (Rc, tc, ec, _) in zip(vg,
                                                et_cpu._lc_verify_pairs(pairs)):
        np.testing.assert_allclose(Rg, Rc, atol=1e-3)
        np.testing.assert_allclose(tg, tc, atol=5e-3)
        np.testing.assert_allclose(eg, ec, rtol=1e-2, atol=1e-6)

    _drive(et_gpu, scans, rels, 4)
    _drive(et_cpu, scans, rels, 4)
    assert _lc_edges(et_gpu.pose_graph) == _lc_edges(et_cpu.pose_graph)
    assert et_gpu.stats.loop_closures == 1
    pg_, pc = np.stack(et_gpu.pose_trajectory), np.stack(et_cpu.pose_trajectory)
    np.testing.assert_allclose(pg_[:, :2, 2], pc[:, :2, 2], atol=5e-3)
    assert bool(torch.isfinite(et_gpu.mapper.log_odds).all())
