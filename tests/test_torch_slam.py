"""The main path as a whole: icp_tpu_torch's fused SLAM step and engine
against icp_tpu's on the dryrun sequence (JAX on the CPU), plus the
package's import hygiene, its guards (a mesh needs more than one
device, a card needs CUDA), and its
CLI (loop closure and checkpoints included). The features path (no IMU,
"features" and "both") and the modular path (``tpu.fused: false``) are
held to icp_tpu's with icp_tpu's RANSAC uniforms injected
(test_torch_features.JaxRansacStream).

The sequence is the 10-scan x 120-beam straight run with the
__graft_entry__.py dryrun config (loop closure off, distributed off).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from icp_tpu_torch.engine import SlamEngine as TEngine, _pad_fixed, filter_and_flatten  # noqa: E402
from icp_tpu_torch.models.slam_step import (  # noqa: E402
    state_from_numpy, state_to_numpy)
from icp_tpu_torch.services.imu import IMUService as TIMU  # noqa: E402
from icp_tpu_torch.services.lidar import LidarService  # noqa: E402
from icp_tpu_torch.utils.config import SlamConfig as TConfig  # noqa: E402
from icp_tpu_torch.utils.synth import generate_sequence  # noqa: E402
from test_torch_features import JaxRansacStream  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DRYRUN_CFG = {
    "icp": {"voxel_size": 0.08, "max_iterations": 12,
            "error_reject_threshold": 5.0},
    "features": {"method": "rotation_search", "rotation_voxel_size": 0.3,
                 "angle_step_coarse": 6.0, "angle_step_fine": 1.0},
    "submap": {"enabled": True, "size": 4, "voxel_size": 0.08,
               "rotation_range": 6.0, "rotation_step": 2.0,
               "rotation_fine_step": 1.0, "rotation_voxel_size": 0.3},
    "loop_closure": {"enabled": False},
    "filter": {"z_min": 0.0, "z_max": 3.0},
    "mapping": {"resolution": 0.2, "margin": 5.0},
    "tpu": {"scan_capacity": 128, "submap_capacity": 512,
            "max_ray_cells": 128, "batch_scans": 4, "distributed": False},
}


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    td = tmp_path_factory.mktemp("dryrun")
    lidar_f, imu_f = str(td / "lidar.csv"), str(td / "imu.csv")
    gt = generate_sequence(lidar_f, imu_f, n_scans=10, n_beams=120,
                           noise=0.005, trajectory="straight", seed=5)
    scans, rels = [], []
    for _, rel, raw in LidarService(lidar_f).scans():
        scans.append(filter_and_flatten(raw, 0.0, 3.0))
        rels.append(rel)
    return gt, scans, rels, imu_f


def _jax_engine(use_imu, imu_f):
    from icp_tpu.engine import SlamEngine
    from icp_tpu.services.imu import IMUService
    from icp_tpu.utils.config import SlamConfig

    return SlamEngine(SlamConfig.from_dict(DRYRUN_CFG),
                      imu=IMUService(imu_f) if use_imu else None,
                      verbose=False)


def _torch_engine(use_imu, imu_f):
    return TEngine(TConfig.from_dict(DRYRUN_CFG),
                   imu=TIMU(imu_f) if use_imu else None, verbose=False,
                   device="cpu")


def _drive(eng, scans, rels, B=4):
    eng.process_scan(scans[0], rels[0])
    for k in range(1, len(scans), B):
        eng.process_scans_batched(scans[k:k + B], rels[k:k + B])
    eng.finish()
    eng.sync_map()
    return eng


@pytest.mark.parametrize("use_imu", [True, False], ids=["imu", "no_imu"])
def test_slice_matches_icp_tpu(dryrun, use_imu):
    """Both engines on the dryrun sequence: the same accepted and
    sub_applied flags scan by scan, positions within 5 mm, yaws within
    1e-3 rad, the same map within 1e-3 log-odds."""
    gt, scans, rels, imu_f = dryrun
    et = _drive(_torch_engine(use_imu, imu_f), scans, rels)
    ej = _drive(_jax_engine(use_imu, imu_f), scans, rels)
    for f in ("scans", "rejected", "submap_corrections", "icp_iters",
              "sweep_dropped_voxels", "truncated_scans"):
        assert getattr(et.stats, f) == getattr(ej.stats, f), f
    np.testing.assert_array_equal(et.pose_scan_indices, ej.pose_scan_indices)
    pt, pj = np.stack(et.pose_trajectory), np.stack(ej.pose_trajectory)
    assert len(pt) >= 7
    np.testing.assert_allclose(pt[:, :2, 2], pj[:, :2, 2], atol=5e-3)
    yt = np.arctan2(pt[:, 1, 0], pt[:, 0, 0])
    yj = np.arctan2(pj[:, 1, 0], pj[:, 0, 0])
    np.testing.assert_allclose(yt, yj, atol=1e-3)
    np.testing.assert_allclose(et.mapper.log_odds.numpy(),
                               np.asarray(ej.mapper.log_odds), atol=1e-3)
    assert et.pose_graph.n_nodes == ej.pose_graph.n_nodes
    assert et.pose_graph.n_edges == ej.pose_graph.n_edges


@pytest.mark.parametrize("lc", [False, True], ids=["lc_off", "lc_on"])
def test_batch_is_bookkept_in_the_call_that_hands_it_over(dryrun, lc):
    """process_scans_batched bookkeeps the scans it is handed before it
    returns: after each call of batch_scans scans, stats.scans counts every
    scan handed over so far and pose_trajectory holds each accepted one.
    Under loop closure a call of fewer than batch_scans scans leaves them
    for the next call or finish(); without it they run at once."""
    import copy

    gt, scans, rels, imu_f = dryrun
    d = copy.deepcopy(DRYRUN_CFG)
    d["loop_closure"]["enabled"] = lc
    eng = TEngine(TConfig.from_dict(d), imu=TIMU(imu_f), verbose=False,
                  device="cpu")
    B = d["tpu"]["batch_scans"]
    eng.process_scan(scans[0], rels[0])
    handed = accepted = 0
    for k in range(1, len(scans) - B + 1, B):
        accepted += eng.process_scans_batched(scans[k:k + B], rels[k:k + B])
        handed += B
        assert eng.stats.scans == handed
        assert len(eng.pose_trajectory) == accepted
        assert accepted == handed - eng.stats.rejected
    rest = len(scans) - 1 - handed
    assert rest > 0
    accepted += eng.process_scans_batched(scans[1 + handed:],
                                          rels[1 + handed:])
    assert eng.stats.scans == handed + (0 if lc else rest)
    accepted += eng.finish()
    assert eng.stats.scans == len(scans) - 1
    assert len(eng.pose_trajectory) == accepted


def test_per_scan_path_and_warmup_match_icp_tpu(dryrun):
    """process_scan one scan at a time (batch_scans 1: the map is painted
    per scan), after a warmup() on padding scans: the same flags and
    positions within 5 mm as icp_tpu, and the same map within 1e-3."""
    import copy

    from icp_tpu.engine import SlamEngine
    from icp_tpu.services.imu import IMUService
    from icp_tpu.utils.config import SlamConfig

    gt, scans, rels, imu_f = dryrun
    d = copy.deepcopy(DRYRUN_CFG)
    d["tpu"]["batch_scans"] = 1
    et = TEngine(TConfig.from_dict(d), imu=TIMU(imu_f), verbose=False,
                 device="cpu")
    ej = SlamEngine(SlamConfig.from_dict(d), imu=IMUService(imu_f),
                    verbose=False)
    for eng in (et, ej):
        eng.process_scan(scans[0], rels[0])
        eng.warmup()
        flags = [eng.process_scan(p, r) for p, r in zip(scans[1:], rels[1:])]
        eng.finish()
        eng.sync_map()
        eng.flags = flags
    assert et.flags == ej.flags
    assert et.stats.submap_corrections == ej.stats.submap_corrections
    pt, pj = np.stack(et.pose_trajectory), np.stack(ej.pose_trajectory)
    np.testing.assert_allclose(pt[:, :2, 2], pj[:, :2, 2], atol=5e-3)
    np.testing.assert_allclose(et.mapper.log_odds.numpy(),
                               np.asarray(ej.mapper.log_odds), atol=1e-3)


def test_step_from_shared_state_matches_icp_tpu(dryrun):
    """Hand icp_tpu's mid-run state to both packages' fused step (through
    state_from_numpy) and run one scan: the same flags and iterations, the
    pose within 1e-4, the submap ring within 1e-4 and the grid within
    1e-5; state_to_numpy round-trips."""
    gt, scans, rels, imu_f = dryrun
    ej = _drive(_jax_engine(True, imu_f), scans[:5], rels[:5])
    et = _torch_engine(True, imu_f)
    et.process_scan(scans[0], rels[0])          # builds the same step
    shared = {k: np.asarray(v) for k, v in ej._state._asdict().items()
              if k in ("prev_pts", "prev_mask", "global_pose", "ring_pts",
                       "ring_mask", "ring_idx", "log_odds")}
    st = state_from_numpy(shared, "cpu")
    back = state_to_numpy(st)
    for k, v in shared.items():
        np.testing.assert_array_equal(back[k], v)

    cur = np.zeros((128, 2), np.float32)
    n = min(len(scans[5]), 128)
    cur[:n], cur[n:] = scans[5][:n], scans[5][0]
    msk = np.arange(128) < n
    delta = float(et.imu.delta_yaw(rels[4], rels[5]))
    yaw = float(et.imu.yaw_at(rels[5]) - et.imu_yaw_offset)
    st_new, ot = et._step_fn(st, torch.as_tensor(cur), torch.as_tensor(msk),
                             torch.tensor(delta), torch.tensor(yaw))
    import jax.numpy as jnp
    sj_new, oj = ej._step_fn(ej._state, jnp.asarray(cur), jnp.asarray(msk),
                             jnp.float32(delta), jnp.float32(yaw))
    for f in ("accepted", "sub_applied", "iters", "sub_n", "sweep_drop"):
        assert int(getattr(ot, f)) == int(getattr(oj, f)), f
    np.testing.assert_allclose(ot.pose.numpy(), np.asarray(oj.pose), atol=1e-4)
    np.testing.assert_allclose(float(ot.error), float(oj.error), rtol=1e-3,
                               atol=1e-7)
    got = state_to_numpy(st_new)
    np.testing.assert_allclose(got["ring_pts"], np.asarray(sj_new.ring_pts),
                               atol=1e-4)
    np.testing.assert_array_equal(got["ring_mask"], np.asarray(sj_new.ring_mask))
    assert int(got["ring_idx"]) == int(sj_new.ring_idx)
    np.testing.assert_allclose(got["log_odds"], np.asarray(sj_new.log_odds),
                               atol=1e-5)


def test_port_imports_no_jax():
    """Importing every module of icp_tpu_torch, and chip_smoke.py, leaves
    jax, icp_tpu and yaml out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import icp_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(icp_tpu_torch.__path__, 'icp_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "for m in ('icp_tpu_torch.parallel', 'icp_tpu_torch.parallel.dist_pose_graph',\n"
        "          'icp_tpu_torch.parallel.mesh', 'icp_tpu_torch.parallel.sweep_shard',\n"
        "          'icp_tpu_torch.parallel.sharded_grid',\n"
        "          'icp_tpu_torch.models.pose_graph', 'icp_tpu_torch.models.features',\n"
        "          'icp_tpu_torch.ops.ransac'):\n"
        "    assert m in sys.modules, m\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'icp_tpu', 'yaml')]\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert torch.backends.cuda.matmul.allow_tf32 is False\n"
        "assert torch.backends.cudnn.allow_tf32 is False\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_engine_refuses_what_is_not_ported(dryrun):
    """distributed: true on one visible device raises RuntimeError (as
    icp_tpu's does), and device='cuda' without CUDA raises RuntimeError.
    The non-fused path, and
    features/both alignment with loop closure on or off and with IMU or
    without, construct; so does the fused step with the features
    prealign."""
    import copy

    from icp_tpu_torch.models.slam_step import make_slam_step

    d = copy.deepcopy(DRYRUN_CFG)
    d["tpu"]["distributed"] = True
    with pytest.raises(RuntimeError, match="distributed"):
        TEngine(TConfig.from_dict(d), imu=TIMU(dryrun[3]), device="cpu")
    for changes in ([("tpu", "fused", False)],
                    [("loop_closure", "enabled", True)],
                    [("loop_closure", "enabled", True),
                     ("features", "method", "features")],
                    [("loop_closure", "enabled", True),
                     ("features", "method", "both"), ("tpu", "fused", False)],
                    [("features", "method", "both")]):
        d = copy.deepcopy(DRYRUN_CFG)
        for section, key, value in changes:
            d[section][key] = value
        for imu in (TIMU(dryrun[3]), None):
            eng = TEngine(TConfig.from_dict(d), imu=imu, device="cpu")
            assert eng.cfg.fused == d["tpu"].get("fused", True)
    step, batch = make_slam_step(
        use_imu=False, prealign="features", icp_method="point_to_line",
        icp_voxel=0.1, icp_max_iterations=5, icp_normal_k=5,
        icp_error_threshold=1e-7, error_reject_threshold=0.5,
        rotation_voxel_size=0.3, angle_step_coarse=2.0, angle_step_fine=0.2,
        submap_enabled=False, submap_voxel=0.1, submap_capacity=64,
        sub_rot_range=5.0, sub_rot_step=1.0, sub_rot_fine=0.2,
        sub_rot_voxel=0.3, sub_corr_dist=0.5, imu_narrow=3.0, grid_min_x=0.0,
        grid_min_y=0.0, grid_resolution=0.1, l_hit=0.8, l_miss=-0.4,
        log_odds_min=-5.0, log_odds_max=5.0, max_ray_cells=64)
    assert callable(step) and callable(batch)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            TEngine(TConfig.from_dict(DRYRUN_CFG))


def test_cli_runs_synthetic_sequence(tmp_path):
    """python -m icp_tpu_torch.cli --synth on a small YAML config with loop
    closure on: runs with it, prints the loop-closure count and wall, and
    writes the map, the trajectory and a checkpoint that --resume loads."""
    data = tmp_path / "lidar.csv"
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(
        f'data_file: "{data}"\n'
        f'imu: {{enabled: true, file: "{tmp_path / "imu.csv"}"}}\n'
        "icp: {voxel_size: 0.08, max_iterations: 12, error_reject_threshold: 5.0}\n"
        "submap: {enabled: true, size: 4, voxel_size: 0.08, rotation_voxel_size: 0.3}\n"
        "loop_closure: {enabled: true}\n"
        "filter: {z_min: 0.0, z_max: 3.0}\n"
        "mapping: {resolution: 0.2, margin: 5.0}\n"
        "service: {loop: false}\n"
        f'output: {{csv: "{tmp_path / "map.csv"}", npy: "{tmp_path / "map.npy"}"}}\n'
        "tpu: {scan_capacity: 128, submap_capacity: 512, max_ray_cells: 128, "
        "batch_scans: 4}\n")
    traj = tmp_path / "traj.npy"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-m", "icp_tpu_torch.cli", "--config", str(cfg),
         "--synth", "--synth-scans", "8", "--synth-beams", "120",
         "--device", "cpu", "--quiet", "--save-traj", str(traj),
         "--checkpoint", str(tmp_path / "ck.npz")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "loop_closures=0" in out.stdout and " lc=" in out.stdout
    assert "not ported" not in out.stdout
    grid = np.load(tmp_path / "map.npy")
    assert grid.ndim == 2 and np.isfinite(grid).all() and (grid != 0.5).any()
    assert np.load(traj).shape[1:] == (3, 3)
    assert (tmp_path / "map.csv").exists()
    ck = np.load(tmp_path / "ck.npz")
    assert ck["poses"].shape[0] == np.load(traj).shape[0] + 1
    assert ck["stats_scans"][0] == 7
    # --resume: the engine restarts from the checkpoint and streams the
    # same 8 scans again after it
    out = subprocess.run(
        [sys.executable, "-m", "icp_tpu_torch.cli", "--config", str(cfg),
         "--device", "cpu", "--quiet", "--resume", str(tmp_path / "ck.npz")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "scans=15 " in out.stdout


# ── the features path and the modular path ────────────────────────────────
FEAT_SECTION = {"voxel_size": 0.15, "ransac_iterations": 128, "top_n": 32,
                "k_descriptor": 8, "min_kp_dist": 0.2}


def _feat_cfg(method, fused=True):
    import copy

    d = copy.deepcopy(DRYRUN_CFG)
    d["features"].update(FEAT_SECTION, method=method)
    d["tpu"]["fused"] = fused
    return d


@pytest.mark.parametrize("method,fused", [("features", True), ("both", True),
                                          ("features", False), ("both", False),
                                          ("none", False)],
                         ids=["fused_features", "fused_both", "modular_features",
                              "modular_both", "modular_none"])
def test_features_and_modular_engines_match_icp_tpu(dryrun, monkeypatch,
                                                    method, fused):
    """No IMU, the dryrun sequence through both engines with icp_tpu's
    RANSAC uniforms injected: the fused path in batches of 4 ("features"
    with its per-scan cache, "both"), the modular path per scan in icp_tpu
    and through process_scans_batched in the port. Every counter equal
    (icp_iters included), positions within 1e-4 m, maps within 1e-3."""
    from icp_tpu.engine import SlamEngine
    from icp_tpu.utils.config import SlamConfig

    gt, scans, rels, imu_f = dryrun
    d = _feat_cfg(method, fused)
    JaxRansacStream(int(d["features"]["ransac_iterations"])).install(monkeypatch)
    et = _drive(TEngine(TConfig.from_dict(d), verbose=False, device="cpu"),
                scans, rels)
    ej = SlamEngine(SlamConfig.from_dict(d), verbose=False)
    if fused:
        _drive(ej, scans, rels)
    else:        # icp_tpu's process_scans_batched needs the fused state
        for p, r in zip(scans, rels):
            ej.process_scan(p, r)
        ej.sync_map()
    assert (et._state is None) == (ej._state is None) == (not fused)
    for f in ("scans", "rejected", "submap_corrections", "icp_iters",
              "sweep_dropped_voxels", "truncated_scans"):
        assert getattr(et.stats, f) == getattr(ej.stats, f), f
    pt, pj = np.stack(et.pose_trajectory), np.stack(ej.pose_trajectory)
    assert len(pt) >= 7
    np.testing.assert_allclose(pt[:, :2, 2], pj[:, :2, 2], atol=1e-4)
    np.testing.assert_allclose(et.mapper.log_odds.numpy(),
                               np.asarray(ej.mapper.log_odds), atol=1e-3)


@pytest.mark.parametrize("use_imu", [True, False],
                         ids=["modular_imu", "modular_rotation_search"])
def test_modular_rotation_search_matches_icp_tpu(dryrun, use_imu):
    """The modular path (tpu.fused: false) with the dryrun config's
    rotation search: with an IMU (the yaw seeds the ICP) and without one
    (the search does). Per scan in icp_tpu, through process_scans_batched
    in the port. Every counter equal, positions within 1e-5 m, maps within
    1e-3."""
    import copy

    from icp_tpu.engine import SlamEngine
    from icp_tpu.services.imu import IMUService
    from icp_tpu.utils.config import SlamConfig

    gt, scans, rels, imu_f = dryrun
    d = copy.deepcopy(DRYRUN_CFG)
    d["tpu"]["fused"] = False
    et = _drive(TEngine(TConfig.from_dict(d),
                        imu=TIMU(imu_f) if use_imu else None, verbose=False,
                        device="cpu"), scans, rels)
    ej = SlamEngine(SlamConfig.from_dict(d),
                    imu=IMUService(imu_f) if use_imu else None, verbose=False)
    for p, r in zip(scans, rels):
        ej.process_scan(p, r)
    ej.sync_map()
    assert et._state is None and ej._state is None
    for f in ("scans", "rejected", "submap_corrections", "icp_iters",
              "sweep_dropped_voxels", "truncated_scans"):
        assert getattr(et.stats, f) == getattr(ej.stats, f), f
    pt, pj = np.stack(et.pose_trajectory), np.stack(ej.pose_trajectory)
    assert len(pt) >= 7
    np.testing.assert_allclose(pt[:, :2, 2], pj[:, :2, 2], atol=1e-5)
    np.testing.assert_allclose(et.mapper.log_odds.numpy(),
                               np.asarray(ej.mapper.log_odds), atol=1e-3)


def test_features_step_from_shared_state_matches_icp_tpu(dryrun, monkeypatch):
    """icp_tpu's mid-run features-mode state (its cache of the previous
    scan's features included) handed to both fused steps through
    state_from_numpy, with the uniforms icp_tpu draws from that state's
    key: the same flags and iterations, the pose within 1e-3, the new
    cache within 1e-5; state_to_numpy carries the cache back."""
    import jax.numpy as jnp
    from icp_tpu.engine import SlamEngine
    from icp_tpu.utils.config import SlamConfig

    gt, scans, rels, imu_f = dryrun
    d = _feat_cfg("features")
    ej = _drive(SlamEngine(SlamConfig.from_dict(d), verbose=False),
                scans[:5], rels[:5])
    et = TEngine(TConfig.from_dict(d), verbose=False, device="cpu")
    et.process_scan(scans[0], rels[0])
    shared = {k: v for k, v in ej._state._asdict().items() if k != "key"}
    assert bool(shared["feat_valid"])
    st = state_from_numpy(shared, "cpu")
    assert st.feat_valid and st.feat.desc.shape == (32, 8)
    back = state_to_numpy(st)
    np.testing.assert_array_equal(back["feat"]["desc"],
                                  np.asarray(shared["feat"].desc))
    assert back["feat_valid"]
    cur, msk = _pad_fixed(scans[5], 128)
    JaxRansacStream(ej._state.key).install(monkeypatch)
    st_new, ot = et._step_fn(st, torch.as_tensor(cur), torch.as_tensor(msk),
                             torch.tensor(0.0), torch.tensor(0.0),
                             degenerate=False)
    sj_new, oj = ej._step_fn(ej._state, jnp.asarray(cur), jnp.asarray(msk),
                             jnp.float32(0.0), jnp.float32(0.0))
    for f in ("accepted", "sub_applied", "iters", "sub_n", "sweep_drop"):
        assert int(getattr(ot, f)) == int(getattr(oj, f)), f
    np.testing.assert_allclose(ot.pose.numpy(), np.asarray(oj.pose), atol=1e-3)
    assert st_new.feat_valid and bool(sj_new.feat_valid)
    for a, b in zip(st_new.feat, sj_new.feat):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_degenerate_scan_keeps_feature_cache(dryrun, monkeypatch):
    """A degenerate scan (6 points) mid-batch in features mode: after it the
    cache still describes the old prev, the scan before it (as icp_tpu's
    select keeps it, slam_step.py:367-374), whether the host passes the
    degenerate flags or the step reads them; the three-scan batch gives
    icp_tpu's poses within 1e-4 with icp_tpu's uniforms; a degenerate step
    on an invalid cache leaves it invalid."""
    import jax.numpy as jnp
    from icp_tpu.engine import SlamEngine
    from icp_tpu.utils.config import SlamConfig
    from icp_tpu_torch.models.features import extract_features

    gt, scans, rels, imu_f = dryrun
    d = _feat_cfg("features")
    ej = SlamEngine(SlamConfig.from_dict(d), verbose=False)
    ej.process_scan(scans[0], rels[0])
    et = TEngine(TConfig.from_dict(d), verbose=False, device="cpu")
    et.process_scan(scans[0], rels[0])
    pts, msk = (np.stack(a) for a in zip(*(_pad_fixed(scans[k], 128) for k in (1, 2, 3))))
    msk[1, 6:] = False                           # scan 2 keeps 6 points
    zero = np.zeros(3, np.float32)
    want = extract_features(torch.as_tensor(pts[0]), torch.as_tensor(msk[0]),
                            voxel_size=0.15, k_curvature=10, top_n=32,
                            min_kp_dist=0.2, k_descriptor=8)
    key = jnp.asarray(np.asarray(ej._state.key))      # the batch donates it
    _, oj = ej._batch_fn(ej._state, jnp.asarray(pts), jnp.asarray(msk),
                         jnp.asarray(zero), jnp.asarray(zero))
    for flags in ([False, True, False], None):
        JaxRansacStream(key).install(monkeypatch)
        st = state_from_numpy(state_to_numpy(et._state), "cpu")
        assert not st.feat_valid
        poses = []
        for lo, hi in ((0, 2), (2, 3)):
            st, out = et._batch_fn(
                st, *(torch.as_tensor(a[lo:hi]) for a in (pts, msk, zero, zero)),
                degenerate=None if flags is None else flags[lo:hi])
            poses.append(out.pose.numpy())
            if hi == 2:
                assert st.feat_valid and not bool(out.accepted[1])
                np.testing.assert_array_equal(st.prev_pts.numpy(), pts[0])
                for a, b in zip(st.feat, want):
                    assert torch.equal(a, b)
        np.testing.assert_allclose(np.concatenate(poses), np.asarray(oj.pose),
                                   atol=1e-4)
    st = state_from_numpy(state_to_numpy(et._state), "cpu")
    st, _ = et._step_fn(st, torch.as_tensor(pts[1]), torch.as_tensor(msk[1]),
                        torch.tensor(0.0), torch.tensor(0.0), degenerate=True)
    assert not st.feat_valid


def test_cli_runs_features_config(tmp_path):
    """python -m icp_tpu_torch.cli --synth on a features YAML (no IMU,
    features.method "features", submap on, the modular path): runs, and
    writes a finite map and a trajectory."""
    data = tmp_path / "lidar.csv"
    cfg = tmp_path / "features.yaml"
    cfg.write_text(
        f'data_file: "{data}"\n'
        "imu: {enabled: false}\n"
        "icp: {voxel_size: 0.08, max_iterations: 12, error_reject_threshold: 5.0}\n"
        "features: {method: features, voxel_size: 0.15, top_n: 32, "
        "k_descriptor: 8, min_kp_dist: 0.2, ransac_iterations: 128}\n"
        "submap: {enabled: true, size: 4, voxel_size: 0.08, rotation_voxel_size: 0.3}\n"
        "loop_closure: {enabled: false}\n"
        "filter: {z_min: 0.0, z_max: 3.0}\n"
        "mapping: {resolution: 0.2, margin: 5.0}\n"
        "service: {loop: false}\n"
        f'output: {{csv: "{tmp_path / "map.csv"}", npy: "{tmp_path / "map.npy"}"}}\n'
        "tpu: {scan_capacity: 128, submap_capacity: 512, max_ray_cells: 128, "
        "batch_scans: 4, fused: false}\n")
    traj = tmp_path / "traj.npy"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-m", "icp_tpu_torch.cli", "--config", str(cfg),
         "--synth", "--synth-scans", "8", "--synth-beams", "120",
         "--device", "cpu", "--quiet", "--save-traj", str(traj)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "scans=7 " in out.stdout
    grid = np.load(tmp_path / "map.npy")
    assert np.isfinite(grid).all() and (grid != 0.5).any()
    assert np.load(traj).shape[1:] == (3, 3)


def test_jax_stays_on_cpu():
    """The comparisons above ran icp_tpu on the CPU backend."""
    assert jax.default_backend() == "cpu"
