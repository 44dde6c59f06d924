"""The scaled pipeline (BASELINE config #5) on a mesh: icp_tpu_torch on 8
virtual CPU shards against icp_tpu on 8 virtual CPU devices
(tests/conftest.py) and against the port on one device, at
``dryrun_multichip``'s 6-scan x 2048-point configuration (loop closure
checked every 2 scans, BA at every closure, Schur from 2 nodes).

Each pipeline runs once per module (icp_tpu's ~15-20 s a scan on the CPU
here). Tolerances: positions within 1 cm of icp_tpu's and the map within
1e-3 outside at most 5 % of the painted cells (tests/test_torch_scaled.py's
tolerances, for the same cell-boundary effects); within 1e-4 m of the
port's one-device run (the mesh moves work, not results); checkpoints
carry the grid exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from icp_tpu_torch.parallel.mesh import make_mesh, set_virtual_devices  # noqa: E402
from icp_tpu_torch.parallel.scaled import ScaledPipeline as TPipe  # noqa: E402
from icp_tpu_torch.utils.synth import large_scan_stream  # noqa: E402

KW = dict(scan_capacity=2048, extent=10.0, map_resolution=0.25,
          map_margin=4.0, max_range=9.0, icp_max_corr=1.5,
          icp_max_iterations=8, icp_grid_shape=(32, 32), icp_cell_cap=192,
          icp_qcells=2048, kf_capacity=1024, kf_voxel=0.2, lc_every=2,
          lc_min_interval=3, lc_distance=50.0, lc_min_travel=0.0,
          lc_error_threshold=10.0, dist_node_threshold=2)


def _mesh8():
    set_virtual_devices(8, "cpu")
    try:
        return make_mesh(8, device="cpu")
    finally:
        set_virtual_devices(0, "cpu")


def _jax_pipe():
    from icp_tpu.parallel.mesh import make_mesh as jmake
    from icp_tpu.parallel.scaled import ScaledPipeline
    return ScaledPipeline(jmake(8), **KW)


@pytest.fixture(scope="module")
def runs():
    scans = [s for s, _ in large_scan_stream(6, n_points=2048, extent=10.0,
                                             max_range=9.0, seed=1)]
    out = {}
    for name, pipe in (("jax", _jax_pipe()), ("mesh", TPipe(_mesh8(), **KW)),
                       ("one", TPipe("cpu", **KW))):
        for scan in scans:
            pipe.step(scan)
        pipe.optimize(n_iterations=2)          # BA + the sharded replay
        out[name] = pipe
    return out


def _pos(pipe):
    return np.stack([m[:2, 2] for m in pipe.trajectory])


def _lo(prob):
    return np.log(prob / (1.0 - prob))


STATS = ("scans", "loop_closures", "lc_checked", "lc_candidates", "ba_runs",
         "gate_fallbacks", "replayed_keyframes")


def test_mesh_pipeline_matches_icp_tpu(runs):
    tp, jp = runs["mesh"], runs["jax"]
    assert len(tp.blocks) == 8 and tp.blocks[0].shape == (tp.ny // 8, tp.nx)
    assert tp.pose_graph.last_strategy == jp.pose_graph.last_strategy \
        == "schur"
    assert tp.stats.wall_replay > 0 and tp.stats.lc_checked >= 1
    for k in STATS:
        assert getattr(tp.stats, k) == getattr(jp.stats, k), k
    np.testing.assert_allclose(_pos(tp), _pos(jp), atol=1e-2)
    pt, pj = tp.map_probability(), jp.map_probability()
    assert pt.shape == pj.shape
    bad = np.abs(_lo(pt) - _lo(pj)) > 1e-3
    painted = int((np.abs(_lo(pj)) > 1e-6).sum())
    assert painted > 0 and bad.sum() <= 0.05 * painted, (bad.sum(), painted)


def test_mesh_pipeline_matches_one_device(runs):
    tp, one = runs["mesh"], runs["one"]
    assert one.mesh.size == 1 and one.pose_graph.last_strategy == "dense"
    for k in STATS:
        assert getattr(tp.stats, k) == getattr(one.stats, k), k
    np.testing.assert_allclose(_pos(tp), _pos(one), atol=1e-4)
    np.testing.assert_allclose(tp.map_probability(), one.map_probability(),
                               atol=1e-4)


def test_mesh_checkpoints_load_both_ways(runs, tmp_path):
    tp, jp = runs["mesh"], runs["jax"]
    ck_t, ck_j = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tp.save_checkpoint(ck_t)
    jp.save_checkpoint(ck_j)
    grid_t, grid_j = np.load(ck_t)["log_odds"], np.load(ck_j)["log_odds"]
    assert grid_t.shape == grid_j.shape == (tp.ny, tp.nx)
    np.testing.assert_array_equal(grid_t, tp.log_odds.numpy())

    tr = TPipe(_mesh8(), **KW)
    tr.load_checkpoint(ck_j)
    np.testing.assert_array_equal(tr.log_odds.numpy(), grid_j)
    assert tr.pose_graph._mesh is tr.mesh
    assert tr.pose_graph.n_edges == jp.pose_graph.n_edges
    np.testing.assert_allclose(tr.map_probability(), jp.map_probability(),
                               atol=1e-6)
    jr = _jax_pipe()
    jr.load_checkpoint(ck_t)
    np.testing.assert_array_equal(np.asarray(jr.log_odds), grid_t)
    np.testing.assert_allclose(jr.map_probability(), tp.map_probability(),
                               atol=1e-6)


def test_time_gn_step_takes_the_optimize_strategy(runs):
    """time_gn_step times the step optimize would take (Schur while within
    its limits, else PCG) and records the partition's host time."""
    tp = runs["mesh"]
    assert tp.time_gn_step(reps=2) > 0 and tp.gn_step_strategy == "schur"
    assert tp.stats.partition_wall > 0
    limit = tp.pose_graph._max_separators
    tp.pose_graph._max_separators = 0
    try:
        assert tp.time_gn_step(reps=1) > 0 and tp.gn_step_strategy == "cg"
    finally:
        tp.pose_graph._max_separators = limit
