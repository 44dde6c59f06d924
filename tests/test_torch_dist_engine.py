"""The engine on a mesh: icp_tpu_torch against icp_tpu (8 virtual CPU
devices, tests/conftest.py) and against the port on one device.

The port's mesh is 8 virtual CPU shards (``set_virtual_devices(8, "cpu")``
in the ``mesh8`` fixture, which clears it again). The engine runs
``dryrun_multichip``'s 10-scan x 120-beam configuration with
``distributed: true`` and ``dist_node_threshold: 2``, so every optimize
goes through the distributed Schur GN. Positions are held within 1e-4 m of
icp_tpu's engine, and within 5e-3 m (``dryrun_multichip``'s bound) of the
port's one-device run; verification lanes give the one-device verdicts.
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from icp_tpu_torch.engine import SlamEngine as TEngine, filter_and_flatten  # noqa: E402
from icp_tpu_torch.parallel.mesh import make_mesh, set_virtual_devices  # noqa: E402
from icp_tpu_torch.services.lidar import LidarService  # noqa: E402
from icp_tpu_torch.tools.entry import DRYRUN_CFG  # noqa: E402
from icp_tpu_torch.utils.config import SlamConfig as TConfig  # noqa: E402
from icp_tpu_torch.utils.synth import generate_sequence  # noqa: E402


@pytest.fixture
def mesh8():
    set_virtual_devices(8, "cpu")
    try:
        yield make_mesh(8, device="cpu")
    finally:
        set_virtual_devices(0, "cpu")


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    td = tmp_path_factory.mktemp("dist_dryrun")
    lidar_f, imu_f = str(td / "lidar.csv"), str(td / "imu.csv")
    generate_sequence(lidar_f, imu_f, n_scans=10, n_beams=120, noise=0.005,
                      trajectory="straight", seed=5)
    scans, rels = [], []
    for _, rel, raw in LidarService(lidar_f).scans():
        scans.append(filter_and_flatten(raw, 0.0, 3.0))
        rels.append(rel)
    return scans, rels


def _cfg(distributed=True, method="rotation_search"):
    d = copy.deepcopy(DRYRUN_CFG)
    d["tpu"]["distributed"] = distributed
    d["features"]["method"] = method
    return d


def _drive(eng, scans, rels):
    eng.process_scan(scans[0], rels[0])
    eng.process_scans_batched(scans[1:], rels[1:])
    eng.finish()
    eng.pose_graph.optimize(n_iterations=2)
    return eng


def _positions(eng):
    return np.stack([p[:2, 2] for p in eng.pose_trajectory])


COUNTERS = ("scans", "rejected", "submap_corrections", "loop_closures",
            "lc_checks", "lc_pairs", "lc_groups", "icp_iters")


def test_engine_on_mesh_matches_icp_tpu_and_one_device(dryrun, mesh8):
    from icp_tpu.engine import SlamEngine as JEngine
    from icp_tpu.utils.config import SlamConfig as JConfig

    scans, rels = dryrun
    je = _drive(JEngine(JConfig.from_dict(_cfg()), verbose=False),
                scans, rels)
    assert je.mesh.devices.size == 8
    te = _drive(TEngine(TConfig.from_dict(_cfg()), verbose=False,
                        device="cpu"), scans, rels)
    assert te.mesh.size == 8
    assert te.pose_graph.last_strategy == je.pose_graph.last_strategy \
        == "schur"
    for k in COUNTERS:
        assert getattr(te.stats, k) == getattr(je.stats, k), k
    np.testing.assert_allclose(_positions(te), _positions(je), atol=1e-4)
    np.testing.assert_allclose(np.stack(te.pose_graph.nodes),
                               np.stack(je.pose_graph.nodes), atol=1e-4)

    one = _drive(TEngine(TConfig.from_dict(_cfg(False)), verbose=False,
                         device="cpu"), scans, rels)
    assert one.mesh is None
    for k in COUNTERS:
        if k != "lc_groups":           # L is padded to a mesh multiple
            assert getattr(te.stats, k) == getattr(one.stats, k), k
    np.testing.assert_allclose(_positions(te), _positions(one), atol=5e-3)

    # verification of 2 candidates: the mesh's lanes give the one-device
    # verdicts
    cands = [(0, 0.0), (1, 0.1)]
    got = te._lc_verify_batched(scans[-1], cands)
    want = one._lc_verify_batched(scans[-1], cands)
    for (R, t, err, it), (R1, t1, err1, it1) in zip(got, want):
        np.testing.assert_allclose(R, R1, atol=1e-6)
        np.testing.assert_allclose(t, t1, atol=1e-6)
        assert abs(err - err1) <= 1e-7 and it == it1


def test_engine_mesh_lanes_draw_the_one_device_ransac_stream(dryrun, mesh8):
    """With features.method "both", a lane's RANSAC uniforms come from the
    engine's generator in pair order, so mesh lanes verify as one device
    does (icp_tpu draws from another generator: port against port)."""
    scans, rels = dryrun
    cands = [(0, 0.0), (1, 0.1), (2, 0.2)]
    out = []
    for dist in (True, False):
        eng = TEngine(TConfig.from_dict(_cfg(dist, "both")), verbose=False,
                      device="cpu")
        eng.process_scan(scans[0], rels[0])
        eng.process_scans_batched(scans[1:4], rels[1:4])
        eng.finish()
        assert (eng.mesh is not None) == dist
        out.append(eng._lc_verify_batched(scans[4], cands)
                   + eng._lc_verify_batched(scans[5], cands))
    for (R, t, err, it), (R1, t1, err1, it1) in zip(*out):
        np.testing.assert_allclose(R, R1, atol=1e-6)
        np.testing.assert_allclose(t, t1, atol=1e-6)
        assert abs(err - err1) <= 1e-7 and it == it1


def test_distributed_requires_multiple_devices():
    """tpu.distributed: true on one visible device raises, as icp_tpu's
    does (tests/test_engine_distributed.py:119-124)."""
    with pytest.raises(RuntimeError, match="distributed"):
        TEngine(TConfig.from_dict(_cfg()), verbose=False, device="cpu")
    eng = TEngine(TConfig.from_dict(_cfg("auto")), verbose=False,
                  device="cpu")
    assert eng.mesh is None                # "auto" on one device
