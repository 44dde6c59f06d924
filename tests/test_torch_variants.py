"""The fused path's configuration variants: icp_tpu_torch's engine against
icp_tpu's (JAX on the CPU) on a short loop with an IMU, batches of 4.

Ten variants of the dryrun configuration, each one knob away from it:
the plain-torch correspondence query (``nn_impl: xla``), point-to-point
ICP, the submap off, a map paint per scan, a ring of 2, sweep caps of 32
and 64 (forced drops), ``max_ray_cells: 16`` (forced truncation),
rejection thresholds 0.5 and 0.05, and ``batch_scans: 1``. Every counter
must be equal, positions within 1e-5 m, and the maps within 1e-3 log-odds
outside the cells a hit on a cell boundary can flip: a pose difference of
~1e-6 m can move such a hit into the next cell, which changes that cell
and its ray. ``_flippable`` marks them: the rays (both end cells) of every
hit within 1e-3 cells of a boundary; the test prints how many cells that
is (152-843 of the 179 x 149 grid's 26,671 on this sequence, against
~14,000 painted; no cell differed by more than 4.8e-7 here, inside the
marked cells or out). Measured positions: 3.8e-6 to 8.1e-6 m apart.
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402,F401

from icp_tpu_torch.engine import SlamEngine as TEngine, filter_and_flatten  # noqa: E402
from icp_tpu_torch.ops.raytrace import bresenham_cells  # noqa: E402
from icp_tpu_torch.services.imu import IMUService as TIMU  # noqa: E402
from icp_tpu_torch.services.lidar import LidarService  # noqa: E402
from icp_tpu_torch.utils.config import SlamConfig as TConfig  # noqa: E402
from icp_tpu_torch.utils.synth import generate_sequence  # noqa: E402
from test_torch_slam import DRYRUN_CFG, _drive  # noqa: E402

N_SCANS = 24
BOUNDARY_CELLS = 1e-3       # a hit this close to a cell edge may flip

VARIANTS = {
    "nn_xla": {"tpu": {"nn_impl": "xla"}},
    "point_to_point": {"icp": {"method": "point_to_point"}},
    "submap_off": {"submap": {"enabled": False}},
    "per_scan_paint": {"tpu": {"batched_map": False}},
    "ring_2": {"submap": {"size": 2}},
    "sweep_caps_32_64": {"tpu": {"sweep_src_capacity": 32,
                                 "sweep_tgt_capacity": 64}},
    "max_ray_cells_16": {"tpu": {"max_ray_cells": 16}},
    "reject_0.5": {"icp": {"error_reject_threshold": 0.5}},
    "reject_0.05": {"icp": {"error_reject_threshold": 0.05}},
    "batch_scans_1": {"tpu": {"batch_scans": 1}},
}


@pytest.fixture(scope="module")
def loop_seq(tmp_path_factory):
    td = tmp_path_factory.mktemp("loop")
    lidar_f, imu_f = str(td / "lidar.csv"), str(td / "imu.csv")
    generate_sequence(lidar_f, imu_f, n_scans=N_SCANS, n_beams=120,
                      noise=0.005, trajectory="loop", seed=5)
    scans, rels = [], []
    for _, rel, raw in LidarService(lidar_f).scans():
        scans.append(filter_and_flatten(raw, 0.0, 3.0))
        rels.append(rel)
    return scans, rels, imu_f


def _flippable(eng, scans):
    """(ny, nx) bool: the cells on the rays of every hit that lies within
    BOUNDARY_CELLS of a cell edge, to either cell it may fall in (and from
    either origin cell, where the origin is that close to an edge)."""
    g = eng.mapper
    lo = np.array([g.min_x, g.min_y])
    out = np.zeros((g.ny, g.nx), bool)
    poses = [np.eye(3)] + list(eng.pose_trajectory)
    idx = [0] + list(eng.pose_scan_indices)

    def cands(c):       # the cells a coordinate near an edge may take
        f = np.floor(c)
        near = np.abs(c - np.round(c)) < BOUNDARY_CELLS
        return {tuple(f.astype(int)),
                tuple(np.where(near, np.round(c) - 1, f).astype(int)),
                tuple(np.where(near, np.round(c), f).astype(int))}

    for T, k in zip(poses, idx):
        hits = (scans[k] @ T[:2, :2].T + T[:2, 2] - lo) / g.resolution
        near = (np.abs(hits - np.round(hits)) < BOUNDARY_CELLS).any(1)
        origin = (T[:2, 2] - lo) / g.resolution
        for o in cands(origin):
            ends = [e for h in (hits if len(cands(origin)) > 1 else hits[near])
                    for e in cands(h)]
            if not ends:
                continue
            e = torch.as_tensor(np.array(ends), dtype=torch.int64)
            cells, act = bresenham_cells(
                torch.as_tensor(o), e, torch.ones(len(e), dtype=torch.bool),
                max_steps=4 * (g.nx + g.ny))
            c = cells[act].numpy()
            c = np.concatenate([c, e.numpy()])
            ok = (c[:, 0] >= 0) & (c[:, 0] < g.nx) & (c[:, 1] >= 0) \
                & (c[:, 1] < g.ny)
            out[c[ok, 1], c[ok, 0]] = True
    return out


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_fused_variant_matches_icp_tpu(loop_seq, variant):
    """One knob off the dryrun config on a 24-scan loop with an IMU,
    batches of 4: counters equal, positions within 1e-5 m, maps within
    1e-3 outside the boundary-flippable cells."""
    from icp_tpu.engine import SlamEngine
    from icp_tpu.services.imu import IMUService
    from icp_tpu.utils.config import SlamConfig

    scans, rels, imu_f = loop_seq
    d = copy.deepcopy(DRYRUN_CFG)
    for section, patch in VARIANTS[variant].items():
        d[section].update(patch)
    et = _drive(TEngine(TConfig.from_dict(d), imu=TIMU(imu_f), verbose=False,
                        device="cpu"), scans, rels)
    ej = _drive(SlamEngine(SlamConfig.from_dict(d), imu=IMUService(imu_f),
                           verbose=False), scans, rels)
    for f in ("scans", "rejected", "submap_corrections", "icp_iters",
              "sweep_dropped_voxels", "truncated_scans"):
        assert getattr(et.stats, f) == getattr(ej.stats, f), f
    np.testing.assert_array_equal(et.pose_scan_indices, ej.pose_scan_indices)
    pt = np.stack(et.pose_trajectory or [np.eye(3)])
    pj = np.stack(ej.pose_trajectory or [np.eye(3)])
    gap = float(np.abs(pt[:, :2, 2] - pj[:, :2, 2]).max())
    flip = _flippable(et, scans)
    diff = np.abs(et.mapper.log_odds.numpy() - np.asarray(ej.mapper.log_odds))
    print(f"{variant}: {len(et.pose_trajectory)} poses, "
          f"{et.stats.rejected} rejected, "
          f"{et.stats.sweep_dropped_voxels} dropped voxels, "
          f"{et.stats.truncated_scans} truncated; max |position gap| "
          f"{gap:.3g} m; {int(flip.sum())} flippable cells, max map gap "
          f"{float(diff.max()):.3g} ({float(diff[~flip].max()):.3g} "
          f"outside them)")
    np.testing.assert_allclose(pt[:, :2, 2], pj[:, :2, 2], atol=1e-5, rtol=0)
    assert float(diff[~flip].max()) <= 1e-3, \
        f"map gap {float(diff[~flip].max())} outside {int(flip.sum())} cells"
