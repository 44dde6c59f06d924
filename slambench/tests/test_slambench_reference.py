"""The plain reference against icp_tpu_torch at tiny sizes on the CPU, and
the reference computed in bfloat16 failing the comparison's numbers."""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from slambench.reference import graph as G
from slambench.reference import grid as M
from slambench.reference import icp as I

F64 = torch.float64


def _room(rng, n=600, noise=0.005):
    """A scan of a 6 x 4 m room's walls with a box inside, sensor frame."""
    t = rng.uniform(0, 1, n)
    side = rng.integers(0, 5, n)
    x = np.select([side == 0, side == 1, side == 2, side == 3],
                  [-3 + 6 * t, 3.0, -3 + 6 * t, -3.0], -1 + 0.6 * t)
    y = np.select([side == 0, side == 1, side == 2, side == 3],
                  [-2.0, -2 + 4 * t, 2.0, -2 + 4 * t], 0.5 + 0.0 * t)
    pts = np.stack([x, y], 1) + rng.normal(scale=noise, size=(n, 2))
    return pts.astype(np.float32)


def test_voxel_mean_matches_the_port():
    from icp_tpu_torch.ops.voxel import (voxel_downsample,
                                         voxel_downsample_fixed)

    rng = np.random.default_rng(0)
    pts = rng.uniform(-5, 5, (2000, 2)).astype(np.float32)
    t = torch.as_tensor(pts)
    m = torch.ones(len(pts), dtype=torch.bool)
    out, om = voxel_downsample(t, m, 0.5)
    ref = I.voxel_mean(t.to(F64), 0.5)
    assert int(om.sum()) == len(ref)
    assert torch.allclose(out[om].to(F64), ref, atol=1e-5)
    out, om = voxel_downsample_fixed(t, m, 0.5, 150)
    ref = I.voxel_mean(t.to(F64), 0.5, 150)
    assert torch.allclose(out[om].to(F64), ref, atol=1e-5)


def test_paint_matches_the_port():
    from icp_tpu_torch.models.occupancy import world_to_cells
    from icp_tpu_torch.ops.raytrace import raytrace_update

    rng = np.random.default_rng(1)
    hits = (rng.uniform(-8, 8, (400, 2)) + 0.013).astype(np.float32)
    origin = np.array([0.37, -0.21], np.float32)
    lo, res, shape = (-10.0, -10.0), 0.1, (200, 200)
    grid = torch.zeros(shape)
    raytrace_update(grid, world_to_cells(torch.as_tensor(origin), *lo, res),
                    world_to_cells(torch.as_tensor(hits), *lo, res),
                    torch.ones(len(hits), dtype=torch.bool), 0.85, -0.4,
                    -5.0, 5.0, max_steps=256)
    g = M.Grid(lo, shape, res, l_hit=0.85, l_miss=-0.4, max_steps=256,
               clamp=(-5.0, 5.0))
    g.add_scans([torch.as_tensor(origin, dtype=F64)],
                [torch.as_tensor(hits, dtype=F64)])
    g.finish_update()
    assert M.diff_share(grid, g.array()) == 0.0
    # bfloat16 sums land elsewhere
    g16 = M.Grid(lo, shape, res, l_hit=0.85, l_miss=-0.4, max_steps=256,
                 clamp=(-5.0, 5.0), dtype=torch.bfloat16)
    for _ in range(3):
        g16.add_scans([torch.as_tensor(origin, dtype=torch.bfloat16)],
                      [torch.as_tensor(hits, dtype=torch.bfloat16)])
    g.add_scans([torch.as_tensor(origin, dtype=F64)] * 2,
                [torch.as_tensor(hits, dtype=F64)] * 2)
    assert M.diff_share(g16.array(), g.array()) > 5.0


def test_graph_solve_matches_the_port():
    from icp_tpu_torch.models.pose_graph import PoseGraph2D

    rng = np.random.default_rng(2)
    n = 30
    s = np.linspace(0, 2 * np.pi, n, endpoint=False)
    truth = np.stack([3 * np.cos(s), 2 * np.sin(s), s + np.pi / 2], 1)
    noisy = truth + np.concatenate([np.zeros((1, 3)), np.cumsum(
        rng.normal(scale=[0.02, 0.02, 0.005], size=(n - 1, 3)), 0)])
    pg = PoseGraph2D("cpu")
    edges = []
    for v in noisy:
        pg.add_node(v.astype(np.float32))
    pairs = [(k - 1, k) for k in range(1, n)] + [(n - 1, 0)]
    for i, j in pairs:
        z = G.relative(torch.as_tensor(truth[i]), torch.as_tensor(truth[j]))
        z = z + torch.as_tensor(rng.normal(scale=0.003, size=3))
        om = np.eye(3) * (100.0 if j else 10.0)
        pg.add_edge(i, j, z.numpy().astype(np.float32),
                    om.astype(np.float32))
        edges.append((i, j, z, torch.as_tensor(om)))
    pg.optimize(n_iterations=30, fix_node=0)
    ref = G.solve(torch.as_tensor(noisy), edges, fix=0)
    prog = np.stack(pg.nodes)
    assert np.abs(prog[:, :2] - ref[:, :2].numpy()).max() < 1e-4
    low = [(i, j, z.to(torch.bfloat16), om.to(torch.bfloat16))
           for i, j, z, om in edges]
    ctl = G.solve(torch.as_tensor(noisy).to(torch.bfloat16), low, fix=0,
                  iters=30).to(F64)
    assert float((ctl[:, :2] - ref[:, :2]).norm(dim=1).max()) > 3e-3


@pytest.mark.parametrize("method", ["point_to_point", "point_to_line"])
def test_refine_holds_the_ports_icp_still(method):
    """From the port's converged ICP pose, the reference moves the scan by
    well under a millimetre; from its bfloat16 answer, by far more."""
    from icp_tpu_torch.models.icp import icp_core

    rng = np.random.default_rng(4)
    tgt = _room(rng)
    th, tt = 0.05, np.array([0.12, -0.07])
    R = np.array([[math.cos(th), -math.sin(th)], [math.sin(th),
                                                   math.cos(th)]])
    src = ((_room(rng) - tt) @ R).astype(np.float32)   # tgt = R src + t
    ts, tg = torch.as_tensor(src), torch.as_tensor(tgt)
    ones = torch.ones(len(src), dtype=torch.bool)
    res = icp_core(ts, ones, tg, ones, torch.eye(2), torch.zeros(2),
                   method=method, max_iterations=150, normal_k=16,
                   error_threshold=1e-10, max_corr_dist=1.5, use_gate=True,
                   nn_impl="xla")
    kind = "p2l" if method == "point_to_line" else "p2p"
    s64, t64 = ts.to(F64), tg.to(F64)
    nrm = I.knn_normals(t64, 16)
    Rp, tp = res.R.to(F64), res.t.to(F64)
    Rr, tr, _, _ = I.refine(s64, t64, Rp, tp, max_corr=1.5, method=kind,
                            normals=nrm, iters=300)
    gap = I.pose_gap(s64, Rp, tp, Rr, tr)
    assert gap < 5e-4
    lo = torch.bfloat16
    Rc, tc, _, _ = I.refine(s64.to(lo), t64.to(lo), Rp.to(lo), tp.to(lo),
                            max_corr=1.5, method=kind, normals=nrm.to(lo),
                            iters=150)
    Rc, tc = Rc.to(F64), tc.to(F64)
    Rr, tr, _, _ = I.refine(s64, t64, Rc, tc, max_corr=1.5, method=kind,
                            normals=nrm, iters=300)
    assert I.pose_gap(s64, Rc, tc, Rr, tr) > 3 * max(gap, 1e-4)


def test_reference_imports_nothing_of_the_program():
    import subprocess
    import sys

    code = ("import sys, slambench.reference.icp, slambench.reference.grid, "
            "slambench.reference.graph, slambench.frozen.synth, "
            "slambench.frozen.metrics, "
            "slambench.compare.engine, slambench.compare.scaled; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'icp_tpu_torch', 'icp_tpu', 'jax', 'benchmarks'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         cwd=str(__import__("slambench").__path__[0] + "/.."))
    assert out.stdout.strip() == "[]"
