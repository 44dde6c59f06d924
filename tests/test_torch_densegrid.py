"""The 10^5-point registration path of icp_tpu_torch against icp_tpu (JAX on
the CPU): the dense world and the scan stream, the dense cell grid
(``ops/densegrid``), ``nn_query_chunked``, ``icp_large``, and the scaled
pipeline's scan-to-scan mode, which registers by icp_large alone.

The same seeded numpy inputs go through both packages. Tolerances:
* the world, the scan stream, the grid and query planes and the overflow
  counts: bit for bit (both sort the cell ids stably);
* the NN answers within ``cell_size``: index and nearest x / y equal, d2
  within 1 ulp. XLA on the CPU contracts ``ddx * ddx + ddy * ddy`` into
  one fused multiply-add, fma(ddx, ddx, ddy * ddy); the port rounds each
  operation on its own, as its CUDA kernels do;
* ``cell_normals``: 1e-5 (the per-cell moments are sums taken in another
  order);
* ``nn_query_chunked``: distance within 1e-6 relative, or 1e-6 m near 0
  (the centre shift is a mean summed in another order, so its rounding
  scales with the coordinates, not the distance); indices equal;
* ``icp_large``: R within 1e-5, t within 1e-4 m; iterations, inliers and
  drops equal. Run at icp_tpu's default error_threshold (1e-7): with 0 the
  stop comes from the 32-ulp floor of the error, which the two packages'
  sum orders cross at different iterations.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from icp_tpu.models.icp import icp_large as j_icp_large  # noqa: E402
from icp_tpu.ops import densegrid as JD  # noqa: E402
from icp_tpu.ops.nn import nn_query_chunked as j_nn_chunked  # noqa: E402
from icp_tpu.utils import synth as JS  # noqa: E402
from icp_tpu.utils.masking import pad_points as j_pad_points  # noqa: E402

from icp_tpu_torch.models.icp import icp_large  # noqa: E402
from icp_tpu_torch.parallel.scaled import ScaledPipeline as TPipe  # noqa: E402
from icp_tpu_torch.ops import densegrid as TD  # noqa: E402
from icp_tpu_torch.ops.nn import nn_query_chunked  # noqa: E402
from icp_tpu_torch.utils import synth as TS  # noqa: E402
from icp_tpu_torch.utils.masking import pad_points  # noqa: E402
from test_icp import _wall_world  # noqa: E402
from test_torch_scaled import KW, _xy, scans  # noqa: E402,F401  (fixture)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _world(seed=0, n=6000, extent=20.0, walls=24):
    return JS.make_dense_world(np.random.default_rng(seed), n_points=n,
                               extent=extent, n_walls=walls)


def test_dense_world_and_scan_stream_bit_equal():
    a = JS.make_dense_world(np.random.default_rng(4), n_points=50_000,
                            extent=30.0, n_walls=40)
    b = TS.make_dense_world(np.random.default_rng(4), n_points=50_000,
                            extent=30.0, n_walls=40)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    for traj in ("loop", "eight"):
        kw = dict(n_points=3000, extent=30.0, max_range=12.0, noise=0.02,
                  seed=9, trajectory=traj)
        ja = list(JS.large_scan_stream(6, **kw))
        ta = list(TS.large_scan_stream(6, **kw))
        assert len(ja) == len(ta) == 6
        for (sj, gj), (st, gt) in zip(ja, ta):
            np.testing.assert_array_equal(sj, st)
            np.testing.assert_array_equal(gj, gt)
    # the default world (one million points) through world_points=None
    for (sj, gj), (st, gt) in zip(JS.large_scan_stream(2, n_points=500, seed=2),
                                  TS.large_scan_stream(2, n_points=500, seed=2)):
        np.testing.assert_array_equal(sj, st)
        np.testing.assert_array_equal(gj, gt)


def test_pad_points_matches():
    pts = np.random.default_rng(0).normal(size=(37, 2)).astype(np.float32)
    for cap in (None, 64, 37):
        for a, b in zip(j_pad_points(pts, cap), pad_points(pts, cap)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        pad_points(pts, 10)


def _grid_inputs(seed, n, cap_pad):
    pts = _world(seed, n=n)
    rng = np.random.default_rng(seed + 100)
    p, m = j_pad_points(pts, cap_pad)
    m = m & (rng.random(cap_pad) < 0.95)
    return p, m


# (grid_shape, cap, qcells, qcap): generous caps drop nothing but points
# off the grid; tight caps drop targets past cap and queries past qcap and
# past qcells
GRID_CASES = [((40, 40), 256, 1024, 256), ((12, 12), 4, 20, 3)]


@pytest.mark.parametrize("grid_shape,cap,qcells,qcap", GRID_CASES)
def test_build_grid_and_bin_queries_bit_equal(grid_shape, cap, qcells, qcap):
    p, m = _grid_inputs(1, 6000, 8192)
    cell = np.float32(1.5)
    jorg = JD.grid_origin(jnp.asarray(p), jnp.asarray(m), cell)
    torg = TD.grid_origin(torch.tensor(p), torch.tensor(m), torch.tensor(cell))
    np.testing.assert_array_equal(_np(jorg), _np(torg))

    jg = JD.build_dense_grid(jnp.asarray(p), jnp.asarray(m), cell, jorg,
                             grid_shape=grid_shape, cap=cap)
    tg = TD.build_dense_grid(torch.tensor(p), torch.tensor(m),
                             torch.tensor(cell), torg, grid_shape=grid_shape,
                             cap=cap)
    for f in ("x", "y", "idx", "mask", "origin", "cell_size", "overflow"):
        np.testing.assert_array_equal(_np(getattr(jg, f)), _np(getattr(tg, f)),
                                      err_msg=f)
    # queries: a moved copy of the cloud (some fall off the grid and clip)
    th = 0.1
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]],
                 np.float32)
    q = (p @ R.T + np.float32([1.3, -0.7])).astype(np.float32)
    qm = m.copy()
    qm[::7] = False
    jq = JD.bin_queries(jnp.asarray(q), jnp.asarray(qm), jg.origin,
                        jg.cell_size, grid_shape=grid_shape, qcells=qcells,
                        qcap=qcap)
    tq = TD.bin_queries(torch.tensor(q), torch.tensor(qm), tg.origin,
                        tg.cell_size, grid_shape=grid_shape, qcells=qcells,
                        qcap=qcap)
    for f in jq._fields:
        np.testing.assert_array_equal(_np(getattr(jq, f)), _np(getattr(tq, f)),
                                      err_msg=f)
    if cap == 4:        # the tight caps do drop, in both packages alike
        assert int(tg.overflow) > 1000 and int(tq.overflow) > 1000
    else:               # nothing but the off-grid points
        assert int(tg.overflow) == 0


def test_cell_normals_match_on_wall_world():
    pts = _wall_world(seed=3)
    p, m = j_pad_points(pts, 4096)
    cell = np.float32(1.5)
    jorg = JD.grid_origin(jnp.asarray(p), jnp.asarray(m), cell)
    jg = JD.build_dense_grid(jnp.asarray(p), jnp.asarray(m), cell, jorg,
                             grid_shape=(32, 32), cap=256)
    tg = TD.build_dense_grid(torch.tensor(p), torch.tensor(m),
                             torch.tensor(cell), torch.tensor(_np(jorg)),
                             grid_shape=(32, 32), cap=256)
    jn = [np.asarray(a) for a in JD.cell_normals(jg)]
    tn = [_np(a) for a in TD.cell_normals(tg)]
    np.testing.assert_array_equal(jn[2], tn[2])
    assert jn[2].sum() > 30
    ok = jn[2]
    # the sign of an eigenvector is arbitrary only where both candidates
    # tie; the closed form picks the same one in both packages
    np.testing.assert_allclose(tn[0][ok], jn[0][ok], atol=1e-5)
    np.testing.assert_allclose(tn[1][ok], jn[1][ok], atol=1e-5)


@pytest.mark.parametrize("qcap,qcells", [(64, 512), (8, 40)])
def test_compact_nn_and_dense_nn_query_bit_equal(qcap, qcells):
    t_pts = _world(2, n=5000)
    tp, tm = j_pad_points(t_pts, 8192)
    rng = np.random.default_rng(7)
    # queries near the targets, so most have a neighbour within cell_size;
    # duplicated targets make exact ties
    tp[4000:4400] = tp[100:500]
    q = (tp[:3000] + rng.normal(scale=0.4, size=(3000, 2))).astype(np.float32)
    qm = rng.random(3000) < 0.9
    cell = np.float32(1.5)
    jorg = JD.grid_origin(jnp.asarray(tp), jnp.asarray(tm), cell)
    jg = JD.build_dense_grid(jnp.asarray(tp), jnp.asarray(tm), cell, jorg,
                             grid_shape=(40, 40), cap=64)
    tg = TD.build_dense_grid(torch.tensor(tp), torch.tensor(tm),
                             torch.tensor(cell), torch.tensor(_np(jorg)),
                             grid_shape=(40, 40), cap=64)
    jq = JD.bin_queries(jnp.asarray(q), jnp.asarray(qm), jg.origin,
                        jg.cell_size, grid_shape=(40, 40), qcells=qcells,
                        qcap=qcap)
    tq = TD.bin_queries(torch.tensor(q), torch.tensor(qm), tg.origin,
                        tg.cell_size, grid_shape=(40, 40), qcells=qcells,
                        qcap=qcap)
    jb = [np.asarray(a) for a in JD.compact_nn(jq, jg)]
    tb = [_np(a) for a in TD.compact_nn(tq, tg)]
    slot = np.asarray(jq.mask) & (jb[0] < np.float32(1.5) ** 2)
    assert slot.sum() > 150
    np.testing.assert_array_max_ulp(jb[0][slot], tb[0][slot], maxulp=1)
    for a, b in zip(jb[1:], tb[1:]):
        np.testing.assert_array_equal(a[slot], b[slot])
    # a row bound that covers the occupied rows changes no valid slot
    rows = int(tq.cell_mask.sum())
    tb_rows = [_np(a) for a in TD.compact_nn(tq, tg, rows)]
    for a, b in zip(tb, tb_rows):
        np.testing.assert_array_equal(a[_np(tq.mask)], b[_np(tq.mask)])

    jr = JD.dense_nn_query(jnp.asarray(q), jnp.asarray(qm), jg, qcap=qcap,
                           qcells=qcells)
    tr = TD.dense_nn_query(torch.tensor(q), torch.tensor(qm), tg, qcap=qcap,
                           qcells=qcells)
    jd = np.asarray(jr.dist)
    within = jd < 1.5
    assert within.sum() > 150
    np.testing.assert_array_max_ulp(jd[within], _np(tr.dist)[within], maxulp=1)
    for f in ("idx", "nx", "ny"):
        np.testing.assert_array_equal(np.asarray(getattr(jr, f))[within],
                                      _np(getattr(tr, f))[within], err_msg=f)
    # dropped and masked queries report BIG in both
    np.testing.assert_array_equal(jd >= 1e29, _np(tr.dist) >= 1e29)


def test_nn_query_chunked_matches():
    rng = np.random.default_rng(11)
    src = rng.uniform(-30, 30, (5000, 2)).astype(np.float32)   # 5000 % 2048 != 0
    tgt = rng.uniform(-30, 30, (1500, 2)).astype(np.float32)
    tgt[700:900] = tgt[:200]                                   # exact ties
    tm = rng.random(1500) < 0.9
    sm = rng.random(5000) < 0.95
    jd, ji = j_nn_chunked(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(tm),
                          jnp.asarray(sm), chunk=2048)
    td, ti = nn_query_chunked(torch.tensor(src), torch.tensor(tgt),
                              torch.tensor(tm), torch.tensor(sm), chunk=2048)
    np.testing.assert_allclose(_np(td), np.asarray(jd), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(_np(ti)[sm], np.asarray(ji)[sm])
    # N <= chunk goes through one nn_query
    td1, ti1 = nn_query_chunked(torch.tensor(src[:100]), torch.tensor(tgt),
                                torch.tensor(tm), chunk=2048)
    np.testing.assert_array_equal(_np(ti1), _np(ti)[:100])


def _icp_case(offset_th, offset_t, n_world=12_000, cap_pad=16384):
    base = _world(5, n=n_world, extent=30.0, walls=40)
    c, s = np.cos(offset_th), np.sin(offset_th)
    R = np.array([[c, -s], [s, c]], np.float32)
    t = np.float32(offset_t)
    src = ((base - t) @ R).astype(np.float32)
    src = src + np.random.default_rng(6).normal(
        scale=0.01, size=src.shape).astype(np.float32)
    sp, sm = j_pad_points(src, cap_pad)
    tp, tm = j_pad_points(base, cap_pad)
    return sp, sm, tp, tm


# (name, yaw, translation, kw): a small offset inside the margin; a large
# one whose first step moves points past the margin (a re-bin); and tight
# caps that drop targets and queries
ICP_CASES = [
    ("small", 0.02, (0.2, -0.1), dict(cap=64, qcap=64, qcells=1024)),
    ("rebin", 0.05, (0.9, -0.6), dict(cap=64, qcap=64, qcells=1024)),
    ("drops", 0.03, (0.3, 0.2), dict(cap=12, qcap=10, qcells=300)),
]


@pytest.mark.parametrize("method", ["point_to_point", "point_to_line"])
@pytest.mark.parametrize("name,th,t,kw", ICP_CASES, ids=[c[0] for c in ICP_CASES])
def test_icp_large_matches(method, name, th, t, kw):
    sp, sm, tp, tm = _icp_case(th, t)
    kw = dict(kw, max_corr_dist=1.0, max_iterations=30, error_threshold=1e-7,
              grid_shape=(48, 48), method=method)
    jr = j_icp_large(jnp.asarray(sp), jnp.asarray(sm), jnp.asarray(tp),
                     jnp.asarray(tm), jnp.eye(2, dtype=jnp.float32),
                     jnp.zeros(2, jnp.float32), **kw)
    tr = icp_large(torch.tensor(sp), torch.tensor(sm), torch.tensor(tp),
                   torch.tensor(tm), torch.eye(2), torch.zeros(2), **kw)
    np.testing.assert_allclose(_np(tr.R), np.asarray(jr.R), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(tr.t), np.asarray(jr.t), atol=1e-4, rtol=0)
    assert int(tr.iters) == int(jr.iters)
    assert int(tr.n_inliers) == int(jr.n_inliers)
    assert int(tr.dropped) == int(jr.dropped)
    got = float(np.arctan2(_np(tr.R)[1, 0], _np(tr.R)[0, 0]))
    assert abs(got - th) < 2e-3, got
    if name == "drops":             # the tight caps do drop
        assert int(tr.dropped) > 0


def test_icp_large_row_bound_redo():
    """A row bound that a re-bin outgrows makes the chunk run again over
    every row: the result is the unbounded one."""
    import sys
    M = sys.modules["icp_tpu_torch.models.icp"]

    sp, sm, tp, tm = _icp_case(0.05, (0.9, -0.6))
    args = (torch.tensor(sp), torch.tensor(sm), torch.tensor(tp),
            torch.tensor(tm), torch.eye(2), torch.zeros(2))
    kw = dict(max_corr_dist=1.0, max_iterations=30, error_threshold=0.0,
              grid_shape=(48, 48), cap=16, qcap=16, qcells=400)
    ref = icp_large(*args, **kw)
    real = M._row_bound
    try:
        M._row_bound = lambda occupied, qcells: occupied - 1
        tight = icp_large(*args, **kw)
    finally:
        M._row_bound = real
    for a, b in zip(ref, tight):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def test_scan_to_scan_mode_matches_icp_tpu(scans, tmp_path):
    """The scaled pipeline's scan-to-scan mode (submap_keyframes=0):
    icp_large between each scan and the previous raw one, seeded by the
    last increment (reference slam.py:465-494), over the first 8 scans of
    tests/test_torch_scaled.py's run. Positions within 1e-4 m (3.6e-6 m measured on the
    CPU), drops and ICP iterations equal, the map within 1e-3 outside at
    most 1 % of the painted cells; a checkpoint of this mode cannot be
    resumed (the raw scan is not kept), in both packages."""
    pts, _ = scans
    from icp_tpu.parallel.mesh import make_mesh
    from icp_tpu.parallel.scaled import ScaledPipeline
    kw = dict(KW, submap_keyframes=0)
    j, t = ScaledPipeline(make_mesh(1), **kw), TPipe("cpu", **kw)
    for p in pts[:8]:
        j.step(p)
        t.step(p)
    j.finish()
    t.finish()
    assert len(t.trajectory) == len(j.trajectory) == 8
    np.testing.assert_allclose(_xy(t.trajectory), _xy(j.trajectory),
                               atol=1e-4, rtol=0)
    assert t.stats.reg_dropped_points == j.stats.reg_dropped_points > 0
    assert t.stats.icp_iters == j.stats.icp_iters
    lj, lt = np.asarray(j.log_odds), t.log_odds.numpy()
    painted = int((np.abs(lj) > 1e-6).sum())
    assert painted > 1000
    assert (np.abs(lt - lj) > 1e-3).sum() <= 0.01 * painted
    ck = str(tmp_path / "s2s.npz")
    t.save_checkpoint(ck)
    for pipe in (TPipe("cpu", **kw), ScaledPipeline(make_mesh(1), **kw)):
        with pytest.raises(NotImplementedError, match="submap mode"):
            pipe.load_checkpoint(ck)
