"""icp_tpu_torch ICP and pre-alignment against icp_tpu (JAX on the CPU).

Inputs are made from a seed with numpy and fed to both packages. On CPU
tensors the port's correspondence query (nn_impl "auto") is the plain
version of the CUDA kernel (direct differencing), while icp_tpu's CPU query
shifts both clouds by the target centroid first; the two differ in the last
bits of each distance, hence the tolerances below.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import importlib  # noqa: E402

import jax.numpy as jnp  # noqa: E402

# the packages' models/__init__ re-export the function ``icp``, which
# shadows the module of the same name
t_icp = importlib.import_module("icp_tpu_torch.models.icp")
t_pre = importlib.import_module("icp_tpu_torch.models.prealign")
j_icp = importlib.import_module("icp_tpu.models.icp")
j_pre = importlib.import_module("icp_tpu.models.prealign")


def T(a):
    return torch.as_tensor(np.asarray(a))


def N(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _room_scan(rng, n=400, noise=0.005):
    """Points on the walls of a 6 x 4 m room with a pillar, plus noise."""
    s = rng.uniform(0, 1, n)
    side = rng.integers(0, 5, n)
    corners = np.array([[-3, -2], [3, -2], [3, 2], [-3, 2], [-3, -2]], float)
    a, b = corners[np.minimum(side, 3)], corners[np.minimum(side, 3) + 1]
    pts = a + (b - a) * s[:, None]
    pillar = side == 4
    ang = s[pillar] * 2 * np.pi
    pts[pillar] = np.stack([1 + 0.3 * np.cos(ang), 0.5 + 0.3 * np.sin(ang)], 1)
    return (pts + rng.normal(scale=noise, size=pts.shape)).astype(np.float32)


def _rot(th):
    return np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]],
                    np.float32)


def _pair(seed, th, t, n=400, cap=512):
    rng = np.random.default_rng(seed)
    tgt = _room_scan(rng, n)
    src = ((tgt - t) @ _rot(th)).astype(np.float32)    # tgt = R src + t
    src = src + rng.normal(scale=0.003, size=src.shape).astype(np.float32)
    sp = np.zeros((cap, 2), np.float32)
    tp = np.zeros((cap, 2), np.float32)
    sp[:n], tp[:n] = src, tgt
    sp[n:], tp[n:] = src[0], tgt[0]
    m = np.arange(cap) < n
    return sp, m, tp, m.copy()


@pytest.mark.parametrize("method,use_gate,nn_impl", [
    ("point_to_point", False, "auto"),
    ("point_to_line", False, "auto"),
    ("point_to_point", True, "auto"),
    ("point_to_line", False, "xla"),
])
def test_icp_core_matches_jax(method, use_gate, nn_impl):
    """Equal iteration counts; R within atol 1e-5, t within atol 1e-4,
    error within rtol 1e-3 (it is a ~1e-5 m^2 residual)."""
    sp, sm, tp, tm = _pair(0, 0.08, np.array([0.15, -0.1]))
    kw = dict(method=method, max_iterations=40, normal_k=10,
              error_threshold=1e-10, max_corr_dist=0.5, use_gate=use_gate)
    eye, z = np.eye(2, dtype=np.float32), np.zeros(2, np.float32)
    rt = t_icp.icp_core(T(sp), T(sm), T(tp), T(tm), T(eye), T(z),
                        nn_impl=nn_impl, **kw)
    rj = j_icp.icp_core(*map(jnp.asarray, (sp, sm, tp, tm, eye, z)),
                        nn_impl="xla", **kw)
    assert int(rt.iters) == int(rj.iters)
    assert int(rt.n_inliers) == int(rj.n_inliers)
    np.testing.assert_allclose(N(rt.R), N(rj.R), atol=1e-5)
    np.testing.assert_allclose(N(rt.t), N(rj.t), atol=1e-4)
    np.testing.assert_allclose(float(rt.error), float(rj.error), rtol=1e-3)
    # and it recovered the transform
    np.testing.assert_allclose(N(rt.R), _rot(0.08), atol=2e-3)


def test_icp_core_gate_abort_freezes_like_jax():
    """Disjoint clouds with the gate on: too few inliers aborts in the first
    iteration and returns the initial guess, as icp_tpu does."""
    rng = np.random.default_rng(1)
    src = rng.uniform(-1, 1, (128, 2)).astype(np.float32)
    tgt = (rng.uniform(-1, 1, (128, 2)) + 50.0).astype(np.float32)
    m = np.ones(128, bool)
    R0 = _rot(0.1)
    t0 = np.array([0.5, 0.2], np.float32)
    kw = dict(method="point_to_point", max_iterations=30, use_gate=True,
              max_corr_dist=0.5)
    rt = t_icp.icp_core(T(src), T(m), T(tgt), T(m), T(R0), T(t0), **kw)
    rj = j_icp.icp_core(*map(jnp.asarray, (src, m, tgt, m, R0, t0)), **kw)
    assert int(rt.iters) == int(rj.iters) == 1
    np.testing.assert_allclose(N(rt.R), N(rj.R), atol=1e-6)
    np.testing.assert_allclose(N(rt.t), N(rj.t), atol=1e-6)
    assert np.isinf(float(rt.error)) and np.isinf(float(rj.error))


def test_icp_with_voxel_downsample_matches_jax():
    """The full ``icp`` entry (voxel both clouds, then icp_core), with an
    iteration budget that ends mid-chunk: equal iterations, R atol 1e-5."""
    sp, sm, tp, tm = _pair(2, -0.05, np.array([-0.1, 0.2]))
    kw = dict(voxel_size=0.05, method="point_to_line", max_iterations=11,
              normal_k=8, error_threshold=1e-12)
    eye, z = np.eye(2, dtype=np.float32), np.zeros(2, np.float32)
    rt = t_icp.icp(T(sp), T(sm), T(tp), T(tm), T(eye), T(z), **kw)
    rj = j_icp.icp(*map(jnp.asarray, (sp, sm, tp, tm, eye, z)), **kw)
    assert int(rt.iters) == int(rj.iters)
    np.testing.assert_allclose(N(rt.R), N(rj.R), atol=1e-5)
    np.testing.assert_allclose(N(rt.t), N(rj.t), atol=1e-4)


def _angle(R):
    return float(np.arctan2(R[1, 0], R[0, 0]))


@pytest.mark.parametrize("seed,th", [(3, 0.6), (4, -2.0)])
def test_rotation_search_matches_jax(seed, th):
    """Winning angle within one fine step of icp_tpu's; t within 0.05 m;
    score within rtol 1e-3."""
    sp, sm, tp, tm = _pair(seed, th, np.array([0.3, -0.2]))
    kw = dict(voxel_size=0.2, angle_step_coarse=4.0, angle_step_fine=0.5)
    Rt, tt, st = t_pre.rotation_search(T(sp), T(sm), T(tp), T(tm), **kw)
    Rj, tj, sj = j_pre.rotation_search(*map(jnp.asarray, (sp, sm, tp, tm)), **kw)
    d = abs((_angle(N(Rt)) - _angle(N(Rj)) + np.pi) % (2 * np.pi) - np.pi)
    assert d <= np.deg2rad(0.5) + 1e-6, np.rad2deg(d)
    np.testing.assert_allclose(N(tt), N(tj), atol=0.05)
    np.testing.assert_allclose(float(st), float(sj), rtol=1e-3)


@pytest.mark.parametrize("src_cap,tgt_cap", [(None, None), (40, 48)])
def test_submap_rotation_search_matches_jax(src_cap, tgt_cap):
    """Winning angle within one fine step of icp_tpu's, refined translation
    within 1e-3 m, and equal drop counts (also when the caps cut voxels)."""
    rng = np.random.default_rng(5)
    sub = np.concatenate([_room_scan(rng, 400) for _ in range(3)])
    cap = 2048
    sp = np.zeros((cap, 2), np.float32)
    sp[:len(sub)] = sub
    sm = np.arange(cap) < len(sub)
    scan_w = _room_scan(rng, 300)
    true = np.array([0.2, 0.1, 0.05])
    scan = ((scan_w - true[:2]) @ _rot(true[2])).astype(np.float32)
    cp = np.zeros((512, 2), np.float32)
    cp[:300] = scan
    cm = np.arange(512) < 300
    pred = np.eye(3, dtype=np.float32)
    pred[:2, :2] = _rot(0.0)
    pred[:2, 2] = [0.15, 0.12]
    kw = dict(angle_range=6.0, angle_step=0.5, fine_step=0.1, voxel_size=0.15,
              src_cap=src_cap, tgt_cap=tgt_cap, with_overflow=True)
    Rt, tt, sdt, tdt = t_pre.submap_rotation_search(T(cp), T(cm), T(sp),
                                                    T(sm), T(pred), **kw)
    Rj, tj, sdj, tdj = j_pre.submap_rotation_search(
        *map(jnp.asarray, (cp, cm, sp, sm, pred)), **kw)
    d = abs(_angle(N(Rt)) - _angle(N(Rj)))
    assert d <= np.deg2rad(0.1) + 1e-6, np.rad2deg(d)
    np.testing.assert_allclose(N(tt), N(tj), atol=1e-3)
    assert int(sdt) == int(sdj) and int(tdt) == int(tdj)
    if src_cap is not None:
        assert int(sdt) > 0 and int(tdt) > 0


def test_masked_percentile_matches_jax_and_numpy():
    """_masked_percentile: equal to icp_tpu's within atol 1e-6 and to
    np.percentile (linear) within rtol 1e-6."""
    rng = np.random.default_rng(6)
    v = rng.exponential(size=200).astype(np.float32)
    for n_valid in (1, 2, 57, 200):
        m = np.zeros(200, bool)
        m[rng.permutation(200)[:n_valid]] = True
        pt = float(t_pre._masked_percentile(T(v), T(m), 80.0))
        pj = float(j_pre._masked_percentile(jnp.asarray(v), jnp.asarray(m), 80.0))
        assert abs(pt - pj) <= 1e-6
        np.testing.assert_allclose(pt, np.percentile(v[m], 80.0), rtol=1e-6)
