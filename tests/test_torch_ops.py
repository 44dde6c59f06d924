"""icp_tpu_torch ops and host modules against icp_tpu (JAX on the CPU).

Every input is made from a seed with numpy and fed to both packages.
Tolerances are stated per test; they cover f32 sums taken in another order
(torch vs XLA, and the scatter order of voxel means and map paints).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from icp_tpu_torch.ops import eig2 as t_eig2  # noqa: E402
from icp_tpu_torch.ops import nn as t_nn  # noqa: E402
from icp_tpu_torch.ops import raytrace as t_rt  # noqa: E402
from icp_tpu_torch.ops import rigid as t_rigid  # noqa: E402
from icp_tpu_torch.ops import voxel as t_voxel  # noqa: E402
from icp_tpu_torch.utils import masking as t_mask  # noqa: E402
from icp_tpu_torch.utils import se2 as t_se2  # noqa: E402

from icp_tpu.ops import eig2 as j_eig2  # noqa: E402
from icp_tpu.ops import nn as j_nn  # noqa: E402
from icp_tpu.ops import raytrace as j_rt  # noqa: E402
from icp_tpu.ops import rigid as j_rigid  # noqa: E402
from icp_tpu.ops import voxel as j_voxel  # noqa: E402
from icp_tpu.utils import masking as j_mask  # noqa: E402
from icp_tpu.utils import se2 as j_se2  # noqa: E402


def T(a):
    return torch.as_tensor(np.asarray(a))


def N(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _cloud(seed, n, n_valid, lo=-5.0, hi=5.0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(lo, hi, (n, 2)).astype(np.float32)
    mask = np.arange(n) < n_valid
    return pts, mask


# ── se2 ──────────────────────────────────────────────────────────────────
def test_se2_matches_jax():
    """rotmat/make_pose/transform/incremental pose/wrap/yaw: atol 1e-6."""
    rng = np.random.default_rng(0)
    th = rng.uniform(-7, 7, 16).astype(np.float32)
    t = rng.uniform(-3, 3, (16, 2)).astype(np.float32)
    pts = rng.uniform(-5, 5, (16, 20, 2)).astype(np.float32)
    R_t, R_j = t_se2.rotmat(T(th)), j_se2.rotmat(jnp.asarray(th))
    np.testing.assert_allclose(N(R_t), N(R_j), atol=1e-6)
    P_t, P_j = t_se2.make_pose(R_t, T(t)), j_se2.make_pose(R_j, jnp.asarray(t))
    np.testing.assert_allclose(N(P_t), N(P_j), atol=1e-6)
    np.testing.assert_allclose(N(t_se2.transform_points(T(pts), P_t)),
                               N(j_se2.transform_points(jnp.asarray(pts), P_j)),
                               atol=1e-5)
    r2, t2 = R_t.roll(1, 0), T(np.roll(t, 1, 0))
    np.testing.assert_allclose(
        N(t_se2.apply_incremental_pose(P_t, r2, t2)),
        N(j_se2.apply_incremental_pose(P_j, jnp.asarray(N(r2)),
                                       jnp.asarray(N(t2)))),
        atol=1e-5)
    np.testing.assert_allclose(N(t_se2.wrap_angle(T(th))),
                               N(j_se2.wrap_angle(jnp.asarray(th))), atol=1e-6)
    np.testing.assert_allclose(N(t_se2.yaw_of_pose(P_t)),
                               N(j_se2.yaw_of_pose(P_j)), atol=1e-6)


def _poses(rng, n):
    th = rng.uniform(-4, 4, n).astype(np.float32)
    t = rng.uniform(-6, 6, (n, 2)).astype(np.float32)
    return (t_se2.make_pose(t_se2.rotmat(T(th)), T(t)),
            j_se2.make_pose(j_se2.rotmat(jnp.asarray(th)), jnp.asarray(t)))


def test_se2_pose_algebra_matches_jax():
    """pose_inverse, pose_compose, relative_pose_vec, apply_rt and
    quat_to_yaw: atol 1e-6."""
    rng = np.random.default_rng(6)
    (Pa_t, Pa_j), (Pb_t, Pb_j) = _poses(rng, 12), _poses(rng, 12)
    np.testing.assert_allclose(N(t_se2.pose_inverse(Pa_t)),
                               N(j_se2.pose_inverse(Pa_j)), atol=1e-6)
    for f in ("pose_compose", "relative_pose_vec"):
        np.testing.assert_allclose(N(getattr(t_se2, f)(Pa_t, Pb_t)),
                                   N(getattr(j_se2, f)(Pa_j, Pb_j)), atol=1e-6)
    np.testing.assert_allclose(N(t_se2.pose_compose(Pa_t, t_se2.pose_inverse(Pa_t))),
                               np.broadcast_to(np.eye(3), (12, 3, 3)), atol=1e-6)
    pts = rng.uniform(-1, 1, (12, 30, 2)).astype(np.float32)
    np.testing.assert_allclose(
        N(t_se2.apply_rt(T(pts), Pa_t[:, :2, :2], Pa_t[:, :2, 2])),
        N(j_se2.apply_rt(jnp.asarray(pts), Pa_j[:, :2, :2], Pa_j[:, :2, 2])),
        atol=1e-6)
    q = rng.normal(size=(4, 50)).astype(np.float32)
    q /= np.linalg.norm(q, axis=0)
    np.testing.assert_allclose(N(t_se2.quat_to_yaw(*map(T, q))),
                               N(j_se2.quat_to_yaw(*map(jnp.asarray, q))),
                               atol=1e-6)


@pytest.mark.parametrize("axis", [None, 0, 1])
def test_masked_min_max_match_jax(axis):
    """masked_min / masked_max, whole and per axis, an all-masked row
    included (BIG / -BIG): atol 1e-6."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(6, 40)).astype(np.float32)
    m = rng.random((6, 40)) < 0.5
    m[2] = False
    for f in ("masked_min", "masked_max"):
        got = getattr(t_mask, f)(T(x), T(m), dim=axis)
        want = getattr(j_mask, f)(jnp.asarray(x), jnp.asarray(m), axis=axis)
        np.testing.assert_allclose(N(got), N(want), atol=1e-6)


# ── nn ───────────────────────────────────────────────────────────────────
@pytest.mark.parametrize("seed,n,m,m_valid,lo,hi", [
    (0, 200, 300, 250, -5.0, 5.0),
    (1, 64, 129, 129, 100.0, 110.0),      # far from the origin
])
def test_nn_query_matches_jax(seed, n, m, m_valid, lo, hi):
    """Indices equal; distances within rtol 1e-5; masked sources BIG."""
    src, smask = _cloud(seed, n, n - 7, lo, hi)
    tgt, tmask = _cloud(seed + 100, m, m_valid, lo, hi)
    d_t, i_t = t_nn.nn_query(T(src), T(tgt), T(tmask), T(smask))
    d_j, i_j = j_nn.nn_query(jnp.asarray(src), jnp.asarray(tgt),
                             jnp.asarray(tmask), jnp.asarray(smask))
    np.testing.assert_array_equal(N(i_t), N(i_j))
    np.testing.assert_allclose(N(d_t), N(d_j), rtol=1e-5)


def test_pairwise_sqdist_matches_jax():
    """Masked, centred 2-D distance matrix: rtol 1e-6 (masked columns BIG
    in both)."""
    rng = np.random.default_rng(2)
    a = rng.normal(size=(30, 2)).astype(np.float32)
    b = rng.normal(size=(40, 2)).astype(np.float32)
    bm = np.arange(40) < 33
    c = np.array([0.5, -0.25], np.float32)
    np.testing.assert_allclose(
        N(t_nn.pairwise_sqdist(T(a), T(b), T(bm), center=T(c))),
        N(j_nn.pairwise_sqdist(jnp.asarray(a), jnp.asarray(b),
                               jnp.asarray(bm), center=jnp.asarray(c))),
        rtol=1e-6)


# ── voxel ────────────────────────────────────────────────────────────────
def _voxel_case(seed, n, n_valid, voxel):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
    pts[: n // 4] = pts[n // 4: n // 2] + 0.01        # shared voxels
    mask = np.zeros(n, bool)
    mask[rng.permutation(n)[:n_valid]] = True
    return pts, mask, voxel


@pytest.mark.parametrize("seed,n,n_valid,voxel", [
    (0, 256, 256, 0.3), (1, 300, 211, 0.5), (2, 128, 0, 0.2)])
def test_voxel_downsample_matches_jax(seed, n, n_valid, voxel):
    """Same mask; valid means within atol 1e-6 (2.4e-7 measured), slot by
    slot, in lexicographic voxel order."""
    pts, mask, v = _voxel_case(seed, n, n_valid, voxel)
    o_t, m_t = t_voxel.voxel_downsample(T(pts), T(mask), v)
    o_j, m_j = j_voxel.voxel_downsample(jnp.asarray(pts), jnp.asarray(mask), v)
    np.testing.assert_array_equal(N(m_t), N(m_j))
    k = N(m_j)
    np.testing.assert_allclose(N(o_t)[k], N(o_j)[k], atol=1e-6)


@pytest.mark.parametrize("capacity", [64, 512])
def test_voxel_downsample_fixed_matches_jax(capacity):
    """Cut (capacity < N: icp_tpu's deviation-from-centre means) and padded
    (capacity >= N) forms: same mask, valid means within atol 1e-6
    (7.5e-9 and 4.8e-7 measured)."""
    pts, mask, v = _voxel_case(3, 400, 350, 0.2)
    o_t, m_t = t_voxel.voxel_downsample_fixed(T(pts), T(mask), v, capacity)
    o_j, m_j = j_voxel.voxel_downsample_fixed(jnp.asarray(pts),
                                              jnp.asarray(mask), v, capacity)
    assert o_t.shape == o_j.shape
    np.testing.assert_array_equal(N(m_t), N(m_j))
    k = N(m_j)
    np.testing.assert_allclose(N(o_t)[k], N(o_j)[k], atol=1e-6)


# ── eig2 / normals ───────────────────────────────────────────────────────
def test_eigh2x2_matches_jax():
    """Eigenvalues within atol 1e-5; eigenvectors equal up to sign."""
    rng = np.random.default_rng(4)
    a, c = rng.uniform(0, 2, (2, 50)).astype(np.float32)
    b = rng.uniform(-1, 1, 50).astype(np.float32)
    lt = t_eig2.eigh2x2(T(a), T(b), T(c))
    lj = j_eig2.eigh2x2(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c))
    np.testing.assert_allclose(N(lt[0]), N(lj[0]), atol=1e-5)
    np.testing.assert_allclose(N(lt[1]), N(lj[1]), atol=1e-5)
    assert (np.abs(np.sum(N(lt[2]) * N(lj[2]), -1)) > 1 - 1e-4).all()


def test_estimate_normals_matches_jax():
    """|dot(n_torch, n_jax)| > 1 - 1e-4 on valid points (sign arbitrary),
    on a noisy room outline with exact duplicate points (tied neighbours)."""
    rng = np.random.default_rng(5)
    s = rng.uniform(0, 4, 150)
    walls = np.concatenate([np.stack([s, np.zeros_like(s)], 1),
                            np.stack([np.full_like(s, 4.0), s], 1)])
    pts = (walls + rng.normal(scale=0.01, size=walls.shape)).astype(np.float32)
    pts[10:15] = pts[20:25]
    mask = np.arange(300) < 280
    n_t = N(t_eig2.estimate_normals(T(pts), T(mask), k=10))
    n_j = N(j_eig2.estimate_normals(jnp.asarray(pts), jnp.asarray(mask), k=10))
    dots = np.abs(np.sum(n_t * n_j, axis=1))[mask]
    assert (dots > 1 - 1e-4).all(), dots.min()


# ── rigid solves ─────────────────────────────────────────────────────────
def test_rigid_solves_match_jax():
    """p2p, p2l and solve3x3 within atol 1e-5 (including a singular 3x3)."""
    rng = np.random.default_rng(6)
    src = rng.uniform(-3, 3, (120, 2)).astype(np.float32)
    th = 0.2
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]], np.float32)
    dst = (src @ R.T + [0.3, -0.2] + rng.normal(scale=0.01, size=src.shape)
           ).astype(np.float32)
    w = (rng.random(120) < 0.8).astype(np.float32)
    nrm = rng.normal(size=(120, 2)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    for tf, jf, args in [
            (t_rigid.p2p_solve_2d, j_rigid.p2p_solve_2d, (src, dst, w)),
            (t_rigid.p2l_solve_2d, j_rigid.p2l_solve_2d, (src, dst, nrm, w))]:
        Rt, tt = tf(*map(T, args))
        Rj, tj = jf(*map(jnp.asarray, args))
        np.testing.assert_allclose(N(Rt), N(Rj), atol=1e-5)
        np.testing.assert_allclose(N(tt), N(tj), atol=1e-5)
    M = rng.normal(size=(3, 3)).astype(np.float32)
    v = rng.normal(size=3).astype(np.float32)
    for MM in (M, np.stack([M[0], M[0], M[2]])):      # regular, singular
        xt, okt = t_rigid.solve3x3(T(MM), T(v))
        xj, okj = j_rigid.solve3x3(jnp.asarray(MM), jnp.asarray(v))
        assert bool(okt) == bool(okj)
        if bool(okj):
            np.testing.assert_allclose(N(xt), N(xj), atol=1e-5)


# ── raytrace ─────────────────────────────────────────────────────────────
@pytest.mark.parametrize("origin", [(7, 9), (0, 0), (-3, 25)])
def test_bresenham_cells_matches_jax_exactly(origin):
    """Exact integers against icp_tpu's closed form, for a sweep of
    endpoints in every octant (the tests/test_raytrace.py pattern)."""
    rng = np.random.default_rng(sum(origin) + 100)
    o = np.array(origin, np.int32)
    ends = rng.integers(-40, 60, size=(200, 2)).astype(np.int32)
    ends[:8] = o + np.array([[5, 0], [0, 5], [-5, 0], [0, -5], [4, 4],
                             [-4, 4], [4, -4], [0, 0]], np.int32)
    valid = rng.random(200) < 0.9
    c_t, a_t = t_rt.bresenham_cells(T(o), T(ends), T(valid), max_steps=128)
    c_j, a_j = j_rt.bresenham_cells(jnp.asarray(o), jnp.asarray(ends),
                                    jnp.asarray(valid), max_steps=128)
    np.testing.assert_array_equal(N(a_t), N(a_j))
    np.testing.assert_array_equal(N(c_t)[N(a_j)], N(c_j)[N(a_j)])


def _map_inputs(seed, ny=60, nx=70, n=40):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-4, 4, (ny, nx)).astype(np.float32)
    origin = np.array([30, 25], np.int32)
    hits = rng.integers(-10, 80, size=(n, 2)).astype(np.int32)
    valid = rng.random(n) < 0.85
    return lo, origin, hits, valid


def test_raytrace_update_matches_jax():
    """One scan's paint on a non-empty grid: atol 1e-5; the grid is
    updated in place."""
    lo, origin, hits, valid = _map_inputs(7)
    got_grid = T(lo.copy())
    got = t_rt.raytrace_update(got_grid, T(origin), T(hits), T(valid),
                               0.85, -0.4, -5.0, 5.0, max_steps=128)
    want = j_rt.raytrace_update(jnp.asarray(lo), jnp.asarray(origin),
                                jnp.asarray(hits), jnp.asarray(valid),
                                jnp.float32(0.85), jnp.float32(-0.4),
                                jnp.float32(-5.0), jnp.float32(5.0),
                                max_steps=128)
    assert got.data_ptr() == got_grid.data_ptr()
    np.testing.assert_allclose(N(got), N(want), atol=1e-5)


@pytest.mark.parametrize("unique_cap", [None, 512])
def test_raytrace_update_batched_matches_jax(unique_cap):
    """A batch of 4 scans, clamped once: atol 1e-5 against icp_tpu's full
    scatter and its compacted (run-length) path."""
    rng = np.random.default_rng(8)
    lo = rng.uniform(-4, 4, (60, 70)).astype(np.float32)
    origins = rng.integers(10, 50, size=(4, 2)).astype(np.int32)
    hits = rng.integers(-10, 80, size=(4, 40, 2)).astype(np.int32)
    valid = rng.random((4, 40)) < 0.85
    got = t_rt.raytrace_update_batched(T(lo.copy()), T(origins), T(hits),
                                       T(valid), 0.85, -0.4, -5.0, 5.0,
                                       max_steps=96)
    want = j_rt.raytrace_update_batched(
        jnp.asarray(lo), jnp.asarray(origins), jnp.asarray(hits),
        jnp.asarray(valid), jnp.float32(0.85), jnp.float32(-0.4),
        jnp.float32(-5.0), jnp.float32(5.0), max_steps=96,
        unique_cap=unique_cap, scan_cap=unique_cap)
    np.testing.assert_allclose(N(got), N(want), atol=1e-5)


def test_occupancy_grid_matches_jax(tmp_path):
    """OccupancyGrid2D.update_scan twice, then the CSV/NPY exports: grid
    within atol 1e-5, probabilities within atol 1e-6."""
    from icp_tpu.models.occupancy import OccupancyGrid2D as JGrid
    from icp_tpu_torch.models.occupancy import OccupancyGrid2D as TGrid

    rng = np.random.default_rng(9)
    kw = dict(resolution=0.1, p_hit=0.85, p_miss=0.42, log_odds_min=-8.0,
              log_odds_max=8.0, max_ray_cells=128)
    gt = TGrid(-5, 5, -4, 4.5, device="cpu", **kw)
    gj = JGrid(-5, 5, -4, 4.5, **kw)
    for k in range(2):
        origin = rng.uniform(-1, 1, 2).astype(np.float32)
        hits = rng.uniform(-6, 6, (50, 2)).astype(np.float32)
        gt.update_scan(origin, hits)
        gj.update_scan(origin, hits)
    np.testing.assert_allclose(N(gt.log_odds), np.asarray(gj.log_odds), atol=1e-5)
    gt.save_npy(tmp_path / "t.npy")
    gj.save_npy(tmp_path / "j.npy")
    gt.save_csv(tmp_path / "t.csv")
    np.testing.assert_allclose(np.load(tmp_path / "t.npy"),
                               np.load(tmp_path / "j.npy"), atol=1e-6)
    np.testing.assert_allclose(np.loadtxt(tmp_path / "t.csv", delimiter=","),
                               np.load(tmp_path / "t.npy"), atol=1e-6)


# ── host modules: config, services, synth, metrics ───────────────────────
def test_config_reads_yaml_like_icp_tpu():
    """Every SlamConfig field of configs/*.yaml equals icp_tpu's."""
    import glob

    from icp_tpu.utils.config import SlamConfig as JConfig
    from icp_tpu_torch.utils.config import SlamConfig as TConfig

    paths = sorted(glob.glob("configs/*.yaml"))
    assert paths
    for p in paths:
        ct, cj = TConfig.from_yaml(p), JConfig.from_yaml(p)
        assert vars(ct) == vars(cj), p


def test_services_synth_metrics_match_icp_tpu(tmp_path):
    """Same synthetic files, same parsed scans and IMU yaws, same ATE/RPE."""
    from icp_tpu.services.imu import IMUService as JIMU
    from icp_tpu.services.lidar import LidarService as JLidar
    from icp_tpu.utils import metrics as jm
    from icp_tpu.utils.synth import generate_sequence as j_gen
    from icp_tpu_torch.services.imu import IMUService as TIMU
    from icp_tpu_torch.services.lidar import LidarService as TLidar
    from icp_tpu_torch.utils import metrics as tm
    from icp_tpu_torch.utils.synth import generate_sequence as t_gen

    kw = dict(n_scans=6, n_beams=90, noise=0.01, trajectory="loop", seed=3)
    gt_t = t_gen(tmp_path / "tl.csv", tmp_path / "ti.csv", **kw)
    gt_j = j_gen(tmp_path / "jl.csv", tmp_path / "ji.csv", **kw)
    np.testing.assert_array_equal(gt_t, gt_j)
    assert (tmp_path / "tl.csv").read_text() == (tmp_path / "jl.csv").read_text()
    assert (tmp_path / "ti.csv").read_text() == (tmp_path / "ji.csv").read_text()

    st = list(TLidar(str(tmp_path / "tl.csv")).scans())
    sj = list(JLidar(str(tmp_path / "tl.csv")).scans())
    assert len(st) == len(sj) == 6
    for a, b in zip(st, sj):
        assert a[:2] == b[:2]
        np.testing.assert_array_equal(a[2], b[2])

    it, ij = TIMU(str(tmp_path / "ti.csv")), JIMU(str(tmp_path / "ti.csv"))
    q = np.array([0, 12_345, 250_000, 499_999])
    np.testing.assert_array_equal(it.yaws_at(q), ij.yaws_at(q))
    np.testing.assert_array_equal(it.delta_yaws(q[:-1], q[1:]),
                                  ij.delta_yaws(q[:-1], q[1:]))

    rng = np.random.default_rng(0)
    est = gt_t[1:] + rng.normal(scale=0.05, size=gt_t[1:].shape)
    assert tm.ate(est[:, :2], gt_t) == jm.ate(est[:, :2], gt_t)
    assert tm.rpe(est, gt_t) == jm.rpe(est, gt_t)


def test_masking_helpers_match_icp_tpu():
    """masked_mean (full and along an axis) and masked_centroid within
    atol 1e-6; an all-masked mean is 0, not NaN."""
    from icp_tpu.utils import masking as jmask
    from icp_tpu_torch.utils import masking as tmask

    rng = np.random.default_rng(1)
    x = rng.normal(size=(37, 5)).astype(np.float32)
    m = rng.random((37, 5)) < 0.6
    for axis in (None, 0, 1):
        np.testing.assert_allclose(
            N(tmask.masked_mean(T(x), T(m), dim=axis)),
            N(jmask.masked_mean(jnp.asarray(x), jnp.asarray(m), axis=axis)),
            atol=1e-6)
    p, pm = x[:, :2], m[:, 0]
    np.testing.assert_allclose(N(tmask.masked_centroid(T(p), T(pm))),
                               N(jmask.masked_centroid(jnp.asarray(p),
                                                       jnp.asarray(pm))),
                               atol=1e-6)
    z = tmask.masked_mean(T(x), T(np.zeros_like(m)))
    assert float(z) == 0.0
