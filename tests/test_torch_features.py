"""Features pre-alignment in icp_tpu_torch against icp_tpu (JAX on the CPU):
curvature, kNN, keypoint NMS, descriptors, matching, compaction, RANSAC
and the whole feature alignment, on seeded numpy inputs fed to both
packages.

Tolerances (each test states its own): curvature, kNN distances and
descriptors to 1e-5; keypoint indices and masks, match indices and masks,
compaction and inlier counts exactly; RANSAC R and t to 1e-5 and the whole
feature alignment to 1e-4. torch cannot reproduce ``jax.random`` streams,
so RANSAC is fed the uniforms icp_tpu derives from its key
(``JaxRansacStream``); the slice tests of test_torch_slam.py and
test_torch_loop_closure.py use the same stream to hold whole runs to
icp_tpu's.

JAX is imported inside the tests that use it, so the `gpu`-marked tests
run on a card without it
(``python -m pytest --noconftest -m gpu tests/test_torch_features.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from icp_tpu_torch.models import features as TF  # noqa: E402
from icp_tpu_torch.ops.eig2 import compute_curvature  # noqa: E402
from icp_tpu_torch.ops.nn import knn_query, pairwise_sqdist  # noqa: E402
from icp_tpu_torch.ops.ransac import ransac_align, ransac_from_uniforms  # noqa: E402
from icp_tpu_torch.ops.rigid import p2p_solve_2d, p2p_solve_2d_batched  # noqa: E402


class JaxRansacStream:
    """icp_tpu's RANSAC uniforms, drawn in icp_tpu's order.

    Each draw splits the stream's key (``key, sub = split(key)``) and then
    ``sub`` as ``ransac_align`` does (``k1, k2 = split(sub)``), which is
    how icp_tpu's fused step and modular path consume their keys. For
    loop-closure verification, ``queue_verification`` queues the per-lane
    keys icp_tpu splits per group of L pairs. ``install`` puts ``ransac``
    in place of the port's ``ransac_align`` for the features module."""

    def __init__(self, key):
        import jax
        self.jax = jax
        self.key = jax.random.PRNGKey(key) if isinstance(key, int) else key
        self.lanes = []

    def draw(self, n):
        jr = self.jax.random
        if self.lanes:
            sub = self.lanes.pop(0)
        else:
            self.key, sub = jr.split(self.key)
        k1, k2 = jr.split(sub)
        return [torch.as_tensor(np.array(jr.uniform(k, (n,)))) for k in (k1, k2)]

    def ransac(self, src, dst, pair_mask, generator=None, *, n_iter,
               inlier_thresh):
        u1, u2 = self.draw(n_iter)
        return ransac_from_uniforms(src, dst, pair_mask, u1.to(src.device),
                                    u2.to(src.device),
                                    inlier_thresh=inlier_thresh)

    def queue_verification(self, n_pairs, L):
        jr = self.jax.random
        for g0 in range(0, n_pairs, L):
            self.key, sub = jr.split(self.key)
            self.lanes.extend(list(jr.split(sub, L))[:min(L, n_pairs - g0)])

    def install(self, monkeypatch=None):
        if monkeypatch is not None:
            monkeypatch.setattr(TF, "ransac_align", self.ransac)
        else:
            TF.ransac_align = self.ransac
        return self

    def wrap_verification(self, eng):
        """Queue icp_tpu's lane keys before each of eng's verifications."""
        inner = eng._lc_verify_pairs
        L = 1 << (max(int(eng.cfg.lc_max_candidates), 1) - 1).bit_length()

        def verify(pairs):
            self.queue_verification(len(pairs), L)
            return inner(pairs)
        eng._lc_verify_pairs = verify


def uninstall_stream():
    TF.ransac_align = ransac_align


def T(a):
    return torch.as_tensor(np.array(a))


def N(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rot(th):
    return np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]],
                    np.float32)


def _scene(rng, n_corner=8, pts_per=30, noise=0.01):
    """Corners of two legs each (keypoint-friendly), with noise."""
    pts = []
    for c in rng.uniform(-6, 6, size=(n_corner, 2)):
        t = np.linspace(0, 1.2, pts_per // 2)
        a1 = rng.uniform(0, 2 * np.pi)
        a2 = a1 + rng.uniform(1.2, 2.0)
        pts += [c + np.stack([np.cos(a1) * t, np.sin(a1) * t], 1),
                c + np.stack([np.cos(a2) * t, np.sin(a2) * t], 1)]
    out = np.concatenate(pts).astype(np.float32)
    return out + rng.normal(scale=noise, size=out.shape).astype(np.float32)


def _pad(pts, cap):
    out = np.zeros((cap, 2), np.float32)
    out[:len(pts)] = pts
    out[len(pts):] = pts[0]
    return out, np.arange(cap) < len(pts)


def _uniforms(seed, n):
    """(u1, u2) as icp_tpu's ransac_align draws them from PRNGKey(seed)."""
    import jax
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return [np.array(jax.random.uniform(k, (n,))) for k in (k1, k2)]


# ── ops ───────────────────────────────────────────────────────────────────
def test_curvature_and_knn_match_icp_tpu():
    """compute_curvature (cnt >= 3 & mask rule included: a cloud of 4 valid
    points and an isolated pair) and knn_query distances to 1e-5; kNN
    indices equal wherever the distances are not tied."""
    import jax.numpy as jnp

    from icp_tpu.ops.eig2 import compute_curvature as j_curv
    from icp_tpu.ops.nn import knn_query as j_knn

    rng = np.random.default_rng(0)
    pts, msk = _pad(_scene(rng), 320)
    msk[rng.random(320) < 0.1] = False
    for p, m, k in ((pts, msk, 10), (pts[:6], np.arange(6) < 4, 3)):
        cj = np.asarray(j_curv(jnp.asarray(p), jnp.asarray(m), k=k))
        ct = N(compute_curvature(T(p), T(m), k=k))
        np.testing.assert_allclose(ct, cj, atol=1e-5)
        assert (ct[~m] == 0).all()
    q, qm = pts[:48], msk[:48]
    dj, ij = j_knn(jnp.asarray(q), jnp.asarray(qm), jnp.asarray(pts),
                   jnp.asarray(msk), 12)
    dt, it = knn_query(T(q), T(qm), T(pts), T(msk), 12)
    np.testing.assert_allclose(N(dt), np.asarray(dj), atol=1e-5)
    untied = np.diff(np.asarray(dj), axis=1) > 1e-5
    untied = np.concatenate([untied[:, :1], untied], 1) & qm[:, None]
    np.testing.assert_array_equal(N(it)[untied], np.asarray(ij)[untied])


def test_pairwise_sqdist_descriptor_rows_match_icp_tpu():
    """The D > 4 expansion to 1e-5 relative on valid entries; BIG rows (a
    masked keypoint's descriptor) put no NaN in a valid row, and a masked
    column reads BIG."""
    import jax.numpy as jnp

    from icp_tpu.ops.nn import pairwise_sqdist as j_pd

    rng = np.random.default_rng(1)
    a = rng.uniform(0, 3, (20, 16)).astype(np.float32)
    b = rng.uniform(0, 3, (24, 16)).astype(np.float32)
    a[3], b[5] = 1e30, 1e30                      # masked keypoints' rows
    b[7, 10:] = 1e15                             # a sparse cloud's far tail
    bm = np.ones(24, bool)
    bm[[5, 9]] = False
    dj = np.asarray(j_pd(jnp.asarray(a), jnp.asarray(b), jnp.asarray(bm)))
    dt = N(pairwise_sqdist(T(a), T(b), T(bm)))
    rows = np.arange(20) != 3
    assert np.isfinite(dt[rows]).all()
    assert (dt[:, ~bm] == np.float32(1e30)).all()
    np.testing.assert_allclose(dt[rows], dj[rows], rtol=1e-5, atol=1e-4)


def test_p2p_batched_equals_single_solve():
    """Each hypothesis of p2p_solve_2d_batched equals p2p_solve_2d on its
    two pairs to 1e-6, with per-hypothesis weights too."""
    rng = np.random.default_rng(2)
    src = T(rng.uniform(-5, 5, (64, 2, 2)).astype(np.float32))
    dst = T(rng.uniform(-5, 5, (64, 2, 2)).astype(np.float32))
    w = T(rng.uniform(0, 1, (64, 2)).astype(np.float32))
    for weights in (torch.ones(2), w):
        Rb, tb = p2p_solve_2d_batched(src, dst, weights)
        for h in range(64):
            R1, t1 = p2p_solve_2d(src[h], dst[h], weights.expand(64, 2)[h])
            np.testing.assert_allclose(N(Rb[h]), N(R1), atol=1e-6)
            np.testing.assert_allclose(N(tb[h]), N(t1), atol=1e-6)


# ── keypoints, descriptors, matching ──────────────────────────────────────
@pytest.mark.parametrize("n,top_n,frac", [(100, 20, 0.8), (130, 64, 0.9),
                                          (33, 64, 1.0), (200, 12, 0.7)],
                         ids=["n100", "n130_uncapped", "n33", "n200_capped"])
def test_extract_keypoints_matches_icp_tpu(n, top_n, frac):
    """Random clouds with random curvatures, N not a multiple of 32 and
    the top_n cap reached or not: the same indices and mask as icp_tpu's
    blocked NMS, and the same kept list as the greedy oracle."""
    import jax.numpy as jnp

    from icp_tpu.models.features import extract_keypoints as j_kp

    rng = np.random.default_rng(n)
    pts = rng.normal(0, 2, (n, 2)).astype(np.float32)
    msk = rng.random(n) < frac
    curv = rng.random(n).astype(np.float32)
    curv[::7] = curv[0]                          # equal curvatures: index order
    kj, mj = j_kp(jnp.asarray(pts), jnp.asarray(msk), jnp.asarray(curv),
                  top_n=top_n, min_dist=0.4)
    kt, mt = TF.extract_keypoints(T(pts), T(msk), T(curv), top_n=top_n,
                                  min_dist=0.4)
    np.testing.assert_array_equal(N(kt), np.asarray(kj))
    np.testing.assert_array_equal(N(mt), np.asarray(mj))
    kept = []
    min_d2 = np.float32(0.4) * np.float32(0.4)
    for i in np.argsort(-np.where(msk, curv, -1.0), kind="stable"):
        if not msk[i] or len(kept) == top_n:
            continue
        d2 = ((pts[kept] - pts[i]) ** 2).sum(1)
        if not (d2 < min_d2).any():
            kept.append(i)
    assert list(N(kt)[N(mt)]) == kept
    assert N(mt).sum() == min(top_n, len(kept))


def test_descriptors_and_features_match_icp_tpu():
    """extract_features on a scene (and on a sparse cloud whose descriptors
    run out of neighbours): the voxel cloud and masks equal, keypoint
    coordinates and descriptors to 1e-5."""
    import jax.numpy as jnp

    from icp_tpu.models.features import extract_features as j_ef

    rng = np.random.default_rng(3)
    kw = dict(voxel_size=0.1, k_curvature=10, top_n=40, min_kp_dist=0.3,
              k_descriptor=12)
    for pts in (_scene(rng), _scene(rng, n_corner=2, pts_per=8, noise=0.5)):
        p, m = _pad(pts, 256)
        fj = j_ef(jnp.asarray(p), jnp.asarray(m), **kw)
        ft = TF.extract_features(T(p), T(m), **kw)
        np.testing.assert_array_equal(N(ft.mask), np.asarray(fj.mask))
        np.testing.assert_array_equal(N(ft.kp_mask), np.asarray(fj.kp_mask))
        np.testing.assert_allclose(N(ft.pts), np.asarray(fj.pts), atol=1e-5)
        np.testing.assert_allclose(N(ft.kp_xy), np.asarray(fj.kp_xy), atol=1e-5)
        np.testing.assert_allclose(N(ft.desc), np.asarray(fj.desc),
                                   rtol=1e-5, atol=1e-5)


def test_match_descriptors_and_compaction_match_icp_tpu():
    """Lowe-ratio matching with masked rows and columns (BIG descriptors):
    the same match indices on valid rows and the same mask everywhere,
    on rows whose ratio test is not within 1e-4 of a tie; a masked column
    never wins a valid row; compact_matches equal."""
    import jax.numpy as jnp

    from icp_tpu.models.features import compact_matches as j_cm
    from icp_tpu.models.features import match_descriptors as j_md

    rng = np.random.default_rng(4)
    A, B, D = 40, 48, 16
    db = rng.uniform(0, 4, (B, D)).astype(np.float32)
    da = db[rng.integers(0, B, A)] + rng.normal(0, 0.05, (A, D)).astype(np.float32)
    da[:8] = rng.uniform(0, 4, (8, D))           # unmatched rows
    ma, mb = rng.random(A) < 0.85, rng.random(B) < 0.85
    da[~ma], db[~mb] = 1e30, 1e30
    jj, okj = j_md(jnp.asarray(da), jnp.asarray(ma), jnp.asarray(db),
                   jnp.asarray(mb), 0.8)
    jt, okt = TF.match_descriptors(T(da), T(ma), T(db), T(mb), 0.8)
    jj, okj, jt, okt = np.asarray(jj), np.asarray(okj), N(jt), N(okt)
    d = ((da[:, None, :].astype(np.float64) - db[None].astype(np.float64)) ** 2).sum(-1)
    d[:, ~mb] = np.inf
    two = np.sort(d, axis=1)[:, :2]
    away = np.abs(two[:, 0] - np.float32(0.8) ** 2 * two[:, 1]) > 1e-4 * two[:, 1]
    assert away.sum() >= A - 4 and okt.any() and not okt.all()
    np.testing.assert_array_equal(okt[away], okj[away])
    np.testing.assert_array_equal(jt[ma & away], jj[ma & away])
    assert mb[jt[ma]].all() and not okt[~ma].any()

    src_kp = rng.uniform(-5, 5, (A, 2)).astype(np.float32)
    dst_kp = rng.uniform(-5, 5, (B, 2)).astype(np.float32)
    cj = j_cm(jnp.asarray(src_kp), jnp.asarray(dst_kp), jnp.asarray(jj),
              jnp.asarray(okj))
    ct = TF.compact_matches(T(src_kp), T(dst_kp), T(jj), T(okj))
    for a, b in zip(ct, cj):
        np.testing.assert_array_equal(N(a), np.asarray(b))


# ── RANSAC and the whole alignment ────────────────────────────────────────
def _ransac_case(name):
    rng = np.random.default_rng(1)
    n = 40
    src = rng.uniform(-5, 5, (n, 2)).astype(np.float32)
    dst = src @ _rot(0.7).T + np.float32([1.0, -2.0])
    mask = np.ones(n, bool)
    if name == "outliers":                       # 25 % outliers
        dst[30:] += rng.uniform(3, 6, (10, 2)).astype(np.float32)
    elif name == "padded":                       # 30 valid pairs, compacted
        mask[30:] = False
        dst[30:] = 0.0
    elif name == "degenerate":
        src, dst, mask = src * 0, dst * 0, mask & False
    elif name == "one_pair":
        mask[1:] = False
    elif name == "tie":
        # two clusters of 10 consistent pairs under two transforms: every
        # hypothesis inside either scores 10, the first one found wins
        dst[10:20] = src[10:20] @ _rot(-1.1).T + np.float32([3.0, 0.5])
        mask[20:] = False
    return src, dst, mask


@pytest.mark.parametrize("case", ["clean", "outliers", "padded", "degenerate",
                                  "one_pair", "tie"])
def test_ransac_matches_icp_tpu(case):
    """ransac_from_uniforms fed icp_tpu's uniforms (PRNGKey(0), 128
    hypotheses, threshold 0.2): n_inliers equal, R and t to 1e-5 — the
    25 %-outlier and degenerate cases of test_features_prealign.py, a
    padded pair list, a single pair and a tie between two models."""
    import jax
    import jax.numpy as jnp

    from icp_tpu.ops.ransac import ransac_align as j_ransac

    src, dst, mask = _ransac_case(case)
    Rj, tj, nj = j_ransac(jnp.asarray(src), jnp.asarray(dst),
                          jnp.asarray(mask), jax.random.PRNGKey(0),
                          n_iter=128, inlier_thresh=0.2)
    u1, u2 = _uniforms(0, 128)
    Rt, tt, nt = ransac_from_uniforms(T(src), T(dst), T(mask), T(u1), T(u2),
                                      inlier_thresh=0.2)
    assert int(nt) == int(nj)
    np.testing.assert_allclose(N(Rt), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(N(tt), np.asarray(tj), atol=1e-5)
    if case in ("degenerate", "one_pair"):
        assert int(nt) == 0 and np.array_equal(N(Rt), np.eye(2))
    if case == "outliers":
        assert int(nt) >= 28
    if case == "tie":
        assert int(nt) == 10


def test_ransac_align_draws_from_its_generator():
    """ransac_align with a seeded generator equals ransac_from_uniforms on
    that generator's two draws, and repeats with the same seed."""
    src, dst, mask = _ransac_case("outliers")
    out = [ransac_align(T(src), T(dst), T(mask),
                        torch.Generator().manual_seed(7), n_iter=64,
                        inlier_thresh=0.2) for _ in range(2)]
    g = torch.Generator().manual_seed(7)
    u1, u2 = torch.rand(64, generator=g), torch.rand(64, generator=g)
    ref = ransac_from_uniforms(T(src), T(dst), T(mask), u1, u2,
                               inlier_thresh=0.2)
    for got in out:
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


@pytest.mark.parametrize("seed", [3, 5])
def test_feature_based_alignment_matches_icp_tpu(seed):
    """The whole alignment of a rotated, shifted scene with injected
    uniforms: n_inliers equal, R and t to 1e-4, and the transform found."""
    import jax
    import jax.numpy as jnp

    from icp_tpu.models.features import feature_based_alignment as j_fba

    rng = np.random.default_rng(seed)
    target = _scene(rng, noise=0.005)
    th, t = np.deg2rad(40.0), np.float32([0.8, -0.5])
    sp, sm = _pad((target - t) @ _rot(th), 256)
    tp, tm = _pad(target, 256)
    kw = dict(voxel_size=0.1, top_n=64, ransac_iterations=128,
              inlier_threshold=0.4, ratio_threshold=0.85, k_descriptor=16)
    Rj, tj, nj = j_fba(jnp.asarray(sp), jnp.asarray(sm), jnp.asarray(tp),
                       jnp.asarray(tm), jax.random.PRNGKey(seed), **kw)
    Rt, tt, nt = TF.feature_based_alignment(
        T(sp), T(sm), T(tp), T(tm), uniforms=[T(u) for u in _uniforms(seed, 128)],
        **kw)
    assert int(nt) == int(nj) >= 3
    np.testing.assert_allclose(N(Rt), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(N(tt), np.asarray(tj), atol=1e-4)
    assert abs(np.arctan2(N(Rt)[1, 0], N(Rt)[0, 0]) - th) < 0.1


def test_feature_alignment_failure_paths_return_identity():
    """Too few points or no matches: (I, 0, 0), as icp_tpu returns."""
    p, m = _pad(_scene(np.random.default_rng(6)), 256)
    few = np.arange(256) < 8
    for mask_s, mask_t in ((few, m), (m, np.zeros(256, bool))):
        R, t, n = TF.feature_based_alignment(
            T(p), T(mask_s), T(p), T(mask_t), torch.Generator().manual_seed(0),
            voxel_size=0.1, top_n=32, ransac_iterations=32)
        assert int(n) == 0 and torch.equal(R, torch.eye(2))
        assert torch.equal(t, torch.zeros(2))


# ── on the card ───────────────────────────────────────────────────────────
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m gpu)")
    return torch.device("cuda:0")


@pytest.mark.gpu
def test_features_on_card_match_cpu(cuda_device):
    """extract_features and feature_based_alignment on the card against the
    CPU with the same uniforms: masks and keypoint indices equal,
    descriptors to 1e-4, n_inliers equal, R and t to 1e-4."""
    rng = np.random.default_rng(3)
    target = _scene(rng, noise=0.005)
    sp, sm = _pad((target - [0.8, -0.5]) @ _rot(0.7), 768)
    tp, tm = _pad(target, 768)
    kw = dict(voxel_size=0.1, top_n=100, min_kp_dist=0.2, k_descriptor=16)
    fc = TF.extract_features(T(sp), T(sm), **kw)
    fg = TF.extract_features(T(sp).to(cuda_device), T(sm).to(cuda_device), **kw)
    for a, b in zip(fg, fc):
        if a.dtype == torch.bool:
            assert torch.equal(a.cpu(), b)
        else:
            np.testing.assert_allclose(N(a), N(b), rtol=1e-4, atol=1e-4)
    g = torch.Generator().manual_seed(0)
    u = [torch.rand(512, generator=g), torch.rand(512, generator=g)]
    outs = []
    for dev in ("cpu", cuda_device):
        args = [T(x).to(dev) for x in (sp, sm, tp, tm)]
        outs.append(TF.feature_based_alignment(
            *args, uniforms=[x.to(dev) for x in u], ransac_iterations=512,
            inlier_threshold=0.3, **kw))
    (Rc, tc, nc), (Rg, tg, ng) = outs
    assert int(ng) == int(nc) >= 3
    np.testing.assert_allclose(N(Rg), N(Rc), atol=1e-4)
    np.testing.assert_allclose(N(tg), N(tc), atol=1e-4)


class _CpuStream:
    """RANSAC uniforms from one seeded CPU generator, moved to the device
    of the call, so the card and the CPU see the same hypotheses."""

    def __init__(self, seed):
        self.gen = torch.Generator().manual_seed(seed)

    def ransac(self, src, dst, pair_mask, generator=None, *, n_iter,
               inlier_thresh):
        u = [torch.rand(n_iter, generator=self.gen).to(src.device)
             for _ in range(2)]
        return ransac_from_uniforms(src, dst, pair_mask, *u,
                                    inlier_thresh=inlier_thresh)


@pytest.mark.gpu
@pytest.mark.parametrize("method,fused", [("features", True), ("both", False)],
                         ids=["fused_features", "modular_both"])
def test_features_path_on_card_matches_cpu(cuda_device, tmp_path, monkeypatch,
                                           method, fused):
    """The no-IMU features path on a 16-scan straight run, on the card and on
    the CPU with the same RANSAC uniforms: the same counters (icp_iters
    aside), positions within 5 mm, both kernels launched on the card."""
    from icp_tpu_torch.engine import SlamEngine, filter_and_flatten
    from icp_tpu_torch.ops.hopper import nn_kernel as K
    from icp_tpu_torch.services.lidar import LidarService
    from icp_tpu_torch.utils.config import SlamConfig
    from icp_tpu_torch.utils.synth import generate_sequence

    lidar = str(tmp_path / "l.csv")
    generate_sequence(lidar, str(tmp_path / "i.csv"), n_scans=16,
                      n_beams=360, noise=0.005, trajectory="straight", seed=5)
    scans = [filter_and_flatten(raw, 0.0, 3.0)
             for _, _, raw in LidarService(lidar).scans()]
    cfg = {"icp": {"voxel_size": 0.06, "max_iterations": 30,
                   "error_reject_threshold": 5.0},
           "features": {"method": method, "voxel_size": 0.1, "top_n": 64,
                        "k_descriptor": 16, "min_kp_dist": 0.2,
                        "ransac_iterations": 256, "inlier_threshold": 0.3},
           "submap": {"enabled": True, "size": 8, "voxel_size": 0.06,
                      "rotation_voxel_size": 0.2},
           "loop_closure": {"enabled": False},
           "filter": {"z_min": 0.0, "z_max": 3.0},
           "mapping": {"resolution": 0.1, "margin": 5.0},
           "tpu": {"scan_capacity": 512, "submap_capacity": 2048,
                   "max_ray_cells": 256, "batch_scans": 4, "fused": fused}}
    runs = []
    for dev in ("cpu", cuda_device):
        monkeypatch.setattr(TF, "ransac_align", _CpuStream(0).ransac)
        K.reset_launch_counts()
        eng = SlamEngine(SlamConfig.from_dict(cfg), verbose=False, device=dev)
        eng.process_scan(scans[0])
        for k in range(1, len(scans), 4):
            eng.process_scans_batched(scans[k:k + 4], [None] * len(scans[k:k + 4]))
        eng.finish()
        eng.sync_map()
        runs.append((eng, K.nn_launches, K.nn_min_launches))
    (ec, _, _), (eg, nn, nn_min) = runs
    assert nn > 0 and nn_min > 0
    for f in ("scans", "rejected", "submap_corrections"):
        assert getattr(eg.stats, f) == getattr(ec.stats, f), f
    pg_, pc = np.stack(eg.pose_trajectory), np.stack(ec.pose_trajectory)
    np.testing.assert_allclose(pg_[:, :2, 2], pc[:, :2, 2], atol=5e-3)
    assert bool(torch.isfinite(eg.mapper.log_odds).all())
