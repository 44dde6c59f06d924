"""The NN kernels' plain versions and the sweep against icp_tpu's Pallas
kernels (interpret mode on the CPU).

The CUDA kernels cannot run here (no card, no nvcc): on CPU tensors each
wrapper takes its plain version, which these tests hold against the Pallas
kernel bodies. The `gpu`-marked tests hold each CUDA kernel against its
plain version on a card; chip_smoke.py does the same at the main path's
shapes. JAX is imported inside the tests that use it, so the card (which
has no JAX) runs the `gpu` tests with
``python -m pytest --noconftest -m gpu tests/test_torch_kernels.py``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from icp_tpu_torch.ops.hopper import nn_kernel as K  # noqa: E402
from icp_tpu_torch.ops.sweep import sweep_scores as t_sweep  # noqa: E402


def _pallas_nn_interpret(source, target, tgt_mask, tn=128, tm=128):
    """icp_tpu's _nn_kernel body run by the Pallas interpreter
    (the tests/test_pallas_nn.py pattern)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    from icp_tpu.ops.pallas import nn_kernel as PK

    n, m = source.shape[0], target.shape[0]
    dist, idx = pl.pallas_call(
        PK._nn_kernel,
        grid=(n // tn, m // tm),
        in_specs=[
            pl.BlockSpec((tn, 1), lambda i, j: (i, 0)),
            pl.BlockSpec((tn, 1), lambda i, j: (i, 0)),
            pl.BlockSpec((1, tm), lambda i, j: (0, j)),
            pl.BlockSpec((1, tm), lambda i, j: (0, j)),
            pl.BlockSpec((1, tm), lambda i, j: (0, j)),
        ],
        out_specs=[
            pl.BlockSpec((tn, 1), lambda i, j: (i, 0)),
            pl.BlockSpec((tn, 1), lambda i, j: (i, 0)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((n, 1), jnp.float32),
            jax.ShapeDtypeStruct((n, 1), jnp.int32),
        ],
        scratch_shapes=[
            pltpu.VMEM((tn, 1), jnp.float32),
            pltpu.VMEM((tn, 1), jnp.int32),
        ],
        interpret=True,
    )(source[:, 0:1], source[:, 1:2], target[:, 0].reshape(1, m),
      target[:, 1].reshape(1, m), tgt_mask.astype(jnp.float32).reshape(1, m))
    return np.asarray(dist[:, 0]), np.asarray(idx[:, 0])


def _nn_case(seed, n, m, n_dup, m_valid):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-5, 5, (m - n_dup, 2)).astype(np.float32)
    tgt = np.concatenate([base, base[:n_dup]])          # exact duplicates
    src = rng.uniform(-5, 5, (n, 2)).astype(np.float32)
    src[:16] = tgt[-16:]                                 # zero distances
    return src, tgt, np.arange(m) < m_valid


@pytest.mark.parametrize("seed,n,m,n_dup,m_valid", [
    (0, 256, 384, 0, 300),
    (3, 256, 768, 256, 700),      # the bench.py tie case, cut to 256 rows
    (4, 128, 256, 128, 0),        # no valid target: (BIG, 0)
])
def test_nn_plain_matches_pallas_kernel(seed, n, m, n_dup, m_valid):
    """Indices equal (ties to the lowest index, duplicated targets
    included); d2 within rtol 1e-5, atol 1e-6."""
    import jax.numpy as jnp

    src, tgt, msk = _nn_case(seed, n, m, n_dup, m_valid)
    d_j, i_j = _pallas_nn_interpret(jnp.asarray(src), jnp.asarray(tgt),
                                    jnp.asarray(msk))
    d_t, i_t = K.nn_plain(torch.as_tensor(src), torch.as_tensor(tgt),
                          torch.as_tensor(msk))
    assert i_t.dtype == torch.int32 and d_t.dtype == torch.float32
    np.testing.assert_array_equal(i_t.numpy(), i_j)
    np.testing.assert_allclose(d_t.numpy(), d_j, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,m,m_valid", [(300, 500, 450), (77, 129, 0)])
def test_nn_min_plain_matches_pallas_kernel(n, m, m_valid):
    """nn_min_plain against nn_min_pallas(interpret=True), ragged N and M:
    rtol 1e-5, atol 1e-6; BIG where no target is valid."""
    import jax.numpy as jnp
    from icp_tpu.ops.pallas.nn_kernel import nn_min_pallas

    rng = np.random.default_rng(n)
    src = rng.uniform(-5, 5, (n, 2)).astype(np.float32)
    tgt = rng.uniform(-5, 5, (m, 2)).astype(np.float32)
    msk = np.arange(m) < m_valid
    d_j = np.asarray(nn_min_pallas(jnp.asarray(src), jnp.asarray(tgt),
                                   jnp.asarray(msk), tn=128, tm=128,
                                   interpret=True))
    d_t = K.nn_min_plain(torch.as_tensor(src), torch.as_tensor(tgt),
                         torch.as_tensor(msk)).numpy()
    np.testing.assert_allclose(d_t, d_j, rtol=1e-5, atol=1e-6)
    if m_valid == 0:
        assert (d_t == np.float32(1e30)).all()


@functools.lru_cache(maxsize=None)
def _split_case(case):
    """A tie-heavy nn case, its nn_plain answer, and icp_tpu's Pallas
    indices for it."""
    import jax.numpy as jnp

    src, tgt, msk = _nn_case(*case)
    d, i = K.nn_plain(torch.as_tensor(src), torch.as_tensor(tgt),
                      torch.as_tensor(msk))
    _, i_j = _pallas_nn_interpret(jnp.asarray(src), jnp.asarray(tgt),
                                  jnp.asarray(msk))
    return src, tgt, msk, d, i, i_j


@pytest.mark.parametrize("n_slices", [1, 3, 8, 13])
@pytest.mark.parametrize("case", [
    (3, 256, 768, 256, 700),      # duplicated targets, zero distances
    (4, 128, 256, 128, 0),        # no valid target: (BIG, 0)
], ids=["ties", "no-valid"])
def test_nn_split_and_reduce_is_exact(case, n_slices):
    """The algebra nn_cuda's cluster split rests on: nn_plain on each
    slice of the targets, indices shifted by the slice's offset, the
    partial (d2, idx) pairs combined by lexicographic min in a shuffled
    order, equals nn_plain on the whole set bit for bit, and its indices
    equal those of icp_tpu's Pallas kernel (interpret mode)."""
    src, tgt, msk, d_all, i_all, i_pallas = _split_case(case)
    s, g, m = (torch.as_tensor(a) for a in (src, tgt, msk))
    parts = []
    for sl in np.array_split(np.arange(g.shape[0]), n_slices):
        lo, hi = int(sl[0]), int(sl[-1]) + 1
        d, i = K.nn_plain(s, g[lo:hi], m[lo:hi])
        parts.append((d, i + lo))
    order = np.random.default_rng(n_slices).permutation(n_slices)
    d, i = parts[order[0]]
    for k in order[1:]:
        pd, pi = parts[k]
        take = (pd < d) | ((pd == d) & (pi < i))
        d, i = torch.where(take, pd, d), torch.where(take, pi, i)
    assert i.dtype == torch.int32
    assert torch.equal(d, d_all) and torch.equal(i, i_all)
    np.testing.assert_array_equal(i.numpy(), i_pallas)


@functools.lru_cache(maxsize=None)
def _min_split_case(case):
    """An nn_min case (256 rows x 300 targets; 10 % of the targets masked,
    or all), its nn_min_plain answer and nn_min_pallas's (interpret mode)."""
    import jax.numpy as jnp
    from icp_tpu.ops.pallas.nn_kernel import nn_min_pallas

    rng = np.random.default_rng(11)
    src = rng.uniform(-5, 5, (256, 2)).astype(np.float32)
    tgt = rng.uniform(-5, 5, (300, 2)).astype(np.float32)
    src[:16] = tgt[:16]                                  # zero distances
    msk = rng.random(300) >= 0.1 if case == "random" else np.zeros(300, bool)
    d = K.nn_min_plain(torch.as_tensor(src), torch.as_tensor(tgt),
                       torch.as_tensor(msk))
    d_j = np.asarray(nn_min_pallas(jnp.asarray(src), jnp.asarray(tgt),
                                   jnp.asarray(msk), tn=128, tm=128,
                                   interpret=True))
    return src, tgt, msk, d, d_j


@pytest.mark.parametrize("n_slices", [1, 3, 8, 13])
@pytest.mark.parametrize("case", ["random", "all-masked"])
def test_nn_min_split_and_reduce_is_exact(case, n_slices):
    """The algebra nn_min_cuda's kernel rests on. Each slice of the targets
    is folded as a kernel thread folds it: masked targets replaced by NaN,
    no mask, torch.fmin over the targets in order (fmin(x, NaN) = x), and
    then BIG where the slice holds a masked target; that equals
    nn_min_plain on the slice with its mask, bit for bit. The slices,
    combined by torch.fmin in a shuffled order from a BIG start, equal
    nn_min_plain on the whole set bit for bit and nn_min_pallas
    (interpret mode) within rtol 1e-5, atol 1e-6."""
    src, tgt, msk, d_all, d_pallas = _min_split_case(case)
    s, g, m = (torch.as_tensor(a) for a in (src, tgt, msk))
    g_nan = torch.where(m[:, None], g, torch.tensor(float("nan")))
    parts = []
    for sl in np.array_split(np.arange(g.shape[0]), n_slices):
        lo, hi = int(sl[0]), int(sl[-1]) + 1
        fold = torch.full((s.shape[0],), float("inf"))
        for j in range(lo, hi):
            dx = s[:, 0] - g_nan[j, 0]
            dy = s[:, 1] - g_nan[j, 1]
            fold = torch.fmin(fold, dx * dx + dy * dy)
        if not bool(m[lo:hi].all()):
            fold = torch.fmin(fold, torch.tensor(K.BIG))
        assert torch.equal(fold, K.nn_min_plain(s, g[lo:hi], m[lo:hi]))
        parts.append(fold)
    d = torch.full((s.shape[0],), K.BIG)
    for k in np.random.default_rng(n_slices).permutation(n_slices):
        d = torch.fmin(d, parts[k])
    assert torch.equal(d, d_all)
    np.testing.assert_allclose(d.numpy(), d_pallas, rtol=1e-5, atol=1e-6)
    if case == "all-masked":
        assert bool((d == K.BIG).all())


# the six shapes the sweep runs nn_min_cuda at (rows = angles x 768):
# the IMU main path's coarse and fine passes, the no-IMU path's, and loop
# closure verification's
PATH_SHAPES = [(13 * 768, 1792), (20 * 768, 1792), (151 * 768, 1792),
               (32 * 768, 1792), (240 * 768, 768), (30 * 768, 768)]
# icp_nn_min's fixed shape (csrc/nn_kernel.cu kMinWarps, kMinTile): the 8
# warps of a block split its slice; targets are staged 2048 at a time
MIN_WARPS, MIN_TILE = 8, 2048


def _nn_min_cover(n, m, k, csize, sl):
    """What icp_nn_min's blocks reduce under geometry (k, csize, sl), by the
    kernel's own index arithmetic: one (row_lo, row_hi, [(t_lo, t_hi), ...])
    per block, the target runs of its warps over its staged tiles."""
    rows = 32 * k
    out = []
    for b in range(-(-n // rows) * csize):
        rank, row0 = b % csize, (b // csize) * rows
        lo = min(m, rank * sl)
        hi = min(m, lo + sl)
        runs = []
        for base in range(lo, hi, MIN_TILE):
            end = min(hi, base + MIN_TILE)
            pairs = (end - base + 1) // 2
            per = -(-pairs // MIN_WARPS)
            for w in range(MIN_WARPS):
                q0, q1 = min(pairs, w * per), min(pairs, (w + 1) * per)
                if q0 < q1:
                    runs.append((base + 2 * q0, min(end, base + 2 * q1)))
        out.append((row0, min(n, row0 + rows), runs))
    return out


@pytest.mark.parametrize("n,m", PATH_SHAPES + [
    (1, 1792), (300, 0), (777, 1791), (500, 5), (3000, 4096), (3000, 9000)])
def test_nn_min_geometry_covers_every_pair_once(n, m):
    """nn_min_geometry's launch, traced by the kernel's index arithmetic
    (_nn_min_cover): the blocks' row ranges tile [0, n), the target runs of
    each row range's blocks and warps tile [0, m) with no overlap, the
    geometry passes the kernel's own checks, and every path shape puts a
    block on each of the H100's 132 SMs."""
    k, csize, sl = K.nn_min_geometry(n, m)
    assert k in (4, 8) and 1 <= csize <= K.NN_MIN_MAX_CLUSTER
    assert sl >= 2 and sl % 2 == 0 and csize * sl >= m
    assert m == 0 and csize == 1 or (csize - 1) * sl < m
    blocks = _nn_min_cover(n, m, k, csize, sl)
    assert len(blocks) == -(-n // (32 * k)) * csize
    groups = {}
    for r0, r1, runs in blocks:
        groups.setdefault((r0, r1), []).extend(runs)
    ranges = sorted(groups)
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    for runs in groups.values():
        pos = 0
        for lo, hi in sorted(runs):
            assert lo == pos and hi > lo
            pos = hi
        assert pos == m
    if (n, m) in PATH_SHAPES:
        assert len(blocks) >= K.H100_SMS


def test_wrappers_take_plain_version_on_cpu_without_counting():
    """On CPU tensors nn_cuda/nn_min_cuda return exactly the plain result
    and count no kernel launch."""
    src, tgt, msk = _nn_case(5, 64, 96, 16, 90)
    args = tuple(torch.as_tensor(a) for a in (src, tgt, msk))
    K.reset_launch_counts()
    d, i = K.nn_cuda(*args)
    d_p, i_p = K.nn_plain(*args)
    assert torch.equal(d, d_p) and torch.equal(i, i_p)
    assert torch.equal(K.nn_min_cuda(*args), K.nn_min_plain(*args))
    assert K.nn_launches == 0 and K.nn_min_launches == 0


def test_sweep_scores_matches_pallas_and_xla_forms():
    """The port's sweep_scores against icp_tpu's _sweep_scores_pallas
    (interpret mode, direct differencing) within rtol 1e-5, and against
    icp_tpu's CPU sweep_scores (centroid-shifted expansion) within rtol
    1e-4; the winning angle is the same."""
    import jax.numpy as jnp
    from icp_tpu.ops.sweep import _sweep_scores_pallas, sweep_scores as j_sweep

    rng = np.random.default_rng(2)
    src = rng.uniform(-5, 5, (96, 2)).astype(np.float32)
    sm = np.arange(96) < 80
    tgt = rng.uniform(-5, 5, (160, 2)).astype(np.float32)
    tm = np.arange(160) < 140
    angles = np.deg2rad(np.arange(-30, 30, 2.5)).astype(np.float32)
    t_off = np.array([0.3, -0.2], np.float32)
    j_args = tuple(map(jnp.asarray, (src, sm, tgt, tm, angles, t_off)))
    s_pal = np.asarray(_sweep_scores_pallas(*j_args, interpret=True))
    s_xla = np.asarray(j_sweep(*j_args))
    s_t = t_sweep(*(torch.as_tensor(a) for a in
                    (src, sm, tgt, tm, angles, t_off))).numpy()
    np.testing.assert_allclose(s_t, s_pal, rtol=1e-5)
    np.testing.assert_allclose(s_t, s_xla, rtol=1e-4)
    assert np.argmin(s_t) == np.argmin(s_pal) == np.argmin(s_xla)


def test_kernel_library_name_tracks_source_and_flags():
    """The built library's name hashes the CUDA source and nvcc flags, so an
    edited kernel is rebuilt, not loaded stale; nothing builds at import."""
    from icp_tpu_torch.ops.hopper import build

    p = build._library_path()
    assert p.parent == build.BUILD_DIR and p.name.startswith("libicp_nn_")
    assert build._library_path() == p
    assert build.SOURCE.exists()
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m gpu)")
    return torch.device("cuda:0")


def _card_case(name):
    """nn_cuda cases on the card: the main path's two shapes, a ragged
    shape, ties across the kernel's target slices (the target set
    concatenated with a copy of itself; all targets equal), M below one
    64-target slice, M = 0 and N = 1."""
    rng = np.random.default_rng(6)
    if "x" in name:
        n, m = map(int, name.split("x"))
        return _nn_case(6, n, m, 256, m - 50)
    if name == "self-concat":
        src, tgt, msk = _nn_case(6, 768, 2048, 0, 1900)
        return src, np.concatenate([tgt, tgt]), np.concatenate([msk, msk])
    src = rng.uniform(-5, 5, (768, 2)).astype(np.float32)
    if name == "all-equal":
        return (src, np.tile(np.float32([[1.5, -0.5]]), (4096, 1)),
                rng.random(4096) < 0.9)
    if name == "M=5":
        return src, src[:5].copy(), np.ones(5, bool)
    if name == "M=0":
        return src, np.zeros((0, 2), np.float32), np.zeros(0, bool)
    assert name == "N=1"
    _, tgt, msk = _nn_case(6, 16, 4096, 256, 4000)
    return src[:1], tgt, msk


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["768x4096", "700x4000", "768x768",
                                  "self-concat", "all-equal", "M=5", "M=0",
                                  "N=1"])
def test_nn_cuda_matches_plain_on_card(cuda_device, case):
    """The CUDA kernel against its plain version on the card: indices
    equal and d2 bit-equal (both round each operation on its own), in one
    launch."""
    src, tgt, msk = _card_case(case)
    args = tuple(torch.as_tensor(a, device=cuda_device) for a in (src, tgt, msk))
    before = K.nn_launches
    d_k, i_k = K.nn_cuda(*args)
    d_p, i_p = K.nn_plain(*args)
    torch.cuda.synchronize()
    assert K.nn_launches == before + 1
    assert torch.equal(i_k, i_p)
    assert torch.equal(d_k, d_p)


def _min_card_case(name):
    """nn_min_cuda cases on the card: (rows, target, mask) as numpy, and
    whether the target is to be a view that is not 16-byte aligned."""
    rng = np.random.default_rng(7)

    def cloud(n, lo=-20.0, hi=20.0):
        return rng.uniform(lo, hi, (n, 2)).astype(np.float32)

    shapes = dict(zip(["main_coarse", "main_fine", "no_imu_coarse",
                       "no_imu_fine", "lc_coarse", "lc_fine"], PATH_SHAPES))
    if name in shapes:
        n, m = shapes[name]
        return cloud(n), cloud(m), rng.random(m) < 0.9, False
    if name == "M=0":
        return cloud(300), np.zeros((0, 2), np.float32), np.zeros(0, bool), False
    if name == "all-masked":
        return cloud(300), cloud(1000), np.zeros(1000, bool), False
    if name == "R=1":
        return cloud(1), cloud(1792), rng.random(1792) < 0.9, False
    if name == "M-odd":
        return cloud(777), cloud(1791), rng.random(1791) < 0.9, False
    if name == "misaligned":
        return cloud(2000), cloud(1792), rng.random(1792) < 0.9, True
    if name == "rows=targets":
        t = cloud(1792)
        return t.copy(), t, rng.random(1792) < 0.9, False
    if name == "far":        # nearest d2 on both sides of BIG, none masked
        return cloud(600, -1e16, 1e16), cloud(700, -1e16, 1e16), \
            np.ones(700, bool), False
    m = {"M=4096": 4096, "M=9000": 9000}[name]
    return cloud(3000), cloud(m), rng.random(m) < 0.9, False


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    "main_coarse", "main_fine", "no_imu_coarse", "no_imu_fine", "lc_coarse",
    "lc_fine", "M=0", "all-masked", "R=1", "M-odd", "misaligned",
    "rows=targets", "M=4096", "M=9000", "far"])
def test_nn_min_cuda_matches_plain_on_card(cuda_device, case):
    """nn_min_cuda against nn_min_plain on the card, bit for bit, in one
    launch: at the six sweep shapes (the IMU main path's coarse 13 x 768 and
    fine 20 x 768 rows, the no-IMU path's 151 and 32 x 768, loop-closure
    verification's 240 and 30 x 768) and at the edges of the kernel's
    staging and geometry, where a d2 above BIG is kept as the plain
    version keeps it."""
    src, tgt, msk, misaligned = _min_card_case(case)
    rows, g, m = (torch.as_tensor(a, device=cuda_device) for a in (src, tgt, msk))
    if misaligned:
        g = torch.as_tensor(np.concatenate([tgt[:1], tgt]), device=cuda_device)[1:]
        assert g.data_ptr() % 16 == 8 and g.is_contiguous()
    before = K.nn_min_launches
    d_k = K.nn_min_cuda(rows, g, m)
    d_p = K.nn_min_plain(rows, g, m)
    torch.cuda.synchronize()
    assert K.nn_min_launches == before + 1
    assert torch.equal(d_k, d_p)
