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


@pytest.mark.gpu
@pytest.mark.parametrize("rows_n,m", [(20 * 768, 1792), (240 * 768, 768),
                                      (30 * 768, 768), (151 * 768, 1792),
                                      (32 * 768, 1792)],
                         ids=["fine_sweep", "lc_coarse", "lc_fine",
                              "no_imu_coarse", "no_imu_fine"])
def test_nn_min_cuda_matches_plain_on_card(cuda_device, rows_n, m):
    """nn_min_cuda against nn_min_plain at the submap fine sweep's shape,
    at loop-closure verification's coarse and fine sweeps, and at the
    no-IMU submap sweep's (151 angles over +-60 degrees, then 32)."""
    rng = np.random.default_rng(7)
    rows = torch.as_tensor(rng.uniform(-20, 20, (rows_n, 2)).astype(np.float32),
                           device=cuda_device)
    tgt = torch.as_tensor(rng.uniform(-20, 20, (m, 2)).astype(np.float32),
                          device=cuda_device)
    msk = torch.as_tensor(rng.random(m) < 0.9, device=cuda_device)
    d_k = K.nn_min_cuda(rows, tgt, msk)
    d_p = K.nn_min_plain(rows, tgt, msk)
    torch.cuda.synchronize()
    torch.testing.assert_close(d_k, d_p, rtol=1e-4, atol=1e-5)
