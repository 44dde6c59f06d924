"""3-D ICP and the native lidar CSV parser of icp_tpu_torch against icp_tpu
(JAX on the CPU). The same seeded numpy inputs go through both packages.

Tolerances:
* ``p2p_solve_3d``: R and t within 1e-5 (both take the SVD of the same
  3 x 3 cross-covariance; the products are summed in another order), a
  case whose raw SVD is a reflection included;
* 3-D ``voxel_downsample`` / ``voxel_downsample_fixed``: the same mask and
  slot order, means within 1e-6 (icp_tpu's unstable sort orders the points
  of a voxel differently, and its fixed variant sums deviations from the
  voxel centre);
* ``icp`` on tests/test_icp.py's 3-D case: R and t within 1e-4 of
  icp_tpu's, error < 1e-4, iterations within 1 (the threshold 1e-12 is
  under the 32-ulp floor of the error, which the two packages' sum orders
  may cross one iteration apart);
* the native parser against the numpy parser and against icp_tpu's native
  loader: timestamps and points bit for bit (both read a double and round
  it to f32).
"""
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from icp_tpu_torch.models.icp import icp, icp_core, identity_init  # noqa: E402
from icp_tpu_torch.ops.nn import nn_query  # noqa: E402
from icp_tpu_torch.ops.rigid import p2p_solve_3d  # noqa: E402
from icp_tpu_torch.ops.voxel import (voxel_downsample,  # noqa: E402
                                     voxel_downsample_fixed)
from icp_tpu_torch.runtime import loader  # noqa: E402
from icp_tpu_torch.services.lidar import LidarService, parse_lidar_line  # noqa: E402
from icp_tpu_torch.utils.masking import pad_points  # noqa: E402


def _t(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


def _rot_y(deg):
    th = np.deg2rad(deg)
    return np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                     [-np.sin(th), 0, np.cos(th)]], np.float32)


def teapot_case():
    """tests/test_icp.py::test_icp_3d_teapot_style's clouds: 418 points in
    512 slots, 25 degrees about Y and a shift."""
    rng = np.random.default_rng(4)
    target = rng.uniform(-1.5, 1.5, size=(418, 3)).astype(np.float32)
    target[:, 2] *= 0.5
    R_true = _rot_y(25.0)
    t_true = np.array([0.3, -0.2, 0.25], np.float32)
    source = (target - t_true) @ R_true
    return (*pad_points(source, 512), *pad_points(target, 512), R_true)


# ── p2p_solve_3d ─────────────────────────────────────────────────────────
@pytest.mark.parametrize("case", ["rotation", "weighted", "reflection"])
def test_p2p_solve_3d_matches_icp_tpu(case):
    import jax.numpy as jnp
    from icp_tpu.ops.rigid import p2p_solve_3d as j_solve

    rng = np.random.default_rng(11)
    src = rng.uniform(-2, 2, (200, 3)).astype(np.float32)
    w = np.ones(200, np.float32)
    if case == "reflection":
        # a mirrored, nearly planar cloud: the unconstrained optimum is a
        # reflection, so the raw V U^T has det -1 and the fix must flip it
        src[:, 2] *= 0.01
        dst = src * np.float32([1, 1, -1]) + np.float32([0.1, 0.2, 0.3])
    else:
        dst = src @ _rot_y(25.0).T + np.float32([0.3, -0.2, 0.25])
        dst += rng.normal(scale=0.01, size=dst.shape).astype(np.float32)
    if case == "weighted":
        w = (rng.random(200) < 0.7).astype(np.float32)
    Rj, tj = j_solve(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w))
    Rt, tt = p2p_solve_3d(*_t(src, dst, w))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)
    assert abs(float(torch.linalg.det(Rt)) - 1.0) < 1e-5    # proper rotation
    if case == "reflection":
        U, _, Vt = np.linalg.svd((src - src.mean(0)).T @ (dst - dst.mean(0)))
        assert np.linalg.det(Vt.T @ U.T) < 0      # the raw solve does reflect


# ── 3-D voxel downsample ─────────────────────────────────────────────────
def _cloud3(seed, n=600, cap=1024):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    pts[:, 2] *= 0.3
    # clusters, so voxels hold several points
    pts[: n // 2] = np.round(pts[: n // 2] / 0.05) * 0.05 + rng.normal(
        scale=0.004, size=(n // 2, 3)).astype(np.float32)
    return pad_points(pts, cap)


@pytest.mark.parametrize("capacity", [None, 2048, 1024, 256, 64])
def test_voxel_downsample_3d_matches_icp_tpu(capacity):
    import jax.numpy as jnp
    from icp_tpu.ops import voxel as JV

    p, m = _cloud3(2)
    if capacity is None:
        oj, mj = JV.voxel_downsample(jnp.asarray(p), jnp.asarray(m), 0.1)
        ot, mt = voxel_downsample(*_t(p, m), 0.1)
    else:
        oj, mj = JV.voxel_downsample_fixed(jnp.asarray(p), jnp.asarray(m),
                                           0.1, capacity)
        ot, mt = voxel_downsample_fixed(*_t(p, m), 0.1, capacity)
    mj, oj = np.asarray(mj), np.asarray(oj)
    assert ot.shape == oj.shape == ((1024 if capacity is None else capacity), 3)
    np.testing.assert_array_equal(mt.numpy(), mj)
    assert 40 < mj.sum() <= len(mj)
    # same slot order: each valid slot holds the same voxel's mean
    np.testing.assert_allclose(ot.numpy()[mj], oj[mj], atol=1e-6)
    # lexicographic (c0, c1, c2) order of the voxel coordinates
    lo = p[m].min(0)
    c = np.floor((ot.numpy()[mj] - lo) / 0.1).astype(np.int64)
    key = (c[:, 0] * 10**6 + c[:, 1]) * 10**6 + c[:, 2]
    assert (np.diff(key) > 0).all()


def test_voxel_downsample_2d_unchanged_by_the_3d_path():
    """A 3-D cloud with a constant third coordinate gives the 2-D result's
    slots, bit for bit: the second sort key is then constant."""
    rng = np.random.default_rng(3)
    p2 = rng.uniform(-3, 3, (500, 2)).astype(np.float32)
    m = rng.random(500) < 0.8
    p3 = np.concatenate([p2, np.full((500, 1), 0.25, np.float32)], 1)
    o2, m2 = voxel_downsample(*_t(p2, m), 0.2)
    o3, m3 = voxel_downsample(*_t(p3, m), 0.2)
    assert torch.equal(m2, m3)
    assert torch.equal(o3[:, :2], o2)
    assert bool((o3[m3][:, 2] == 0.25).all())


# ── 3-D ICP ──────────────────────────────────────────────────────────────
def test_icp_3d_matches_icp_tpu():
    import jax.numpy as jnp
    from icp_tpu.models.icp import icp as j_icp

    sp, sm, tp, tm, R_true = teapot_case()
    kw = dict(voxel_size=0.005, method="point_to_point", max_iterations=300,
              error_threshold=1e-12)
    rj = j_icp(jnp.asarray(sp), jnp.asarray(sm), jnp.asarray(tp),
               jnp.asarray(tm), jnp.eye(3, dtype=jnp.float32),
               jnp.zeros(3, jnp.float32), **kw)
    rt = icp(*_t(sp, sm, tp, tm), *identity_init(3, "cpu"), **kw)
    assert rt.R.shape == (3, 3) and rt.t.shape == (3,)
    assert float(rt.error) < 1e-4
    np.testing.assert_allclose(rt.R.numpy(), R_true, atol=2e-2)
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=1e-4)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=1e-4)
    assert abs(int(rt.iters) - int(rj.iters)) <= 1
    assert int(rt.n_inliers) == int(rj.n_inliers) == 418


@pytest.mark.parametrize("nn_impl", ["auto", "xla"])
def test_icp_3d_point_to_line_runs_point_to_point(nn_impl):
    """D = 3 estimates no normals and launches no 2-D kernel: the method
    and nn_impl change nothing."""
    sp, sm, tp, tm, _ = teapot_case()
    args = (*_t(sp, sm, tp, tm), *identity_init(3, "cpu"))
    kw = dict(max_iterations=40, error_threshold=1e-9)
    a = icp_core(*args, method="point_to_point", nn_impl="xla", **kw)
    b = icp_core(*args, method="point_to_line", nn_impl=nn_impl, **kw)
    assert torch.equal(a.R, b.R) and torch.equal(a.t, b.t)
    assert int(a.iters) == int(b.iters) and float(a.error) == float(b.error)


def test_nn_query_3d_matches_icp_tpu():
    import jax.numpy as jnp
    from icp_tpu.ops.nn import nn_query as j_nn

    sp, sm, tp, tm, _ = teapot_case()
    dj, ij = j_nn(jnp.asarray(sp), jnp.asarray(tp), jnp.asarray(tm),
                  jnp.asarray(sm))
    dt, it = nn_query(*_t(sp, tp, tm, sm))
    np.testing.assert_array_equal(it.numpy()[sm], np.asarray(ij)[sm])
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5)


def test_icp_core_rejects_other_dimensions():
    p = torch.zeros(8, 4)
    m = torch.ones(8, dtype=torch.bool)
    with pytest.raises(ValueError, match=r"\(N, 2\) or \(N, 3\)"):
        icp_core(p, m, p, m, torch.eye(4), torch.zeros(4))
    with pytest.raises(ValueError, match=r"\(N, 2\) or \(N, 3\)"):
        voxel_downsample(p, m, 0.1)


# ── the native parser ────────────────────────────────────────────────────
SAMPLE = ["1000;1.0;2.0;1.2;0;0;0;3.5;-1.0;1.1",
          "2000;0.5;0.5;1.3",
          "3000;-2.0;4.0;1.0;7.0;8.0;1.25"]


def _write_big(path, n_scans=50, n_points=100):
    rng = np.random.default_rng(0)
    with open(path, "w") as fh:
        for k in range(n_scans):
            vals = rng.uniform(-10, 10, size=(n_points, 3))
            row = ";".join(f"{v:.5f}" for v in vals.reshape(-1))
            fh.write(f"{1000 + k};{row}\n")


def _numpy_parse(path):
    with open(path) as fh:
        return [parse_lidar_line(line) for line in fh if line.strip()]


def _assert_same_scans(a, b):
    assert len(a) == len(b)
    for (ts_a, pts_a), (ts_b, pts_b) in zip(a, b):
        assert ts_a == ts_b
        assert pts_a.dtype == pts_b.dtype == np.float32
        np.testing.assert_array_equal(pts_a, pts_b)


def test_native_lib_builds_into_the_ports_build_dir():
    lib = loader.get_lib()
    assert isinstance(lib, ctypes.CDLL)
    built = list(loader.BUILD_DIR.glob("libfastcsv_*.so"))
    assert built and loader.BUILD_DIR.name == "build"
    assert loader.BUILD_DIR.parent.name == "icp_tpu_torch"
    assert loader.SOURCE.parent.name == "csrc"


@pytest.mark.parametrize("which", ["sample", "big"])
def test_native_parser_bit_equal_to_numpy_and_icp_tpu(tmp_path, which):
    from icp_tpu.runtime.loader import load_lidar_csv as j_load

    f = tmp_path / f"{which}.csv"
    if which == "sample":
        f.write_text("\n".join(SAMPLE) + "\n")
    else:
        _write_big(f)
    native = loader.load_lidar_csv(str(f))
    _assert_same_scans(native, _numpy_parse(f))
    _assert_same_scans(native, j_load(str(f)))
    if which == "sample":
        assert native[0][1].shape == (2, 3)      # padding triple dropped
    else:
        assert len(native) == 50
        assert all(p.shape == (100, 3) for _, p in native)


def test_native_parser_on_malformed_lines(tmp_path):
    """The two differences from parse_lidar_line, as in icp_tpu: a line
    with no leading number is skipped, and a line ends at its first
    incomplete triple."""
    f = tmp_path / "odd.csv"
    f.write_text("# header\n\n1000;1.0;2.0;3.0;4.0;5.0\n2000;0;0;0\n")
    native = loader.load_lidar_csv(str(f))
    assert [ts for ts, _ in native] == [1000, 2000]
    np.testing.assert_array_equal(native[0][1], np.float32([[1, 2, 3]]))
    assert native[1][1].shape == (0, 3)
    with pytest.raises(ValueError):
        parse_lidar_line("1000;1.0;2.0;3.0;4.0;5.0")
    with pytest.raises(FileNotFoundError):
        loader.load_lidar_csv(str(tmp_path / "missing.csv"))


def test_lidar_service_streams_natively(tmp_path):
    f = tmp_path / "sample.csv"
    f.write_text("\n".join(SAMPLE) + "\n")
    svc = LidarService(str(f))
    assert svc.parser is None
    out = list(svc.scans())
    assert svc.parser == "native"
    assert [(ts, rel) for ts, rel, _ in out] == [(1000, 0), (2000, 1000),
                                                 (3000, 2000)]
    _assert_same_scans([(ts, p) for ts, _, p in out], _numpy_parse(f))


def test_lidar_service_without_a_compiler_parses_with_numpy(tmp_path,
                                                            monkeypatch):
    f = tmp_path / "sample.csv"
    f.write_text("\n".join(SAMPLE) + "\n")
    monkeypatch.setattr(loader, "_lib", None)
    monkeypatch.setattr(loader, "find_compiler", lambda: None)
    svc = LidarService(str(f))
    out = list(svc.scans())
    assert svc.parser == "numpy"
    _assert_same_scans([(ts, p) for ts, _, p in out], _numpy_parse(f))
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        loader.load_lidar_csv(str(f))


def test_failing_compiler_raises(tmp_path, monkeypatch):
    """A compiler that is found and fails is an error, not a reason to
    parse with numpy."""
    f = tmp_path / "sample.csv"
    f.write_text("\n".join(SAMPLE) + "\n")
    monkeypatch.setattr(loader, "_lib", None)
    monkeypatch.setattr(loader, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", "false")
    assert loader.find_compiler()[0].endswith("false")
    with pytest.raises(RuntimeError, match="false failed"):
        loader.get_lib()
    with pytest.raises(RuntimeError, match="false failed"):
        list(LidarService(str(f)).scans())
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_that_does_not_load_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(loader, "_lib", None)
    monkeypatch.setattr(loader, "BUILD_DIR", tmp_path)
    path = loader._library_path(loader.find_compiler()[1])
    path.write_bytes(b"not a shared object")
    with pytest.raises(OSError):
        loader.get_lib()
