"""icp_core's two ways of running one iteration body: the Python loop and
the CUDA-graph replay of whole chunks.

On the CPU (no card, no capture) the tests hold the Python loop over the
factored body bit for bit to the loop as it was written before the body
was factored out (``_before`` below), and check which way each input
takes and what it counts. The `gpu`-marked tests hold the graph replays
to the Python loop on a card, bit for bit, at the engine's two shapes
and the same cases; they import no JAX, so the card runs them with
``python -m pytest --noconftest -m gpu tests/test_torch_icp_graph.py``.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from icp_tpu_torch.ops.eig2 import estimate_normals  # noqa: E402
from icp_tpu_torch.ops.hopper import nn_kernel as K  # noqa: E402
from icp_tpu_torch.ops.hopper.nn_kernel import nn_cuda  # noqa: E402
from icp_tpu_torch.ops.nn import nn_query  # noqa: E402
from icp_tpu_torch.ops.rigid import (  # noqa: E402
    p2l_solve_2d, p2p_solve_2d, p2p_solve_3d)
from icp_tpu_torch.utils import spans  # noqa: E402
from icp_tpu_torch.utils.masking import masked_mean  # noqa: E402

# models/__init__ re-exports the function ``icp``, which shadows the module
I = importlib.import_module("icp_tpu_torch.models.icp")


def _before(source, src_mask, target, tgt_mask, R_init, t_init, *,
            method="point_to_point", max_iterations=100, normal_k=10,
            error_threshold=1e-7, max_corr_dist=0.0, use_gate=False,
            nn_impl="auto"):
    """icp_core's loop as it stood before its body was factored out."""
    dim = source.shape[1]
    dev = source.device
    f32 = torch.float32
    use_p2l = method == "point_to_line" and dim == 2
    use_kernel = nn_impl != "xla" and dim == 2
    n_valid = src_mask.to(f32).sum()
    min_inliers = torch.clamp(torch.floor(n_valid / 10.0), min=3.0)
    max_corr_sq = torch.tensor(max_corr_dist, dtype=f32, device=dev) ** 2
    err_thresh = torch.tensor(error_threshold, dtype=f32, device=dev)
    target_normals = (estimate_normals(target, tgt_mask, k=normal_k)
                      if use_p2l else None)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    transformed = source @ R_init.T + t_init
    r_total, t_total = R_init, t_init
    error = torch.tensor(float("inf"), dtype=f32, device=dev)
    stop = torch.zeros((), dtype=torch.bool, device=dev)
    n_in = torch.zeros((), dtype=f32, device=dev)
    done = 0
    while done < max_iterations:
        for _ in range(min(8, max_iterations - done)):
            live = ~stop
            if use_kernel:
                d2, nn_idx = nn_cuda(transformed, target, tgt_mask)
                nn_dists = torch.sqrt(d2)
                nn_idx = nn_idx.long()
            else:
                nn_dists, nn_idx = nn_query(transformed, target, tgt_mask,
                                            src_mask)
            nearest = target[nn_idx]
            if use_gate:
                inlier = (nn_dists * nn_dists < max_corr_sq) & src_mask
            else:
                inlier = src_mask
            w = inlier.to(f32)
            n_in_new = w.sum()
            abort = n_in_new < min_inliers
            if use_p2l:
                r, t = p2l_solve_2d(transformed, nearest,
                                    target_normals[nn_idx], w)
            elif dim == 2:
                r, t = p2p_solve_2d(transformed, nearest, w)
            else:
                r, t = p2p_solve_3d(transformed, nearest, w)
            new_transformed = transformed @ r.T + t
            sq = ((nearest - new_transformed) ** 2).sum(-1)
            new_error = masked_mean(sq, src_mask)
            delta = torch.abs(error - new_error)
            eff_thresh = torch.maximum(err_thresh, 32.0 * 1.1920929e-07 * new_error)
            converged = delta < eff_thresh
            apply = live & ~abort
            transformed = torch.where(apply, new_transformed, transformed)
            r_total = torch.where(apply, r @ r_total, r_total)
            t_total = torch.where(apply, t_total @ r.T + t, t_total)
            error = torch.where(apply, new_error, error)
            n_in = torch.where(live, n_in_new, n_in)
            it = it + live.to(torch.int32)
            stop = stop | abort | converged
            done += 1
        if bool(stop):
            break
    return I.ICPResult(r_total, t_total, error, it, n_in.to(torch.int32))


def _rot(th):
    return np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]],
                    np.float32)


def _room(rng, n, noise=0.005):
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


def _padded(pts, cap):
    out = np.zeros((cap, 2), np.float32)
    out[:len(pts)] = pts
    out[len(pts):] = pts[0] if len(pts) else 0.0
    return out, np.arange(cap) < len(pts)


def _case(name, n=256, m=256, seed=1):
    """(source, src_mask, target, tgt_mask, R0, t0, keywords) as numpy."""
    rng = np.random.default_rng(seed)
    th, tr = 0.05, np.array([0.12, -0.08])
    tgt = _room(rng, int(0.9 * m))
    src = ((tgt[:int(0.9 * n)] - tr) @ _rot(th)).astype(np.float32)
    src = src + rng.normal(scale=0.003, size=src.shape).astype(np.float32)
    kw = dict(max_iterations=150, error_threshold=1e-10, normal_k=10)
    method, gated = {"p2p": ("point_to_point", False),
                     "p2l": ("point_to_line", False),
                     "p2p_gated": ("point_to_point", True),
                     "p2l_gated": ("point_to_line", True)}.get(
                         name.split("/")[0], ("point_to_point", True))
    kw.update(method=method, use_gate=gated, max_corr_dist=0.3)
    if name == "abort":             # disjoint clouds: too few inliers
        tgt = tgt + np.float32(50.0)
    if name == "all_masked":
        src = src[:0]
    if name.endswith("/5"):         # a budget of 5 that never converges
        kw.update(max_iterations=5, error_threshold=0.0)
    sp, sm = _padded(src, n)
    tp, tm = _padded(tgt, m)
    return (sp, sm, tp, tm, np.eye(2, dtype=np.float32),
            np.zeros(2, np.float32), kw)


CASES = ["p2p", "p2l", "p2p_gated", "p2l_gated", "p2p/5", "p2l_gated/5",
         "abort", "all_masked"]


def _tensors(case, dev="cpu", **size):
    *arrays, kw = _case(case, **size)
    return [torch.as_tensor(a, device=dev) for a in arrays], kw


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a[:5], b[:5]))


@pytest.mark.parametrize("nn_impl", ["auto", "xla"])
@pytest.mark.parametrize("case", CASES)
def test_factored_body_matches_the_loop_before(case, nn_impl):
    """On the CPU the Python loop of the factored body is the loop as it
    was, bit for bit: R, t, error, iterations and inliers."""
    args, kw = _tensors(case)
    got = I.icp_core(*args, nn_impl=nn_impl, **kw)
    want = _before(*args, nn_impl=nn_impl, **kw)
    assert _equal(got, want), (case, got, want)
    iters = int(got.iters)
    if case in ("abort", "all_masked"):
        assert iters == 1 and torch.isinf(got.error)
    elif case.endswith("/5"):
        assert iters == 5
    else:                           # converged inside a chunk
        assert 1 < iters < 150 and iters % 8, iters


def test_factored_body_matches_in_3d():
    """3-D ICP (the SVD solve, the plain query) keeps the Python loop and
    its result."""
    rng = np.random.default_rng(4)
    tgt = rng.uniform(-2, 2, (200, 3)).astype(np.float32)
    c, s = np.cos(0.05), np.sin(0.05)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    src = ((tgt - [0.05, 0.02, 0.0]) @ R).astype(np.float32)
    m = np.ones(200, bool)
    args = [torch.as_tensor(a) for a in (src, m, tgt, m, np.eye(3, dtype=np.float32),
                                         np.zeros(3, np.float32))]
    kw = dict(max_iterations=30, error_threshold=1e-10)
    assert _equal(I.icp_core(*args, **kw), _before(*args, **kw))


@pytest.mark.parametrize("is_cuda,dim,nn_impl,graph", [
    (False, 2, "auto", False),      # the CPU
    (True, 3, "auto", False),       # 3-D: the SVD may synchronize
    (True, 2, "xla", False),        # the plain query
    (True, 2, "auto", True),        # the card, 2-D, the kernel
    (True, 2, "cuda", True),
])
def test_graph_choice(is_cuda, dim, nn_impl, graph):
    assert I._replays_graphs(is_cuda, dim, nn_impl) is graph


@pytest.mark.parametrize("max_iterations,lengths", [
    (150, [8, 6]), (5, [5]), (16, [8]), (8, [8]), (0, [])])
def test_chunk_lengths(max_iterations, lengths):
    assert I._chunk_lengths(max_iterations) == lengths


@pytest.mark.parametrize("case", ["p2l", "p2p/5", "abort"])
def test_cpu_counts_eager_chunks_only(case):
    """On the CPU every chunk is counted as an eager one, one stop read
    each, and no graph is captured or replayed."""
    args, kw = _tensors(case)
    with spans.record("cpu") as spent:
        res = I.icp_core(*args, **kw)
    counts = spent.record.totals()["counts"]
    chunks = -(-int(res.iters) // 8)
    assert counts["icp.eager_chunks"] == counts["sync.icp.stop"] == chunks
    assert counts["sync.icp.consts"] == 3
    assert not [k for k in counts if k.startswith("icp.graph_")], counts


# ── on the card ──────────────────────────────────────────────────────────

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m gpu)")
    I._graphs.clear()
    yield torch.device("cuda:0")
    I._graphs.clear()


def _eager(monkeypatch, *args, **kw):
    """icp_core under the Python loop on the card."""
    with monkeypatch.context() as mp:
        mp.setattr(I, "_replays_graphs", lambda *a: False)
        return I.icp_core(*args, **kw)


def _counted(dev, *args, **kw):
    """(result, counts, nn_cuda launches) of one icp_core call."""
    before = K.nn_launches
    with spans.record(dev) as spent:
        res = I.icp_core(*args, **kw)
    return res, spent.record.totals()["counts"], K.nn_launches - before


ENGINE_SHAPES = {
    # the engine's scan-to-scan call and its submap call
    "scan2scan 768x768": ("p2l", 768, 768),
    "submap 768x4096": ("p2p_gated", 768, 4096),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(ENGINE_SHAPES) + CASES)
def test_graph_matches_eager_on_card(cuda_device, monkeypatch, case):
    """The graph replays against the Python loop on the card, bit for bit
    in R, t, error, iterations and inliers, with the same nn_cuda launches
    and pairs; the second call captures nothing."""
    name, n, m = ENGINE_SHAPES.get(case, (case, 256, 256))
    args, kw = _tensors(name, cuda_device, n=n, m=m)
    b0 = K.nn_launches
    want = _eager(monkeypatch, *args, **kw)
    torch.cuda.synchronize()
    eager_launches = K.nn_launches - b0
    first, c1, _ = _counted(cuda_device, *args, **kw)
    again, c2, launches = _counted(cuda_device, *args, **kw)
    assert _equal(first, want) and _equal(again, want), (case, first, want)
    lengths = I._chunk_lengths(kw["max_iterations"])
    assert c1["icp.graph_captures"] == len(lengths)
    assert "icp.graph_captures" not in c2
    assert "icp.eager_chunks" not in c2
    assert c2["icp.graph_replays"] == c2["sync.icp.stop"]
    assert "sync.icp.consts" not in c2
    assert launches == eager_launches
    with spans.record(cuda_device) as spent:
        _eager(monkeypatch, *args, **kw)
    ce = spent.record.totals()["counts"]
    assert ce["icp.eager_chunks"] == c2["icp.graph_replays"]
    for k in ("nn.pairs_computed", "nn.pairs_valid"):
        assert ce[k] == c2[k], (k, ce[k], c2[k])


@pytest.mark.gpu
def test_result_survives_a_later_call(cuda_device):
    """A returned ICPResult is the caller's: a later call of the same shape
    with other inputs leaves it as it was."""
    args1, kw = _tensors("p2l", cuda_device, n=768, m=768, seed=1)
    args2, _ = _tensors("p2l", cuda_device, n=768, m=768, seed=2)
    r1 = I.icp_core(*args1, **kw)
    kept = [x.clone() for x in r1[:5]]
    r2 = I.icp_core(*args2, **kw)
    torch.cuda.synchronize()
    assert _equal(r1, kept)
    assert not _equal(r1, r2)
