"""The ordered scatter-sum (ops/scatter.py) and what it carries: the voxel
means and the pose-graph assembly, against CPU ``index_add_`` and icp_tpu.

On the CPU ``ordered_index_add_`` is ``index_add_`` itself (of a plan's
kept rows). What the CUDA kernel computes instead (a stable sort of the
index, then each run of equal slots added one row after another from
``out``'s value) is emulated here in numpy, and held bit for bit against
``index_add_`` at every width and dtype the port uses: once as the
algorithm, and once block by block as ``csrc/segment_add.cu`` walks a
segment plan (its tiles, halo, exits and long-run stages). The kernel
itself is held against ``index_add_`` on the card (the ``gpu`` tests,
``pytest --noconftest -m gpu tests/test_torch_scatter.py``;
``chip_smoke.py`` phase 3).

``voxel_downsample_fixed`` with capacity < N computes icp_tpu's mean, the
cell centre plus the mean deviation from it. icp_tpu takes the deviation
sums as differences of cumulative sums (a TPU workaround that is not
ported); the port adds them in order. Measured on the CPU: the main
path's 40 x 768 -> 4,096 merge agrees with icp_tpu within 4.8e-7 m (the
old raw-coordinate means: 9.5e-7), and a 3-D cut within 9.5e-7 m; the
tolerances are 1e-6 and 2e-6 (both were 1e-5).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from icp_tpu_torch.ops import scatter as S  # noqa: E402
from icp_tpu_torch.ops import voxel as t_voxel  # noqa: E402


def _emulate_kernel(out, index, src, sorted_index=False):
    """icp_segment_add's algorithm in numpy: stable sort (unless sorted),
    then every run adds its rows in order, starting from out's value, each
    add rounded in out's dtype."""
    width = math.prod(out.shape[1:])
    out = out.copy().reshape(out.shape[0], width)
    src = src.reshape(src.shape[0], width)
    if sorted_index:
        sidx, perm = index, np.arange(len(index))
    else:
        perm = np.argsort(index, kind="stable")
        sidx = index[perm]
    n = len(sidx)
    head = np.ones(n, bool)
    head[1:] = sidx[1:] != sidx[:-1]
    # the k-th row of each run, for every run at once, k = 0, 1, ...
    start = np.maximum.accumulate(np.where(head, np.arange(n), 0))
    pos = np.arange(n) - start
    for k in range(int(pos.max()) + 1 if n else 0):
        rows = np.nonzero(pos == k)[0]
        out[sidx[rows]] = out[sidx[rows]] + src[perm[rows]]
    return out


# csrc/segment_add.cu's constants
_THREADS, _STAGE, _HALO = 256, 512, 64


def _emulate_tiles(out, slots, perm, src, n_slots):
    """icp_segment_add as csrc/segment_add.cu walks a plan, block by block:
    slots (N,) non-decreasing (left-out rows n_slots), perm (N,) or None,
    src (N, width). Each block owns 256 // width rows; it exits when its
    first slot is n_slots or when its rows all continue an earlier run;
    each run that starts in it adds its staged rows (the tile and a halo
    of up to 64 rows), and the one run that goes past them goes on a
    stage of 512 values at a time. Adds round in out's dtype."""
    width = math.prod(out.shape[1:])
    out = out.copy().reshape(out.shape[0], width)
    n = len(slots)
    vals = src.reshape(n, width)
    if perm is not None:
        vals = vals[perm]
    sl = lambda r: slots[r] if 0 <= r < n else -1  # noqa: E731
    tile = _THREADS // width
    halo = min(_HALO, (_STAGE - tile * width) // width)
    chunk = _STAGE // width
    for r0 in range(0, n, tile):
        nt, ns = min(tile, n - r0), min(tile + halo, n - r0)
        if sl(r0) >= n_slots or (r0 > 0 and sl(r0 + nt - 1) == sl(r0 - 1)):
            continue                              # the uniform exits
        for i in range(nt):
            slot = sl(r0 + i)
            if not (0 <= slot < n_slots and slot != sl(r0 + i - 1)):
                continue
            acc = out[slot].copy()
            k = i
            while True:                           # staged rows
                acc = acc + vals[r0 + k]
                k += 1
                if not (k < ns and sl(r0 + k) == slot):
                    break
            j = r0 + ns
            going = k == ns and sl(j) == slot
            while going:                          # the long run's stages
                m = min(chunk, n - j)
                k = 0
                while k < m and sl(j + k) == slot:
                    acc = acc + vals[j + k]
                    k += 1
                going = k == m and sl(j + m) == slot
                j += m
            out[slot] = acc
    return out


def _case(rng, n, slots, width, dtype, sort):
    index = rng.integers(0, slots, n)
    if sort:
        index = np.sort(index)
    shape = (width,) if width > 1 else ()
    # magnitudes over six decades: the sum of a slot depends on its order
    src = (rng.normal(size=(n,) + shape)
           * 10.0 ** rng.uniform(-3, 3, (n,) + shape)).astype(dtype)
    out = rng.normal(size=(slots,) + shape).astype(dtype)
    return out, index, src


def _keep(rng, mode, n):
    """The rows a plan keeps: all ("plan"), about 70 % ("plan_kept"), none
    ("plan_none"); None for a call without a plan."""
    return {"sorted": None, "unsorted": None, "plan": np.ones(n, bool),
            "plan_kept": rng.random(n) < 0.7,
            "plan_none": np.zeros(n, bool)}[mode]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("width", [1, 2, 3, 4, 9])
@pytest.mark.parametrize("sort", ["sorted", "unsorted", "plan", "plan_kept",
                                  "plan_none"])
def test_ordered_index_add_matches_index_add(width, dtype, sort):
    """The plain version is index_add_ (bit for bit, a non-zero out), of a
    plan's kept rows; the kernel, emulated as the algorithm and block by
    block on the plan the card would build, gives the same bits. Where the
    left-out rows hold +-0, the kept rows give index_add_'s bits of every
    row."""
    rng = np.random.default_rng(width + 10 * (sort == "sorted"))
    before = S.segment_add_launches
    out, index, src = _case(rng, 5000, 300, width, dtype, sort == "sorted")
    keep = _keep(rng, sort, len(index))
    ti, ts = torch.as_tensor(index), torch.as_tensor(src)
    if keep is None:
        rows = np.arange(len(index))
        got = S.ordered_index_add_(torch.tensor(out), ti, ts,
                                   sorted_index=sort == "sorted")
    else:
        rows = np.nonzero(keep)[0]
        tk = torch.as_tensor(keep)
        got = S.ordered_index_add_(torch.tensor(out),
                                   S.segment_plan(ti, 300, keep=tk), ts)
    want = torch.tensor(out).index_add_(0, ti[rows], ts[rows])
    assert torch.equal(got, want)
    emu = _emulate_kernel(out, index[rows], src[rows],
                          sorted_index=sort == "sorted")
    np.testing.assert_array_equal(emu.reshape(want.shape), want.numpy())
    if sort == "sorted":
        slots, perm = index, None
    else:
        slots, perm = (x.numpy() for x in S._plan_order(
            ti, 300, None if keep is None else torch.as_tensor(keep)))
    np.testing.assert_array_equal(
        _emulate_tiles(out, slots, perm, src, 300).reshape(want.shape),
        want.numpy())
    if keep is not None:
        # left-out rows of +-0 change no bit of index_add_ over every row
        zeroed = np.where(keep.reshape((-1,) + (1,) * (src.ndim - 1)), src,
                          np.copysign(0.0, rng.normal(size=src.shape))
                          .astype(dtype))
        every = torch.tensor(out).index_add_(0, ti, torch.as_tensor(zeroed))
        plan = S.segment_plan(ti, 300, keep=torch.as_tensor(keep))
        assert torch.equal(S.ordered_index_add_(
            torch.tensor(out), plan, torch.as_tensor(zeroed)), every)
    assert S.segment_add_launches == before     # the CPU launches nothing


@pytest.mark.parametrize("case", ["empty", "one_run", "one_row"])
def test_ordered_index_add_edge_cases(case):
    """No rows, every row in one slot, one row: as index_add_."""
    rng = np.random.default_rng(1)
    n = {"empty": 0, "one_run": 4000, "one_row": 1}[case]
    out = rng.normal(size=(16, 3)).astype(np.float32)
    index = np.full(n, 7, np.int64)
    src = rng.normal(size=(n, 3)).astype(np.float32)
    want = torch.tensor(out).index_add_(0, torch.as_tensor(index),
                                           torch.as_tensor(src))
    got = S.ordered_index_add_(torch.tensor(out), torch.as_tensor(index),
                               torch.as_tensor(src))
    assert torch.equal(got, want)
    np.testing.assert_array_equal(_emulate_kernel(out, index, src),
                                  want.numpy())
    np.testing.assert_array_equal(_emulate_tiles(out, index, None, src, 16),
                                  want.numpy())


@pytest.mark.parametrize("width", [1, 3, 9])
def test_long_runs_emulated_block_by_block(width):
    """Runs of ~300-1,200 rows (a hub node's), longer than a block's tile,
    its halo and a stage: the blocks' walk gives index_add_'s bits, f32
    and f64."""
    rng = np.random.default_rng(20 + width)
    for dtype in (np.float32, np.float64):
        out, index, src = _case(rng, 6000, 12, width, dtype, False)
        index[:1200] = 5                          # one run of 1,200 rows
        ti = torch.as_tensor(index)
        want = torch.tensor(out).index_add_(0, ti, torch.as_tensor(src))
        slots, perm = (x.numpy() for x in S._plan_order(ti, 12))
        np.testing.assert_array_equal(
            _emulate_tiles(out, slots, perm, src, 12).reshape(want.shape),
            want.numpy())


def test_concatenated_call_equals_calls_in_sequence():
    """Several index_add_ calls into one buffer are one ordered call with
    the indices and values concatenated in call order (how the pose graph
    adds its four H blocks and its ei / ej halves): the same bits."""
    rng = np.random.default_rng(2)
    parts = [_case(rng, 700, 50, 9, np.float32, False)[1:] for _ in range(4)]
    seq = torch.zeros((50, 9))
    for index, src in parts:
        seq.index_add_(0, torch.as_tensor(index), torch.as_tensor(src))
    cat_i = np.concatenate([p[0] for p in parts])
    cat_s = np.concatenate([p[1] for p in parts])
    one = S.ordered_index_add_(torch.zeros((50, 9)), torch.as_tensor(cat_i),
                               torch.as_tensor(cat_s))
    assert torch.equal(one, seq)
    np.testing.assert_array_equal(
        _emulate_kernel(np.zeros((50, 9), np.float32), cat_i, cat_s),
        seq.numpy())


def test_kernel_libraries_hash_every_source():
    """One library a CUDA source, each named by a hash of its source and
    the flags; nothing builds at import."""
    from icp_tpu_torch.ops.hopper import build

    assert set(build.SOURCES) == {"nn", "segment_add"}
    names = set()
    for name, src in build.SOURCES.items():
        assert src.exists() and src.suffix == ".cu"
        p = build._library_path(name)
        assert p.parent == build.BUILD_DIR
        assert p.name.startswith(f"libicp_{name}_")
        names.add(p.name)
    assert len(names) == len(build.SOURCES)
    assert "icp_segment_add" in build.SOURCES["segment_add"].read_text()
    assert build._libs == {} or "segment_add" not in build._libs


# ── voxel means ──────────────────────────────────────────────────────────
def _ring(rng, k=40, cap=768, valid=0.8):
    """A submap ring as the main path merges it: k scans of cap slots of a
    room-sized cloud, some slots masked."""
    pts, mask = [], []
    for s in range(k):
        ang = rng.uniform(-np.pi, np.pi, cap)
        r = rng.uniform(2.0, 12.0, cap)
        pts.append(np.stack([r * np.cos(ang) + 0.02 * s, r * np.sin(ang)],
                            1).astype(np.float32))
        mask.append(rng.random(cap) < valid)
    return np.concatenate(pts), np.concatenate(mask)


def _both(pts, mask, v, cap):
    # JAX on the CPU only here: the gpu tests below run without it
    import jax.numpy as jnp

    from icp_tpu.ops import voxel as j_voxel

    o_t, m_t = t_voxel.voxel_downsample_fixed(torch.as_tensor(pts),
                                              torch.as_tensor(mask), v, cap)
    o_j, m_j = j_voxel.voxel_downsample_fixed(jnp.asarray(pts),
                                              jnp.asarray(mask), v, cap)
    return o_t.numpy(), m_t.numpy(), np.asarray(o_j), np.asarray(m_j)


def _f64_means(pts, mask, v, k):
    """The first k voxels' means in float64, the points grouped as the
    port groups them."""
    _, _, _, sp, sm, slot = t_voxel._sorted_runs(torch.as_tensor(pts),
                                                 torch.as_tensor(mask), v)
    sp, sm, slot = sp.numpy().astype(np.float64), sm.numpy(), slot.numpy()
    sums = np.zeros((k, sp.shape[1]))
    keep = sm & (slot < k)
    np.add.at(sums, slot[keep], sp[keep])
    return sums / np.bincount(slot[keep], minlength=k)[:, None]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fixed_voxel_main_path_shape_matches_icp_tpu(seed):
    """The main path's submap merge, 40 x 768 rows into 4,096 slots at the
    submap voxel (0.05 m): the same slots, means within 1e-6 m of
    icp_tpu's, and no farther from the float64 means than icp_tpu's."""
    rng = np.random.default_rng(seed)
    pts, mask = _ring(rng)
    o_t, m_t, o_j, m_j = _both(pts, mask, 0.05, 4096)
    assert o_t.shape == (4096, 2)
    np.testing.assert_array_equal(m_t, m_j)
    np.testing.assert_allclose(o_t[m_j], o_j[m_j], atol=1e-6, rtol=0)
    exact = _f64_means(pts, mask, 0.05, int(m_j.sum()))
    assert np.abs(o_t[m_j] - exact).max() <= np.abs(o_j[m_j] - exact).max()


def test_fixed_voxel_3d_matches_icp_tpu():
    """A 3-D cut (2,000 rows into 1,000 slots at 0.4 m): means within
    2e-6 m of icp_tpu's."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(-3, 3, (2000, 3)).astype(np.float32)
    mask = rng.random(2000) < 0.9
    o_t, m_t, o_j, m_j = _both(pts, mask, 0.4, 1000)
    np.testing.assert_array_equal(m_t, m_j)
    assert m_j.any()
    np.testing.assert_allclose(o_t[m_j], o_j[m_j], atol=2e-6, rtol=0)


def test_voxel_means_are_ordered_sums():
    """voxel_downsample's sums are those of index_add_ over the sorted
    rows (the CPU path is unchanged bit for bit), counts exact."""
    rng = np.random.default_rng(4)
    pts, mask = _ring(rng, k=4)
    out, om = t_voxel.voxel_downsample(torch.as_tensor(pts),
                                       torch.as_tensor(mask), 0.05)
    _, _, _, sp, sm, slot = t_voxel._sorted_runs(torch.as_tensor(pts),
                                                 torch.as_tensor(mask), 0.05)
    n = pts.shape[0]
    sums = torch.zeros(n + 1, 2).index_add_(
        0, torch.where(sm, slot, n), torch.where(sm[:, None], sp, 0.0))[:n]
    counts = torch.zeros(n + 1).index_add_(0, torch.where(sm, slot, n),
                                           sm.float())[:n]
    assert torch.equal(om, counts > 0)
    k = int(om.sum())
    assert torch.equal(out[:k], (sums / counts.clamp(min=1)[:, None])[:k])
    assert math.isclose(float(counts.sum()), float(mask.sum()))


# ── on the card ──────────────────────────────────────────────────────────
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m gpu)")
    return torch.device("cuda:0")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(30720, 4096, 3), (768, 768, 3),
                                   (131072, 8192, 3), (40000, 9437184, 1),
                                   (2200, 1024, 9), (4000, 16, 3), (0, 16, 3)])
def test_segment_add_kernel_on_the_card(cuda_device, shape):
    """icp_segment_add against CPU index_add_, bit for bit, sorted and
    unsorted, f32 and f64, one launch a call (none for no rows)."""
    n, slots, width = shape
    rng = np.random.default_rng(n)
    for dtype in (np.float32, np.float64):
        for sort in (True, False):
            out, index, src = _case(rng, n, slots, width, dtype, sort)
            want = torch.tensor(out).index_add_(
                0, torch.as_tensor(index), torch.as_tensor(src))
            before = S.segment_add_launches
            got = S.ordered_index_add_(
                torch.as_tensor(out, device=cuda_device),
                torch.as_tensor(index, device=cuda_device),
                torch.as_tensor(src, device=cuda_device), sorted_index=sort)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want), (shape, dtype, sort)
            assert S.segment_add_launches == before + (n > 0)


def _graph_adds(hub: bool = False):
    """The ordered scatter-sums of one dense GN iteration and one PCG step
    on a 1,024-node chain with a closure every 16 nodes (1,087 edges in
    2,048 slots), recorded on the CPU: [(label, out before, plan, src)].
    ``hub``: node 512 also gets 252 closures, 256 real edges in all."""
    from icp_tpu_torch.models import pose_graph as PG
    from icp_tpu_torch.parallel import dist_pose_graph as DP

    rng = np.random.default_rng(5)
    n = 1024
    pg = PG.PoseGraph2D("cpu")
    for k in range(n):
        a = 2 * np.pi * k / n
        pg.add_node([5 * np.cos(a), 5 * np.sin(a), a] + rng.normal(
            scale=0.05, size=3))
    pairs = [(k - 1, k) for k in range(1, n)]
    pairs += [(i, (i + 16) % n) for i in range(0, n, 16)]
    if hub:
        pairs += [(512, j) for j in range(0, n, 4) if j not in (508, 512, 516)
                  ][:252]
    for i, j in pairs:
        pg.add_edge(i, j, rng.normal(scale=0.1, size=3), np.eye(3) * 50.0)
    g = pg._packed_device()
    calls, real = [], S.ordered_index_add_

    def rec(out, index, src, **kw):
        calls.append((out.clone(), index, src.clone()))
        return real(out, index, src, **kw)

    PG.ordered_index_add_ = DP.ordered_index_add_ = rec
    try:
        PG.optimize_dense(*g[:7], 0, n_iterations=1, convergence_eps=0.0)
        DP.gn_step_cg(*g[:7], 0, cg_iters=1)
    finally:
        PG.ordered_index_add_ = DP.ordered_index_add_ = real
    labels = ["H (width 1)", "b (width 1)", "PCG b (width 3)",
              "PCG blocks (width 9)", "PCG Hx (width 3)"]
    return [(lab, *c) for lab, c in zip(labels, calls)]


@pytest.mark.gpu
@pytest.mark.parametrize("hub", [False, True], ids=["chain", "hub"])
def test_segment_add_plans_on_the_card(cuda_device, hub):
    """The pose graph's adds through plans built on the card, padded edges
    left out: bit-equal to CPU index_add_ of every row, f32 and f64, one
    launch a call; the hub's 256-edge runs take the long-run stages."""
    for label, out, plan, src in _graph_adds(hub):
        assert plan.keep is not None and not bool(plan.keep.all()), label
        for dt in (torch.float32, torch.float64):
            o, x = out.to(dt), src.to(dt)
            want = o.clone().index_add_(0, plan.index, x)
            dplan = S.segment_plan(plan.index.to(cuda_device), plan.n_slots,
                                   keep=plan.keep.to(cuda_device))
            before = S.segment_add_launches
            got = S.ordered_index_add_(o.to(cuda_device), dplan,
                                       x.to(cuda_device))
            torch.cuda.synchronize()
            assert S.segment_add_launches == before + 1
            assert torch.equal(got.cpu(), want), (label, dt, hub)


@pytest.mark.gpu
def test_optimize_dense_repeats_on_the_card(cuda_device):
    """optimize_dense (10 iterations) on the 1,024-node chain twice on the
    card: bit-equal, 2 plan builds a solve."""
    from icp_tpu_torch.models import pose_graph as PG

    pg = PG.PoseGraph2D(cuda_device)
    for k in range(1024):
        a = 2 * np.pi * k / 1024
        pg.add_node([5 * np.cos(a), 5 * np.sin(a), a + 0.01 * (k % 7)])
    for k in range(1, 1024):
        pg.add_edge(k - 1, k, [2 * np.pi * 5 / 1024, 0.0, 2 * np.pi / 1024])
    for i in range(0, 1024, 16):
        pg.add_edge(i, (i + 16) % 1024, [0.0, 0.0, 0.0], np.eye(3) * 50.0)
    g = pg._packed_device()
    runs = []
    for _ in range(2):
        builds = S.segment_plan_builds
        out, it = PG.optimize_dense(*g[:7], 0, n_iterations=10,
                                    convergence_eps=0.0)
        assert S.segment_plan_builds == builds + 2 and it == 10
        runs.append(out.cpu())
    assert torch.equal(runs[0], runs[1])


@pytest.mark.gpu
def test_main_path_repeats_on_the_card(cuda_device, tmp_path):
    """A 30-scan main-path run (bench.py's configuration) twice on the
    card: bit-equal trajectories and maps."""
    from icp_tpu_torch.engine import SlamEngine, filter_and_flatten
    from icp_tpu_torch.services.imu import IMUService
    from icp_tpu_torch.services.lidar import LidarService
    from icp_tpu_torch.utils.config import SlamConfig
    from icp_tpu_torch.utils.synth import generate_sequence

    lidar_f, imu_f = str(tmp_path / "l.csv"), str(tmp_path / "i.csv")
    generate_sequence(lidar_f, imu_f, n_scans=31, n_beams=720, noise=0.005,
                      trajectory="loop", seed=42)
    scans, rels = [], []
    for _, rel, raw in LidarService(lidar_f).scans():
        scans.append(filter_and_flatten(raw, 0.5, 2.0))
        rels.append(rel)
    cfg = SlamConfig.from_dict({
        "imu": {"enabled": True, "narrow_search_range": 3.0},
        "icp": {"method": "point_to_line", "normal_k": 16, "voxel_size": 0.04,
                "error_threshold": 1e-10, "max_iterations": 150},
        "submap": {"enabled": True, "size": 40, "voxel_size": 0.05},
        "loop_closure": {"enabled": False},
        "mapping": {"resolution": 0.05, "margin": 50.0},
        "tpu": {"scan_capacity": 768, "submap_capacity": 4096,
                "max_ray_cells": 448, "batch_scans": 16,
                "distributed": False}})
    runs = []
    for _ in range(2):
        eng = SlamEngine(cfg, imu=IMUService(imu_f), verbose=False,
                         device=cuda_device)
        eng.process_scan(scans[0], rels[0])
        for k in range(1, len(scans), 16):
            eng.process_scans_batched(scans[k:k + 16], rels[k:k + 16])
        eng.finish()
        eng.sync_map()
        runs.append((np.stack(eng.pose_trajectory),
                     eng.mapper.log_odds.cpu().numpy()))
    assert S.segment_add_launches > 0
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
