"""icp_tpu_torch's device mesh (parallel/) against icp_tpu's on the CPU.

icp_tpu runs on the 8 virtual CPU devices of tests/conftest.py; the port on
8 virtual CPU shards (``set_virtual_devices(8, "cpu")`` in the ``mesh8``
fixture, which clears it again). The same seeded numpy inputs go through
both, at tests/test_multichip.py's sizes. Tolerances: the port's psum sums
in shard order and XLA in its own, so sharded results agree to f32
rounding; ``partition_graph`` and the one-device sharded sweep are exact.
The ``gpu`` tests hold both kernels against their plain versions on the
last visible card (they skip with fewer than 2 cards) and the sharded
functions on one card's virtual mesh
(``python -m pytest --noconftest -m gpu tests/test_torch_mesh.py``).
"""
import functools
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from icp_tpu_torch.parallel import dist_pose_graph as TD  # noqa: E402
from icp_tpu_torch.parallel import sharded_grid as TG  # noqa: E402
from icp_tpu_torch.parallel.mesh import (Mesh, make_mesh,  # noqa: E402
                                         set_virtual_devices,
                                         visible_devices)
from icp_tpu_torch.parallel.sweep_shard import sweep_scores_sharded  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID_ARGS = (0.85, -0.4, -8.0, 8.0)


@pytest.fixture
def mesh8():
    set_virtual_devices(8, "cpu")
    try:
        yield make_mesh(8, device="cpu")
    finally:
        set_virtual_devices(0, "cpu")


def _jmesh(n=8):
    from icp_tpu.parallel.mesh import make_mesh as jmake
    return jmake(n)


def _jit(fn, *args, **static):
    """icp_tpu's sharded function under jit (eager shard_map runs op by op,
    tens of seconds on the CPU); the mesh and keywords are static."""
    return jax.jit(functools.partial(fn, **static))(*args)


def _t(a, dt=None):
    return torch.as_tensor(np.array(a), dtype=dt)


def _graph(rng, n_nodes=12, per_dev=3, n_dev=8):
    """tests/test_multichip.py's chain graph (numpy)."""
    n_edges = per_dev * n_dev
    nodes = np.cumsum(rng.normal(scale=0.2, size=(n_nodes, 3)),
                      0).astype(np.float32)
    ei = (np.arange(n_edges) % (n_nodes - 1)).astype(np.int32)
    z = rng.normal(scale=0.1, size=(n_edges, 3)).astype(np.float32)
    om = np.broadcast_to(np.eye(3, dtype=np.float32), (n_edges, 3, 3)).copy()
    return (nodes, np.ones(n_nodes, bool), ei, ei + 1, z, om,
            np.ones(n_edges, bool))


def _closure_graph():
    """test_gn_schur_matches_dense_single_step's 40-node graph: a chain,
    3 loop closures across chunks, 2 masked edges."""
    rng = np.random.default_rng(5)
    n = 40
    ei = np.array(list(range(n - 1)) + [2, 11, 5] + [0, 0], np.int32)
    ej = np.array(list(range(1, n)) + [31, 38, 22] + [1, 2], np.int32)
    E = len(ei)
    nodes = np.cumsum(rng.normal(scale=0.2, size=(n, 3)), 0).astype(np.float32)
    z = rng.normal(scale=0.1, size=(E, 3)).astype(np.float32)
    om = rng.normal(size=(E, 3, 3)).astype(np.float32)
    om = om @ om.transpose(0, 2, 1) + 3 * np.eye(3, dtype=np.float32)
    em = np.array([True] * (E - 2) + [False, False])
    return nodes, np.ones(n, bool), ei, ej, z, om, em


def _torch_graph(g):
    nodes, nm, ei, ej, z, om, em = g
    return (_t(nodes), _t(nm), _t(ei, torch.int64), _t(ej, torch.int64),
            _t(z), _t(om), _t(em))


def _jax_graph(g):
    return tuple(jnp.asarray(a) for a in g)


# ── the mesh itself ──────────────────────────────────────────────────────

def test_virtual_devices_and_mesh_helpers(mesh8):
    assert visible_devices("cpu") == [torch.device("cpu")] * 8
    assert mesh8.size == 8 and mesh8.local_size == 8 and mesh8.group is None
    x = torch.arange(16.0).reshape(8, 2)
    parts = mesh8.split(x)
    assert [p.tolist() for p in parts] == [[r] for r in x.tolist()]
    assert mesh8.axis_index(3) == 3
    torch.testing.assert_close(mesh8.all_gather(parts), x, rtol=0, atol=0)
    s = mesh8.psum([p.sum() for p in parts])
    assert len(s) == 8 and all(float(v) == float(x.sum()) for v in s)
    with pytest.raises(ValueError, match="multiple"):
        mesh8.split(torch.zeros(12))
    with pytest.raises(RuntimeError, match="needs 16"):
        make_mesh(16, device="cpu")


def test_virtual_devices_cleared():
    assert visible_devices("cpu") == [torch.device("cpu")]
    assert make_mesh(device="cpu").size == 1


# ── sweep ────────────────────────────────────────────────────────────────

def test_sweep_sharded_matches_icp_tpu_and_unsharded(mesh8):
    from icp_tpu.parallel.sweep_shard import sweep_scores_sharded as jsweep
    from icp_tpu_torch.ops.sweep import sweep_scores

    rng = np.random.default_rng(0)
    src = rng.uniform(-3, 3, (64, 2)).astype(np.float32)
    tgt = rng.uniform(-3, 3, (64, 2)).astype(np.float32)
    m = np.ones(64, bool)
    angles = np.linspace(-np.pi, np.pi, 32).astype(np.float32)
    toff = np.zeros(2, np.float32)
    got = sweep_scores_sharded(mesh8, _t(src), _t(m), _t(tgt), _t(m),
                               _t(angles), _t(toff), chunk=4)
    want = jsweep(_jmesh(), *(jnp.asarray(a) for a in
                              (src, m, tgt, m, angles, toff)), chunk=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    one = sweep_scores(_t(src), _t(m), _t(tgt), _t(m), _t(angles), _t(toff))
    assert torch.equal(got, one)


# ── grids ────────────────────────────────────────────────────────────────

def test_raytrace_sharded_matches_icp_tpu(mesh8):
    from icp_tpu.parallel.sharded_grid import raytrace_update_sharded as jray

    rng = np.random.default_rng(3)
    origin = np.array([20, 20], np.int32)
    hits = rng.integers(0, 40, (32, 2)).astype(np.int32)
    ok = np.ones(32, bool)
    got = TG.raytrace_update_sharded(
        mesh8, torch.zeros((40, 40)), _t(origin, torch.int64),
        _t(hits, torch.int64), _t(ok), *GRID_ARGS, max_steps=64)
    want = _jit(functools.partial(jray, _jmesh()),
                jnp.zeros((40, 40), jnp.float32), jnp.asarray(origin),
                jnp.asarray(hits), jnp.asarray(ok),
                *(jnp.float32(a) for a in GRID_ARGS), max_steps=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _block_inputs():
    rng = np.random.default_rng(4)
    grid = rng.normal(0, 0.5, (64, 40)).astype(np.float32)   # 8 blocks of 8
    origin = np.array([17, 33], np.int32)
    # out-of-grid endpoints included: the drop path is part of the parity
    hits = rng.integers(-8, 72, (48, 2)).astype(np.int32)
    ok = rng.random(48) > 0.1
    return rng, grid, origin, hits, ok


def test_raytrace_block_sharded_matches_icp_tpu(mesh8):
    from icp_tpu.parallel.sharded_grid import (block_sharding as jblock,
                                               raytrace_update_block_sharded
                                               as jupdate)
    _, grid, origin, hits, ok = _block_inputs()
    jm = _jmesh()
    want = np.asarray(_jit(
        functools.partial(jupdate, jm),
        jax.device_put(jnp.asarray(grid), jblock(jm)),
        jnp.asarray(origin), jnp.asarray(hits), jnp.asarray(ok),
        *(jnp.float32(a) for a in GRID_ARGS), max_steps=96))
    for cap in (None, 512, 8):           # icp_tpu's dedup caps: accepted
        blocks = TG.block_sharding(mesh8, _t(grid))
        out = TG.raytrace_update_block_sharded(
            mesh8, blocks, _t(origin, torch.int64), _t(hits, torch.int64),
            _t(ok), *GRID_ARGS, max_steps=96, free_unique_cap=cap)
        assert out is blocks and len(out) == 8
        assert all(b.shape == (8, 40) for b in out)
        np.testing.assert_allclose(mesh8.all_gather(out).numpy(), want,
                                   atol=1e-4)


def test_raytrace_replay_block_sharded_matches_icp_tpu(mesh8):
    from icp_tpu.parallel.sharded_grid import (block_sharding as jblock,
                                               raytrace_replay_block_sharded
                                               as jreplay)
    rng, grid, _, _, _ = _block_inputs()
    B = 4
    origins = rng.integers(5, 35, (B, 2)).astype(np.int32)
    hits = rng.integers(-8, 72, (B, 48, 2)).astype(np.int32)
    ok = rng.random((B, 48)) > 0.1
    jm = _jmesh()
    want = np.asarray(_jit(
        functools.partial(jreplay, jm, ray_cells=jnp.asarray(hits[:, ::2]),
                          ray_valid=jnp.asarray(ok[:, ::2])),
        jax.device_put(jnp.asarray(grid), jblock(jm)),
        jnp.asarray(origins), jnp.asarray(hits), jnp.asarray(ok),
        *(jnp.float32(a) for a in GRID_ARGS), max_steps=96))
    blocks = TG.raytrace_replay_block_sharded(
        mesh8, TG.block_sharding(mesh8, _t(grid)), _t(origins, torch.int64),
        _t(hits, torch.int64), _t(ok), *GRID_ARGS, max_steps=96,
        ray_cells=_t(hits[:, ::2], torch.int64), ray_valid=_t(ok[:, ::2]),
        free_unique_cap=512, hit_unique_cap=512)
    np.testing.assert_allclose(mesh8.all_gather(blocks).numpy(), want,
                               atol=1e-4)


# ── pose graph ───────────────────────────────────────────────────────────

def test_partition_graph_equals_icp_tpu():
    from icp_tpu.parallel.dist_pose_graph import (partition_graph as jpart,
                                                  schur_within_limits as jok)
    nodes, nm, ei, ej, z, om, em = _closure_graph()
    rb = np.zeros(len(ei), bool)
    rb[-5:-2] = True
    for n_dev in (1, 3, 8):
        got = TD.partition_graph(40, ei, ej, z, om, em, n_dev, 0, robust=rb)
        want = jpart(40, ei, ej, z, om, em, n_dev, 0, robust=rb)
        assert got._fields == want._fields
        for f, a, b in zip(got._fields, got, want):
            np.testing.assert_array_equal(a, b, err_msg=f)
            assert np.asarray(a).dtype == np.asarray(b).dtype, f
        assert got.sep_ids.size < 40 or n_dev == 1
        for kw in (dict(max_separators=2000, cg_node_threshold=2000,
                        dense_budget=1 << 30),
                   dict(max_separators=2, cg_node_threshold=2000,
                        dense_budget=1 << 30),
                   dict(max_separators=2000, cg_node_threshold=4,
                        dense_budget=1 << 30),
                   dict(max_separators=2000, cg_node_threshold=2000,
                        dense_budget=1000)):
            assert TD.schur_within_limits(got, **kw) == jok(want, **kw), kw


def test_gn_steps_match_icp_tpu(mesh8):
    from icp_tpu.parallel import dist_pose_graph as JD

    jm = _jmesh()
    g = _graph(np.random.default_rng(1))
    got = TD.gn_step_sharded(mesh8, *_torch_graph(g), 0)
    want = _jit(functools.partial(JD.gn_step_sharded, jm), *_jax_graph(g),
                jnp.int32(0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)

    g = _graph(np.random.default_rng(2))
    rb = np.zeros(24, bool)
    rb[::5] = True
    got = TD.gn_step_cg_sharded(mesh8, *_torch_graph(g), 0, _t(rb), 0.5,
                                0.1, cg_iters=20)
    want = JD._cg_step_cached(jm, *_jax_graph(g), jnp.int32(0),
                              jnp.asarray(rb), jnp.float32(0.5),
                              jnp.float32(0.1), cg_iters=20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    # the one-shard case is gn_step_cg
    one = TD.gn_step_cg(*_torch_graph(g), 0, _t(rb), 0.5, 0.1, cg_iters=20)
    np.testing.assert_allclose(got.numpy(), one.numpy(), atol=1e-5)

    g = _closure_graph()
    part = TD.partition_graph(40, *g[2:], 8, fix_node=0)
    jpart = JD.partition_graph(40, *g[2:], 8, fix_node=0)
    for rphi, damp in ((1.0, 0.0), (0.5, 0.01)):
        got = TD.gn_step_schur_sharded(mesh8, _t(g[0]), _t(g[1]), part,
                                       rphi, damp)
        want = JD._schur_step_cached(jm, jnp.asarray(g[0]),
                                     jnp.asarray(g[1]), jpart,
                                     jnp.float32(rphi), jnp.float32(damp))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)


def test_optimize_schur_and_cg_match_icp_tpu(mesh8):
    from icp_tpu.parallel import dist_pose_graph as JD

    jm = _jmesh()
    g = _graph(np.random.default_rng(6), n_nodes=24, per_dev=4)
    part = TD.partition_graph(24, *g[2:], 8, fix_node=0)
    got, it_t = TD.optimize_schur(mesh8, _t(g[0]), _t(g[1]), part,
                                  n_iterations=20)
    want, it_j = JD.optimize_schur(jm, jnp.asarray(g[0]), jnp.asarray(g[1]),
                                   JD.partition_graph(24, *g[2:], 8,
                                                      fix_node=0),
                                   n_iterations=20)
    assert it_t == it_j
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)

    # 30 edges: padded to a mesh multiple inside optimize_cg
    g = _graph(np.random.default_rng(7), n_nodes=16, per_dev=1, n_dev=30)
    got, it_t = TD.optimize_cg(mesh8, *_torch_graph(g), 0, n_iterations=5,
                               cg_iters=30)
    want, it_j = JD.optimize_cg(jm, jnp.asarray(g[0]), jnp.asarray(g[1]),
                                *g[2:], 0, n_iterations=5, cg_iters=30)
    assert it_t == it_j
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def _chain(PG, n=40, **kw):
    """A noisy circular chain with three closures (tests/test_pose_graph.py's
    shape) in a PoseGraph2D of either package."""
    rng = np.random.default_rng(1)
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    true = np.stack([np.cos(ang) * 5, np.sin(ang) * 5,
                     (ang + np.pi / 2 + np.pi) % (2 * np.pi) - np.pi], 1)

    def rel(a, b):
        ca, sa = np.cos(a[2]), np.sin(a[2])
        d = b[:2] - a[:2]
        return np.array([ca * d[0] + sa * d[1], -sa * d[0] + ca * d[1],
                         (b[2] - a[2] + np.pi) % (2 * np.pi) - np.pi])
    pg = PG(**kw)
    for k in range(n):
        noise = rng.normal(scale=0.05, size=3) * [1, 1, 0.2] if k else 0
        pg.add_node(true[k] + noise)
    for k in range(1, n):
        pg.add_edge(k - 1, k, rel(true[k - 1], true[k]))
    for i, j in ((0, n // 2), (4, 25), (9, 33)):
        pg.add_edge(i, j, rel(true[i], true[j]), np.eye(3) * 50.0,
                    robust=(i == 4))
    return pg


@pytest.mark.parametrize("strategy", ["schur", "dist_cg"])
def test_pose_graph_on_mesh_matches_icp_tpu(mesh8, strategy):
    from icp_tpu.models.pose_graph import PoseGraph2D as JPG
    from icp_tpu_torch.models.pose_graph import PoseGraph2D as TPG

    gj, gt = _chain(JPG), _chain(TPG, device="cpu")
    gj.set_mesh(_jmesh(), 2)
    gt.set_mesh(mesh8, 2)
    if strategy == "dist_cg":
        gj._max_separators = gt._max_separators = 2
    gj.optimize(n_iterations=10)
    gt.optimize(n_iterations=10)
    assert gt.last_strategy == gj.last_strategy == strategy
    np.testing.assert_allclose(np.stack(gt.nodes), np.stack(gj.nodes),
                               atol=1e-4)


def test_pose_graph_one_shard_mesh_keeps_dense():
    from icp_tpu_torch.models.pose_graph import PoseGraph2D as TPG

    ref, gt = _chain(TPG, device="cpu"), _chain(TPG, device="cpu")
    gt.set_mesh(Mesh(("cpu",)), 2)
    ref.optimize(n_iterations=5)
    gt.optimize(n_iterations=5)
    assert gt.last_strategy == ref.last_strategy == "dense"
    np.testing.assert_array_equal(np.stack(gt.nodes), np.stack(ref.nodes))


# ── two processes (gloo) ─────────────────────────────────────────────────

WORKER = r"""
import os, sys
import numpy as np
import torch
from icp_tpu_torch.parallel.mesh import init_distributed, make_mesh
from icp_tpu_torch.parallel.dist_pose_graph import gn_step_sharded

pid = int(os.environ["PID_"])
assert init_distributed(os.environ["COORD"], 2, pid, backend="gloo")
mesh = make_mesh(device="cpu")
assert mesh.size == 2 and mesh.local_size == 1, mesh
# psum over both processes' local [0..7] and [100..107]
local = torch.arange(8.0) + 100.0 * pid
print("PSUM_RESULT", float(mesh.psum([local.sum()])[0]), flush=True)
# process 0's values on both, dtypes and shapes kept
b = mesh.broadcast([torch.full((2, 2), 1.5 + pid), torch.tensor(pid == 0),
                    torch.tensor([70000 + pid], dtype=torch.int32)])
print("BCAST", b[0].tolist(), bool(b[1]), b[2].dtype, b[2].tolist(), flush=True)
# a 16-node chain and one loop edge, edges split one half a process
rng = np.random.default_rng(7)
n = 16
nodes = np.cumsum(rng.normal(scale=0.1, size=(n, 3)), 0).astype(np.float32)
ei = np.concatenate([np.arange(n - 1), [n - 1]])
ej = np.concatenate([np.arange(1, n), [0]])
z = rng.normal(scale=0.05, size=(n, 3)).astype(np.float32)
om = np.broadcast_to(np.eye(3, dtype=np.float32), (n, 3, 3)).copy()
t = torch.as_tensor
out = gn_step_sharded(mesh, t(nodes), torch.ones(n, dtype=torch.bool),
                      t(ei), t(ej), t(z), t(om),
                      torch.ones(n, dtype=torch.bool), 0)
np.save(os.environ["OUT"], out.numpy())
print("GN_DONE", flush=True)
torch.distributed.destroy_process_group()
"""


def _launch(tmp_path, script):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    path = tmp_path / "worker.py"
    path.write_text(script)
    procs = []
    for pid in (0, 1):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("JAX_") and k != "XLA_FLAGS"}
        env.update({"PYTHONPATH": REPO, "COORD": f"127.0.0.1:{port}",
                    "PID_": str(pid), "OUT": str(tmp_path / f"out{pid}.npy"),
                    "OMP_NUM_THREADS": "1"})
        procs.append(subprocess.Popen(
            [sys.executable, str(path)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-1500:]
    return [o for o, _ in outs]


def test_two_process_psum_broadcast_and_gn_step(tmp_path):
    from icp_tpu.parallel.dist_pose_graph import gn_step_sharded as jstep

    outs = _launch(tmp_path, WORKER)
    want_psum = sum(range(8)) * 2 + 100.0 * 8
    for so in outs:
        assert f"PSUM_RESULT {want_psum}" in so, so
        assert ("BCAST [[1.5, 1.5], [1.5, 1.5]] True torch.int32 [70000]"
                in so), so
        assert "GN_DONE" in so, so
    a, b = (np.load(tmp_path / f"out{k}.npy") for k in (0, 1))
    np.testing.assert_array_equal(a, b)        # both processes agree
    rng = np.random.default_rng(7)
    n = 16
    nodes = np.cumsum(rng.normal(scale=0.1, size=(n, 3)), 0).astype(np.float32)
    ei = np.concatenate([np.arange(n - 1), [n - 1]]).astype(np.int32)
    ej = np.concatenate([np.arange(1, n), [0]]).astype(np.int32)
    z = rng.normal(scale=0.05, size=(n, 3)).astype(np.float32)
    om = np.broadcast_to(np.eye(3, dtype=np.float32), (n, 3, 3)).copy()
    g = (nodes, np.ones(n, bool), ei, ej, z, om, np.ones(n, bool))
    set_virtual_devices(2, "cpu")
    try:
        single = TD.gn_step_sharded(make_mesh(device="cpu"),
                                    *_torch_graph(g), 0).numpy()
    finally:
        set_virtual_devices(0, "cpu")
    np.testing.assert_allclose(a, single, atol=1e-5)
    want = np.asarray(_jit(functools.partial(jstep, _jmesh(2)),
                           *_jax_graph(g), jnp.int32(0)))
    np.testing.assert_allclose(a, want, atol=1e-5)
    assert np.abs(a - nodes).max() > 1e-4       # the step moved the graph


# ── dryrun_multichip ─────────────────────────────────────────────────────

def test_dryrun_multichip_on_virtual_cpu_shards(mesh8, capsys):
    from icp_tpu_torch.tools.entry import dryrun_multichip

    dryrun_multichip(8, device="cpu")
    assert "dryrun_multichip(8, cpu): ok" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="needs 9"):
        dryrun_multichip(9, device="cpu")


# ── on the card ──────────────────────────────────────────────────────────

@pytest.mark.gpu
def test_kernels_on_the_last_card():
    """Both kernels launch on their tensors' card even when it is not the
    current device, and equal their plain versions there."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs 2 or more CUDA devices")
    from icp_tpu_torch.ops.hopper import nn_kernel as K

    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    assert torch.cuda.current_device() != dev.index
    rng = np.random.default_rng(0)
    src = torch.as_tensor(rng.uniform(-20, 20, (768, 2)), dtype=torch.float32,
                          device=dev)
    tgt = torch.as_tensor(rng.uniform(-20, 20, (4096, 2)), dtype=torch.float32,
                          device=dev)
    msk = torch.as_tensor(rng.random(4096) > 0.1, device=dev)
    d2, idx = K.nn_cuda(src, tgt, msk)
    pd2, pidx = K.nn_plain(src, tgt, msk)
    torch.cuda.synchronize(dev)
    assert d2.device == dev and torch.equal(d2, pd2) and torch.equal(idx, pidx)
    rows = src.repeat(240, 1)
    out = K.nn_min_cuda(rows, tgt[:768], msk[:768])
    torch.cuda.synchronize(dev)
    assert torch.equal(out, K.nn_min_plain(rows, tgt[:768], msk[:768]))


@pytest.mark.gpu
def test_sharded_functions_on_a_virtual_card_mesh():
    """The sharded sweep on 4 virtual shards of one card equals the
    unsharded sweep bit for bit, and the block paint the whole-grid paint."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m gpu)")
    from icp_tpu_torch.ops.raytrace import raytrace_update
    from icp_tpu_torch.ops.sweep import sweep_scores

    set_virtual_devices(4, "cuda:0")
    try:
        mesh = make_mesh(4, device="cuda")
    finally:
        set_virtual_devices(0, "cuda")
    dev = mesh.devices[0]
    rng = np.random.default_rng(0)
    c = lambda a, dt=torch.float32: torch.as_tensor(  # noqa: E731
        a, dtype=dt, device=dev)
    src, tgt = c(rng.uniform(-9, 9, (768, 2))), c(rng.uniform(-9, 9, (768, 2)))
    m = torch.ones(768, dtype=torch.bool, device=dev)
    angles, toff = c(np.linspace(-np.pi, np.pi, 240)), c([0.1, -0.2])
    assert torch.equal(sweep_scores_sharded(mesh, src, m, tgt, m, angles, toff),
                       sweep_scores(src, m, tgt, m, angles, toff))
    hits = c(rng.integers(-8, 72, (512, 2)), torch.int64)
    ok = c(rng.random(512) > 0.1, torch.bool)
    origin = c([17, 33], torch.int64)
    blocks = TG.raytrace_update_block_sharded(
        mesh, TG.block_sharding(mesh, torch.zeros((64, 40), device=dev)),
        origin, hits, ok, *GRID_ARGS, max_steps=96)
    want = raytrace_update(torch.zeros((64, 40), device=dev), origin, hits, ok,
                           *GRID_ARGS, max_steps=96)
    torch.testing.assert_close(mesh.all_gather(blocks), want, rtol=0,
                               atol=1e-4)
