"""icp_tpu_torch's pose graph against icp_tpu's (JAX on the CPU): the batched
edge terms, DCS weights and total error, the dense GN solve with its
divergence guard and LM retry, the matrix-free PCG path and the coarse
supernode initialisation. Inputs come from numpy seeds."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from icp_tpu.models import pose_graph as J  # noqa: E402
from icp_tpu_torch.models import pose_graph as T  # noqa: E402
from icp_tpu_torch.parallel import dist_pose_graph as TD  # noqa: E402
from icp_tpu_torch.utils import se2 as tse2  # noqa: E402


def _rel(a, b):
    Ta, Tb = tse2.vec_to_pose_np(a), tse2.vec_to_pose_np(b)
    return tse2.pose_to_vec_np(np.linalg.inv(Ta) @ Tb, np.float64)


def _chain_with_closures(pg, n=96, closures=(), drift=0.05, seed=1):
    """tests/test_pose_graph.py's noisy circular chain with closure edges
    (i, j) measured from the true poses."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    true = [np.array([np.cos(a) * 5, np.sin(a) * 5,
                      (a + np.pi / 2 + np.pi) % (2 * np.pi) - np.pi])
            for a in ang]
    for k, v in enumerate(true):
        noise = rng.normal(scale=drift, size=3) * [1, 1, 0.2] if k else 0
        pg.add_node(np.asarray(v, float) + noise)
    for k in range(1, n):
        pg.add_edge(k - 1, k, _rel(true[k - 1], true[k]), np.eye(3))
    for (i, j) in closures:
        pg.add_edge(i, j, _rel(true[i], true[j]), np.eye(3) * 50.0)
    return pg


def _chain_graph(pg, n=30, robust_flag=False, bad_weight=5e4):
    """tests/test_robust_lc.py's straight odometry + one wrong closure."""
    for k in range(n):
        pg.add_node(np.array([k * 1.0, 0.0, 0.0], np.float32))
    z = np.array([1.0, 0.0, 0.0], np.float32)
    for k in range(1, n):
        pg.add_edge(k - 1, k, z, np.eye(3, dtype=np.float32) * 100.0)
    pg.add_edge(n - 1, 0, np.array([-(n - 1) + 3.0, 1.0, 0.0], np.float32),
                np.eye(3, dtype=np.float32) * bad_weight, robust=robust_flag)
    return pg


def _pair(build, **kw):
    """The same graph in both packages."""
    return build(J.PoseGraph2D(), **kw), build(T.PoseGraph2D("cpu"), **kw)


def _random_graph(seed, n=40, e=90):
    rng = np.random.default_rng(seed)
    nodes = np.concatenate([rng.uniform(-10, 10, (n, 2)),
                            rng.uniform(-np.pi, np.pi, (n, 1))], 1)
    ei = rng.integers(0, n, e).astype(np.int32)
    ej = rng.integers(0, n, e).astype(np.int32)
    z = np.concatenate([rng.normal(0, 2, (e, 2)),
                        rng.uniform(-np.pi, np.pi, (e, 1))], 1)
    L = rng.normal(0, 1, (e, 3, 3))
    om = np.einsum("eij,ekj->eik", L, L) + np.eye(3) * 0.5
    em = rng.random(e) < 0.8
    rb = rng.random(e) < 0.5
    f = lambda a: a.astype(np.float32)  # noqa: E731
    return f(nodes), ei, ej, f(z), f(om), em, rb


def _tt(*arrays):
    out = []
    for a in arrays:
        t = torch.as_tensor(a)
        out.append(t.long() if t.dtype == torch.int32 else t)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_edge_terms_robust_omega_total_error_match(seed):
    """edge_terms, robust_omega (phi 0.5 and 3) and total_error of a random
    graph with masked edges: to 1e-5 of icp_tpu's."""
    nodes, ei, ej, z, om, em, rb = _random_graph(seed)
    args_j = [jnp.asarray(a) for a in (nodes, ei, ej, z, om, em)]
    args_t = _tt(nodes, ei, ej, z, om, em)
    ej_, Aj, Bj = J.edge_terms(*args_j)
    et, At, Bt = T.edge_terms(*args_t)
    for a, b in ((et, ej_), (At, Aj), (Bt, Bj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5)
    for phi in (0.5, 3.0):
        wj = J.robust_omega(ej_, jnp.asarray(om), jnp.asarray(rb),
                            jnp.float32(phi))
        wt = T.robust_omega(et, torch.as_tensor(om), torch.as_tensor(rb), phi)
        np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-5,
                                   atol=1e-5)
    tj = float(J.total_error(*args_j))
    tt = float(T.total_error(*args_t))
    np.testing.assert_allclose(tt, tj, rtol=1e-5)


@pytest.mark.parametrize("damping", [0.0, 0.1])
def test_optimize_dense_matches(damping):
    """optimize_dense on the chain with closures (robust flags on the
    closures, padded capacity buckets): nodes to 1e-4 and the same
    iteration count; at damping 0 the step equals the undamped call."""
    gj, gt = _pair(_chain_with_closures, closures=[(0, 48), (10, 60)])
    packed = gj._packed()
    packed[7][-4:] = True                          # flag padding: no effect
    nodes, nm, ei, ej, z, om, em, rb = packed
    rb[95:97] = True
    oj, itj = J.optimize_dense(
        *[jnp.asarray(a) for a in (nodes, nm, ei, ej, z, om, em)],
        jnp.int32(0), jnp.asarray(rb), jnp.float32(1.0),
        jnp.float32(damping), n_iterations=15)
    ot, itt = T.optimize_dense(*_tt(nodes, nm, ei, ej, z, om, em), 0,
                               torch.as_tensor(rb), 1.0, damping,
                               n_iterations=15)
    assert int(itj) == itt
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-4)
    if damping == 0.0:
        ot0, _ = T.optimize_dense(*_tt(nodes, nm, ei, ej, z, om, em), 0,
                                  torch.as_tensor(rb), 1.0, n_iterations=15)
        assert torch.equal(ot0, ot)


@pytest.mark.parametrize("case", ["square_chain", "robust_bad_closure",
                                  "plain_bad_closure", "anchor_mid"])
def test_pose_graph_optimize_matches(case):
    """PoseGraph2D.optimize through the dense route: nodes to 1e-4, the
    same last_strategy and total error."""
    if case == "square_chain":
        gj, gt = _pair(_chain_with_closures,
                       closures=[(0, 48), (10, 60), (20, 80)])
        kw = dict(n_iterations=30)
    elif case == "anchor_mid":
        gj, gt = _pair(_chain_with_closures, n=40, closures=[(2, 30)])
        kw = dict(n_iterations=10, fix_node=17)
    else:
        # the plain case at weight 500: at 5e4 the f32 LU solves of the
        # two packages' LAPACKs part by up to 7e-4 m over 30 iterations
        robust = case == "robust_bad_closure"
        gj, gt = _pair(_chain_graph, n=24, robust_flag=robust,
                       bad_weight=5e4 if robust else 500.0)
        kw = dict(n_iterations=30)
    gj.optimize(**kw)
    gt.optimize(**kw)
    assert gt.last_strategy == gj.last_strategy == "dense"
    np.testing.assert_allclose(np.stack(gt.nodes), np.stack(gj.nodes),
                               atol=1e-4)
    np.testing.assert_allclose(gt.total_error(), gj.total_error(),
                               rtol=1e-3, atol=1e-6)


def test_divergence_guard_rejects_like_icp_tpu():
    """An inner solve that blows the graph up at every damping is rejected
    in both packages: prior estimate kept, suffix '+rejected'."""
    gj, gt = _pair(_chain_graph, n=10, bad_weight=1.0)
    before = np.stack(gt.nodes)
    for g in (gj, gt):
        def corrupt(n_iterations, fix_node, convergence_eps, damping=0.0,
                    g=g):
            for k in range(g.n_nodes):
                g._nodes[k] = g._nodes[k] + 1e6
        g._optimize_inner = corrupt
        g.optimize(n_iterations=5)
    assert gt.last_strategy == gj.last_strategy
    assert gt.last_strategy.endswith("+rejected")
    np.testing.assert_allclose(np.stack(gt.nodes), before)
    np.testing.assert_allclose(np.stack(gt.nodes), np.stack(gj.nodes))


def test_lm_retry_matches_icp_tpu():
    """Plain GN diverges (simulated) and a damped rung descends: both
    packages accept the same rung ('+lm(lambda)') with nodes to 1e-4."""
    gj, gt = _pair(_chain_graph, n=10, bad_weight=100.0)
    before = gt.total_error()
    calls = {}
    for g in (gj, gt):
        real = g._optimize_inner
        calls[id(g)] = []

        def flaky(n_iterations, fix_node, convergence_eps, damping=0.0,
                  g=g, real=real):
            calls[id(g)].append(damping)
            if damping == 0.0:
                for k in range(g.n_nodes):
                    g._nodes[k] = g._nodes[k] + 1e6
            else:
                real(n_iterations, fix_node, convergence_eps, damping=damping)
        g._optimize_inner = flaky
        g.optimize(n_iterations=10)
    assert gt.last_strategy == gj.last_strategy
    assert "+lm(" in gt.last_strategy
    assert calls[id(gt)] == calls[id(gj)]
    assert gt.total_error() < before
    np.testing.assert_allclose(np.stack(gt.nodes), np.stack(gj.nodes),
                               atol=1e-4)


def test_cg_path_matches_icp_tpu_and_dense():
    """The PCG route forced with _cg_node_threshold = 2 (robust closures
    included): to 5e-4 of icp_tpu's CG, and to 5e-3 of the port's dense
    fixed point."""
    closures = [(0, 48), (10, 60), (20, 80)]
    gj, gt = _pair(_chain_with_closures, closures=closures)
    for g in (gj, gt):
        g._edges_rb[-1] = True
        g._cg_node_threshold = 2
        g.optimize(n_iterations=30)
    assert gt.last_strategy == gj.last_strategy == "cg"
    nt = np.stack(gt.nodes)
    np.testing.assert_allclose(nt, np.stack(gj.nodes), atol=5e-4)
    dense = _chain_with_closures(T.PoseGraph2D("cpu"), closures=closures)
    dense._edges_rb[-1] = True
    dense.optimize(n_iterations=30)
    assert dense.last_strategy == "dense"
    assert np.abs(nt[:, :2] - np.stack(dense.nodes)[:, :2]).max() < 5e-3


def test_inv3x3_matches_icp_tpu():
    """The preconditioner's closed-form inverse, singular blocks included."""
    from icp_tpu.parallel.dist_pose_graph import _inv3x3

    rng = np.random.default_rng(4)
    M = rng.normal(0, 1, (16, 3, 3)).astype(np.float32)
    M[3] = 0.0
    M[5, 2] = M[5, 0]                              # rank 2
    np.testing.assert_allclose(TD._inv3x3(torch.as_tensor(M)).numpy(),
                               np.asarray(_inv3x3(jnp.asarray(M))),
                               rtol=1e-4, atol=1e-5)


def _drifted_loop(pg, n=600):
    """tests/test_coarse_pose_graph.py's circle integrated with a yaw bias,
    with one strong true closure last -> first."""
    yaw_bias = 0.3 / n
    R = 50.0
    dth = 2 * np.pi / n
    step = 2 * R * np.sin(dth / 2)
    true_xy = np.stack([R * np.cos(np.arange(n) * dth),
                        R * np.sin(np.arange(n) * dth)], 1)
    x, y, th = true_xy[0, 0], true_xy[0, 1], np.pi / 2 + dth / 2
    for _ in range(n):
        pg.add_node(np.array([x, y, th], np.float32))
        x += step * np.cos(th)
        y += step * np.sin(th)
        th += dth + yaw_bias
    z_od = np.array([step, 0.0, dth + yaw_bias], np.float32)
    for k in range(1, n):
        pg.add_edge(k - 1, k, z_od, np.eye(3, dtype=np.float32) * 10.0)
    tha = np.pi / 2 + dth / 2 + (n - 1) * dth
    thb = np.pi / 2 + dth / 2
    ca, sa = np.cos(tha), np.sin(tha)
    d = true_xy[0] - true_xy[n - 1]
    pg.add_edge(n - 1, 0, np.array([ca * d[0] + sa * d[1],
                                    -sa * d[0] + ca * d[1],
                                    ((thb - tha + np.pi) % (2 * np.pi)) - np.pi],
                                   np.float32),
                np.eye(3, dtype=np.float32) * 1e3, robust=True)
    return pg


def test_coarse_correct_through_optimize_matches():
    """_coarse_correct inside optimize on a 600-node drifted loop
    (_coarse_threshold lowered to 500, CG forced): nodes to 1e-3 of
    icp_tpu's, and the loop error shrinks."""
    gj, gt = _pair(_drifted_loop)
    before = np.stack(gt.nodes)
    for g in (gj, gt):
        g._cg_node_threshold = 2
        g._coarse_threshold = 500
        g.optimize(n_iterations=5)
    assert gt.last_strategy == gj.last_strategy == "cg"
    nt, nj = np.stack(gt.nodes), np.stack(gj.nodes)
    np.testing.assert_allclose(nt[:, :2], nj[:, :2], atol=1e-3)
    dth = (nt[:, 2] - nj[:, 2] + np.pi) % (2 * np.pi) - np.pi
    assert np.abs(dth).max() < 1e-3
    moved = np.linalg.norm(nt[:, :2] - before[:, :2], axis=1)
    assert moved.max() > 1.0                       # the closure was applied


def test_graph_accessors_and_guards():
    """get_poses_as_matrices, packing buckets after reserve(), the no-op
    cases, vec/pose round trips, and set_mesh with a one-shard mesh keeping
    the dense route."""
    gj, gt = J.PoseGraph2D(), T.PoseGraph2D("cpu")
    for g in (gj, gt):
        g.optimize()                               # empty: no-op
        g.add_node([1.0, 2.0, 0.5])
        g.optimize()                               # one node: no-op
        g.reserve(100)
    np.testing.assert_allclose(gt.get_poses_as_matrices()[0],
                               gj.get_poses_as_matrices()[0], atol=1e-7)
    for a, b in zip(gt._packed(), gj._packed()):
        np.testing.assert_array_equal(a, b)
    v = torch.tensor([[1.0, -2.0, 3.0], [0.5, 0.25, -1.0]])
    np.testing.assert_allclose(tse2.pose_to_vec(tse2.vec_to_pose(v)).numpy(),
                               v.numpy(), atol=1e-6)
    np.testing.assert_allclose(
        tse2.vec_to_pose_np(np.array([1.0, -2.0, 3.0]), np.float32),
        tse2.vec_to_pose(v[0]).numpy(), atol=1e-6)
    from icp_tpu_torch.parallel.mesh import Mesh
    gt.add_node([1.5, 2.0, 0.4])
    gt.add_edge(0, 1, [0.5, 0.0, -0.1])
    gt.set_mesh(Mesh(("cpu",)), node_threshold=2)
    gt.optimize()
    assert gt.last_strategy == "dense"


# ── segment plans: padded edges left out, one sort a solve ──────────────
def _every_row(out, index, src, **kw):
    """The assembly as it was before plans: index_add_ of every row,
    padded edges included (CPU ordered_index_add_ is index_add_)."""
    from icp_tpu_torch.ops.scatter import SegmentPlan

    if isinstance(index, SegmentPlan):
        index = index.index
    return out.index_add_(0, index, src)


def _closure_chain_1024(dtype):
    """A 1,024-node chain with three long closures and one every 16 nodes:
    1,090 edges in 2,048 slots, so 958 padded edges at node 0."""
    n = 1024
    closures = [(0, n // 2), (106, 640), (213, 853)]
    closures += [(i, (i + 16) % n) for i in range(0, n, 16)]
    g = _chain_with_closures(T.PoseGraph2D("cpu"), n=n, closures=closures)
    nodes, nm, ei, ej, z, om, em, rb = g._packed_device()
    assert int(em.sum()) == 1090 and em.shape[0] == 2048
    return nodes.to(dtype), nm, ei, ej, z.to(dtype), om.to(dtype), em, rb


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_scatter_dense_plans_drop_padding_bit_equal(monkeypatch, dtype):
    """_scatter_dense on plans that leave the padded edges out gives the
    bits of the every-row assembly on the 1,024-node chain, and so do two
    GN iterations of optimize_dense."""
    nodes, nm, ei, ej, z, om, em, rb = _closure_chain_1024(dtype)
    n = nodes.shape[0]
    plans = T._dense_plans(n, ei, ej, em)
    assert int(plans[0].keep.sum()) == 36 * 1090
    e, A, B = T.edge_terms(nodes, ei, ej, z, om, em)
    blocks = T._block_products(e, A, B, T.robust_omega(e, om, rb, 1.0), em)
    H, b = T._scatter_dense(n, plans, *blocks)
    kept = T.optimize_dense(nodes, nm, ei, ej, z, om, em, 0, rb,
                            n_iterations=2, convergence_eps=0.0)[0]
    monkeypatch.setattr(T, "ordered_index_add_", _every_row)
    H_all, b_all = T._scatter_dense(n, plans, *blocks)
    every = T.optimize_dense(nodes, nm, ei, ej, z, om, em, 0, rb,
                             n_iterations=2, convergence_eps=0.0)[0]
    assert torch.equal(H, H_all) and torch.equal(b, b_all)
    assert torch.equal(kept, every)


def test_gn_steps_on_plans_bit_equal_on_two_shards(monkeypatch):
    """One PCG step and one Schur step on a 2-shard virtual CPU mesh: the
    plans (padded edges and interior slots left out) give the bits of the
    every-row assembly."""
    from icp_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh(("cpu", "cpu"))
    nodes, nm, ei, ej, z, om, em, rb = _closure_chain_1024(torch.float32)
    part = TD.partition_graph(nodes.shape[0], ei.numpy(), ej.numpy(),
                              z.numpy(), om.numpy(), em.numpy(), 2, 0,
                              robust=rb.numpy())
    assert not part.edge_mask.all() and not part.int_valid.all()

    def steps():
        return (TD.gn_step_cg_sharded(mesh, nodes, nm, ei, ej, z, om, em, 0,
                                      rb, 0.5, 0.1, cg_iters=10),
                TD.gn_step_schur_sharded(mesh, nodes, nm, part, 0.5, 0.1))
    kept = steps()
    monkeypatch.setattr(T, "ordered_index_add_", _every_row)
    monkeypatch.setattr(TD, "ordered_index_add_", _every_row)
    every = steps()
    for a, b in zip(kept, every):
        assert torch.equal(a, b)


def test_solves_build_their_plans_once():
    """The dense, PCG and Schur solves sort their indices once a solve,
    not once a GN iteration: 2 plans (H, b) a dense solve, one a shard a
    PCG solve, three a shard (H, b, back-substitution) a Schur solve."""
    from icp_tpu_torch.ops import scatter as S
    from icp_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh(("cpu", "cpu"))
    g = _chain_with_closures(T.PoseGraph2D("cpu"),
                             closures=[(0, 48), (10, 60), (20, 80)])
    nodes, nm, ei, ej, z, om, em, rb = g._packed_device()
    part = TD.partition_graph(nodes.shape[0], ei.numpy(), ej.numpy(),
                              z.numpy(), om.numpy(), em.numpy(), 2, 0)
    for solve, per_solve in (
            (lambda: T.optimize_dense(nodes, nm, ei, ej, z, om, em, 0,
                                      n_iterations=4, convergence_eps=0.0), 2),
            (lambda: TD.optimize_cg(mesh, nodes, nm, ei, ej, z, om, em, 0,
                                    n_iterations=4, convergence_eps=0.0,
                                    cg_iters=5), 2),
            (lambda: TD.optimize_schur(mesh, nodes, nm, part, n_iterations=4,
                                       convergence_eps=0.0), 6)):
        before = S.segment_plan_builds
        _, it = solve()
        assert it == 4
        assert S.segment_plan_builds - before == per_solve
    before = S.segment_plan_builds
    g.optimize(n_iterations=5)
    assert g.last_strategy == "dense" and g.last_iterations >= 1
    assert S.segment_plan_builds - before == 2
