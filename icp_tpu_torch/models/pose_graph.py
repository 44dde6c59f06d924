"""SE(2) pose-graph Gauss-Newton on device tensors (counterpart of
icp_tpu.models.pose_graph: ``edge_terms``, ``robust_omega``,
``optimize_dense``, ``total_error``, ``PoseGraph2D``).

The graph grows on the host (lists of nodes and edges); ``optimize`` packs
it into power-of-two capacity buckets and solves on ``device``:

* errors and Jacobians of all edges are one batched computation;
* the dense 3n x 3n normal matrix is assembled with ordered scatter-sums
  (``ops.scatter``, on segment plans sorted once a solve, padded edges
  left out) and solved with ``torch.linalg.solve_ex`` (icp_tpu's
  ``jnp.linalg.solve``). icp_tpu runs the GN iterations as one
  ``lax.while_loop``; here the loop runs on the host and reads the stop
  flag once per iteration, so it stops where the while-loop stops;
* past ``_cg_node_threshold`` nodes the matrix-free block-Jacobi PCG of
  ``parallel.dist_pose_graph`` replaces the dense solve, and past
  ``_coarse_threshold`` a coarse supernode solve initialises it;
* with a mesh of more than one shard (``set_mesh``), graphs from
  ``node_threshold`` nodes up solve by the distributed Schur-complement GN,
  or by the distributed PCG past the Schur limits.

Each ``optimize`` is the span ``pose_graph.solve`` (``utils.spans``), and
its parts are spans under it: ``pose_graph.pack``, ``dense_build`` and
``dense_solve`` on the dense route, ``coarse_correct`` and ``pcg`` on the
PCG route, ``store`` and ``total_error``.

Anchor semantics are icp_tpu's and the reference's (pose_graph.py:109-114):
the fixed node's rows and columns are zeroed and its diagonal block set to
1e10 * I. Padded nodes get an identity diagonal.
"""
from __future__ import annotations

import numpy as np
import torch

from icp_tpu_torch.ops.scatter import ordered_index_add_, segment_plan
from icp_tpu_torch.utils import spans
from icp_tpu_torch.utils.masking import next_pow2
from icp_tpu_torch.utils.se2 import pose_to_vec_np, vec_to_pose_np, wrap_angle

ANCHOR_WEIGHT = 1e10


def edge_terms(nodes, ei, ej, z, omega, edge_mask):
    """Batched error and Jacobians of every edge.

    nodes (N, 3) [x, y, theta]; ei/ej (E,) int; z (E, 3); omega (E, 3, 3);
    edge_mask (E,). Returns (e (E, 3), A (E, 3, 3), B (E, 3, 3)); masked
    edges are zeroed downstream through the omega weighting.
    """
    xi = nodes[ei]
    xj = nodes[ej]
    c, s = torch.cos(xi[:, 2]), torch.sin(xi[:, 2])
    dt = xj[:, :2] - xi[:, :2]
    pred_x = c * dt[:, 0] + s * dt[:, 1]
    pred_y = -s * dt[:, 0] + c * dt[:, 1]
    dth = wrap_angle(xj[:, 2] - xi[:, 2])
    e = torch.stack([pred_x - z[:, 0], pred_y - z[:, 1],
                     wrap_angle(dth - z[:, 2])], dim=-1)

    # d(Ri^T dt)/dtheta_i rows: [[-s, c], [-c, -s]] @ dt
    dx = -s * dt[:, 0] + c * dt[:, 1]
    dy = -c * dt[:, 0] - s * dt[:, 1]
    zeros, ones = torch.zeros_like(c), torch.ones_like(c)
    A = torch.stack([torch.stack([-c, -s, dx], -1),
                     torch.stack([s, -c, dy], -1),
                     torch.stack([zeros, zeros, -ones], -1)], dim=-2)
    B = torch.stack([torch.stack([c, s, zeros], -1),
                     torch.stack([-s, c, zeros], -1),
                     torch.stack([zeros, zeros, ones], -1)], dim=-2)
    return e, A, B


def robust_omega(e, omega, robust_mask, phi):
    """Dynamic Covariance Scaling (DCS) of flagged edges: s = min(1, 2 phi /
    (phi + chi2)), omega *= s^2; unflagged edges keep their weight.
    Recomputed from the current estimate every GN iteration."""
    chi2 = torch.einsum("ei,eij,ej->e", e, omega, e)
    s = torch.clamp(2.0 * phi / (phi + chi2), max=1.0)
    s = torch.where(robust_mask, s, 1.0)
    return omega * (s * s)[:, None, None]


def _block_products(e, A, B, omega, edge_mask):
    """Per-edge H blocks and b segments, masked."""
    om = omega * edge_mask.to(e.dtype)[:, None, None]
    AtO = torch.einsum("eij,eik->ejk", A, om)          # A^T omega
    BtO = torch.einsum("eij,eik->ejk", B, om)
    Hii = torch.einsum("ejk,ekl->ejl", AtO, A)
    Hij = torch.einsum("ejk,ekl->ejl", AtO, B)
    Hji = torch.einsum("ejk,ekl->ejl", BtO, A)
    Hjj = torch.einsum("ejk,ekl->ejl", BtO, B)
    bi = torch.einsum("ejk,ek->ej", AtO, e)
    bj = torch.einsum("ejk,ek->ej", BtO, e)
    return Hii, Hij, Hji, Hjj, bi, bj


def _dense_plans(n, ei, ej, edge_mask):
    """Segment plans of the dense H (9 n^2 slots) and b (3 n slots) of the
    edges (ei, ej), built once a solve (the indices do not change between
    GN iterations): H's rows are the four blocks' entries in the order
    Hii, Hij, Hji, Hjj, b's the bi then bj entries. Masked (padded) edges'
    rows are left out: their information matrix is 0, so every value they
    carry is +-0, and the sums keep their bits without them."""
    r = torch.arange(3, device=ei.device)
    ri = 3 * ei[:, None] + r[None, :]                  # (E, 3)
    rj = 3 * ej[:, None] + r[None, :]

    def flat(rows, cols):                              # (E, 3, 3) into H
        return (rows[:, :, None] * (3 * n) + cols[:, None, :]).reshape(-1)

    kept = edge_mask != 0
    return (segment_plan(
                torch.cat([flat(ri, ri), flat(ri, rj), flat(rj, ri),
                           flat(rj, rj)]), 9 * n * n,
                keep=kept.repeat_interleave(9).repeat(4)),
            segment_plan(torch.cat([ri.reshape(-1), rj.reshape(-1)]), 3 * n,
                         keep=kept.repeat_interleave(3).repeat(2)))


def _scatter_dense(n, plans, Hii, Hij, Hji, Hjj, bi, bj):
    """Assemble the dense (3n, 3n) H and (3n,) b from per-edge blocks, on
    ``plans = _dense_plans(n, ...)``."""
    dev, dt = Hii.device, Hii.dtype
    plan_h, plan_b = plans
    # one ordered scatter-sum each for H and b, the blocks concatenated:
    # the same bits as one index_add_ a block, in this order, on the CPU
    H = torch.zeros(9 * n * n, dtype=dt, device=dev)
    ordered_index_add_(H, plan_h, torch.cat([Hii.reshape(-1), Hij.reshape(-1),
                                             Hji.reshape(-1),
                                             Hjj.reshape(-1)]))
    b = torch.zeros(3 * n, dtype=dt, device=dev)
    ordered_index_add_(b, plan_b, torch.cat([bi.reshape(-1), bj.reshape(-1)]))
    return H.view(3 * n, 3 * n), b


def optimize_dense(nodes, node_mask, ei, ej, z, omega, edge_mask,
                   fix_node, robust_mask=None, robust_phi=1.0, damping=0.0,
                   *, n_iterations: int = 20, convergence_eps=1e-6):
    """Gauss-Newton with a dense solve per iteration.

    ``robust_mask`` flags edges for DCS reweighting (None: none).
    ``damping`` > 0 makes the step Levenberg-Marquardt, (H + damping
    diag(H)) dx = -b; 0 is the plain GN step. The loop stops after
    ``n_iterations``, when ||dx|| < convergence_eps, or when the solve gives
    a non-finite step (which is then not applied), reading the flag once per
    iteration. Returns (nodes, iterations run).
    """
    n = nodes.shape[0]
    dev = nodes.device
    if robust_mask is None:
        robust_mask = torch.zeros(ei.shape[0], dtype=torch.bool, device=dev)
    with spans.span("pose_graph.dense_build"):
        idx3 = torch.arange(3 * n, device=dev)
        anchor_rows = (idx3 // 3) == int(fix_node)
        diag_add = (torch.where(anchor_rows, ANCHOR_WEIGHT, 0.0)
                    + torch.where(torch.repeat_interleave(~node_mask, 3),
                                  1.0, 0.0)).to(nodes.dtype)
        cross = anchor_rows[:, None] | anchor_rows[None, :]
        plans = _dense_plans(n, ei, ej, edge_mask)
    with spans.span("pose_graph.dense_solve"):
        cur = nodes
        it = 0
        while it < n_iterations:
            e, A, B = edge_terms(cur, ei, ej, z, omega, edge_mask)
            om_eff = robust_omega(e, omega, robust_mask, robust_phi)
            H, b = _scatter_dense(n, plans,
                                  *_block_products(e, A, B, om_eff, edge_mask))
            # anchor: zero row/col, big diagonal (pose_graph.py:109-114)
            H = torch.where(cross, 0.0, H) + torch.diag(diag_add)
            b = torch.where(anchor_rows, 0.0, b)
            # Levenberg-Marquardt diagonal scaling (adds exactly 0 at
            # damping 0)
            H = H + torch.diag(damping * torch.diagonal(H))
            dx, info = torch.linalg.solve_ex(H, -b)
            # a singular H (info > 0) is the non-finite step of an LU solve
            bad = (info != 0) | ~torch.isfinite(dx).all()
            dx = torch.where(bad, 0.0, dx)
            dxr = dx.reshape(n, 3)
            new = torch.stack([cur[:, 0] + dxr[:, 0], cur[:, 1] + dxr[:, 1],
                               wrap_angle(cur[:, 2] + dxr[:, 2])], dim=-1)
            cur = torch.where(node_mask[:, None], new, cur)
            it += 1
            spans.count("sync.pose_graph.stop")
            if bool(bad | (torch.linalg.norm(dx) < convergence_eps)):
                break
    return cur, it


def total_error(nodes, ei, ej, z, omega, edge_mask):
    """Sum of weighted squared edge errors (pose_graph.py:188-195)."""
    e, _, _ = edge_terms(nodes, ei, ej, z, omega, edge_mask)
    w = edge_mask.to(e.dtype)
    return (w * torch.einsum("ei,eij,ej->e", e, omega, e)).sum()


class PoseGraph2D:
    """Host-side growing graph, optimized on ``device``.

    The API is icp_tpu's (add_node / add_edge / optimize /
    get_poses_as_matrices / total_error / reserve / last_strategy); a
    ``_packed()`` graph is the same numpy arrays in both packages.
    """

    # thresholds of the strategy choice (see optimize). 2000 comes from
    # icp_tpu, where the TPU's LU solve ran out of scoped memory past a
    # ~6k x 6k system (pow2 bucket 2048 -> 6144^2 fits, 4096 does not);
    # it is kept until the H100's own crossover is measured. So are the
    # distributed path's Schur limits: past _schur_dense_budget bytes of
    # per-shard dense block (3 (i_cap + s))^2 f32, or _max_separators
    # separators, it falls back to the distributed PCG
    _cg_node_threshold = 2000
    _schur_dense_budget = 1 << 30
    _max_separators = 2000
    _coarse_threshold = 5000
    # Levenberg-Marquardt retry ladder of the divergence guard: each rung
    # re-runs the solve with (H + lambda diag(H)) dx = -b
    _lm_ladder = (1e-3, 1e-1, 10.0, 1e3)

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("PoseGraph2D(device='cuda') but CUDA is not "
                               "available; pass device='cpu' explicitly")
        self._nodes: list[np.ndarray] = []
        self._edges_i: list[int] = []
        self._edges_j: list[int] = []
        self._edges_z: list[np.ndarray] = []
        self._edges_om: list[np.ndarray] = []
        self._edges_rb: list[bool] = []     # robust (DCS) flag per edge
        self.robust_phi = 1.0               # DCS phi (chi2 scale)
        self._min_nc = 2
        self._min_ec = 2
        self._mesh = None                   # set_mesh: distributed solve
        self._dist_threshold = 1024
        # "dense" | "cg" | "schur" | "dist_cg" (+ guard suffix)
        self.last_strategy = None
        # GN iterations the last optimize ran, its LM retries included
        self.last_iterations = 0
        # the divergence guard over the graph's life (coarse solves' too):
        # solves saved by an LM retry, and solves rejected
        self.lm_retries = 0
        self.rejected_solves = 0

    def set_mesh(self, mesh, node_threshold: int = 1024):
        """Solve graphs of ``node_threshold`` nodes and more by the exact
        Schur-complement GN sharded over ``mesh`` (a
        ``parallel.mesh.Mesh``) where it has more than one shard. Below it,
        and on a one-shard mesh, the dense (or PCG) route stays: both are
        exact GN steps."""
        self._mesh = mesh
        self._dist_threshold = int(node_threshold)

    def reserve(self, n_nodes: int, n_edges: int | None = None):
        """Pin the packed capacity buckets (they still grow past it)."""
        self._min_nc = next_pow2(max(int(n_nodes), 2))
        self._min_ec = next_pow2(max(int(n_edges if n_edges is not None
                                         else 2 * n_nodes), 2))

    # ── mutation ─────────────────────────────────────────────────────────
    def add_node(self, pose_vec) -> int:
        self._nodes.append(np.asarray(pose_vec, np.float32).copy())
        return len(self._nodes) - 1

    def add_edge(self, i, j, measurement, information=None,
                 robust: bool = False):
        """``robust=True`` flags the edge for DCS reweighting (loop-closure
        edges); the default keeps the reference's plain GN."""
        self._edges_i.append(int(i))
        self._edges_j.append(int(j))
        self._edges_z.append(np.asarray(measurement, np.float32).copy())
        self._edges_om.append(
            np.eye(3, dtype=np.float32) if information is None
            else np.asarray(information, np.float32).copy())
        self._edges_rb.append(bool(robust))

    @property
    def nodes(self):
        return self._nodes

    @property
    def n_nodes(self):
        return len(self._nodes)

    @property
    def n_edges(self):
        return len(self._edges_i)

    # ── packing ──────────────────────────────────────────────────────────
    def _packed(self):
        """Numpy (nodes, node_mask, ei, ej, z, om, edge_mask, robust) at
        power-of-two capacities (icp_tpu's layout)."""
        n = len(self._nodes)
        e = len(self._edges_i)
        nc = max(next_pow2(max(n, 2)), self._min_nc)
        ec = max(next_pow2(max(e, 2)), self._min_ec)
        nodes = np.zeros((nc, 3), np.float32)
        nodes[:n] = np.stack(self._nodes) if n else 0
        ei = np.zeros(ec, np.int32)
        ej = np.zeros(ec, np.int32)
        z = np.zeros((ec, 3), np.float32)
        om = np.zeros((ec, 3, 3), np.float32)
        rb = np.zeros(ec, bool)
        if e:
            ei[:e] = self._edges_i
            ej[:e] = self._edges_j
            z[:e] = np.stack(self._edges_z)
            om[:e] = np.stack(self._edges_om)
            rb[:e] = self._edges_rb
        return (nodes, np.arange(nc) < n, ei, ej, z, om, np.arange(ec) < e,
                rb)

    def _packed_device(self):
        """``_packed()`` as tensors on the graph's device (int64 indices)."""
        nodes, nm, ei, ej, z, om, em, rb = self._packed()
        spans.count("sync.pose_graph.upload", 8)
        t = lambda a, dt=None: torch.as_tensor(a, dtype=dt,  # noqa: E731
                                               device=self.device)
        return (t(nodes), t(nm), t(ei, torch.int64), t(ej, torch.int64),
                t(z), t(om), t(em), t(rb))

    def _store(self, out: torch.Tensor):
        with spans.span("pose_graph.store"):
            spans.count("sync.pose_graph.store")
            out = out.cpu().numpy()
            for k in range(self.n_nodes):
                self._nodes[k] = out[k]

    # ── optimisation ─────────────────────────────────────────────────────
    @spans.spanned("pose_graph.solve")
    def optimize(self, n_iterations=20, fix_node=0, convergence_eps=1e-6):
        """Gauss-Newton with a divergence guard and a damped (LM) retry.

        If the plain solve leaves a higher (or non-finite) total error than
        1.5x the error it started from, it is re-run from the pre-solve
        state with Levenberg-Marquardt damping, rung by rung of
        ``_lm_ladder``, until a rung strictly decreases chi2 (suffix
        ``+lm(lambda)``). If no rung improves, the solve is rejected and
        the prior estimate kept (suffix ``+rejected``). A plain solve that
        descends never sees damping."""
        if self.n_nodes < 2 or self.n_edges == 0:
            return
        self.last_iterations = 0
        before = self.total_error()
        snapshot = [v.copy() for v in self._nodes]
        self._optimize_inner(n_iterations, fix_node, convergence_eps)
        after = self.total_error()
        if np.isfinite(after) and after <= before * 1.5 + 1e-6:
            return
        diverged_to = after
        best_after = np.inf
        best_nodes = None
        best_lam = None
        for lam in self._lm_ladder:
            self._nodes = [v.copy() for v in snapshot]
            self._optimize_inner(n_iterations, fix_node, convergence_eps,
                                 damping=lam)
            after = self.total_error()
            if np.isfinite(after) and after < best_after:
                best_after = after
                best_nodes = [v.copy() for v in self._nodes]
                best_lam = lam
            if np.isfinite(after) and after < before - 1e-12:
                break                       # this rung descends; take it
        if best_nodes is not None and best_after < before - 1e-12:
            self._nodes = best_nodes
            self.last_strategy = f"{self.last_strategy}+lm({best_lam:g})"
            self.lm_retries += 1
            print(f"  [info] GN diverged (chi2 {before:.3g} -> "
                  f"{diverged_to:.3g}); LM retry lambda={best_lam:g} "
                  f"accepted (chi2 -> {best_after:.3g})")
            return
        self._nodes = snapshot
        self.last_strategy = f"{self.last_strategy}+rejected"
        self.rejected_solves += 1
        print(f"  [warn] pose-graph solve rejected (chi2 "
              f"{before:.3g} -> {diverged_to:.3g}; best damped retry "
              f"{best_after:.3g}); keeping prior estimate")

    def _optimize_inner(self, n_iterations, fix_node, convergence_eps,
                        damping=0.0):
        if (self._mesh is not None and self._mesh.size > 1
                and self.n_nodes >= self._dist_threshold):
            return self._optimize_distributed(n_iterations, fix_node,
                                              convergence_eps, damping)
        if self.n_nodes >= self._cg_node_threshold:
            # the dense 3n x 3n system is O(n^2) memory and O(n^3) flops;
            # matrix-free PCG is O(edges)
            return self._optimize_cg(n_iterations, fix_node,
                                     convergence_eps, damping=damping)
        self.last_strategy = "dense"
        with spans.span("pose_graph.pack"):
            nodes, nm, ei, ej, z, om, em, rb = self._packed_device()
        out, it = optimize_dense(
            nodes, nm, ei, ej, z, om, em, int(fix_node), rb,
            float(self.robust_phi), float(damping),
            n_iterations=int(n_iterations), convergence_eps=convergence_eps)
        self.last_iterations += it
        self._store(out)

    def _coarse_correct(self, fix_node: int, stride: int):
        """Hierarchical initialisation for long chains (HOG-Man style).

        Block-Jacobi PCG moves information about cg_iters nodes per GN
        step, so a closure's correction never reaches the far side of a
        long chain. Every ``stride``-th node becomes a supernode; segment
        odometry is composed from the current estimate with information
        1/stride, and each loop-closure edge is re-anchored to its
        endpoints' supernodes. The supernode graph is solved with the dense
        GN, and each supernode's world-frame correction is interpolated
        along its segment (linear in translation, wrapped-linear in yaw),
        landing both segment ends exactly on their solved poses."""
        n = self.n_nodes
        sup = list(range(0, n, stride))
        if sup[-1] != n - 1:
            sup.append(n - 1)
        ns = len(sup)
        sup_arr = np.asarray(sup)
        nodes_np = np.stack(self._nodes)

        Ts = np.zeros((n, 3, 3), np.float64)
        c = np.cos(nodes_np[:, 2]); s = np.sin(nodes_np[:, 2])
        Ts[:, 0, 0] = c; Ts[:, 0, 1] = -s; Ts[:, 0, 2] = nodes_np[:, 0]
        Ts[:, 1, 0] = s; Ts[:, 1, 1] = c; Ts[:, 1, 2] = nodes_np[:, 1]
        Ts[:, 2, 2] = 1.0

        def rel(a, b):
            Ta = Ts[a]
            R = Ta[:2, :2]
            inv = np.eye(3)
            inv[:2, :2] = R.T
            inv[:2, 2] = -R.T @ Ta[:2, 2]
            return pose_to_vec_np(inv @ Ts[b])

        cg = PoseGraph2D(self.device)
        cg.robust_phi = self.robust_phi
        for k in sup:
            cg.add_node(nodes_np[k])
        # segment odometry from the current estimate; info ~ 1/stride
        seg_info = np.eye(3, dtype=np.float32) / float(stride)
        for k in range(ns - 1):
            cg.add_edge(k, k + 1, rel(sup[k], sup[k + 1]), seg_info)
        # re-anchor non-chain (loop-closure) edges to their supernodes
        sup_of = np.minimum(np.round(np.arange(n) / stride).astype(int),
                            ns - 1)
        ei_a = np.asarray(self._edges_i)
        ej_a = np.asarray(self._edges_j)
        for e in np.where(np.abs(ei_a - ej_a) != 1)[0]:
            i, j = int(ei_a[e]), int(ej_a[e])
            a, b = int(sup_of[i]), int(sup_of[j])
            if a == b:
                continue
            Za = vec_to_pose_np(rel(sup[a], i))     # supernode -> node
            Zb = vec_to_pose_np(rel(sup[b], j))
            Zij = vec_to_pose_np(self._edges_z[e])
            z_ab = pose_to_vec_np(Za @ Zij @ np.linalg.inv(Zb))
            # not robust at the coarse level: before the first global
            # correction a true closure's residual is the whole drift,
            # which DCS would suppress; DCS guards the fine polish
            cg.add_edge(a, b, z_ab, self._edges_om[e])
        cg.optimize(n_iterations=30, fix_node=int(sup_of[fix_node]))
        self.lm_retries += cg.lm_retries
        self.rejected_solves += cg.rejected_solves

        # world-frame correction per supernode, interpolated along segments
        new_sup = np.stack(cg._nodes)
        dxy = new_sup[:, :2] - nodes_np[sup_arr, :2]
        dth = ((new_sup[:, 2] - nodes_np[sup_arr, 2] + np.pi)
               % (2 * np.pi) - np.pi)
        seg = np.clip(np.searchsorted(sup_arr, np.arange(n),
                                      side="right") - 1, 0, ns - 2)
        a = sup_arr[seg]
        b = sup_arr[seg + 1]
        t = (np.arange(n) - a) / np.maximum(b - a, 1)
        ddth = ((dth[seg + 1] - dth[seg] + np.pi) % (2 * np.pi)) - np.pi
        dthi = dth[seg] + ddth * t
        # rotate each node about its segment-start supernode by the
        # interpolated yaw correction, translate by the start correction,
        # then spread the end mismatch linearly along the segment
        rot_c = np.cos(dthi); rot_s = np.sin(dthi)
        px = nodes_np[:, 0] - nodes_np[a, 0]
        py = nodes_np[:, 1] - nodes_np[a, 1]
        qx = nodes_np[a, 0] + dxy[seg][:, 0] + rot_c * px - rot_s * py
        qy = nodes_np[a, 1] + dxy[seg][:, 1] + rot_s * px + rot_c * py
        eb_c = np.cos(dth[seg + 1]); eb_s = np.sin(dth[seg + 1])
        bx = nodes_np[b, 0] - nodes_np[a, 0]
        by = nodes_np[b, 1] - nodes_np[a, 1]
        mx = (nodes_np[b, 0] + dxy[seg + 1][:, 0]
              - (nodes_np[a, 0] + dxy[seg][:, 0] + eb_c * bx - eb_s * by))
        my = (nodes_np[b, 1] + dxy[seg + 1][:, 1]
              - (nodes_np[a, 1] + dxy[seg][:, 1] + eb_s * bx + eb_c * by))
        qx = qx + t * mx
        qy = qy + t * my
        qth = nodes_np[:, 2] + dthi
        out = np.stack([qx, qy, ((qth + np.pi) % (2 * np.pi)) - np.pi],
                       axis=1).astype(np.float32)
        out[fix_node] = nodes_np[fix_node]          # pin the anchor exactly
        for k in range(n):
            self._nodes[k] = out[k]

    def _optimize_cg(self, n_iterations, fix_node, convergence_eps,
                     mesh=None, damping=0.0):
        """Matrix-free block-Jacobi PCG Gauss-Newton, on one device
        (``mesh`` None) or sharded over ``mesh``. Past
        ``_coarse_threshold`` nodes a coarse supernode solve initialises
        the correction first (not on an LM retry, so the ladder damps the
        whole correction)."""
        # deferred: parallel.dist_pose_graph imports this module
        from icp_tpu_torch.parallel.dist_pose_graph import optimize_cg
        from icp_tpu_torch.parallel.mesh import Mesh
        if mesh is None:
            mesh = Mesh((self.device,))
        if self.n_nodes >= self._coarse_threshold and damping == 0.0:
            with spans.span("pose_graph.coarse_correct"):
                self._coarse_correct(int(fix_node),
                                     max(2, self.n_nodes // 1000))
        self.last_strategy = "cg" if mesh.size == 1 else "dist_cg"
        with spans.span("pose_graph.pack"):
            nodes, nm, ei, ej, z, om, em, rb = self._packed_device()
        with spans.span("pose_graph.pcg"):
            out, it = optimize_cg(
                mesh, nodes, nm, ei, ej, z, om, em, int(fix_node),
                n_iterations=int(n_iterations),
                convergence_eps=convergence_eps, robust_mask=rb,
                robust_phi=float(self.robust_phi), damping=float(damping))
        self.last_iterations += it
        self._store(out)

    def _optimize_distributed(self, n_iterations, fix_node, convergence_eps,
                              damping=0.0):
        """Distributed GN over the mesh: partition the graph (topology only,
        once an optimize) and run the exact Schur-complement step, one local
        dense factorization and one psum round an iteration, unless the
        partition is past the Schur limits (dense closure clusters make
        every endpoint of a cross-chunk edge a separator); then the
        matrix-free PCG over the same mesh."""
        from icp_tpu_torch.parallel.dist_pose_graph import (
            optimize_schur, partition_graph, schur_within_limits)
        nodes, nm, ei, ej, z, om, em, rb = self._packed()
        part = partition_graph(nodes.shape[0], ei, ej, z, om, em,
                               self._mesh.size, int(fix_node), robust=rb)
        if not schur_within_limits(
                part, max_separators=self._max_separators,
                cg_node_threshold=self._cg_node_threshold,
                dense_budget=self._schur_dense_budget):
            return self._optimize_cg(n_iterations, fix_node,
                                     convergence_eps, mesh=self._mesh,
                                     damping=damping)
        self.last_strategy = "schur"
        d0 = self._mesh.devices[0]
        out, it = optimize_schur(
            self._mesh, torch.as_tensor(nodes, device=d0),
            torch.as_tensor(nm, device=d0), part,
            n_iterations=int(n_iterations), convergence_eps=convergence_eps,
            robust_phi=float(self.robust_phi), damping=float(damping))
        self.last_iterations += it
        self._store(out)

    # ── accessors ────────────────────────────────────────────────────────
    def get_poses_as_matrices(self):
        return [vec_to_pose_np([float(v[0]), float(v[1]), float(v[2])],
                               np.float32) for v in self._nodes]

    def total_error(self) -> float:
        if self.n_edges == 0:
            return 0.0
        with spans.span("pose_graph.total_error"):
            nodes, _, ei, ej, z, om, em, _ = self._packed_device()
            spans.count("sync.pose_graph.chi2")
            return float(total_error(nodes, ei, ej, z, om, em))
