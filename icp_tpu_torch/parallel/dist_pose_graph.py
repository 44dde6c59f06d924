"""Distributed SE(2) pose-graph Gauss-Newton (counterpart of
icp_tpu.parallel.dist_pose_graph).

The normal equations H dx = -b are a sum over edges, so edges split over
the mesh's shards and per-shard partial sums combine with ``Mesh.psum``:

* ``gn_step_sharded``: each shard assembles the dense H and b of its
  edges, one psum, one dense solve;
* ``gn_step_cg_sharded``: block-Jacobi preconditioned CG without forming H;
  each product Hx is an edge gather / compute / scatter on every shard and
  a psum. ``gn_step_cg`` is its one-shard case;
* ``gn_step_schur_sharded``: the exact solve by Schur-complement reduction.
  Keyframes split into contiguous chunks (``partition_graph``, host NumPy,
  equal array for array to icp_tpu's); the separators are the endpoints of
  cross-chunk edges and the anchor. Each shard factors its interior block
  H_II once against [H_IS | b_I], the reduced separator system is psummed
  and solved once, and the interiors back-substitute.

A sharded step loops over the local shards, queues each shard's work on
its device, then reduces; the replicated solves run once, on the mesh's
first device. Results match icp_tpu's to f32 rounding (psum sums in shard
order, XLA in its own). icp_tpu's ``_schur_step_cached`` and
``_cg_step_cached`` are jit caches and have no counterpart: the port runs
eagerly.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from icp_tpu_torch.models.pose_graph import (ANCHOR_WEIGHT, _block_products,
                                             _scatter_dense, edge_terms,
                                             robust_omega)
from icp_tpu_torch.ops.scatter import ordered_index_add_
from icp_tpu_torch.parallel.mesh import Mesh
from icp_tpu_torch.utils.se2 import wrap_angle


def _apply_update(nodes, node_mask, dx):
    dxr = dx.reshape(nodes.shape[0], 3)
    new = torch.stack([nodes[:, 0] + dxr[:, 0], nodes[:, 1] + dxr[:, 1],
                       wrap_angle(nodes[:, 2] + dxr[:, 2])], dim=-1)
    return torch.where(node_mask[:, None], new, nodes)


def _solve(A, B):
    """``jnp.linalg.solve``: an LU solve whose singular case gives NaN
    (solve_ex flags it in ``info`` without a host sync)."""
    X, info = torch.linalg.solve_ex(A, B)
    return torch.where(info != 0, float("nan"), X)


def _inv3x3(M):
    """Batched closed-form 3x3 inverse (block-Jacobi preconditioner);
    identity where |det| <= 1e-12."""
    c0 = torch.linalg.cross(M[..., :, 1], M[..., :, 2], dim=-1)
    c1 = torch.linalg.cross(M[..., :, 2], M[..., :, 0], dim=-1)
    c2 = torch.linalg.cross(M[..., :, 0], M[..., :, 1], dim=-1)
    det = (M[..., :, 0] * c0).sum(-1)[..., None, None]
    adj = torch.stack([c0, c1, c2], dim=-2)          # rows of adjugate^T
    ok = det.abs() > 1e-12
    inv = adj / torch.where(ok, det, 1.0)
    eye = torch.eye(3, dtype=M.dtype, device=M.device).expand(M.shape)
    return torch.where(ok, inv, eye)


def _edge_shards(mesh, *arrays):
    """Split each edge array over the mesh: one tuple per local shard."""
    return list(zip(*(mesh.split(a) for a in arrays)))


def gn_step_sharded(mesh: Mesh, nodes, node_mask, ei, ej, z, omega,
                    edge_mask, fix_node, *, axis: str = "d"):
    """One dense GN step with the edges split over the mesh (their count a
    multiple of the mesh size; pad with masked edges). nodes (N, 3) and
    node_mask come in whole; returns the updated nodes on the mesh's first
    device."""
    del axis
    n = nodes.shape[0]
    Hs, bs = [], []
    for dev, (lei, lej, lz, lom, lem) in zip(
            mesh.devices, _edge_shards(mesh, ei, ej, z, omega, edge_mask)):
        nd = nodes.to(dev)
        e, A, B = edge_terms(nd, lei, lej, lz, lom, lem)
        H, b = _scatter_dense(n, lei, lej,
                              *_block_products(e, A, B, lom, lem))
        Hs.append(H)
        bs.append(b)
    d0 = mesh.devices[0]
    H, b = mesh.psum(Hs)[0], mesh.psum(bs)[0]
    nd, nm = nodes.to(d0), node_mask.to(d0)
    anchor = (torch.arange(3 * n, device=d0) // 3) == int(fix_node)
    H = torch.where(anchor[:, None] | anchor[None, :], 0.0, H)
    H = H + torch.diag(torch.where(anchor, ANCHOR_WEIGHT, 0.0)
                       + torch.where(torch.repeat_interleave(~nm, 3), 1.0, 0.0)
                       ).to(H.dtype)
    b = torch.where(anchor, 0.0, b)
    dx = _solve(H, -b)
    dx = torch.where(torch.isfinite(dx), dx, 0.0)
    return _apply_update(nd, nm, dx)


def gn_step_cg_sharded(mesh: Mesh, nodes, node_mask, ei, ej, z, omega,
                       edge_mask, fix_node, robust_mask=None,
                       robust_phi=1.0, damping=0.0, *, axis: str = "d",
                       cg_iters: int = 50, cg_tol=1e-8):
    """One matrix-free GN step: ``cg_iters`` iterations (a fixed count, as
    icp_tpu's ``lax.scan``; ``cg_tol`` is accepted and unused there too) of
    block-Jacobi preconditioned CG over psum-combined edge shards.
    ``robust_mask`` flags edges for DCS reweighting; ``damping`` > 0 is the
    Levenberg-Marquardt scaling (H + damping diag(H)), applied inside Hx
    and to the preconditioner blocks. Returns the updated nodes on the
    mesh's first device."""
    del axis, cg_tol
    n = nodes.shape[0]
    d0 = mesh.devices[0]
    if robust_mask is None:
        robust_mask = torch.zeros(ei.shape[0], dtype=torch.bool,
                                  device=ei.device)
    shards = []            # per shard: (ei, ej, A, B, om)
    bs, Ds = [], []
    for dev, (lei, lej, lz, lom, lem, lrb) in zip(
            mesh.devices, _edge_shards(mesh, ei, ej, z, omega, edge_mask,
                                       robust_mask)):
        nd = nodes.to(dev)
        e, A, B = edge_terms(nd, lei, lej, lz, lom, lem)
        om = robust_omega(e, lom, lrb, robust_phi)
        om = om * lem.to(nd.dtype)[:, None, None]
        AtO = torch.einsum("eij,eik->ejk", A, om)
        BtO = torch.einsum("eij,eik->ejk", B, om)
        # every add below goes to the nodes i then j of each edge: sort
        # [ei, ej] once; the ordered sums give the bits of an index_add_
        # at ei followed by one at ej
        sidx, perm = torch.sort(torch.cat([lei, lej]), stable=True)
        b = torch.zeros((n, 3), dtype=nd.dtype, device=dev)
        ordered_index_add_(b, sidx, torch.cat([
            torch.einsum("ejk,ek->ej", AtO, e),
            torch.einsum("ejk,ek->ej", BtO, e)])[perm], sorted_index=True)
        Dblk = torch.zeros((n, 3, 3), dtype=nd.dtype, device=dev)
        ordered_index_add_(Dblk, sidx, torch.cat([
            torch.einsum("ejk,ekl->ejl", AtO, A),
            torch.einsum("ejk,ekl->ejl", BtO, B)])[perm], sorted_index=True)
        shards.append((lei, lej, A, B, om, sidx, perm))
        bs.append(b)
        Ds.append(Dblk)

    nd, nm = nodes.to(d0), node_mask.to(d0)
    f32 = nd.dtype
    free = nm & (torch.arange(n, device=d0) != int(fix_node))
    freec = free[:, None]
    rhs = torch.where(freec, -mesh.psum(bs)[0], 0.0)
    eye3 = torch.eye(3, dtype=f32, device=d0)
    Dblk = mesh.psum(Ds)[0] + eye3 * 1e-8
    dvec = torch.diagonal(Dblk, dim1=-2, dim2=-1)              # (n, 3)
    Minv = _inv3x3(Dblk + damping * dvec[:, :, None] * eye3)

    def Hx(x):
        # per edge s = A x_i + B x_j; y_i += A^T om s, y_j += B^T om s
        xp = torch.where(freec, x, 0.0)
        ys = []
        for xs, (lei, lej, A, B, om, sidx, perm) in zip(mesh.replicate(xp),
                                                        shards):
            s = (torch.einsum("ejk,ek->ej", A, xs[lei])
                 + torch.einsum("ejk,ek->ej", B, xs[lej]))
            oms = torch.einsum("ejk,ek->ej", om, s)
            y = torch.zeros_like(xs)
            ordered_index_add_(y, sidx, torch.cat([
                torch.einsum("ekj,ek->ej", A, oms),
                torch.einsum("ekj,ek->ej", B, oms)])[perm], sorted_index=True)
            ys.append(y)
        y = mesh.psum(ys)[0] + damping * dvec * xp   # (H + damping diag(H)) x
        return torch.where(freec, y, 0.0)

    def precond(r):
        return torch.einsum("njk,nk->nj", Minv, r) * freec

    x = torch.zeros_like(rhs)
    r = rhs
    p = precond(r)
    rz = (r * p).sum()
    for _ in range(cg_iters):
        Hp = Hx(p)
        denom = (p * Hp).sum()
        alpha = torch.where(denom.abs() > 1e-20, rz / denom, 0.0)
        x = x + alpha * p
        r = r - alpha * Hp
        zz = precond(r)
        rz_new = (r * zz).sum()
        beta = torch.where(rz.abs() > 1e-20, rz_new / rz, 0.0)
        p = zz + beta * p
        rz = rz_new
    dx = x.reshape(-1)
    dx = torch.where(torch.isfinite(dx), dx, 0.0)
    return _apply_update(nd, nm, dx)


def gn_step_cg(nodes, node_mask, ei, ej, z, omega, edge_mask, fix_node,
               robust_mask=None, robust_phi=1.0, damping=0.0, *,
               cg_iters: int = 50):
    """``gn_step_cg_sharded`` on a one-shard mesh on the nodes' device."""
    return gn_step_cg_sharded(Mesh((nodes.device,)), nodes, node_mask, ei,
                              ej, z, omega, edge_mask, fix_node, robust_mask,
                              robust_phi, damping, cg_iters=cg_iters)


class SchurPartition(NamedTuple):
    """Host-computed graph partition for ``gn_step_schur_sharded``.

    Keyframes split into ``n_dev`` contiguous chunks; separators are the
    endpoints of cross-chunk edges plus the anchor node. Each edge lives on
    the shard that owns its interior endpoint (separator-separator edges on
    the first endpoint's chunk), so every interior Hessian block is complete
    locally. The (D, ...) arrays are padded to uniform capacities, each
    rounded up to a power of two as in icp_tpu.
    """
    int_ids: np.ndarray    # (D, i_cap) int32 global ids, n = padding
    int_valid: np.ndarray  # (D, i_cap) bool
    sep_ids: np.ndarray    # (s_cap,) int32 global separator ids (padded)
    sep_valid: np.ndarray  # (s_cap,) bool
    lei: np.ndarray        # (D, e_cap) int32 global i endpoint
    lej: np.ndarray        # (D, e_cap) int32 global j endpoint
    lei_loc: np.ndarray    # (D, e_cap) int32 unified local index of i
    lej_loc: np.ndarray    # (D, e_cap) int32 unified local index of j
    z: np.ndarray          # (D, e_cap, 3)
    omega: np.ndarray      # (D, e_cap, 3, 3)
    edge_mask: np.ndarray  # (D, e_cap) bool
    robust: np.ndarray     # (D, e_cap) bool: DCS-reweighted edges
    fix_sep_pos: int       # anchor's position in sep_ids


def partition_graph(n: int, ei, ej, z, omega, edge_mask, n_dev: int,
                    fix_node: int, robust=None) -> SchurPartition:
    """Partition a pose graph for the distributed Schur solve (host NumPy,
    once per optimize call). ``robust``: optional (E,) bool DCS flags,
    re-bucketed with the edges."""
    ei = np.asarray(ei, np.int64)
    ej = np.asarray(ej, np.int64)
    em = np.asarray(edge_mask, bool)
    z = np.asarray(z, np.float32)
    om = np.asarray(omega, np.float32)
    rb = (np.zeros(len(ei), bool) if robust is None
          else np.asarray(robust, bool))

    chunk = -(-n // n_dev)                       # ceil
    dev_of = np.minimum(np.arange(n) // chunk, n_dev - 1)

    cross = em & (dev_of[ei] != dev_of[ej])
    sep = np.unique(np.concatenate(
        [ei[cross], ej[cross], np.array([fix_node], np.int64)]))
    sep_pos = np.full(n, -1, np.int64)
    sep_pos[sep] = np.arange(len(sep))
    is_sep = sep_pos >= 0

    def _pow2(x, lo=1):
        return max(lo, 1 << max(0, int(x) - 1).bit_length())

    int_lists = []
    int_pos = np.full(n, -1, np.int64)           # position in own shard list
    for d in range(n_dev):
        ids = np.where((dev_of == d) & ~is_sep)[0]
        int_pos[ids] = np.arange(len(ids))
        int_lists.append(ids)
    i_cap = _pow2(max(len(x) for x in int_lists))
    int_ids = np.full((n_dev, i_cap), n, np.int32)
    int_valid = np.zeros((n_dev, i_cap), bool)
    for d, ids in enumerate(int_lists):
        int_ids[d, :len(ids)] = ids
        int_valid[d, :len(ids)] = True

    # edge -> shard of its interior endpoint (sep-sep: first endpoint)
    e_dev = np.where(~is_sep[ei], dev_of[ei],
                     np.where(~is_sep[ej], dev_of[ej], dev_of[ei]))

    def uloc(node):
        return np.where(is_sep[node], i_cap + sep_pos[node], int_pos[node])

    buckets = [np.where(em & (e_dev == d))[0] for d in range(n_dev)]
    e_cap = _pow2(max(len(b) for b in buckets))
    lei = np.zeros((n_dev, e_cap), np.int32)
    lej = np.zeros((n_dev, e_cap), np.int32)
    lei_loc = np.zeros((n_dev, e_cap), np.int32)
    lej_loc = np.zeros((n_dev, e_cap), np.int32)
    lz = np.zeros((n_dev, e_cap, 3), np.float32)
    lom = np.zeros((n_dev, e_cap, 3, 3), np.float32)
    lem = np.zeros((n_dev, e_cap), bool)
    lrb = np.zeros((n_dev, e_cap), bool)
    for d, b in enumerate(buckets):
        k = len(b)
        lei[d, :k] = ei[b]
        lej[d, :k] = ej[b]
        lei_loc[d, :k] = uloc(ei[b])
        lej_loc[d, :k] = uloc(ej[b])
        lz[d, :k] = z[b]
        lom[d, :k] = om[b]
        lem[d, :k] = True
        lrb[d, :k] = rb[b]

    s_raw = len(sep)
    s_cap = _pow2(s_raw)
    sep_ids = np.zeros(s_cap, np.int32)
    sep_ids[:s_raw] = sep
    sep_valid = np.zeros(s_cap, bool)
    sep_valid[:s_raw] = True
    return SchurPartition(int_ids, int_valid, sep_ids, sep_valid,
                          lei, lej, lei_loc, lej_loc, lz, lom, lem, lrb,
                          int(sep_pos[fix_node]))


def gn_step_schur_sharded(mesh: Mesh, nodes, node_mask,
                          part: SchurPartition, robust_phi=1.0,
                          damping=0.0, *, axis: str = "d"):
    """One exact GN step by distributed Schur-complement reduction.

    Per shard: assemble the local (interior + separator) normal equations
    from its edge bucket, factor H_II once against [H_IS | b_I] (back-
    substitution is then a product, not a second solve); psum the reduced
    separator system S and its rhs r; solve it once; back-substitute.
    ``part`` must be partitioned for ``mesh.size`` shards. Returns the
    updated nodes on the mesh's first device."""
    del axis
    if part.int_ids.shape[0] != mesh.size:
        raise ValueError(f"partition for {part.int_ids.shape[0]} shards, "
                         f"mesh of {mesh.size}")
    n = nodes.shape[0]
    i_cap = part.int_ids.shape[1]
    s = len(part.sep_ids)
    nl = i_cap + s
    k = 3 * i_cap
    d0 = mesh.devices[0]
    i64 = torch.int64
    sep_ids = torch.as_tensor(part.sep_ids, dtype=i64, device=d0)
    sep_valid = torch.as_tensor(part.sep_valid, device=d0)

    local, Ss, rs = [], [], []
    for j, dev in enumerate(mesh.devices):
        g = mesh.axis_index(j)
        t = lambda a, dt=None: torch.as_tensor(a[g], dtype=dt,  # noqa: E731
                                               device=dev)
        int_ids, int_valid = t(part.int_ids, i64), t(part.int_valid)
        lei, lej = t(part.lei, i64), t(part.lej, i64)
        lei_loc, lej_loc = t(part.lei_loc, i64), t(part.lej_loc, i64)
        lz, lom, lem, lrb = (t(part.z), t(part.omega), t(part.edge_mask),
                             t(part.robust))
        nd, nm = nodes.to(dev), node_mask.to(dev)

        e, A, B = edge_terms(nd, lei, lej, lz, lom, lem)
        lom = robust_omega(e, lom, lrb, robust_phi)
        H, b = _scatter_dense(nl, lei_loc, lej_loc,
                              *_block_products(e, A, B, lom, lem))
        # padded slots and invalid nodes get an identity diagonal (their
        # rhs is zero, so their dx is zero)
        nm_pad = torch.cat([nm, torch.zeros(1, dtype=torch.bool,
                                            device=dev)])  # id n = padding
        int_reg = ~(int_valid & nm_pad[int_ids])
        diag = torch.zeros(3 * nl, dtype=H.dtype, device=dev)
        diag[:k] = torch.repeat_interleave(int_reg, 3).to(H.dtype)
        H = H + torch.diag(diag)
        # LM scaling: interior diagonals are complete locally, and the
        # separator block's partial diagonals sum to the global one under
        # the psum, so a local damping * diag(H) is exact
        H = H + torch.diag(damping * torch.diagonal(H))

        H_II, H_IS, H_SS = H[:k, :k], H[:k, k:], H[k:, k:]
        b_I, b_S = b[:k], b[k:]
        X = _solve(H_II, torch.cat([H_IS, b_I[:, None]], 1))
        X_IS, x_b = X[:, :-1], X[:, -1]
        Ss.append(H_SS - H_IS.T @ X_IS)
        rs.append(b_S - H_IS.T @ x_b)
        local.append((int_ids, int_valid, X_IS, x_b))
    S, r = mesh.psum(Ss)[0], mesh.psum(rs)[0]

    # anchor clamp on the reduced system (reference pose_graph.py:109-114)
    nm0 = node_mask.to(d0)
    a = (torch.arange(3 * s, device=d0) // 3) == part.fix_sep_pos
    # padded separator slots route through the sentinel node row n (masked,
    # identity diagonal, zero rhs), so their dx is discarded
    nm_pad = torch.cat([nm0, torch.zeros(1, dtype=torch.bool, device=d0)])
    uid = torch.where(sep_valid, sep_ids, n)
    sep_bad = torch.repeat_interleave(~(nm_pad[uid] & sep_valid), 3)
    S = torch.where(a[:, None] | a[None, :], 0.0, S)
    S = S + torch.diag(torch.where(a, ANCHOR_WEIGHT, 0.0)
                       + torch.where(sep_bad, 1.0, 0.0)).to(S.dtype)
    r = torch.where(a, 0.0, r)
    dx_S = _solve(S, -r)

    parts = []
    for dev, dxs, (int_ids, int_valid, X_IS, x_b) in zip(
            mesh.devices, mesh.replicate(dx_S), local):
        dx_I = -(X_IS @ dxs + x_b)            # = H_II^-1 (-b_I - H_IS dx_S)
        dx = torch.zeros((n + 1, 3), dtype=dx_I.dtype, device=dev)
        ordered_index_add_(dx, int_ids,
                           dx_I.reshape(i_cap, 3) * int_valid[:, None])
        parts.append(dx)
    dx = mesh.psum(parts)[0]
    dx[uid] = dx_S.reshape(s, 3)
    dx = dx[:n].reshape(-1)
    dx = torch.where(torch.isfinite(dx), dx, 0.0)
    return _apply_update(nodes.to(d0), nm0, dx)


def schur_within_limits(part: SchurPartition, *, max_separators: int,
                        cg_node_threshold: int, dense_budget: int) -> bool:
    """The Schur-or-PCG choice shared by PoseGraph2D._optimize_distributed
    and ScaledPipeline.time_gn_step, so the timed strategy is the one that
    runs: Schur unless the separators, the interior capacity or the
    per-shard dense block (3 (i_cap + s))^2 f32 exceed their limits."""
    sep_count = int(np.sum(part.sep_valid))
    i_cap = int(part.int_ids.shape[1])
    s_cap = int(part.sep_ids.shape[0])
    dense_bytes = (3 * (i_cap + s_cap)) ** 2 * 4
    return not (sep_count > max_separators
                or i_cap > cg_node_threshold
                or dense_bytes > dense_budget)


def _pad_edges(mesh, ei, ej, z, omega, edge_mask, robust_mask):
    """Pad the edge arrays with masked edges to a multiple of the mesh
    size."""
    pad = (-ei.shape[0]) % mesh.size
    if not pad:
        return ei, ej, z, omega, edge_mask, robust_mask
    return tuple(torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
                 for a in (ei, ej, z, omega, edge_mask, robust_mask))


def _converge(step, nodes, node_mask, n_iterations, convergence_eps):
    """Run ``step`` until ``n_iterations`` or the masked step norm falls
    below ``convergence_eps`` (read on the host once a step, as icp_tpu).
    Returns (nodes, iterations run)."""
    it = 0
    for it in range(1, n_iterations + 1):
        new = step(nodes)
        dn = float(torch.linalg.norm(
            torch.where(node_mask[:, None], new - nodes, 0.0)))
        nodes = new
        if dn < convergence_eps:
            break
    return nodes, it


def optimize_cg(mesh: Mesh, nodes, node_mask, ei, ej, z, omega, edge_mask,
                fix_node: int = 0, *, n_iterations: int = 20,
                convergence_eps=1e-6, cg_iters: int = 100, axis: str = "d",
                robust_mask=None, robust_phi: float = 1.0,
                damping: float = 0.0):
    """Full Gauss-Newton through ``gn_step_cg_sharded``: the O(edges) path
    where the dense or Schur solve stops being cheap. Tensors as for
    ``models.pose_graph.optimize_dense``; the edges are padded here to a
    multiple of the mesh size. Returns (nodes on the mesh's first device,
    iterations run)."""
    del axis
    if robust_mask is None:
        robust_mask = torch.zeros(ei.shape[0], dtype=torch.bool,
                                  device=ei.device)
    ei, ej, z, omega, edge_mask, robust_mask = _pad_edges(
        mesh, ei, ej, z, omega, edge_mask, robust_mask)
    nm = node_mask.to(mesh.devices[0])
    return _converge(
        lambda nd: gn_step_cg_sharded(
            mesh, nd, nm, ei, ej, z, omega, edge_mask, fix_node, robust_mask,
            robust_phi, damping, cg_iters=cg_iters),
        nodes.to(mesh.devices[0]), nm, n_iterations, convergence_eps)


def optimize_schur(mesh: Mesh, nodes, node_mask, part: SchurPartition, *,
                   n_iterations: int = 20, convergence_eps=1e-6,
                   axis: str = "d", robust_phi: float = 1.0,
                   damping: float = 0.0):
    """Full Gauss-Newton through ``gn_step_schur_sharded``. The partition
    depends only on the graph's topology, so one ``partition_graph`` serves
    every iteration. Stops as ``optimize_cg``. Returns (nodes, iterations
    run)."""
    del axis
    nm = node_mask.to(mesh.devices[0])
    return _converge(
        lambda nd: gn_step_schur_sharded(mesh, nd, nm, part, robust_phi,
                                         damping),
        nodes.to(mesh.devices[0]), nm, n_iterations, convergence_eps)
