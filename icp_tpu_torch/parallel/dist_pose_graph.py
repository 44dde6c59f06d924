"""Matrix-free pose-graph Gauss-Newton on one device (the single-device part
of icp_tpu.parallel.dist_pose_graph: ``_inv3x3``, the PCG step of
``gn_step_cg_sharded`` as ``gn_step_cg``, and ``optimize_cg``).

Each GN step solves H dx = -b by block-Jacobi preconditioned CG without
forming H: a product Hx is one gather / compute / scatter over the edges,
so memory is O(edges) where the dense solve needs (3n)^2. icp_tpu shards
the edges over a mesh and psums the partial products; here all edges live
on one device, so every psum is the identity. The mesh, the Schur step and
``partition_graph`` are not ported yet (ROADMAP Queue 1, parallel/).
"""
from __future__ import annotations

import torch

from icp_tpu_torch.models.pose_graph import edge_terms, robust_omega
from icp_tpu_torch.utils.se2 import wrap_angle


def _apply_update(nodes, node_mask, dx):
    dxr = dx.reshape(nodes.shape[0], 3)
    new = torch.stack([nodes[:, 0] + dxr[:, 0], nodes[:, 1] + dxr[:, 1],
                       wrap_angle(nodes[:, 2] + dxr[:, 2])], dim=-1)
    return torch.where(node_mask[:, None], new, nodes)


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


def gn_step_cg(nodes, node_mask, ei, ej, z, omega, edge_mask, fix_node,
               robust_mask=None, robust_phi=1.0, damping=0.0, *,
               cg_iters: int = 50):
    """One matrix-free GN step: ``cg_iters`` iterations of block-Jacobi
    preconditioned CG (a fixed count, as icp_tpu's ``lax.scan``).
    ``robust_mask`` flags edges for DCS reweighting; ``damping`` > 0 is the
    Levenberg-Marquardt scaling (H + damping diag(H)), applied inside Hx and
    to the preconditioner blocks. Returns the updated nodes."""
    n = nodes.shape[0]
    dev, f32 = nodes.device, nodes.dtype
    if robust_mask is None:
        robust_mask = torch.zeros(ei.shape[0], dtype=torch.bool, device=dev)
    e, A, B = edge_terms(nodes, ei, ej, z, omega, edge_mask)
    om = robust_omega(e, omega, robust_mask, robust_phi)
    om = om * edge_mask.to(f32)[:, None, None]
    AtO = torch.einsum("eij,eik->ejk", A, om)
    BtO = torch.einsum("eij,eik->ejk", B, om)

    free = node_mask & (torch.arange(n, device=dev) != int(fix_node))
    freec = free[:, None]

    # rhs: -b, projected to the free nodes
    b = torch.zeros((n, 3), dtype=f32, device=dev)
    b.index_add_(0, ei, torch.einsum("ejk,ek->ej", AtO, e))
    b.index_add_(0, ej, torch.einsum("ejk,ek->ej", BtO, e))
    rhs = torch.where(freec, -b, 0.0)

    # block diagonal of H for the preconditioner, LM-damped like H
    Dblk = torch.zeros((n, 3, 3), dtype=f32, device=dev)
    Dblk.index_add_(0, ei, torch.einsum("ejk,ekl->ejl", AtO, A))
    Dblk.index_add_(0, ej, torch.einsum("ejk,ekl->ejl", BtO, B))
    eye3 = torch.eye(3, dtype=f32, device=dev)
    Dblk = Dblk + eye3 * 1e-8
    dvec = torch.diagonal(Dblk, dim1=-2, dim2=-1)              # (n, 3)
    Minv = _inv3x3(Dblk + damping * dvec[:, :, None] * eye3)

    def Hx(x):
        # per edge s = A x_i + B x_j; y_i += A^T om s, y_j += B^T om s
        xp = torch.where(freec, x, 0.0)
        s = (torch.einsum("ejk,ek->ej", A, xp[ei])
             + torch.einsum("ejk,ek->ej", B, xp[ej]))
        oms = torch.einsum("ejk,ek->ej", om, s)
        y = torch.zeros_like(x)
        y.index_add_(0, ei, torch.einsum("ekj,ek->ej", A, oms))
        y.index_add_(0, ej, torch.einsum("ekj,ek->ej", B, oms))
        y = y + damping * dvec * xp          # (H + damping diag(H)) x
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
    return _apply_update(nodes, node_mask, dx)


def optimize_cg(nodes, node_mask, ei, ej, z, omega, edge_mask,
                fix_node: int = 0, *, n_iterations: int = 20,
                convergence_eps=1e-6, cg_iters: int = 100,
                robust_mask=None, robust_phi: float = 1.0,
                damping: float = 0.0):
    """Full Gauss-Newton through ``gn_step_cg``: stops after
    ``n_iterations`` or when the masked step norm falls below
    ``convergence_eps`` (read on the host once per step, as icp_tpu does).
    Tensors as for ``models.pose_graph.optimize_dense``. Returns (nodes,
    iterations run)."""
    it = 0
    for it in range(1, n_iterations + 1):
        new = gn_step_cg(nodes, node_mask, ei, ej, z, omega, edge_mask,
                         fix_node, robust_mask, robust_phi, damping,
                         cg_iters=cg_iters)
        dn = float(torch.linalg.norm(
            torch.where(node_mask[:, None], new - nodes, 0.0)))
        nodes = new
        if dn < convergence_eps:
            break
    return nodes, it
