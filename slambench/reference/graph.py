"""Plain 2-D pose-graph least squares for the checks.

Nodes are [x, y, theta]; an edge (i, j, z, omega) measures node j in node
i's frame, e = [R_i^T (t_j - t_i) - z_xy, wrap(theta_j - theta_i - z_th)],
and the solve minimises sum e^T omega e with node ``fix`` held, by
Gauss-Newton on a dense system with analytic Jacobians, until the
step is below ``eps``. Imports nothing of ``icp_tpu_torch``.
"""
from __future__ import annotations

import math

import torch


def wrap(a):
    return torch.remainder(a + math.pi, 2 * math.pi) - math.pi


def relative(pi, pj):
    """z of an edge from pose i to pose j, both [x, y, theta]."""
    c, s = torch.cos(pi[2]), torch.sin(pi[2])
    d = pj[:2] - pi[:2]
    return torch.stack([c * d[0] + s * d[1], -s * d[0] + c * d[1],
                        wrap(pj[2] - pi[2])])


def solve(nodes, edges, *, fix: int = 0, iters: int = 50,
          eps: float = 1e-10):
    """``nodes`` (N, 3); ``edges`` [(i, j, z (3,), omega (3, 3))]. Returns
    the optimised (N, 3) nodes."""
    x = nodes.clone()
    n = x.shape[0]
    dt = x.dtype
    ei = torch.tensor([e[0] for e in edges], device=x.device)
    ej = torch.tensor([e[1] for e in edges], device=x.device)
    z = torch.stack([e[2] for e in edges]).to(dt)
    om = torch.stack([e[3] for e in edges]).to(dt)
    for _ in range(iters):
        xi, xj = x[ei], x[ej]
        c, s = torch.cos(xi[:, 2]), torch.sin(xi[:, 2])
        d = xj[:, :2] - xi[:, :2]
        e = torch.stack([c * d[:, 0] + s * d[:, 1] - z[:, 0],
                         -s * d[:, 0] + c * d[:, 1] - z[:, 1],
                         wrap(xj[:, 2] - xi[:, 2] - z[:, 2])], 1)
        zero, one = torch.zeros_like(c), torch.ones_like(c)
        A = torch.stack([
            torch.stack([-c, -s, -s * d[:, 0] + c * d[:, 1]], 1),
            torch.stack([s, -c, -c * d[:, 0] - s * d[:, 1]], 1),
            torch.stack([zero, zero, -one], 1)], 1)
        B = torch.stack([torch.stack([c, s, zero], 1),
                         torch.stack([-s, c, zero], 1),
                         torch.stack([zero, zero, one], 1)], 1)
        H = torch.zeros((3 * n, 3 * n), dtype=dt, device=x.device)
        b = torch.zeros(3 * n, dtype=dt, device=x.device)
        for J1, k1 in ((A, ei), (B, ej)):
            b.index_add_(0, (3 * k1[:, None] + torch.arange(3, device=x.device)
                             ).reshape(-1),
                         torch.einsum("eji,ejk,ek->ei", J1, om, e).reshape(-1))
            for J2, k2 in ((A, ei), (B, ej)):
                blk = torch.einsum("eji,ejk,ekl->eil", J1, om, J2)
                r = 3 * k1[:, None, None] + torch.arange(3, device=x.device
                                                         )[None, :, None]
                cidx = 3 * k2[:, None, None] + torch.arange(3, device=x.device
                                                            )[None, None, :]
                H.index_put_((r.expand_as(blk).reshape(-1),
                              cidx.expand_as(blk).reshape(-1)),
                             blk.reshape(-1), accumulate=True)
        keep = torch.ones(3 * n, dtype=torch.bool, device=x.device)
        keep[3 * fix:3 * fix + 3] = False
        dx = torch.zeros(3 * n, dtype=dt, device=x.device)
        dx[keep] = _solve(H[keep][:, keep], -b[keep])
        x = x + dx.reshape(n, 3)
        x[:, 2] = wrap(x[:, 2])
        if float(dx.abs().max()) < eps:
            break
    return x


def _solve(H, g):
    if H.dtype in (torch.float32, torch.float64):
        return torch.linalg.solve(H, g)
    # bfloat16 / float16 have no LU here: solve on their values in float32
    # (least squares where their rounding left the system singular) and
    # round the step back
    Hf, gf = H.float(), g.float()
    x, info = torch.linalg.solve_ex(Hf, gf)
    if int(info) != 0 or not bool(torch.isfinite(x).all()):
        x = torch.linalg.lstsq(Hf.cpu(), gf.cpu()[:, None]).solution[:, 0]
    return x.to(H.device, H.dtype)
