"""Plain 2-D pose-graph Gauss-Newton with Dynamic Covariance Scaling (DCS)
on flagged edges, for the checks of a bundle adjustment.

Nodes are [x, y, theta]; an edge (i, j, z, omega) measures node j in node
i's frame, e = [R_i^T (t_j - t_i) - z_xy, wrap(theta_j - theta_i - z_th)]
(as ``graph.py``). Each iteration minimises sum s_e^2 e^T omega e with node
``fix`` held, where for a flagged (robust) edge s = min(1, 2 phi / (phi +
chi2)), chi2 = e^T omega e at the current estimate (Agarwal et al., "Robust
Map Optimization using Dynamic Covariance Scaling", ICRA 2013), and s = 1
for every other edge. A flagged edge's information is first capped at
``cap`` (each entry of omega at most ``cap``; 0: no cap), the closure
weight's upper limit. The loop runs ``iters`` iterations, stopping after
one whose step has a Euclidean norm under ``eps``. Dense system, analytic
Jacobians, any torch dtype; imports nothing of ``icp_tpu_torch``.
"""
from __future__ import annotations

import torch

from slambench.reference.graph import _solve, wrap

# the checks compare float64 sums: no reduced-precision matmuls
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def dcs_scale(chi2, phi: float):
    """DCS's scale of an edge of error ``chi2``: min(1, 2 phi / (phi +
    chi2))."""
    return torch.clamp(2.0 * phi / (phi + chi2), max=1.0)


def solve(nodes, ei, ej, z, omega, robust, *, phi: float = 1.0,
          cap: float = 0.0, fix: int = 0, iters: int = 10,
          eps: float = 1e-6):
    """``nodes`` (N, 3); edges as ``ei``, ``ej`` (E,) int, ``z`` (E, 3),
    ``omega`` (E, 3, 3), ``robust`` (E,) bool. Returns (the optimised
    (N, 3) nodes, iterations run)."""
    x = nodes.clone()
    n, dt, dev = x.shape[0], x.dtype, x.device
    ei = torch.as_tensor(ei, dtype=torch.int64, device=dev)
    ej = torch.as_tensor(ej, dtype=torch.int64, device=dev)
    z = torch.as_tensor(z, device=dev).to(dt)
    om = torch.as_tensor(omega, device=dev).to(dt)
    rb = torch.as_tensor(robust, dtype=torch.bool, device=dev)
    if cap > 0:
        om = torch.where(rb[:, None, None], om.clamp(max=cap), om)
    r3 = torch.arange(3, device=dev)
    keep = torch.ones(3 * n, dtype=torch.bool, device=dev)
    keep[3 * fix:3 * fix + 3] = False
    it = 0
    while it < iters:
        xi, xj = x[ei], x[ej]
        c, s = torch.cos(xi[:, 2]), torch.sin(xi[:, 2])
        d = xj[:, :2] - xi[:, :2]
        e = torch.stack([c * d[:, 0] + s * d[:, 1] - z[:, 0],
                         -s * d[:, 0] + c * d[:, 1] - z[:, 1],
                         wrap(xj[:, 2] - xi[:, 2] - z[:, 2])], 1)
        chi2 = torch.einsum("ei,eij,ej->e", e, om, e)
        sc = torch.where(rb, dcs_scale(chi2, phi), torch.ones_like(chi2))
        w = om * (sc * sc)[:, None, None]
        zero, one = torch.zeros_like(c), torch.ones_like(c)
        A = torch.stack([
            torch.stack([-c, -s, -s * d[:, 0] + c * d[:, 1]], 1),
            torch.stack([s, -c, -c * d[:, 0] - s * d[:, 1]], 1),
            torch.stack([zero, zero, -one], 1)], 1)
        B = torch.stack([torch.stack([c, s, zero], 1),
                         torch.stack([-s, c, zero], 1),
                         torch.stack([zero, zero, one], 1)], 1)
        H = torch.zeros((3 * n, 3 * n), dtype=dt, device=dev)
        b = torch.zeros(3 * n, dtype=dt, device=dev)
        for J1, k1 in ((A, ei), (B, ej)):
            rows = 3 * k1[:, None] + r3
            b.index_add_(0, rows.reshape(-1),
                         torch.einsum("eji,ejk,ek->ei", J1, w, e).reshape(-1))
            for J2, k2 in ((A, ei), (B, ej)):
                blk = torch.einsum("eji,ejk,ekl->eil", J1, w, J2)
                cols = 3 * k2[:, None] + r3
                r = rows[:, :, None].expand_as(blk)
                cc = cols[:, None, :].expand_as(blk)
                H.index_put_((r.reshape(-1), cc.reshape(-1)),
                             blk.reshape(-1), accumulate=True)
        dx = torch.zeros(3 * n, dtype=dt, device=dev)
        dx[keep] = _solve(H[keep][:, keep], -b[keep])
        x = x + dx.reshape(n, 3)
        x[:, 2] = wrap(x[:, 2])
        it += 1
        if float(torch.linalg.norm(dx.to(torch.float64))) < eps:
            break
    return x, it
