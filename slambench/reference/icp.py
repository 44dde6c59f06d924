"""Plain registration for the checks: voxel means, brute-force nearest
neighbours and ICP refinement, in any torch dtype on any device.

Written from the algorithms' definitions (the upstream project's
voxel-mean downsampling, point-to-point and point-to-line ICP with a
correspondence gate), not from the program: it imports nothing of
``icp_tpu_torch``. The checks run it in float64 to judge the program's
float32 answers; the precision control runs the same code in bfloat16.
"""
from __future__ import annotations

import math

import torch

from slambench.reference.graph import _solve

_BLOCK = 1 << 24          # distance-matrix elements per block


def voxel_mean(points: torch.Tensor, voxel: float, capacity=None):
    """Mean of the points in each voxel of side ``voxel``, the grid anchored
    at the cloud's minimum. Voxels come in lexicographic (ix, iy) order; with
    ``capacity`` only the first ``capacity`` of them are kept."""
    lo = points.amin(0)
    cell = torch.floor((points - lo) / voxel).to(torch.int64)
    key = cell[:, 0] * (1 << 31) + cell[:, 1]
    uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
    sums = torch.zeros((len(uniq), 2), dtype=points.dtype,
                       device=points.device).index_add_(0, inv, points)
    counts = torch.bincount(inv, minlength=len(uniq)).to(points.dtype)
    means = sums / counts[:, None]
    return means if capacity is None else means[:capacity]


def nearest(src: torch.Tensor, tgt: torch.Tensor):
    """(squared distance, index) of each source row's nearest target,
    by brute force in blocks of rows."""
    rows = max(1, _BLOCK // max(len(tgt), 1))
    d2s, idxs = [], []
    for i in range(0, len(src), rows):
        s = src[i:i + rows]
        d2 = ((s[:, None, :] - tgt[None, :, :]) ** 2).sum(-1)
        v, j = d2.min(1)
        d2s.append(v)
        idxs.append(j)
    return torch.cat(d2s), torch.cat(idxs)


def knn_normals(tgt: torch.Tensor, k: int):
    """Unit normal of each target point: the eigenvector of the smallest
    eigenvalue of its k nearest neighbours' covariance."""
    rows = max(1, _BLOCK // max(len(tgt), 1))
    out = []
    k = min(k, len(tgt))
    for i in range(0, len(tgt), rows):
        s = tgt[i:i + rows]
        d2 = ((s[:, None, :] - tgt[None, :, :]) ** 2).sum(-1)
        nb = tgt[d2.topk(k, dim=1, largest=False).indices]      # (r, k, 2)
        c = nb - nb.mean(1, keepdim=True)
        cov = c.transpose(1, 2) @ c                             # (r, 2, 2)
        a, b, d = cov[:, 0, 0], cov[:, 0, 1], cov[:, 1, 1]
        # smallest-eigenvalue direction of [[a, b], [b, d]] in closed form
        theta = 0.5 * torch.atan2(2 * b, a - d) + math.pi / 2
        out.append(torch.stack([torch.cos(theta), torch.sin(theta)], 1))
    return torch.cat(out)


def rot(theta):
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s]), torch.stack([s, c])])


def _p2p_step(a, b, w):
    """Weighted closed-form rigid fit of a onto b (2-D Kabsch)."""
    ws = w.sum()
    ca = (a * w[:, None]).sum(0) / ws
    cb = (b * w[:, None]).sum(0) / ws
    pa, pb = a - ca, b - cb
    sxx = (w * pa[:, 0] * pb[:, 0]).sum()
    syy = (w * pa[:, 1] * pb[:, 1]).sum()
    sxy = (w * pa[:, 0] * pb[:, 1]).sum()
    syx = (w * pa[:, 1] * pb[:, 0]).sum()
    th = torch.atan2(sxy - syx, sxx + syy)
    R = rot(th)
    return R, cb - R @ ca


def _p2l_step(a, b, n, w):
    """One linearised point-to-line step: min sum w (n . (R a + t - b))^2
    over small (dtheta, tx, ty), centred on the weighted source centroid."""
    ws = w.sum()
    c = (a * w[:, None]).sum(0) / ws
    ac = a - c
    cross = ac[:, 0] * n[:, 1] - ac[:, 1] * n[:, 0]
    J = torch.stack([cross, n[:, 0], n[:, 1]], 1)
    r = ((a - b) * n).sum(1)
    H = (J * w[:, None]).T @ J
    g = (J * w[:, None]).T @ r
    x = _solve(H, -g)
    R = rot(x[0])
    return R, c - R @ c + x[1:]


def refine(src, tgt, R, t, *, max_corr: float, method: str = "p2p",
           normals=None, iters: int = 100, tol: float = 1e-9):
    """ICP of ``src`` onto ``tgt`` from (R, t), correspondences gated at
    ``max_corr``, until a step moves no source point by more than ``tol``
    (metres) or ``iters`` steps. Returns (R, t, steps, inliers)."""
    corr2 = max_corr * max_corr
    n_in = 0
    for k in range(iters):
        a = src @ R.T + t
        d2, j = nearest(a, tgt)
        w = (d2 < corr2).to(src.dtype)
        n_in = int(w.sum())
        if n_in < 3:
            break
        b = tgt[j]
        if method == "p2l":
            dR, dt = _p2l_step(a, b, normals[j], w)
        else:
            dR, dt = _p2p_step(a, b, w)
        R, t = dR @ R, dR @ t + dt
        move = ((a @ dR.T + dt - a) ** 2).sum(1).amax().sqrt()
        if float(move) < tol:
            return R, t, k + 1, n_in
    return R, t, iters, n_in


def pose_gap(points, R1, t1, R2, t2):
    """Largest distance between a cloud placed at two poses (metres)."""
    d = points @ (R1 - R2).T + (t1 - t2)
    return float((d * d).sum(1).amax().sqrt())
