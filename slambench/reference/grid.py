"""Plain log-odds occupancy painting for the checks.

The upstream mapping's semantics (one ray per hit, traced with Bresenham's
integer recurrence from the sensor's cell, endpoint excluded; every hit
cell adds l_hit, every free cell l_miss, rays that overlap count each
time; cells outside the grid are dropped; the grid is clamped after each
update when it has bounds). The recurrence is taken in its closed form:
after s steps along the major axis the minor axis has moved
max(0, floor((2 s m + M - 1) / (2 M))) cells, M and m the larger and the
smaller of |dx| and |dy|. Imports nothing of ``icp_tpu_torch``.
"""
from __future__ import annotations

import torch


class Grid:
    """A (ny, nx) log-odds grid whose cell (ix, iy) covers
    [min_x + ix res, min_x + (ix + 1) res) x [min_y + iy res, ...)."""

    def __init__(self, min_xy, shape, res, *, l_hit, l_miss, max_steps,
                 clamp=None, dtype=torch.float64, device="cpu"):
        self.min = torch.as_tensor(min_xy, dtype=dtype, device=device)
        self.ny, self.nx = int(shape[0]), int(shape[1])
        self.res = float(res)
        self.l_hit, self.l_miss = float(l_hit), float(l_miss)
        self.max_steps = int(max_steps)
        self.clamp = clamp
        self.lo = torch.zeros(self.ny * self.nx, dtype=dtype, device=device)

    def cells(self, xy):
        return torch.floor((xy - self.min) / self.res).to(torch.int64)

    def _add(self, ix, iy, value):
        ok = (ix >= 0) & (ix < self.nx) & (iy >= 0) & (iy < self.ny)
        key = (iy * self.nx + ix)[ok]
        self.lo.index_add_(0, key, torch.full(key.shape, value,
                                              dtype=self.lo.dtype,
                                              device=self.lo.device))

    def add_scans(self, origins, hits, ray_stride: int = 1):
        """Add the hits and free cells of several scans (no clamp).
        ``origins``: (K, 2) world positions; ``hits``: K (n_k, 2) world
        clouds; free space is traced along every ``ray_stride``-th hit."""
        for o, h in zip(origins, hits):
            oc = self.cells(o[None])[0]
            hc = self.cells(h)
            self._add(hc[:, 0], hc[:, 1], self.l_hit)
            self._trace(oc, hc[::ray_stride])

    def _trace(self, oc, ends):
        x0, y0 = oc[0], oc[1]
        dx, dy = ends[:, 0] - x0, ends[:, 1] - y0
        sx = torch.where(dx > 0, 1, -1)
        sy = torch.where(dy > 0, 1, -1)
        big = torch.maximum(dx.abs(), dy.abs())
        small = torch.minimum(dx.abs(), dy.abs())
        s = torch.arange(self.max_steps, device=ends.device)[:, None]
        minor = torch.clamp(torch.div(2 * s * small + big - 1,
                                      torch.clamp(2 * big, min=1),
                                      rounding_mode="floor"), min=0)
        along_x = dx.abs() >= dy.abs()
        ix = x0 + sx * torch.where(along_x, s, minor)
        iy = y0 + sy * torch.where(along_x, minor, s)
        live = s < big
        self._add(ix[live], iy[live], self.l_miss)

    def finish_update(self):
        if self.clamp is not None:
            self.lo.clamp_(*self.clamp)

    def array(self):
        return self.lo.reshape(self.ny, self.nx)


def diff_share(program, reference, observed_tol: float = 1e-9,
               atol: float = 1e-3, rtol: float = 1e-4) -> float:
    """Share (%) of the cells observed in either grid whose log-odds differ
    by more than ``atol + rtol |reference|``: a float32 sum of n terms is
    off by some n eps of it at most, eps = 6e-8, and a cell the program
    counted one ray more or fewer is off by |l_miss| = 0.41 or more."""
    p = torch.as_tensor(program, dtype=torch.float64)
    r = torch.as_tensor(reference, dtype=torch.float64).to(p.device)
    seen = (p.abs() > observed_tol) | (r.abs() > observed_tol)
    n = int(seen.sum())
    if n == 0:
        return 0.0
    bad = (p - r).abs() > atol + rtol * r.abs()
    return 100.0 * int(bad[seen].sum()) / n
