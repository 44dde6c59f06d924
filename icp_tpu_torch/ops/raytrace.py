"""Closed-form Bresenham ray tracing + scatter-add occupancy update
(counterpart of icp_tpu.ops.raytrace: ``bresenham_cells_xy``,
``bresenham_cells``, ``raytrace_update``, ``raytrace_update_batched``; the
optional ``ray_cells`` trace free space from a strided ray set beside all
hits, as parallel.sharded_grid's block paint does on each block).

Semantics as in icp_tpu and the reference (utilities/mapping.py:68-141):
cells are emitted before stepping with the endpoint excluded; out-of-grid
cells are dropped; hit cells add l_hit, every emitted free cell adds
l_miss (overlapping rays count twice); then the grid is clamped once. The
update is a plain accumulate-scatter: hits first, then free cells, then
one clamp — per scan, or per batch for the batched form. icp_tpu's sort
compaction, run-length dedup (``dedup_scatter_add``) and windowed scatter
answer TPU scatter costs and are not ported: ``index_add_`` adds directly.
With lo_min = -inf and lo_max = +inf the grid keeps the unclamped sum.

The update functions write into ``log_odds`` in place (the counterpart of
icp_tpu donating the grid to the fused step) and return it. CUDA's
``index_add_`` adds in no fixed order, but every add of one call is the
same constant, so a run repeats bit for bit; icp_tpu's run-length dedup
adds count * l_hit at once, so sums match icp_tpu to f32 rounding.
"""
from __future__ import annotations

import torch

from icp_tpu_torch.utils import spans


def bresenham_cells_xy(origin_cell, end_cells, valid, *, max_steps: int):
    """Free-space cells of rays origin -> each endpoint, as separate planes.

    origin_cell (..., 2) int; end_cells (..., N, 2) int; valid (..., N)
    bool, with any leading batch dims (none for one scan, (B,) for a batch).
    Returns (x, y, active), each (..., S, N) with S = max_steps, int64.

    After s steps along the major axis the minor axis has advanced
    max(0, floor((2*s*m + M - 1) / (2*M))) cells, M = max(|dx|, |dy|),
    m = min(|dx|, |dy|) (the reference's integer error recurrence solved in
    closed form); floor division, not truncation.
    """
    origin_cell = origin_cell.to(torch.int64)
    end_cells = end_cells.to(torch.int64)
    x0 = origin_cell[..., 0, None]                           # (..., 1)
    y0 = origin_cell[..., 1, None]
    x1 = end_cells[..., 0]                                   # (..., N)
    y1 = end_cells[..., 1]
    dx = (x1 - x0).abs()
    dy = (y1 - y0).abs()
    sx = torch.where(x0 < x1, 1, -1)[..., None, :]           # (..., 1, N)
    sy = torch.where(y0 < y1, 1, -1)[..., None, :]
    M = torch.maximum(dx, dy)[..., None, :]
    m = torch.minimum(dx, dy)[..., None, :]
    s = torch.arange(max_steps, device=end_cells.device)[:, None]  # (S, 1)
    denom = torch.clamp(2 * M, min=1)
    minor = torch.clamp(torch.div(2 * s * m + M - 1, denom,
                                  rounding_mode="floor"), min=0)
    major = s.expand(minor.shape)
    x_major = (dx >= dy)[..., None, :]
    x = x0[..., None] + sx * torch.where(x_major, major, minor)
    y = y0[..., None] + sy * torch.where(x_major, minor, major)
    active = valid[..., None, :] & (s < M)
    return x, y, active


def bresenham_cells(origin_cell, end_cells, valid, *, max_steps: int):
    """Like bresenham_cells_xy, stacked: (cells (S, N, 2), active (S, N))."""
    x, y, active = bresenham_cells_xy(origin_cell, end_cells, valid,
                                      max_steps=max_steps)
    return torch.stack([x, y], dim=-1), active


def _paint(log_odds, hx, hy, hit_valid, fx, fy, free_active,
           l_hit, l_miss, lo_min, lo_max):
    """Add l_hit at in-grid hits, then l_miss at in-grid free cells, then
    clamp; all in place on ``log_odds``. Inputs are flattened here."""
    ny, nx = log_odds.shape
    flat = log_odds.view(-1)
    hx, hy, hit_valid = hx.reshape(-1), hy.reshape(-1), hit_valid.reshape(-1)
    hit_in = hit_valid & (hx >= 0) & (hx < nx) & (hy >= 0) & (hy < ny)
    spans.count("sync.map.paint_mask", 2)      # the two masked indexings
    hkey = (hy * nx + hx)[hit_in]
    # each call adds one constant to every cell it touches (l_hit here,
    # l_miss below), so the sums do not depend on the atomics' order
    flat.index_add_(0, hkey, torch.full(hkey.shape, l_hit, dtype=flat.dtype,
                                        device=flat.device))
    fx, fy, free_active = fx.reshape(-1), fy.reshape(-1), free_active.reshape(-1)
    free_in = free_active & (fx >= 0) & (fx < nx) & (fy >= 0) & (fy < ny)
    fkey = (fy * nx + fx)[free_in]
    flat.index_add_(0, fkey, torch.full(fkey.shape, l_miss, dtype=flat.dtype,
                                        device=flat.device))
    return log_odds.clamp_(lo_min, lo_max)


def _rays(hit_cells, valid, ray_cells, ray_valid):
    """The rays to trace: every hit by default, else ``ray_cells``."""
    if ray_cells is None:
        return hit_cells, valid
    if ray_valid is None:
        raise ValueError("ray_cells requires ray_valid")
    return ray_cells.to(torch.int64), ray_valid


def raytrace_update(log_odds, origin_cell, hit_cells, valid,
                    l_hit, l_miss, lo_min, lo_max, *, max_steps: int,
                    ray_cells=None, ray_valid=None):
    """One scan's occupancy update, in place on ``log_odds`` (ny, nx).

    origin_cell (2,) int; hit_cells (N, 2) as (ix, iy); valid (N,).
    ``ray_cells`` (R, 2) / ``ray_valid`` (R,): optionally trace free space
    along these rays only (a strided subset of the hits, say), while every
    valid hit still adds l_hit.
    """
    hit_cells = hit_cells.to(torch.int64)
    rc, rv = _rays(hit_cells, valid, ray_cells, ray_valid)
    x, y, active = bresenham_cells_xy(origin_cell, rc, rv, max_steps=max_steps)
    return _paint(log_odds, hit_cells[..., 0], hit_cells[..., 1], valid,
                  x, y, active, float(l_hit), float(l_miss),
                  float(lo_min), float(lo_max))


def raytrace_update_batched(log_odds, origin_cells, hit_cells, valid,
                            l_hit, l_miss, lo_min, lo_max, *, max_steps: int,
                            ray_cells=None, ray_valid=None):
    """A batch of scans' occupancy updates in one pass, in place.

    origin_cells (B, 2); hit_cells (B, N, 2); valid (B, N); optional
    ``ray_cells`` (B, R, 2) / ``ray_valid`` (B, R) as in raytrace_update.
    All hits and free cells of the batch are added, then the grid is
    clamped once per batch (as icp_tpu's batched form; this differs from B
    per-scan updates only for a cell that both saturates a bound and gets
    opposite-sign updates within the batch).
    """
    hit_cells = hit_cells.to(torch.int64)
    rc, rv = _rays(hit_cells, valid, ray_cells, ray_valid)
    x, y, active = bresenham_cells_xy(origin_cells, rc, rv, max_steps=max_steps)
    return _paint(log_odds, hit_cells[..., 0], hit_cells[..., 1], valid,
                  x, y, active, float(l_hit), float(l_miss),
                  float(lo_min), float(lo_max))
