"""Dense cell-grid nearest neighbours for 10^5-point clouds (counterpart of
icp_tpu.ops.densegrid: ``DenseGrid``, ``CompactQueries``, ``DenseNNResult``,
``grid_origin``, ``build_dense_grid``, ``bin_queries``, ``cell_normals``,
``compact_nn``, ``scatter_results``, ``dense_nn_query``).

Targets are binned once into a padded (Cy+2, Cx+2, cap) grid of x / y /
idx / mask planes; queries are compacted into their occupied cells,
(qcells, qcap) planes plus each compact row's (row, col) in the grid; each
compact row compares its slots with the targets of its 3x3 cell
neighbourhood, and the results return to the input order.

Kept from icp_tpu, so the planes and the answers are the same:
* the slot order inside a cell. Both sort the cell ids stably (``lax.sort``
  is stable by default), so equal inputs give bit-equal planes;
* the tie rule. Within one neighbour cell the first slot that attains the
  min wins; the nine cells are taken in (dy, dx) order and a later cell
  wins only when strictly nearer, so on a tie the earlier cell wins;
* the exactness contract: every neighbour within ``cell_size`` of a query
  is found exactly. Targets beyond ``cap`` per cell or outside the grid,
  and queries beyond ``qcap`` per cell or ``qcells`` cells, are dropped and
  counted in ``overflow``; a dropped query gets distance BIG.

Not ported, as answers to TPU costs only: the one-hot winner (here argmin
and a gather), the shift-by-shift loop (here the nine cells compared in
one pass; the first index of the min over the concatenated cells is the
sequential rule), and ``mode="drop"`` scatters (here an index write into a
spare row that is sliced off).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from icp_tpu_torch.ops.eig2 import eigh2x2
from icp_tpu_torch.utils import spans
from icp_tpu_torch.utils.masking import BIG


class DenseGrid(NamedTuple):
    """Cell-binned target cloud, padded with a one-cell invalid ring."""
    x: torch.Tensor          # (Cy+2, Cx+2, cap) f32
    y: torch.Tensor          # (Cy+2, Cx+2, cap) f32
    idx: torch.Tensor        # (Cy+2, Cx+2, cap) int32 original row (n = empty)
    mask: torch.Tensor       # (Cy+2, Cx+2, cap) bool
    origin: torch.Tensor     # (2,) world position of unpadded cell (0, 0)
    cell_size: torch.Tensor  # scalar f32
    overflow: torch.Tensor   # int32: targets dropped (capacity or extent)


class CompactQueries(NamedTuple):
    """Queries binned to their occupied cells; the occupied rows come first."""
    x: torch.Tensor          # (qcells, qcap) f32 query coordinates
    y: torch.Tensor          # (qcells, qcap) f32
    idx: torch.Tensor        # (qcells, qcap) int32 original row (n = empty)
    mask: torch.Tensor       # (qcells, qcap) bool
    cell_yx: torch.Tensor    # (qcells, 2) int32 unpadded grid cell of the row
    cell_mask: torch.Tensor  # (qcells,) bool: the row holds an occupied cell
    overflow: torch.Tensor   # int32: queries dropped by qcap / qcells


class DenseNNResult(NamedTuple):
    dist: torch.Tensor   # (N,) Euclidean distance, BIG where none was found
    idx: torch.Tensor    # (N,) int32 index into the target array
    nx: torch.Tensor     # (N,) nearest-point x (0 where none)
    ny: torch.Tensor     # (N,) nearest-point y


def _f32(x, device):
    if not isinstance(x, torch.Tensor):
        spans.count("sync.densegrid.const")
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _rank_in_cell(cs):
    """Rank of each sorted key within its run of equal keys, and run heads."""
    n = cs.shape[0]
    head = torch.ones(n, dtype=torch.bool, device=cs.device)
    head[1:] = cs[1:] != cs[:-1]
    ar = torch.arange(n, device=cs.device)
    seg_start = torch.cummax(torch.where(head, ar, 0), 0).values
    return ar - seg_start, head


def _cell_coords(points, origin, cell_size):
    """Integer (cx, cy) of each point's cell, as icp_tpu computes them."""
    c = torch.floor((points - origin) / cell_size).to(torch.int64)
    return c[:, 0], c[:, 1]


def grid_origin(points, mask, cell_size):
    """World position of cell (0, 0): masked min minus one cell of margin."""
    mn = torch.where(mask[:, None], points, BIG).amin(0)
    return mn - cell_size


def build_dense_grid(points, mask, cell_size, origin, *,
                     grid_shape: tuple[int, int], cap: int = 16) -> DenseGrid:
    """Bin target points into the padded dense grid (once per ICP)."""
    Cy, Cx = grid_shape
    n = points.shape[0]
    dev = points.device
    cell_size = _f32(cell_size, dev)
    origin = _f32(origin, dev)
    cx, cy = _cell_coords(points, origin, cell_size)
    inb = mask & (cx >= 0) & (cx < Cx) & (cy >= 0) & (cy < Cy)
    n_cells = Cy * Cx
    cid = torch.where(inb, cy * Cx + cx, n_cells)

    cs, perm = torch.sort(cid, stable=True)
    rank, _ = _rank_in_cell(cs)
    ok = (cs < n_cells) & (rank < cap)
    # flat row of the padded (Cy+2) x (Cx+2) plane; dropped points go to
    # the spare row n_pad
    n_pad = (Cy + 2) * (Cx + 2)
    row = torch.where(ok, (cs // Cx + 1) * (Cx + 2) + cs % Cx + 1, n_pad)
    col = torch.where(ok, rank, 0)

    def plane(fill, dtype, values):
        p = torch.full((n_pad + 1, cap), fill, dtype=dtype, device=dev)
        p[row, col] = values
        return p[:n_pad].reshape(Cy + 2, Cx + 2, cap)

    sp = points[perm]
    px = plane(0.0, torch.float32, sp[:, 0])
    py = plane(0.0, torch.float32, sp[:, 1])
    pidx = plane(n, torch.int32, perm.to(torch.int32))
    pm = plane(False, torch.bool, ok)
    dropped = (mask.sum() - ok.sum()).to(torch.int32)
    return DenseGrid(px, py, pidx, pm, origin, cell_size, dropped)


def bin_queries(query, query_mask, origin, cell_size, *,
                grid_shape: tuple[int, int], qcells: int,
                qcap: int) -> CompactQueries:
    """Compact queries into their occupied cells (one sort + index writes).

    Query cells clip to the grid edge, so a query up to one cell outside
    the extent still sees the boundary cells (in-radius exactness holds).
    """
    Cy, Cx = grid_shape
    n = query.shape[0]
    dev = query.device
    cx, cy = _cell_coords(query, _f32(origin, dev), _f32(cell_size, dev))
    cx = cx.clamp(0, Cx - 1)
    cy = cy.clamp(0, Cy - 1)
    n_cells = Cy * Cx
    cid = torch.where(query_mask, cy * Cx + cx, n_cells)

    cs, perm = torch.sort(cid, stable=True)
    rank, head = _rank_in_cell(cs)
    valid = cs < n_cells
    crow = torch.cumsum((head & valid).to(torch.int64), 0) - 1   # compact row

    ok = valid & (rank < qcap) & (crow < qcells)
    row = torch.where(ok, crow, qcells)        # qcells: the spare row
    col = torch.where(ok, rank, 0)

    def plane(fill, dtype, values):
        p = torch.full((qcells + 1, qcap), fill, dtype=dtype, device=dev)
        p[row, col] = values
        return p[:qcells]

    sq = query[perm]
    qx = plane(0.0, torch.float32, sq[:, 0])
    qy = plane(0.0, torch.float32, sq[:, 1])
    qidx = plane(n, torch.int32, perm.to(torch.int32))
    qm = plane(False, torch.bool, ok)

    hrow = torch.where(head & valid & (crow < qcells), crow, qcells)
    cell_yx = torch.zeros((qcells + 1, 2), dtype=torch.int32, device=dev)
    cell_yx[hrow] = torch.stack([cs // Cx, cs % Cx], dim=1).to(torch.int32)
    cell_mask = torch.zeros(qcells + 1, dtype=torch.bool, device=dev)
    # a host scalar put at tensor indices is copied to the device first
    spans.count("sync.densegrid.mask_fill")
    cell_mask[hrow] = True
    overflow = (query_mask.sum() - ok.sum()).to(torch.int32)
    return CompactQueries(qx, qy, qidx, qm, cell_yx[:qcells],
                          cell_mask[:qcells], overflow)


def cell_normals(grid: DenseGrid):
    """Per-cell unit surface normals from 3x3-neighbourhood point moments.

    Every cell gets one normal from the covariance of all points in its 3x3
    cell neighbourhood. Moments are taken in each cell's LOCAL coordinates
    (relative to its own corner) and translated by the static cell offsets
    when the nine neighbours are summed: world-coordinate second moments at
    100 m would cancel in f32.

    Returns (nx, ny, valid) as flat (Cy*Cx,) planes over the unpadded cells
    (row-major, as ``CompactQueries.cell_yx`` indexes them); valid = the
    neighbourhood holds >= 3 points.
    """
    Cyp, Cxp, cap = grid.x.shape
    Cy, Cx = Cyp - 2, Cxp - 2
    dev = grid.x.device
    cell = grid.cell_size
    col = torch.arange(Cxp, device=dev).to(torch.float32)[None, :]
    row = torch.arange(Cyp, device=dev).to(torch.float32)[:, None]
    corner_x = grid.origin[0] + (col - 1.0) * cell        # (1, Cxp)
    corner_y = grid.origin[1] + (row - 1.0) * cell        # (Cyp, 1)
    m = grid.mask.to(torch.float32)
    xl = (grid.x - corner_x[:, :, None]) * m
    yl = (grid.y - corner_y[:, :, None]) * m
    n = m.sum(-1)                                         # (Cyp, Cxp)
    s1x = xl.sum(-1)
    s1y = yl.sum(-1)
    sxx = (xl * xl).sum(-1)
    sxy = (xl * yl).sum(-1)
    syy = (yl * yl).sum(-1)

    # neighbour (dy, dx)'s local coordinates differ from the centre cell's
    # by ((dx - 1) * cell, (dy - 1) * cell)
    zeros = torch.zeros((Cy, Cx), dtype=torch.float32, device=dev)
    N, X, Y, XX, XY, YY = (zeros,) * 6
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            ox = (dx - 1) * cell
            oy = (dy - 1) * cell
            win = (slice(dy, dy + Cy), slice(dx, dx + Cx))
            nn, ax, ay = n[win], s1x[win], s1y[win]
            N = N + nn
            X = X + ax + nn * ox
            Y = Y + ay + nn * oy
            XX = XX + sxx[win] + 2.0 * ox * ax + nn * ox * ox
            XY = XY + (sxy[win] + ox * ay + oy * ax + nn * ox * oy)
            YY = YY + syy[win] + 2.0 * oy * ay + nn * oy * oy

    nc = torch.clamp(N, min=1.0)
    mx = X / nc
    my = Y / nc
    a = XX / nc - mx * mx
    b = XY / nc - mx * my
    c = YY / nc - my * my
    _, _, v = eigh2x2(a, b, c)
    valid = (N >= 3.0).reshape(-1)
    return v[..., 0].reshape(-1), v[..., 1].reshape(-1), valid


def compact_nn(cq: CompactQueries, grid: DenseGrid, rows: int | None = None):
    """NN of each compacted query slot against its 3x3 cell neighbourhood.

    Returns per-slot planes (qcells, qcap): d2 (BIG where no valid target),
    target idx, nearest x / y (0 where none). ``rows`` limits the work to
    the first ``rows`` compact rows; the others get (BIG, 0, 0, 0). Since
    the occupied rows come first, any ``rows`` >= ``cq.cell_mask.sum()``
    gives every valid slot its exact answer.
    """
    Cyp, Cxp, cap = grid.x.shape
    qcells, qcap = cq.x.shape
    R = qcells if rows is None else max(0, min(int(rows), qcells))
    dev = cq.x.device
    # padded-plane flat rows of the nine neighbour cells, in (dy, dx) order
    spans.count("sync.densegrid.offsets")
    offs = torch.tensor([dy * Cxp + dx for dy in range(3) for dx in range(3)],
                        device=dev)
    base = cq.cell_yx[:R, 0].to(torch.int64) * Cxp + cq.cell_yx[:R, 1]
    r = base[:, None] + offs[None, :]                          # (R, 9)

    def nbhd(plane):
        return plane.reshape(-1, cap)[r].reshape(R, 9 * cap)

    tx, ty, ti, tm = nbhd(grid.x), nbhd(grid.y), nbhd(grid.idx), nbhd(grid.mask)
    d2 = cq.x[:R, :, None] - tx[:, None, :]                    # (R, qcap, 9 cap)
    ddy = cq.y[:R, :, None] - ty[:, None, :]
    d2.mul_(d2).add_(ddy.mul_(ddy))
    d2.masked_fill_(~tm[:, None, :], BIG)
    del ddy
    dmin, arg = torch.min(d2, dim=-1)       # the first slot attaining the min
    del d2
    found = dmin < BIG

    def pick(plane, none):
        return torch.where(found, torch.gather(plane, 1, arg), none)

    best = (torch.where(found, dmin, BIG), pick(ti, 0), pick(tx, 0.0),
            pick(ty, 0.0))
    if R == qcells:
        return best
    fills = (BIG, 0, 0.0, 0.0)
    return tuple(
        torch.cat([b, torch.full((qcells - R, qcap), f, dtype=b.dtype,
                                 device=dev)])
        for b, f in zip(best, fills))


def scatter_results(cq: CompactQueries, best_d2, best_i, best_x, best_y,
                    *, n: int) -> DenseNNResult:
    """Return compact per-slot results to the original query order."""
    dev = best_d2.device
    found = cq.mask & (best_d2 < BIG)
    dflat = torch.where(found, torch.sqrt(best_d2), BIG).reshape(-1)
    qi = cq.idx.reshape(-1).to(torch.int64)    # n for empty slots: spare row

    def back(fill, dtype, values):
        out = torch.full((n + 1,), fill, dtype=dtype, device=dev)
        out[qi] = values.reshape(-1)
        return out[:n]

    return DenseNNResult(back(BIG, torch.float32, dflat),
                         back(0, torch.int32, best_i),
                         back(0.0, torch.float32, best_x),
                         back(0.0, torch.float32, best_y))


def dense_nn_query(query, query_mask, grid: DenseGrid, *, qcap: int = 16,
                   qcells: int = 4096) -> DenseNNResult:
    """Nearest target within cell_size of each query (see module docstring)."""
    Cyp, Cxp, _ = grid.x.shape
    cq = bin_queries(query, query_mask, grid.origin, grid.cell_size,
                     grid_shape=(Cyp - 2, Cxp - 2), qcells=qcells, qcap=qcap)
    best = compact_nn(cq, grid)
    return scatter_results(cq, *best, n=query.shape[0])
