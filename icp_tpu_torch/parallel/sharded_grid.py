"""Sharded occupancy-grid updates (counterpart of
icp_tpu.parallel.sharded_grid).

Log-odds updates are additive and per cell, so both ways of sharding are
exact up to the order of f32 sums:

* ``raytrace_update_sharded`` splits the RAYS over the shards: each shard
  traces its rays into a zero delta of the whole grid, one ``psum``
  combines the deltas, one clamp follows;
* the block-sharded forms keep the (ny, nx) grid ROW-BLOCK-SHARDED: block k
  (``ny / D`` rows) lives on shard k and is never replicated
  (``block_sharding``). Every shard traces all rays (a scan is small next
  to the map) and adds only the cells in its own rows, through
  ``ops.raytrace._paint`` on the block with a row offset. A Bresenham cell
  belongs to exactly one block, so there is no collective and no halo.
  ``raytrace_update_block_sharded`` paints one scan,
  ``raytrace_replay_block_sharded`` a batch (one clamp a batch).

The block functions update the blocks in place and return them, as the
port's ``ops.raytrace`` updates do. ``free_unique_cap`` and
``hit_unique_cap`` are accepted and unused: they size icp_tpu's run-length
dedup of the scatter (``dedup_scatter_add``), a TPU scatter workaround that
the port's ground rules leave out; ``index_add_`` adds duplicates directly.
"""
from __future__ import annotations

import torch

from icp_tpu_torch.ops.raytrace import _paint, _rays, bresenham_cells_xy
from icp_tpu_torch.parallel.mesh import Mesh

_INF = float("inf")


def raytrace_update_sharded(mesh: Mesh, log_odds, origin_cell, hit_cells,
                            valid, l_hit, l_miss, lo_min, lo_max,
                            *, max_steps: int, axis: str = "d"):
    """One scan's update with the ray axis split over the mesh (its length
    a multiple of the mesh size; pad with valid=False rays). ``log_odds``
    (ny, nx) comes in whole; returns the clamped sum as a new tensor on its
    device."""
    del axis
    hit_cells = hit_cells.to(torch.int64)
    deltas = []
    for dev, hc, vm in zip(mesh.devices, mesh.split(hit_cells),
                           mesh.split(valid)):
        d = torch.zeros(log_odds.shape, dtype=log_odds.dtype, device=dev)
        x, y, active = bresenham_cells_xy(origin_cell.to(dev), hc, vm,
                                          max_steps=max_steps)
        deltas.append(_paint(d, hc[:, 0], hc[:, 1], vm, x, y, active,
                             float(l_hit), float(l_miss), -_INF, _INF))
    delta = mesh.psum(deltas)[0].to(log_odds.device)
    return torch.clamp(log_odds + delta, float(lo_min), float(lo_max))


def block_sharding(mesh: Mesh, grid):
    """The row-block layout of a whole (ny, nx) grid: this process's blocks
    of ``ny / D`` rows, block k on shard k (``NamedSharding(mesh, P(axis,
    None))`` with ``device_put``)."""
    return mesh.split(grid)


def _paint_blocks(mesh, blocks, origin, hit_cells, valid, ray_cells,
                  ray_valid, l_hit, l_miss, lo_min, lo_max, max_steps):
    """On each shard's device: trace every ray, then add the hit and free
    cells that fall in the shard's rows to its block, in place."""
    hit_cells = hit_cells.to(torch.int64)
    rc, rv = _rays(hit_cells, valid, ray_cells, ray_valid)
    block_ny = blocks[0].shape[0]
    for k, (dev, blk) in enumerate(zip(mesh.devices, blocks)):
        r0 = mesh.axis_index(k) * block_ny
        hc = hit_cells.to(dev)
        x, y, active = bresenham_cells_xy(origin.to(dev), rc.to(dev),
                                          rv.to(dev), max_steps=max_steps)
        _paint(blk, hc[..., 0], hc[..., 1] - r0, valid.to(dev), x, y - r0,
               active, float(l_hit), float(l_miss), float(lo_min),
               float(lo_max))
    return blocks


def raytrace_update_block_sharded(mesh: Mesh, blocks, origin_cell,
                                  hit_cells, valid, l_hit, l_miss,
                                  lo_min, lo_max, *, max_steps: int,
                                  axis: str = "d", ray_cells=None,
                                  ray_valid=None,
                                  free_unique_cap: int | None = None):
    """One scan painted into the row-block-sharded grid (memory scaling).

    ``blocks``: this process's row blocks (``block_sharding``), updated in
    place and returned. origin_cell (2,), hit_cells (N, 2), valid (N,).
    ``ray_cells`` / ``ray_valid`` optionally trace free space from a smaller
    ray set than the hits. Exact against ``ops.raytrace.raytrace_update`` on
    the whole grid: the blocks partition the rows and the clamp is per
    cell."""
    del axis, free_unique_cap
    return _paint_blocks(mesh, blocks, origin_cell, hit_cells, valid,
                         ray_cells, ray_valid, l_hit, l_miss, lo_min, lo_max,
                         max_steps)


def raytrace_replay_block_sharded(mesh: Mesh, blocks, origin_cells,
                                  hit_cells, valid, l_hit, l_miss,
                                  lo_min, lo_max, *, max_steps: int,
                                  axis: str = "d", ray_cells=None,
                                  ray_valid=None,
                                  free_unique_cap: int | None = None,
                                  hit_unique_cap: int | None = None):
    """A batch of scans painted into the row-block-sharded grid: the
    replay of keyframes at corrected poses after bundle adjustment.
    origin_cells (B, 2), hit_cells (B, N, 2), valid (B, N); optional
    ``ray_cells`` (B, R, 2) / ``ray_valid`` (B, R). One clamp a batch, as
    ``ops.raytrace.raytrace_update_batched``."""
    del axis, free_unique_cap, hit_unique_cap
    return _paint_blocks(mesh, blocks, origin_cells, hit_cells, valid,
                         ray_cells, ray_valid, l_hit, l_miss, lo_min, lo_max,
                         max_steps)
