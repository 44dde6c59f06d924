"""Mean-per-voxel downsampling (counterpart of icp_tpu.ops.voxel).

Static shapes, as in icp_tpu: sort the points by integer voxel
coordinates, mark segment heads, give each segment a dense slot with a
cumulative sum, and sum (count, coordinates) per slot. The output keeps
the input capacity; the valid voxels fill the first slots in ``np.unique``
lexicographic (c0, c1[, c2]) order, which the sweep caps of models/prealign
rely on.

``torch.sort`` takes one key, so (c0, c1) is packed into one int64 key
``c0 * 2**31 + c1``; coordinates are >= 0 (measured from the masked
minimum) and below 2**30, and masked rows carry the sentinel 2**30 in
every plane, so they sort last. Three planes of 31 bits do not fit one
key, so 3-D points are sorted twice: a stable sort by c2, then a stable
sort by the (c0, c1) key, which is the lexicographic (c0, c1, c2) order
whatever the coordinates' range (no host read of the largest one).

The per-slot sums go through ``ops.scatter.ordered_index_add_`` with the
slots already in order: each voxel adds its points in sorted order, so a
run gives the same bits on the card every time and the same bits as on
the CPU. Masked rows each take a slot of their own past the N real ones
(cut off), so no run is longer than one voxel's points.

``voxel_downsample_fixed`` with ``capacity < N`` computes icp_tpu's form
of the mean, the cell centre ``min_bound + (c + 0.5) * voxel`` plus the
mean of the points' deviations from it; icp_tpu's cumulative-sum
differences, which spare the TPU a scatter, are not ported.
"""
from __future__ import annotations

import torch

from icp_tpu_torch.ops.scatter import ordered_index_add_

_INT_SENTINEL = 2**30          # per-plane sentinel: sorts after real coords
_KEY_SHIFT = 2**31             # c1 < 2**31, so c0 * 2**31 + c1 is lexicographic


def _sorted_runs(points, mask, voxel_size):
    """Sort the points by voxel and number the runs.

    Returns (v, min_bound, sorted coords (N, D) int64, sorted points,
    sorted mask, slot (N,) int64): valid rows' slots count the voxels from
    0 in sorted order, masked rows (sorted last) take slots N + row; the
    slots never decrease."""
    n, d = points.shape
    if d not in (2, 3):
        raise ValueError(f"voxel_downsample takes (N, 2) or (N, 3) points, "
                         f"got {tuple(points.shape)}")
    v = torch.as_tensor(voxel_size, dtype=points.dtype, device=points.device)
    # f32 reciprocal, as icp_tpu computes it on a traced f32 voxel size
    inv = 1.0 / v
    min_bound = torch.where(mask[:, None], points, torch.inf).amin(0)
    coords = torch.floor((points - min_bound) * inv)
    # masked rows first become 0 (their coords may be inf/nan), then sentinel
    coords = torch.where(mask[:, None], coords, 0.0).to(torch.int64)
    coords = torch.where(mask[:, None], coords, _INT_SENTINEL)
    key = coords[:, 0] * _KEY_SHIFT + coords[:, 1]
    if d == 2:
        sorted_key, perm = torch.sort(key, stable=True)
    else:
        by_c2 = torch.sort(coords[:, 2], stable=True).indices
        sorted_key, by_key = torch.sort(key[by_c2], stable=True)
        perm = by_c2[by_key]
    sorted_pts = points[perm]
    sorted_mask = mask[perm]
    sorted_coords = coords[perm]

    head = torch.ones_like(sorted_mask)
    head[1:] = sorted_key[1:] != sorted_key[:-1]
    if d == 3:
        head[1:] |= sorted_coords[1:, 2] != sorted_coords[:-1, 2]
    head = head & sorted_mask
    rows = torch.arange(n, device=points.device)
    slot = torch.cumsum(head.to(torch.int64), 0) - 1
    slot = torch.where(sorted_mask, slot, n + rows)
    return v, min_bound, sorted_coords, sorted_pts, sorted_mask, slot


def _run_sums(slot, sorted_mask, values):
    """(count (2N,), sums (2N, D)) per slot: one ordered scatter-sum of
    the rows (mask, values) with the slots in order."""
    n, d = values.shape
    rows = torch.cat([sorted_mask.to(values.dtype)[:, None],
                      torch.where(sorted_mask[:, None], values, 0.0)], 1)
    acc = torch.zeros((2 * n, d + 1), dtype=values.dtype, device=values.device)
    ordered_index_add_(acc, slot, rows, sorted_index=True)
    return acc[:, 0], acc[:, 1:]


def voxel_downsample(points, mask, voxel_size):
    """Masked mean-per-voxel downsample of 2-D or 3-D points.

    points (N, D) f32 with D in {2, 3}, mask (N,) bool, voxel_size float.
    Returns (out_points (N, D), out_mask (N,)): voxel means in lexicographic
    voxel order, out_mask True for the first n_unique slots; the other
    slots hold the first voxel's mean.
    """
    n = points.shape[0]
    _, _, _, sorted_pts, sorted_mask, slot = _sorted_runs(points, mask,
                                                          voxel_size)
    counts, sums = _run_sums(slot, sorted_mask, sorted_pts)
    counts, sums = counts[:n], sums[:n]
    out_mask = counts > 0
    out = sums / torch.clamp(counts, min=1.0)[:, None]
    out = torch.where(out_mask[:, None], out, out[0])
    return out, out_mask


def voxel_downsample_fixed(points, mask, voxel_size, capacity: int):
    """voxel_downsample with the output cut or zero-padded to ``capacity``
    slots. Voxels beyond ``capacity`` (lexicographically last) are dropped;
    callers choose capacity >= the expected unique count and watch the
    saturation count."""
    n = points.shape[0]
    if capacity >= n:
        out, out_mask = voxel_downsample(points, mask, voxel_size)
        pad = capacity - n
        out = torch.nn.functional.pad(out, (0, 0, 0, pad))
        out_mask = torch.nn.functional.pad(out_mask, (0, pad))
        return out, out_mask
    v, min_bound, coords, sorted_pts, sorted_mask, slot = _sorted_runs(
        points, mask, voxel_size)
    # each row's cell centre; the sums are of deviations from it (each
    # within half a voxel), and a slot's centre is read at its run's first
    # row (masked rows' deviations are 0)
    centre = min_bound + (coords.to(points.dtype) + 0.5) * v
    counts, dev = _run_sums(slot, sorted_mask, sorted_pts - centre)
    counts, dev = counts[:capacity], dev[:capacity]
    first = torch.searchsorted(slot, torch.arange(capacity, device=slot.device))
    seg_centre = centre[torch.clamp(first, max=n - 1)]
    out_mask = counts > 0.5
    out = seg_centre + dev / torch.clamp(counts, min=1.0)[:, None]
    out = torch.where(out_mask[:, None], out, out[0])
    return out, out_mask
