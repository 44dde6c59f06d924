"""Mean-per-voxel downsampling (counterpart of icp_tpu.ops.voxel).

Static shapes, as in icp_tpu: sort the points by integer voxel
coordinates, mark segment heads, give each segment a dense slot with a
cumulative sum, and scatter-add (sum, count) into fixed-capacity buffers.
The output keeps the input capacity; the valid voxels fill the first
slots in ``np.unique`` lexicographic (c0, c1[, c2]) order, which the sweep caps
of models/prealign rely on.

``torch.sort`` takes one key, so (c0, c1) is packed into one int64 key
``c0 * 2**31 + c1``; coordinates are >= 0 (measured from the masked
minimum) and below 2**30, and masked rows carry the sentinel 2**30 in
every plane, so they sort last. Three planes of 31 bits do not fit one
key, so 3-D points are sorted twice: a stable sort by c2, then a stable
sort by the (c0, c1) key, which is the lexicographic (c0, c1, c2) order
whatever the coordinates' range (no host read of the largest one). On
CUDA the scatter-add runs in no fixed order, so voxel means match icp_tpu
to f32 rounding, not bit for bit.
"""
from __future__ import annotations

import torch

_INT_SENTINEL = 2**30          # per-plane sentinel: sorts after real coords
_KEY_SHIFT = 2**31             # c1 < 2**31, so c0 * 2**31 + c1 is lexicographic


def voxel_downsample(points, mask, voxel_size):
    """Masked mean-per-voxel downsample of 2-D or 3-D points.

    points (N, D) f32 with D in {2, 3}, mask (N,) bool, voxel_size float.
    Returns (out_points (N, D), out_mask (N,)): voxel means in lexicographic
    voxel order, out_mask True for the first n_unique slots; the other
    slots hold the first voxel's mean.
    """
    n, d = points.shape
    if d not in (2, 3):
        raise ValueError(f"voxel_downsample takes (N, 2) or (N, 3) points, "
                         f"got {tuple(points.shape)}")
    # f32 reciprocal, as icp_tpu computes it on a traced f32 voxel size
    inv = 1.0 / torch.as_tensor(voxel_size, dtype=points.dtype, device=points.device)
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

    head = torch.ones_like(sorted_mask)
    head[1:] = sorted_key[1:] != sorted_key[:-1]
    if d == 3:
        sorted_c2 = coords[perm, 2]
        head[1:] |= sorted_c2[1:] != sorted_c2[:-1]
    head = head & sorted_mask
    slot = torch.cumsum(head.to(torch.int64), 0) - 1
    # masked rows go to an extra sentinel slot n, sliced off below
    slot = torch.where(sorted_mask, slot, n)

    counts = torch.zeros(n + 1, dtype=points.dtype, device=points.device)
    counts.index_add_(0, slot, sorted_mask.to(points.dtype))
    sums = torch.zeros(n + 1, d, dtype=points.dtype, device=points.device)
    sums.index_add_(0, slot, torch.where(sorted_mask[:, None], sorted_pts, 0.0))
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
    out, out_mask = voxel_downsample(points, mask, voxel_size)
    n = points.shape[0]
    if capacity >= n:
        pad = capacity - n
        out = torch.nn.functional.pad(out, (0, 0, 0, pad))
        out_mask = torch.nn.functional.pad(out_mask, (0, pad))
        return out, out_mask
    return out[:capacity], out_mask[:capacity]
