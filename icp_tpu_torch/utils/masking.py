"""Fixed-capacity padded point sets (counterpart of icp_tpu.utils.masking).

Every point cloud is a ``(capacity, D)`` tensor plus a ``(capacity,)`` bool
validity mask, so per-scan shapes stay constant over a sequence and the
ops never branch on the host on how many points are valid.
"""
from __future__ import annotations

import numpy as np
import torch

# sentinel "infinite" distance for masked slots
BIG = 1e30


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (minimum 8)."""
    n = max(int(n), 8)
    return 1 << (n - 1).bit_length()


def bucket_capacity(n: int, minimum: int = 256) -> int:
    """Pad-target capacity for n points: pow2 bucketing with a floor."""
    return max(next_pow2(n), minimum)


def pad_points(points: np.ndarray, capacity: int | None = None):
    """Pad an (n, D) host array to (capacity, D) + bool mask (numpy).

    Padding rows repeat the first valid point, so reductions that forget
    the mask still see in-range coordinates.
    """
    points = np.asarray(points, dtype=np.float32)
    n = points.shape[0]
    if capacity is None:
        capacity = bucket_capacity(n)
    if n > capacity:
        raise ValueError(f"point count {n} exceeds capacity {capacity}")
    d = points.shape[1] if points.ndim == 2 else 2
    out = np.zeros((capacity, d), dtype=np.float32)
    if n > 0:
        out[:n] = points
        out[n:] = points[0]
    mask = np.zeros((capacity,), dtype=bool)
    mask[:n] = True
    return out, mask


def _sum(x: torch.Tensor, dim):
    return x.sum() if dim is None else x.sum(dim)


def masked_mean(x, mask, dim=None, eps=1e-12):
    """Mean of x over entries where mask is True (mask broadcasts to x)."""
    m = mask.to(x.dtype)
    s = _sum(x * m, dim)
    c = _sum(m, dim)
    return s / torch.clamp(c, min=eps)


def masked_centroid(points, mask):
    """(N, D), (N,) -> (D,) masked mean of points."""
    return masked_mean(points, mask[..., None], dim=-2)


def take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-d index tensor without a host sync (indexing with
    a 0-d tensor reads its value on the host)."""
    return x.index_select(0, i.reshape(1).long()).squeeze(0)
