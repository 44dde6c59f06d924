"""Fixed-capacity padded point sets (counterpart of icp_tpu.utils.masking).

Every point cloud is a ``(capacity, D)`` tensor plus a ``(capacity,)`` bool
validity mask, so per-scan shapes stay constant over a sequence and the
ops never branch on the host on how many points are valid.
"""
from __future__ import annotations

import torch

# sentinel "infinite" distance for masked slots
BIG = 1e30


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (minimum 8)."""
    n = max(int(n), 8)
    return 1 << (n - 1).bit_length()


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
