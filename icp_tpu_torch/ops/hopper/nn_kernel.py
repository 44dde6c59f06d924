"""Hopper CUDA kernels for the 2-D nearest-neighbour queries.

Counterparts of icp_tpu/ops/pallas/nn_kernel.py:
  * ``nn_cuda``     replaces ``nn_pallas``     (kernel ``_nn_kernel``): the
    ICP correspondence query, (min squared distance, argmin) per row;
  * ``nn_min_cuda`` replaces ``nn_min_pallas`` (kernel ``_nn_min_kernel``):
    the rotation-sweep scorer's min squared distance per row.

The kernels are in ``csrc/nn_kernel.cu`` (see its header for the design and
what bounds them), built by ``ops/hopper/build.py`` at first use. Each
wrapper takes its plain torch version only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises. ``nn_launches`` and
``nn_min_launches`` count kernel launches (not plain-version calls).
``nn_min_cuda``'s launch geometry is chosen here (``nn_min_geometry``), so
the CPU tests can check that it covers every (row, target) pair once.
"""
from __future__ import annotations

import functools

import torch

from icp_tpu_torch.utils.masking import BIG

nn_launches = 0
nn_min_launches = 0

# icp_nn_min takes clusters of at most 8 blocks (csrc/nn_kernel.cu)
NN_MIN_MAX_CLUSTER = 8
H100_SMS = 132


def reset_launch_counts() -> None:
    global nn_launches, nn_min_launches
    nn_launches = 0
    nn_min_launches = 0


def _sqdist_plain(source, target, tgt_mask):
    """(N, M) squared distances by direct differencing, as the kernels
    compute them (each operation rounded on its own); masked targets BIG."""
    dx = source[:, 0:1] - target[None, :, 0]
    dy = source[:, 1:2] - target[None, :, 1]
    d2 = dx * dx + dy * dy
    return torch.where(tgt_mask[None, :], d2, BIG)


def nn_plain(source, target, tgt_mask):
    """Plain torch version of nn_cuda: (d2 (N,) f32, idx (N,) int32)."""
    d2 = _sqdist_plain(source, target, tgt_mask)
    if d2.shape[1] == 0:
        n = source.shape[0]
        return (torch.full((n,), BIG, dtype=torch.float32, device=source.device),
                torch.zeros(n, dtype=torch.int32, device=source.device))
    idx = torch.argmin(d2, dim=1)
    return torch.gather(d2, 1, idx[:, None])[:, 0], idx.to(torch.int32)


def nn_min_plain(rows, target, tgt_mask):
    """Plain torch version of nn_min_cuda: (R,) f32, BIG where no target."""
    d2 = _sqdist_plain(rows, target, tgt_mask)
    if d2.shape[1] == 0:
        return torch.full((rows.shape[0],), BIG, dtype=torch.float32,
                          device=rows.device)
    return d2.amin(dim=1)


def _checked(source, target, tgt_mask):
    """Validate what the kernels take; return contiguous operands."""
    if not (source.is_cuda and target.is_cuda and tgt_mask.is_cuda):
        raise ValueError("nn kernels take CUDA tensors (or all-CPU tensors "
                         "for the plain version)")
    if not (source.device == target.device == tgt_mask.device):
        raise ValueError("source, target and tgt_mask must share a device")
    if source.dtype != torch.float32 or target.dtype != torch.float32:
        raise TypeError("source and target must be float32")
    if tgt_mask.dtype != torch.bool:
        raise TypeError("tgt_mask must be bool")
    if source.dim() != 2 or source.shape[1] != 2 or target.dim() != 2 \
            or target.shape[1] != 2 or tgt_mask.shape != (target.shape[0],):
        raise ValueError(f"expected source (N, 2), target (M, 2), mask (M,); got "
                         f"{tuple(source.shape)}, {tuple(target.shape)}, "
                         f"{tuple(tgt_mask.shape)}")
    if source.shape[0] >= 2**31 or target.shape[0] >= 2**31:
        raise ValueError("N and M must fit in int32")
    return source.contiguous(), target.contiguous(), tgt_mask.contiguous()


def nn_cuda(source, target, tgt_mask):
    """Nearest valid target per source row.

    source (N, 2) f32, target (M, 2) f32, tgt_mask (M,) bool; any N, M.
    Returns (d2 (N,) f32 squared distance, idx (N,) int32); ties go to the
    lowest index; a row with no valid target gets (BIG, 0).
    """
    global nn_launches
    if source.device.type == "cpu":
        return nn_plain(source, target, tgt_mask)
    src, tgt, msk = _checked(source, target, tgt_mask)
    n, m = src.shape[0], tgt.shape[0]
    d2 = torch.empty(n, dtype=torch.float32, device=src.device)
    idx = torch.empty(n, dtype=torch.int32, device=src.device)
    if n == 0:
        return d2, idx
    from icp_tpu_torch.ops.hopper.build import load

    lib = load()
    # the runtime launches on the thread's current device, not the stream's
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = lib.icp_nn(src.data_ptr(), tgt.data_ptr(), msk.data_ptr(), n, m,
                         d2.data_ptr(), idx.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"icp_nn kernel launch failed: cudaError {err}")
    nn_launches += 1
    return d2, idx


# nn_min_geometry's cost model, fitted to the times of every geometry at the
# six sweep shapes on an H100 (icp_tpu_torch/tools/nn_min_sweep.py, PERF.md):
# the resident blocks an SM holds (48 registers a thread at k = 8, 32 at
# k = 4; 256 threads a block), and a fixed cost per block and per extra
# block of a cluster, in pairs.
_BLOCKS_PER_SM = {8: 5, 4: 8}
_BLOCK_COST = 8192
_CLUSTER_COST = 8192


@functools.lru_cache(maxsize=256)
def nn_min_geometry(n: int, m: int, sms: int = H100_SMS) -> tuple[int, int, int]:
    """icp_nn_min's launch geometry for n rows x m targets on ``sms`` SMs:
    (k rows per lane, csize blocks to a cluster, slice targets a block).

    A block holds 32 k rows; the csize blocks of a cluster split the
    targets into slices of ``slice`` (even, none empty), and each block's 8
    warps split its slice again. The kernel is issue-bound, so the choice
    minimises the work of the busiest SM: blocks an SM x (32 k slice pairs
    + a fixed cost), plus a cost per extra block of a cluster. Blocks an SM
    is ceil(blocks / sms) while every block is resident at once, and
    blocks / sms beyond that, where the block scheduler evens the load.
    Only geometries that give every SM a block compete, where any does.
    """
    if m == 0:
        return 4, 1, 2
    best = None
    for k, c, sl in nn_min_candidates(m):
        blocks = -(-n // (32 * k)) * c
        per_sm = -(-blocks // sms) if blocks <= _BLOCKS_PER_SM[k] * sms \
            else blocks / sms
        cost = per_sm * (32 * k * sl + _BLOCK_COST) + _CLUSTER_COST * (c - 1)
        key = (blocks < sms, cost, c, -k)
        if best is None or key < best[0]:
            best = (key, (k, c, sl))
    return best[1]


def nn_min_candidates(m: int) -> list[tuple[int, int, int]]:
    """Every geometry (k, csize, slice) icp_nn_min takes for m > 0 targets:
    k in (8, 4), csize slices of an even size, none of them empty."""
    out = []
    for k in (8, 4):
        for c in range(1, NN_MIN_MAX_CLUSTER + 1):
            sl = -(-m // c)
            sl += sl % 2
            if -(-m // sl) == c:
                out.append((k, c, sl))
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def nn_min_cuda(rows, target, tgt_mask):
    """Min squared distance from each row to any valid target.

    rows (R, 2) f32, target (M, 2) f32, tgt_mask (M,) bool; any R, M.
    Returns (R,) f32, BIG where no target is valid.
    """
    global nn_min_launches
    if rows.device.type == "cpu":
        return nn_min_plain(rows, target, tgt_mask)
    src, tgt, msk = _checked(rows, target, tgt_mask)
    n, m = src.shape[0], tgt.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=src.device)
    if n == 0:
        return out
    from icp_tpu_torch.ops.hopper.build import load

    lib = load()
    k, csize, sl = nn_min_geometry(n, m, _sm_count(src.device.index))
    with torch.cuda.device(src.device):     # as in nn_cuda
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = lib.icp_nn_min(src.data_ptr(), tgt.data_ptr(), msk.data_ptr(),
                             n, m, k, csize, sl, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"icp_nn_min kernel launch failed: cudaError {err}")
    nn_min_launches += 1
    return out
