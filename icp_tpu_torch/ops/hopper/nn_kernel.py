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
"""
from __future__ import annotations

import torch

from icp_tpu_torch.utils.masking import BIG

nn_launches = 0
nn_min_launches = 0


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
    stream = torch.cuda.current_stream(src.device).cuda_stream
    err = lib.icp_nn(src.data_ptr(), tgt.data_ptr(), msk.data_ptr(), n, m,
                     d2.data_ptr(), idx.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"icp_nn kernel launch failed: cudaError {err}")
    nn_launches += 1
    return d2, idx


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
    stream = torch.cuda.current_stream(src.device).cuda_stream
    err = lib.icp_nn_min(src.data_ptr(), tgt.data_ptr(), msk.data_ptr(), n, m,
                         out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"icp_nn_min kernel launch failed: cudaError {err}")
    nn_min_launches += 1
    return out
