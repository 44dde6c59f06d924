"""Ordered scatter-sum: ``index_add_`` that gives the same bits every run.

torch's CUDA ``index_add_`` adds through float atomics, so the order of
the additions into a slot, and with it the rounding, changes from run to
run. ``ordered_index_add_`` returns what CPU ``out.index_add_(0, index,
src)`` returns, bit for bit, on either device: each slot starts from
``out``'s value and adds its source rows in ascending source-row order.

On the CPU it is ``index_add_`` itself (the plain version). For CUDA
tensors it takes a stable sort of the index (skipped with
``sorted_index=True``) and launches ``icp_segment_add``
(``csrc/segment_add.cu``, built by ``ops/hopper/build.py`` at first use),
or raises; it never falls back to ``index_add_``. ``segment_add_launches``
counts kernel launches.

A caller that adds with one index several times sorts it once
(``torch.sort(index, stable=True)``), permutes its values and passes
``sorted_index=True``. Several ``index_add_`` calls into one buffer are
one call with the indices and values concatenated in call order: the
stable sort keeps each slot's rows in that order.
"""
from __future__ import annotations

import math

import torch

segment_add_launches = 0

_DTYPES = {torch.float32: 0, torch.float64: 1}


def reset_launch_counts() -> None:
    global segment_add_launches
    segment_add_launches = 0


def ordered_index_add_(out, index, src, *, sorted_index: bool = False):
    """``out.index_add_(0, index, src)`` with the CPU's summation order.

    out (S, ...) float32 or float64, updated in place and returned; index
    (N,) integer slots in [0, S); src (N, ...) of out's dtype and trailing
    shape. ``sorted_index=True`` promises a non-decreasing index (the sort
    is skipped); a wrong promise gives wrong sums.
    """
    global segment_add_launches
    if out.device.type == "cpu":
        return out.index_add_(0, index, src)
    if not (out.is_cuda and index.device == out.device
            and src.device == out.device):
        raise ValueError("ordered_index_add_ takes out, index and src on one "
                         "CUDA device (or all on the CPU for the plain "
                         "version)")
    if out.dtype not in _DTYPES or src.dtype != out.dtype:
        raise TypeError(f"out and src must share float32 or float64, got "
                        f"{out.dtype} and {src.dtype}")
    if index.dim() != 1 or index.dtype not in (torch.int64, torch.int32) \
            or src.shape[:1] != index.shape or src.shape[1:] != out.shape[1:]:
        raise ValueError(f"expected index (N,) int, src (N, ...) matching out "
                         f"(S, ...); got {tuple(index.shape)} {index.dtype}, "
                         f"{tuple(src.shape)}, {tuple(out.shape)}")
    if not out.is_contiguous():
        raise ValueError("ordered_index_add_ updates out in place: it must "
                         "be contiguous")
    n = index.shape[0]
    width = math.prod(out.shape[1:])
    if n == 0 or width == 0:
        return out
    if sorted_index:
        sidx, perm = index.to(torch.int64).contiguous(), None
    elif out.shape[0] <= 2**31:
        # 32-bit keys: half the radix passes of the sort
        sidx, perm = torch.sort(index.to(torch.int32), stable=True)
        sidx = sidx.to(torch.int64)
    else:
        sidx, perm = torch.sort(index.to(torch.int64), stable=True)
    src = src.contiguous()
    from icp_tpu_torch.ops.hopper.build import load

    lib = load("segment_add")
    # the runtime launches on the thread's current device, not the stream's
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = lib.icp_segment_add(
            out.data_ptr(), src.data_ptr(), sidx.data_ptr(),
            perm.data_ptr() if perm is not None else None, n, width,
            out.shape[0], _DTYPES[out.dtype], stream)
    if err != 0:
        raise RuntimeError(f"icp_segment_add kernel launch failed: "
                           f"cudaError {err}")
    segment_add_launches += 1
    return out
