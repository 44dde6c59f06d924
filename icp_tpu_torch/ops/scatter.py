"""Ordered scatter-sum: ``index_add_`` that gives the same bits every run.

torch's CUDA ``index_add_`` adds through float atomics, so the order of
the additions into a slot, and with it the rounding, changes from run to
run. ``ordered_index_add_`` returns what CPU ``out.index_add_(0, index,
src)`` returns, bit for bit, on either device: each slot starts from
``out``'s value and adds its source rows in ascending source-row order.

On the CPU it is ``index_add_`` itself (the plain version). For CUDA
tensors it launches ``icp_segment_add`` (``csrc/segment_add.cu``, built by
``ops/hopper/build.py`` at first use) on a segment plan, or raises; it
never falls back to ``index_add_``. ``segment_add_launches`` counts kernel
launches, ``segment_plan_builds`` the plans built (span
``scatter.segment_plan``, see ``utils.spans``).

A segment plan (``segment_plan``) is the index in the kernel's order: a
stable sort on 32-bit keys and its permutation, built on the device with
no host read. A caller that adds with one index many times (a pose-graph
solve: H, b and every CG product) builds it once and passes it in place
of the index. ``keep`` leaves rows out: they take the key ``n_slots``, sort
to the end and are never walked. Leave out only rows whose values are
+-0: a slot starts at +0 and, in round-to-nearest, x + (+-0) = x for every
x but -0, which such a sum never holds, so the kept rows alone give
``index_add_``'s bits of all the rows (a pose graph's padded edges, whose
information matrices are 0). An index already in order needs no plan:
``sorted_index=True`` (the voxel means). Several ``index_add_`` calls into
one buffer are one call with the indices and values concatenated in call
order: the stable sort keeps each slot's rows in that order.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from icp_tpu_torch.utils import spans

segment_add_launches = 0
segment_plan_builds = 0

_DTYPES = {torch.float32: 0, torch.float64: 1}
_MAX_WIDTH = 256                 # csrc/segment_add.cu: a block owns a row


class SegmentPlan(NamedTuple):
    """An index in ``icp_segment_add``'s order (``segment_plan``)."""
    index: torch.Tensor          # (N,) the slots as given
    keep: torch.Tensor | None    # (N,) bool: the rows added; None: all
    n_slots: int
    slots: torch.Tensor | None   # card: (N,) sorted keys, left out n_slots
    perm: torch.Tensor | None    # card: (N,) int32 sorted position -> row


def reset_launch_counts() -> None:
    global segment_add_launches, segment_plan_builds
    segment_add_launches = 0
    segment_plan_builds = 0


def segment_plan(index, n_slots: int, keep=None) -> SegmentPlan:
    """Sort ``index`` (N,) once for ``ordered_index_add_``: rows where
    ``keep`` (N,) bool is False are left out. On a card the stable sort
    and its permutation are computed here, on the device; on the CPU the
    plan holds the index and mask for ``index_add_``."""
    global segment_plan_builds
    segment_plan_builds += 1
    if index.dim() != 1 or index.dtype not in (torch.int64, torch.int32):
        raise ValueError(f"expected an index (N,) of int, got "
                         f"{tuple(index.shape)} {index.dtype}")
    if keep is not None and (keep.shape != index.shape
                             or keep.dtype != torch.bool):
        raise ValueError(f"keep must be (N,) bool like the index, got "
                         f"{tuple(keep.shape)} {keep.dtype}")
    if isinstance(n_slots, torch.Tensor):
        spans.count("sync.scatter.n_slots")
    n_slots = int(n_slots)
    if index.device.type == "cpu":
        return SegmentPlan(index, keep, n_slots, None, None)
    with spans.span("scatter.segment_plan"):
        return SegmentPlan(index, keep, n_slots,
                           *_plan_order(index, n_slots, keep))


def _plan_order(index, n_slots: int, keep=None):
    """(sorted keys, int32 permutation) of a plan on the card: left-out
    rows take the key n_slots, and a stable sort puts them last."""
    if index.shape[0] >= 2**31 - 1:
        raise ValueError("icp_segment_add takes fewer than 2**31 rows")
    # 32-bit keys: half the radix passes of the sort
    key = index.to(torch.int32 if n_slots < 2**31 - 1 else torch.int64)
    if keep is not None:
        key = torch.where(keep, key, n_slots)
    slots, perm = torch.sort(key, stable=True)
    return slots, perm.to(torch.int32)


def _sorted_plan(index, n_slots: int) -> SegmentPlan:
    """A plan for an index already in order: no sort, no permutation."""
    return SegmentPlan(index, None, n_slots, index.contiguous(), None)


def ordered_index_add_(out, index, src, *, sorted_index: bool = False):
    """``out.index_add_(0, index, src)`` with the CPU's summation order.

    out (S, ...) float32 or float64, updated in place and returned; index
    (N,) integer slots in [0, S), or a ``SegmentPlan`` of S slots; src (N,
    ...) of out's dtype and trailing shape. ``sorted_index=True`` promises
    a non-decreasing index (no sort); a wrong promise gives wrong sums.
    """
    global segment_add_launches
    plan = index if isinstance(index, SegmentPlan) else None
    rows = plan.index if plan is not None else index
    if out.device.type == "cpu":
        if plan is not None and plan.keep is not None:
            return out.index_add_(0, rows[plan.keep], src[plan.keep])
        return out.index_add_(0, rows, src)
    if not (out.is_cuda and rows.device == out.device
            and src.device == out.device):
        raise ValueError("ordered_index_add_ takes out, index and src on one "
                         "CUDA device (or all on the CPU for the plain "
                         "version)")
    if out.dtype not in _DTYPES or src.dtype != out.dtype:
        raise TypeError(f"out and src must share float32 or float64, got "
                        f"{out.dtype} and {src.dtype}")
    if rows.dim() != 1 or rows.dtype not in (torch.int64, torch.int32) \
            or src.shape[:1] != rows.shape or src.shape[1:] != out.shape[1:]:
        raise ValueError(f"expected index (N,) int, src (N, ...) matching out "
                         f"(S, ...); got {tuple(rows.shape)} {rows.dtype}, "
                         f"{tuple(src.shape)}, {tuple(out.shape)}")
    if not out.is_contiguous():
        raise ValueError("ordered_index_add_ updates out in place: it must "
                         "be contiguous")
    n = rows.shape[0]
    width = math.prod(out.shape[1:])
    if n == 0 or width == 0:
        return out
    if width > _MAX_WIDTH:
        raise ValueError(f"icp_segment_add adds rows of at most {_MAX_WIDTH} "
                         f"values, got {width}")
    if plan is None:
        plan = (_sorted_plan(index, out.shape[0]) if sorted_index
                else segment_plan(index, out.shape[0]))
    elif plan.n_slots != out.shape[0] or plan.slots is None:
        raise ValueError(f"the plan is for {plan.n_slots} slots on "
                         f"{plan.index.device}, out has {out.shape[0]} on "
                         f"{out.device}")
    src = src.contiguous()
    from icp_tpu_torch.ops.hopper.build import load

    lib = load("segment_add")
    # the runtime launches on the thread's current device, not the stream's
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = lib.icp_segment_add(
            out.data_ptr(), src.data_ptr(), plan.slots.data_ptr(),
            plan.perm.data_ptr() if plan.perm is not None else None, n,
            width, out.shape[0], _DTYPES[out.dtype],
            int(plan.slots.dtype == torch.int64), stream)
    if err != 0:
        raise RuntimeError(f"icp_segment_add kernel launch failed: "
                           f"cudaError {err}")
    segment_add_launches += 1
    return out
