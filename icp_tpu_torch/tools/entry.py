"""The registration step as one callable with example arguments
(counterpart of ``entry()`` in __graft_entry__.py): the correlative
rotation sweep followed by point-to-line ICP, the hot path of the engine,
on a 256-point two-wall scene."""
from __future__ import annotations

import numpy as np
import torch


def entry(device="cuda"):
    """(fn, example_args): ``fn(src, src_mask, tgt, tgt_mask)`` returns the
    ICP's (R, t, error); the example tensors lie on ``device``."""
    from icp_tpu_torch.models.icp import icp_core
    from icp_tpu_torch.models.prealign import rotation_search

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("entry(device='cuda') but CUDA is not available; "
                           "pass device='cpu' explicitly")

    def registration_step(src, src_mask, tgt, tgt_mask):
        R0, t0, _ = rotation_search(
            src, src_mask, tgt, tgt_mask,
            voxel_size=0.15, angle_step_coarse=6.0, angle_step_fine=1.0,
        )
        res = icp_core(
            src, src_mask, tgt, tgt_mask, R0, t0,
            method="point_to_line", max_iterations=30, normal_k=10,
            error_threshold=1e-9,
        )
        return res.R, res.t, res.error

    n = 256
    rng = np.random.default_rng(0)
    t = np.linspace(0, 1, n // 2)
    pts = np.concatenate([
        np.stack([t * 6 - 3, np.full(n // 2, -2.0)], 1),
        np.stack([np.full(n // 2, 3.0), t * 4 - 2], 1),
    ]).astype(np.float32)
    pts += rng.normal(scale=0.01, size=pts.shape).astype(np.float32)
    th = 0.3
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]],
                 np.float32)
    src = pts @ R
    mask = np.ones(n, bool)
    example_args = tuple(torch.as_tensor(a, device=dev)
                         for a in (src, mask, pts, mask))
    return registration_step, example_args
