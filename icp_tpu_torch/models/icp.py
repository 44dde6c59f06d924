"""Iterative Closest Point on masked clouds (counterpart of
icp_tpu.models.icp: ``ICPResult``, ``icp_core``, ``icp``).

Each iteration is {NN query, correspondence gate, closed-form solve,
accumulate, convergence check} on device tensors. icp_tpu runs the loop as
one ``lax.while_loop``; here the iteration count depends on the data, and
reading the stop flag after every iteration would cost one host sync per
iteration. So the loop runs in chunks of ``_CHUNK`` iterations and reads
the flag once per chunk: once ``stop`` is set (or the iteration budget is
spent) every later iteration of the chunk leaves the state untouched, so the
result is exactly the while-loop's, at the cost of at most ``_CHUNK - 1``
wasted iterations.

Convergence as in icp_tpu (reference icp.py:215-218): stop when
|prev_error - error| < max(error_threshold, 32 ulp of error), where error
is the mean squared point-to-point NN residual over the valid sources.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from icp_tpu_torch.ops.eig2 import estimate_normals
from icp_tpu_torch.ops.hopper.nn_kernel import nn_cuda
from icp_tpu_torch.ops.nn import nn_query
from icp_tpu_torch.ops.rigid import p2l_solve_2d, p2p_solve_2d
from icp_tpu_torch.ops.voxel import voxel_downsample
from icp_tpu_torch.utils.masking import masked_mean

_F32_EPS = 1.1920929e-07
_CHUNK = 8          # ICP iterations between two reads of the stop flag


class ICPResult(NamedTuple):
    R: torch.Tensor          # (2, 2) accumulated rotation
    t: torch.Tensor          # (2,) accumulated translation
    error: torch.Tensor      # scalar mean squared NN residual
    iters: torch.Tensor      # iterations executed (int32)
    n_inliers: torch.Tensor  # inlier count at the last executed iteration


def icp_core(
    source, src_mask, target, tgt_mask, R_init, t_init,
    *,
    method: str = "point_to_point",
    max_iterations: int = 100,
    normal_k: int = 10,
    error_threshold=1e-7,
    max_corr_dist=0.0,
    use_gate: bool = False,
    nn_impl: str = "auto",
):
    """ICP on already-downsampled masked 2-D clouds.

    source/target (N, 2)/(M, 2) with masks; R_init (2, 2), t_init (2,).
    ``nn_impl``: "xla" uses the plain torch distance-matrix query
    (ops/nn.nn_query); any other value uses the NN kernel wrapper
    ``nn_cuda``, which launches the CUDA kernel on CUDA tensors and runs
    its plain version on CPU tensors. Both break ties toward the lower
    index.
    """
    if source.shape[1] != 2:
        raise NotImplementedError("the port's icp_core is 2-D only")
    dev = source.device
    f32 = torch.float32
    use_p2l = method == "point_to_line"
    use_kernel = nn_impl != "xla"

    n_valid = src_mask.to(f32).sum()
    min_inliers = torch.clamp(torch.floor(n_valid / 10.0), min=3.0)
    max_corr_sq = torch.tensor(max_corr_dist, dtype=f32, device=dev) ** 2
    err_thresh = torch.tensor(error_threshold, dtype=f32, device=dev)
    target_normals = (estimate_normals(target, tgt_mask, k=normal_k)
                      if use_p2l else None)

    it = torch.zeros((), dtype=torch.int32, device=dev)
    transformed = source @ R_init.T + t_init
    r_total, t_total = R_init, t_init
    error = torch.tensor(float("inf"), dtype=f32, device=dev)
    stop = torch.zeros((), dtype=torch.bool, device=dev)
    n_in = torch.zeros((), dtype=f32, device=dev)

    done = 0
    while done < max_iterations:
        for _ in range(min(_CHUNK, max_iterations - done)):
            live = ~stop        # it < max_iterations holds: the host counts
            if use_kernel:
                d2, nn_idx = nn_cuda(transformed, target, tgt_mask)
                nn_dists = torch.sqrt(d2)
                nn_idx = nn_idx.long()
            else:
                nn_dists, nn_idx = nn_query(transformed, target, tgt_mask,
                                            src_mask)
            nearest = target[nn_idx]
            if use_gate:
                inlier = (nn_dists * nn_dists < max_corr_sq) & src_mask
            else:
                inlier = src_mask
            w = inlier.to(f32)
            n_in_new = w.sum()
            abort = n_in_new < min_inliers     # reference icp.py:186-187

            if use_p2l:
                r, t = p2l_solve_2d(transformed, nearest,
                                    target_normals[nn_idx], w)
            else:
                r, t = p2p_solve_2d(transformed, nearest, w)

            new_transformed = transformed @ r.T + t
            sq = ((nearest - new_transformed) ** 2).sum(-1)
            new_error = masked_mean(sq, src_mask)
            delta = torch.abs(error - new_error)
            eff_thresh = torch.maximum(err_thresh, 32.0 * _F32_EPS * new_error)
            converged = delta < eff_thresh

            # on abort keep the state (the reference breaks before applying
            # the solve); after stop, keep everything
            apply = live & ~abort
            transformed = torch.where(apply, new_transformed, transformed)
            r_total = torch.where(apply, r @ r_total, r_total)
            t_total = torch.where(apply, t_total @ r.T + t, t_total)
            error = torch.where(apply, new_error, error)
            n_in = torch.where(live, n_in_new, n_in)
            it = it + live.to(torch.int32)
            stop = stop | abort | converged
            done += 1
        if bool(stop):          # one host sync per chunk
            break
    return ICPResult(r_total, t_total, error, it, n_in.to(torch.int32))


def icp(
    source, src_mask, target, tgt_mask, R_init, t_init,
    *,
    voxel_size,
    method: str = "point_to_point",
    max_iterations: int = 100,
    normal_k: int = 10,
    error_threshold=1e-7,
    max_corr_dist=0.0,
    use_gate: bool = False,
    nn_impl: str = "auto",
):
    """Full ICP entry: voxel-downsample both clouds, then run icp_core."""
    src_d, src_dm = voxel_downsample(source, src_mask, voxel_size)
    tgt_d, tgt_dm = voxel_downsample(target, tgt_mask, voxel_size)
    return icp_core(
        src_d, src_dm, tgt_d, tgt_dm, R_init, t_init,
        method=method, max_iterations=max_iterations, normal_k=normal_k,
        error_threshold=error_threshold, max_corr_dist=max_corr_dist,
        use_gate=use_gate, nn_impl=nn_impl,
    )

