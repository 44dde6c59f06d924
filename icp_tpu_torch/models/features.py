"""Feature-based pre-alignment: curvature keypoints, sorted-distance
descriptors, Lowe-ratio matching and batched RANSAC (counterpart of
icp_tpu.models.features, under its names).

icp_tpu leaves all of this to XLA, so here it is plain torch. Where its
form answers a TPU cost, the semantics are ported instead:

* keypoint NMS: icp_tpu scans blocks of 32 candidates with the greedy loop
  unrolled inside each (scan latency on a TPU). Ported as written it would
  issue thousands of launches per cloud. Here the greedy result is the
  fixed point of a relaxation over the (N, N) "earlier and closer than
  min_dist" matrix (see ``extract_keypoints``);
* ties: ``lax.top_k`` and ``jnp.argsort`` put the lower index first, so
  the port uses stable sorts and first-index ``argmin``;
* RANSAC draws its uniforms from a ``torch.Generator``, or takes them
  injected (``uniforms=(u1, u2)``) so a test can hold it to icp_tpu's key.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from icp_tpu_torch.ops.eig2 import compute_curvature
from icp_tpu_torch.ops.nn import knn_query, pairwise_sqdist
from icp_tpu_torch.ops.ransac import ransac_align, ransac_from_uniforms
from icp_tpu_torch.ops.voxel import voxel_downsample
from icp_tpu_torch.utils.masking import BIG

_NMS_CHUNK = 4      # relaxation passes between two reads of the fixed-point test


def _f32_square(x: float) -> float:
    """x * x rounded in f32, as icp_tpu squares a traced f32 threshold."""
    return float(np.float32(x) * np.float32(x))


def extract_keypoints(points, mask, curvatures, *, top_n: int = 100,
                      min_dist=0.3):
    """Greedy descending-curvature selection with spatial NMS (reference
    extract_keypoints, features.py:57-71): walk the valid points by
    descending curvature (stable, so equal curvatures keep index order) and
    keep a point unless an already kept point lies closer than
    ``min_dist``; stop at ``top_n``.

    Returns (kp_idx (top_n,) int64 indices into ``points`` in selection
    order, kp_mask (top_n,) bool); unused slots hold index 0.

    With C[i, j] = "sorted point j comes before i and lies closer than
    min_dist", the greedy set is the unique fixed point of
    ``kept = valid & ~any(C & kept)``: point i's verdict depends only on
    earlier points, so relaxing from ``kept = valid`` fixes at least one
    more leading point per pass. The flag is read once per ``_NMS_CHUNK``
    passes. The ``top_n`` cap only stops the walk, and a later point never
    suppresses an earlier one, so the capped set is the first ``top_n`` of
    the uncapped one.
    """
    n = points.shape[0]
    dev = points.device
    order = torch.argsort(-torch.where(mask, curvatures, -1.0), stable=True)
    ps = points[order]
    ms = mask[order]
    d2 = ((ps[:, None, :] - ps[None, :, :]) ** 2).sum(-1)
    earlier = torch.ones((n, n), dtype=torch.bool, device=dev).tril(-1)
    clash = (d2 < _f32_square(min_dist)) & earlier
    kept = ms
    while True:
        for _ in range(_NMS_CHUNK):
            prev, kept = kept, ms & ~(clash & kept[None, :]).any(1)
        if torch.equal(kept, prev):            # one host read per chunk
            break
    rank = torch.cumsum(kept.to(torch.int64), 0) - 1
    take = kept & (rank < top_n)
    # compact the kept slots to the front, in order; the rest go to the
    # sentinel slot top_n, which is cut off
    slot = torch.where(take, rank, top_n)
    kp_idx = torch.zeros(top_n + 1, dtype=torch.int64, device=dev)
    kp_idx.scatter_(0, slot, order)
    kp_mask = torch.arange(top_n, device=dev) < take.sum()
    return kp_idx[:top_n], kp_mask


def compute_descriptors(points, mask, kp_idx, kp_mask, *, k: int = 30):
    """Sorted distances to the k nearest points, self excluded: a
    rotation-invariant descriptor per keypoint (reference features.py:76-87).
    Returns (top_n, k) f32; masked keypoints' rows are BIG."""
    dists, _ = knn_query(points[kp_idx], kp_mask, points, mask, k + 1)
    return dists[:, 1:]                            # drop the self column


def match_descriptors(da, ma, db, mb, ratio=0.8):
    """Lowe-ratio nearest-descriptor matching (reference features.py:92-106).

    Returns (match_j (A,) int64 row of db, match_mask (A,) bool). The first
    index of the row minimum wins a tie, as ``lax.top_k`` orders it; the
    second-smallest distance is the minimum with that one entry removed.
    """
    D = pairwise_sqdist(da, db, mb)                # (A, B), masked cols BIG
    j0 = torch.argmin(D, dim=1)
    d0 = torch.gather(D, 1, j0[:, None])[:, 0]
    d1 = D.scatter(1, j0[:, None], torch.inf).amin(dim=1)
    nb = mb.sum()
    ok = ma & (d0 < _f32_square(ratio) * d1) & (d1 < BIG) & (nb >= 2)
    return j0, ok


def compact_matches(src_kp, dst_kp, match_j, match_mask):
    """Gather the matched pairs and compact the valid ones to the front, in
    order. Returns (src (A, 2), dst (A, 2), pair_mask (A,))."""
    a = src_kp.shape[0]
    order = torch.argsort((~match_mask).to(torch.int32), stable=True)
    pair_mask = torch.arange(a, device=src_kp.device) < match_mask.sum()
    return src_kp[order], dst_kp[match_j[order]], pair_mask


class FeatureSet(NamedTuple):
    """Features of one cloud. ``kp_xy`` holds the keypoint coordinates, so a
    cached set needs no gather into its cloud later."""
    pts: torch.Tensor       # (cap, 2) voxel-downsampled cloud
    mask: torch.Tensor      # (cap,)
    kp_xy: torch.Tensor     # (top_n, 2) keypoint coordinates
    kp_mask: torch.Tensor   # (top_n,)
    desc: torch.Tensor      # (top_n, k_descriptor)


def blank_features(cap: int, top_n: int, k_descriptor: int,
                   device="cpu") -> FeatureSet:
    """All-invalid FeatureSet of the given shapes."""
    f32 = torch.float32
    return FeatureSet(
        pts=torch.zeros((cap, 2), dtype=f32, device=device),
        mask=torch.zeros(cap, dtype=torch.bool, device=device),
        kp_xy=torch.zeros((top_n, 2), dtype=f32, device=device),
        kp_mask=torch.zeros(top_n, dtype=torch.bool, device=device),
        desc=torch.zeros((top_n, k_descriptor), dtype=f32, device=device),
    )


def extract_features(points, mask, *, voxel_size=0.2, k_curvature: int = 10,
                     top_n: int = 100, min_kp_dist=0.3,
                     k_descriptor: int = 30) -> FeatureSet:
    """Per-cloud half of the pipeline: downsample, curvature, keypoints,
    descriptors (reference features.py:283-295). A function of the cloud
    alone, so the fused step can cache a scan's set for the next pair."""
    pts, m = voxel_downsample(points, mask, voxel_size)
    curv = compute_curvature(pts, m, k=k_curvature)
    kpi, kpm = extract_keypoints(pts, m, curv, top_n=top_n,
                                 min_dist=min_kp_dist)
    desc = compute_descriptors(pts, m, kpi, kpm, k=k_descriptor)
    return FeatureSet(pts=pts, mask=m, kp_xy=pts[kpi], kp_mask=kpm,
                      desc=desc)


def match_and_align(fs: FeatureSet, ft: FeatureSet, generator=None, *,
                    uniforms=None, ratio_threshold=0.8,
                    ransac_iterations: int = 1000, inlier_threshold=0.5):
    """Pair half: matching, RANSAC and the failure gates (reference
    features.py:298-315). RANSAC draws ``ransac_iterations`` hypotheses from
    ``generator``, or takes ``uniforms`` = (u1, u2) as given. Returns
    (R (2, 2), t (2,), n_inliers int32); (I, 0, 0) on every failure path."""
    match_j, match_mask = match_descriptors(fs.desc, fs.kp_mask, ft.desc,
                                            ft.kp_mask, ratio_threshold)
    m_src, m_dst, pair_mask = compact_matches(fs.kp_xy, ft.kp_xy, match_j,
                                              match_mask)
    if uniforms is not None:
        R, t, n_inliers = ransac_from_uniforms(
            m_src, m_dst, pair_mask, *uniforms,
            inlier_thresh=inlier_threshold)
    else:
        R, t, n_inliers = ransac_align(
            m_src, m_dst, pair_mask, generator, n_iter=ransac_iterations,
            inlier_thresh=inlier_threshold)
    enough = ((fs.mask.sum() >= 10) & (ft.mask.sum() >= 10)
              & (fs.kp_mask.sum() >= 2) & (ft.kp_mask.sum() >= 2)
              & (match_mask.sum() >= 2))
    R = torch.where(enough, R, torch.eye(2, dtype=R.dtype, device=R.device))
    t = torch.where(enough, t, 0.0)
    return R, t, torch.where(enough, n_inliers, 0)


def feature_based_alignment(source, src_mask, target, tgt_mask,
                            generator=None, *, uniforms=None, voxel_size=0.2,
                            k_curvature: int = 10, top_n: int = 100,
                            min_kp_dist=0.3, k_descriptor: int = 30,
                            ratio_threshold=0.8,
                            ransac_iterations: int = 1000,
                            inlier_threshold=0.5):
    """The whole feature alignment of source onto target (reference
    features.py:247-315): extract_features per cloud, then match_and_align.
    Returns (R, t, n_inliers); (I, 0, 0) on every failure path."""
    kw = dict(voxel_size=voxel_size, k_curvature=k_curvature, top_n=top_n,
              min_kp_dist=min_kp_dist, k_descriptor=k_descriptor)
    fs = extract_features(source, src_mask, **kw)
    ft = extract_features(target, tgt_mask, **kw)
    return match_and_align(fs, ft, generator, uniforms=uniforms,
                           ratio_threshold=ratio_threshold,
                           ransac_iterations=ransac_iterations,
                           inlier_threshold=inlier_threshold)
