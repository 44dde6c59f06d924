"""Sharded correlative sweep (counterpart of icp_tpu.parallel.sweep_shard).

Rotation-search angles are independent of each other: each shard scores
its block of the angle axis against the whole point clouds with
``ops.sweep.sweep_scores`` on its own device (which launches
``nn_min_cuda`` there), and the blocks are gathered. On one device the
sharded scores equal the unsharded ones bit for bit.
"""
from __future__ import annotations

from icp_tpu_torch.ops.sweep import sweep_scores
from icp_tpu_torch.parallel.mesh import Mesh


def sweep_scores_sharded(mesh: Mesh, source, src_mask, target, tgt_mask,
                         angles, t_offset, *, axis: str = "d",
                         chunk: int = 8):
    """``sweep_scores`` with the angle axis split over the mesh.

    ``angles`` (A,) with A a multiple of the mesh size (pad with extra
    angles and drop their scores: the caller's part, as in icp_tpu). The
    clouds and ``t_offset`` come in whole. ``axis`` names the mesh's only
    axis and ``chunk`` is accepted and unused, as in the port's sweep.
    Returns the (A,) scores on the mesh's first device."""
    del axis, chunk
    parts = []
    for dev, angs in zip(mesh.devices, mesh.split(angles)):
        parts.append(sweep_scores(source.to(dev), src_mask.to(dev),
                                  target.to(dev), tgt_mask.to(dev), angs,
                                  t_offset.to(dev)))
    return mesh.all_gather(parts)
