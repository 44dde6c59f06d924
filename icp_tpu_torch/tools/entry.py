"""Entry points of __graft_entry__.py on the port: ``entry()``, the
registration step as one callable with example arguments (the correlative
rotation sweep followed by point-to-line ICP, the hot path of the engine,
on a 256-point two-wall scene), and ``dryrun_multichip(n)``, the
multi-device path driven once over an n-shard mesh."""
from __future__ import annotations

import os
import tempfile

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


# __graft_entry__.py's dry-run engine configuration
DRYRUN_CFG = {
    "icp": {"voxel_size": 0.08, "max_iterations": 12,
            "error_reject_threshold": 5.0},
    "features": {"method": "rotation_search", "rotation_voxel_size": 0.3,
                 "angle_step_coarse": 6.0, "angle_step_fine": 1.0},
    "submap": {"enabled": True, "size": 4, "voxel_size": 0.08,
               "rotation_range": 6.0, "rotation_step": 2.0,
               "rotation_fine_step": 1.0, "rotation_voxel_size": 0.3},
    "loop_closure": {"enabled": True, "min_interval": 4,
                     "max_candidates": 2},
    "filter": {"z_min": 0.0, "z_max": 3.0},
    "mapping": {"resolution": 0.2, "margin": 5.0},
    "tpu": {"scan_capacity": 128, "submap_capacity": 512,
            "max_ray_cells": 128, "batch_scans": 4,
            "distributed": True, "dist_node_threshold": 2},
}


def _run_dryrun_engine(cfg, scans, rels, device):
    from icp_tpu_torch.engine import SlamEngine

    eng = SlamEngine(cfg, imu=None, verbose=False, device=device)
    eng.process_scan(scans[0], rels[0])                # init grid and state
    eng.process_scans_batched(scans[1:], rels[1:])     # fused batches
    eng.finish()
    return eng


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Drive the multi-device path over an ``n_devices``-shard mesh of
    ``device``'s kind (``parallel.mesh.visible_devices``; virtual shards
    count): the engine with ``distributed: true`` (fused batches, loop
    closure verified on the mesh's lanes, ``PoseGraph2D.optimize`` through
    the distributed Schur GN) held within 5 mm of the one-device engine;
    the standalone sharded functions (sweep, dense / PCG / Schur GN steps,
    ray-sharded paint); the block-sharded grid; and the scaled pipeline
    stepped and optimized on the mesh. Raises if fewer than ``n_devices``
    devices are visible."""
    from icp_tpu_torch.engine import filter_and_flatten
    from icp_tpu_torch.parallel.mesh import make_mesh, visible_devices
    from icp_tpu_torch.services.lidar import LidarService
    from icp_tpu_torch.utils.config import SlamConfig
    from icp_tpu_torch.utils.synth import generate_sequence

    kind = torch.device(device).type
    n_vis = len(visible_devices(kind))
    if n_vis < n_devices:
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) needs {n_devices} {kind} devices, "
            f"{n_vis} visible: parallel.mesh.set_virtual_devices({n_devices}, "
            f"...) gives virtual shards")

    # ── 1. the engine on a mesh, against one device ──────────────────────
    with tempfile.TemporaryDirectory() as td:
        lidar_f = os.path.join(td, "lidar.csv")
        imu_f = os.path.join(td, "imu.csv")
        generate_sequence(lidar_f, imu_f, n_scans=10, n_beams=120,
                          noise=0.005, trajectory="straight", seed=5)
        scans, rels = [], []
        for _, rel, raw in LidarService(lidar_f).scans():
            scans.append(filter_and_flatten(raw, 0.0, 3.0))
            rels.append(rel)
    cfg = SlamConfig.from_dict(DRYRUN_CFG)
    eng = _run_dryrun_engine(cfg, scans, rels, device)
    assert eng.mesh is not None and eng.mesh.size == n_vis, eng.mesh
    assert eng.stats.scans >= 8, eng.stats.scans
    # loop-closure verification on the mesh's lanes
    verdicts = eng._lc_verify_batched(scans[-1], [(0, 0.0), (1, 0.1)])
    assert len(verdicts) == 2 and np.isfinite(verdicts[0][2]), verdicts
    # pose-graph optimize -> the distributed Schur GN (threshold 2)
    eng.pose_graph.optimize(n_iterations=2)
    assert eng.pose_graph.last_strategy.startswith("schur"), \
        eng.pose_graph.last_strategy
    assert np.isfinite(np.stack(eng.pose_graph.nodes)).all()
    eng.sync_map()
    assert bool(torch.isfinite(eng.mapper.log_odds).all())

    cfg1 = SlamConfig.from_dict({**DRYRUN_CFG, "tpu": {
        **DRYRUN_CFG["tpu"], "distributed": False}})
    eng1 = _run_dryrun_engine(cfg1, scans, rels, device)
    assert eng1.mesh is None
    assert eng1.stats.scans == eng.stats.scans
    assert eng1.stats.loop_closures == eng.stats.loop_closures
    ta = np.stack([p[:2, 2] for p in eng.pose_trajectory])
    tb = np.stack([p[:2, 2] for p in eng1.pose_trajectory])
    assert ta.shape == tb.shape, (ta.shape, tb.shape)
    max_diff = float(np.max(np.linalg.norm(ta - tb, axis=1)))
    assert max_diff < 5e-3, f"mesh-vs-single trajectory diverged: " \
                            f"{max_diff:.4f} m"

    # ── 2. the standalone sharded functions ──────────────────────────────
    from icp_tpu_torch.parallel.dist_pose_graph import (
        gn_step_cg_sharded, gn_step_schur_sharded, gn_step_sharded,
        partition_graph)
    from icp_tpu_torch.parallel.sharded_grid import (
        block_sharding, raytrace_update_block_sharded,
        raytrace_update_sharded)
    from icp_tpu_torch.parallel.sweep_shard import sweep_scores_sharded

    mesh = make_mesh(n_devices, device=device)
    d0 = mesh.devices[0]
    rng = np.random.default_rng(0)
    t = lambda a, dt=torch.float32: torch.as_tensor(  # noqa: E731
        np.array(a), dtype=dt, device=d0)
    N = M = 64
    src, tgt = t(rng.uniform(-3, 3, (N, 2))), t(rng.uniform(-3, 3, (M, 2)))
    ones_n = torch.ones(N, dtype=torch.bool, device=d0)
    A = 8 * n_devices
    scores = sweep_scores_sharded(mesh, src, ones_n, tgt, ones_n,
                                  t(np.linspace(-np.pi, np.pi, A)),
                                  t(np.zeros(2)), chunk=4)

    n_nodes, n_edges = 16, 4 * n_devices
    nodes = t(np.cumsum(rng.normal(scale=0.1, size=(n_nodes, 3)), 0))
    node_mask = torch.ones(n_nodes, dtype=torch.bool, device=d0)
    ei_np = np.arange(n_edges) % (n_nodes - 1)
    ei, ej = t(ei_np, torch.int64), t(ei_np + 1, torch.int64)
    z = t(rng.normal(scale=0.1, size=(n_edges, 3)))
    om = t(np.broadcast_to(np.eye(3), (n_edges, 3, 3)))
    em = torch.ones(n_edges, dtype=torch.bool, device=d0)
    part = partition_graph(n_nodes, ei_np, ei_np + 1, z.cpu().numpy(),
                           om.cpu().numpy(), np.ones(n_edges, bool),
                           n_devices, 0)
    nodes1 = gn_step_sharded(mesh, nodes, node_mask, ei, ej, z, om, em, 0)
    nodes2 = gn_step_cg_sharded(mesh, nodes1, node_mask, ei, ej, z, om, em,
                                0, cg_iters=8)
    nodes3 = gn_step_schur_sharded(mesh, nodes2, node_mask, part)

    n_rays = 8 * n_devices
    hits = t(rng.integers(0, 32, size=(n_rays, 2)), torch.int64)
    rays_ok = torch.ones(n_rays, dtype=torch.bool, device=d0)
    grid1 = raytrace_update_sharded(
        mesh, torch.zeros((32, 32), device=d0), t([16, 16], torch.int64),
        hits, rays_ok, 0.85, -0.4, -8.0, 8.0, max_steps=64)
    assert scores.shape == (A,)
    for out in (scores, nodes3, grid1):
        assert bool(torch.isfinite(out).all())

    # the row-block-sharded grid: stays sharded in and out
    blocks = block_sharding(mesh, torch.zeros((8 * n_devices, 32),
                                              device=d0))
    blocks = raytrace_update_block_sharded(
        mesh, blocks, t([4, 4], torch.int64), hits % 8, rays_ok, 0.85, -0.4,
        -8.0, 8.0, max_steps=16)
    assert len(blocks) == mesh.local_size
    assert all(bool(torch.isfinite(b).all()) for b in blocks)

    # ── 3. the scaled pipeline (BASELINE config #5) on the mesh ─────────
    from icp_tpu_torch.parallel.scaled import ScaledPipeline
    from icp_tpu_torch.utils.synth import large_scan_stream

    pipe = ScaledPipeline(
        mesh, scan_capacity=2048, extent=10.0, map_resolution=0.25,
        map_margin=4.0, max_range=9.0, icp_max_corr=1.5,
        icp_max_iterations=8, icp_grid_shape=(32, 32), icp_cell_cap=192,
        icp_qcells=2048, kf_capacity=1024, kf_voxel=0.2, lc_every=2,
        lc_min_interval=3, lc_distance=50.0, lc_min_travel=0.0,
        lc_error_threshold=10.0, dist_node_threshold=2,
    )
    for scan, _ in large_scan_stream(6, n_points=2048, extent=10.0,
                                     max_range=9.0, seed=1):
        pipe.step(scan)
    pipe.optimize(n_iterations=2)              # BA + the sharded replay
    assert pipe.stats.wall_replay > 0
    assert bool(torch.isfinite(pipe.log_odds).all())
    assert all(np.isfinite(m).all() for m in pipe.trajectory)
    assert pipe.stats.lc_checked >= 1

    print(f"dryrun_multichip({n_devices}, {kind}): ok: engine on a "
          f"{eng.mesh.size}-shard mesh (fused batches, mesh LC lanes, "
          f"{eng.pose_graph.last_strategy} optimize), within "
          f"{1e3 * max_diff:.3f} mm of one device; sweep {A} angles, GN "
          f"dense + PCG + Schur over {n_edges} edges, {n_rays} rays "
          f"psum-combined, block-sharded grid update; the scaled pipeline "
          f"stepped and optimized on the mesh", flush=True)
