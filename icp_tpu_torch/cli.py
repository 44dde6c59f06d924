"""Command-line entry: python -m icp_tpu_torch.cli --config configs/default.yaml

The run path of icp_tpu.cli on the port: load a YAML config (the same
schema), optionally write a synthetic sequence first (``--synth``), run
SLAM on ``--device`` (default cuda), loop closure included where the
config enables it, and save the occupancy grid; ``--checkpoint`` saves the
whole SLAM state at the end and ``--resume`` restores one first (the npz
of either package); ``--map-png`` also renders the final map with the
trajectory, and ``--profile DIR`` runs the engine under ``torch.profiler``
and writes a Chrome trace into DIR. ``--scaled`` runs the scaled pipeline
(parallel/scaled.py, BASELINE config #5) instead of the engine, over a mesh
of every visible device of ``--device``'s kind (``parallel.mesh.make_mesh``;
one device, a one-shard mesh), with its knobs under the config's
``scaled:`` section. It joins a multi-process run first where the launcher
sets JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and JAX_PROCESS_ID
(``parallel.mesh.init_distributed``), as icp_tpu's does.
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="2D SLAM on PyTorch/CUDA (ICP + submap + pose graph + "
                    "mapping)")
    parser.add_argument("--config", type=str, default="configs/default.yaml",
                        help="YAML configuration file")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (default: cuda)")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--profile", type=str, default=None, metavar="DIR",
                        help="capture a torch.profiler trace into DIR")
    parser.add_argument("--map-png", type=str, default=None,
                        help="also render the final map (+trajectory) to PNG")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="save full SLAM state to this .npz at the end")
    parser.add_argument("--save-traj", type=str, default=None,
                        help="save the pose trajectory (N, 3, 3) to .npy")
    parser.add_argument("--resume", type=str, default=None,
                        help="restore SLAM state from a checkpoint first")
    parser.add_argument("--synth", action="store_true",
                        help="generate a synthetic sequence at data_file/imu "
                             "paths from the config before running")
    parser.add_argument("--synth-scans", type=int, default=200)
    parser.add_argument("--synth-beams", type=int, default=720)
    parser.add_argument("--synth-noise", type=float, default=0.005)
    parser.add_argument("--scaled", action="store_true",
                        help="run the scaled pipeline (parallel/scaled.py: "
                             "scan-to-submap registration, block-sharded map "
                             "allocated up front, online BA) over a mesh of "
                             "the visible devices instead of the engine; "
                             "knobs under the config's `scaled:` section")
    args = parser.parse_args(argv)

    from icp_tpu_torch.utils.config import SlamConfig
    cfg = SlamConfig.from_yaml(args.config)

    if args.synth:
        from icp_tpu_torch.utils.synth import generate_sequence
        os.makedirs(os.path.dirname(cfg.data_file) or ".", exist_ok=True)
        gt = generate_sequence(
            cfg.data_file,
            cfg.imu_file or (cfg.data_file + ".imu.csv"),
            n_scans=args.synth_scans,
            n_beams=args.synth_beams,
            noise=args.synth_noise,
        )
        np.save(cfg.data_file + ".gt.npy", gt)
        print(f"synthetic sequence written: {cfg.data_file} "
              f"({args.synth_scans} scans)")

    if args.scaled:
        return _run_scaled(cfg, args)

    from icp_tpu_torch.engine import run_slam

    def run():
        return run_slam(cfg, verbose=not args.quiet, device=args.device,
                        resume=args.resume)

    if args.profile:
        global_pose, trajectory, mapper, engine = _profiled(run, args.profile)
    else:
        global_pose, trajectory, mapper, engine = run()

    print("global_pose:\n", global_pose)
    s = engine.stats
    print(f"scans={s.scans} rejected={s.rejected} "
          f"submap_corr={s.submap_corrections} loop_closures={s.loop_closures} "
          f"icp_iters={s.icp_iters}")
    print(f"wall: registration={s.wall_registration:.2f}s "
          f"mapping={s.wall_mapping:.2f}s lc={s.wall_loop_closure:.2f}s")
    print(f"lidar parser: {engine.lidar_parser}")

    if mapper is not None:
        for path in (cfg.out_csv, cfg.out_npy):
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
        mapper.save_csv(cfg.out_csv)
        mapper.save_npy(cfg.out_npy)
        print(f"map saved: {cfg.out_csv}, {cfg.out_npy}")
        if args.map_png:
            traj_xy = np.array([[p[0, 2], p[1, 2]] for p in trajectory])
            mapper.save_png(args.map_png, trajectory=traj_xy)
            print(f"map render: {args.map_png}")

    if args.save_traj and trajectory:
        np.save(args.save_traj, np.stack(trajectory))
        print(f"trajectory saved: {args.save_traj} ({len(trajectory)} poses)")

    if args.checkpoint:
        engine.save_checkpoint(args.checkpoint)
        print(f"checkpoint saved: {args.checkpoint}")


def _profiled(run, trace_dir):
    """``run()`` under torch.profiler (CPU activity and, where the run
    reaches a card, CUDA activity); the Chrome trace goes into
    ``trace_dir`` (open it in chrome://tracing or Perfetto)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        out = run()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(trace_dir, "icp_tpu_torch.trace.json")
    prof.export_chrome_trace(path)
    print(f"profiler trace written to {path}")
    return out


def _run_scaled(cfg, args):
    """Drive the scaled pipeline from the same config and CSV inputs as the
    engine. Reference-schema knobs map across (mapping / loop_closure
    sections); scale knobs live under ``scaled:`` (extent, the world
    half-size of the grid allocated up front; submap_keyframes;
    kf_capacity / kf_voxel; the icp_* capacities; ba_every; replay_chunk)."""
    from icp_tpu_torch.engine import filter_and_flatten
    from icp_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from icp_tpu_torch.parallel.scaled import ScaledPipeline
    from icp_tpu_torch.services.lidar import LidarService
    from icp_tpu_torch.utils.masking import next_pow2

    sc = (cfg.raw.get("scaled") or {}) if isinstance(cfg.raw, dict) else {}

    def stream():
        """One pass over the CSV. Degenerate scans still step (the
        agreement gate dead-reckons through them), so trajectory row k
        stays aligned with input scan k."""
        for _, _, raw in LidarService(cfg.data_file).scans():
            pts = filter_and_flatten(raw, cfg.z_min, cfg.z_max)
            if pts.shape[0] == 0:
                pts = np.zeros((1, 2), np.float32)
            yield pts
    # capacity prepass only when the scaled: section does not pin them
    if "scan_capacity" in sc and "max_range" in sc:
        max_pts, max_rng = 8, float(sc["max_range"])
    else:
        max_pts, max_rng, count = 8, 1.0, 0
        for pts in stream():
            count += 1
            max_pts = max(max_pts, pts.shape[0])
            max_rng = max(max_rng,
                          float(np.max(np.linalg.norm(pts, axis=1))))
        if count == 0:
            raise SystemExit(f"no scans in {cfg.data_file}")

    method = sc.get("icp_method", cfg.icp_method
                    if cfg.icp_method in ("point_to_point", "point_to_line")
                    else "point_to_line")
    kw = dict(
        scan_capacity=int(sc.get("scan_capacity", next_pow2(max_pts))),
        extent=float(sc.get("extent", 100.0)),
        map_resolution=cfg.map_resolution,
        map_margin=cfg.map_margin,
        max_range=float(sc.get("max_range", max_rng * 1.1)),
        icp_max_corr=float(sc.get("icp_max_corr", 1.0)),
        icp_max_iterations=int(sc.get("icp_max_iterations", 30)),
        icp_method=method,
        icp_grid_shape=tuple(sc.get("icp_grid_shape", (160, 160))),
        icp_cell_cap=int(sc.get("icp_cell_cap", 64)),
        icp_qcells=int(sc.get("icp_qcells", 8192)),
        p_hit=cfg.p_hit, p_miss=cfg.p_miss,
        log_odds_min=cfg.log_odds_min, log_odds_max=cfg.log_odds_max,
        map_ray_stride=int(sc.get("map_ray_stride", 1)),
        kf_capacity=int(sc.get("kf_capacity", 8192)),
        kf_voxel=float(sc.get("kf_voxel", max(cfg.map_resolution, 0.1))),
        submap_keyframes=int(sc.get("submap_keyframes", 8)),
        replay_chunk=int(sc.get("replay_chunk", 32)),
    )
    if cfg.lc_enabled:
        kw.update(
            lc_every=int(sc.get("lc_every", 8)),
            lc_min_interval=int(cfg.lc_min_interval),
            lc_distance=float(cfg.lc_distance),
            lc_min_travel=float(cfg.lc_min_travel),
            lc_error_threshold=float(cfg.lc_error_threshold),
            lc_max_candidates=int(cfg.lc_max_candidates),
            lc_info_scale=float(cfg.lc_info_scale),
            lc_info_cap=float(cfg.lc_info_cap),
            lc_robust=bool(cfg.lc_robust),
            lc_robust_phi=float(cfg.lc_robust_phi),
            lc_cooldown=int(cfg.lc_cooldown),
            ba_every=int(sc.get("ba_every", 1)),
        )
    else:
        kw.update(lc_min_interval=10 ** 9)     # loop closure disabled
    init_distributed()
    pipe = ScaledPipeline(make_mesh(device=args.device), **kw)
    if cfg.lc_enabled:
        pipe.warm_replay()

    for k, pts in enumerate(stream()):
        pipe.step(pts)
        if not args.quiet and (k + 1) % 25 == 0:
            print(f"scan {k + 1}  "
                  f"lc={pipe.stats.loop_closures} ba={pipe.stats.ba_runs}")
    pipe.finish()
    if cfg.lc_enabled:
        pipe.optimize(n_iterations=cfg.lc_opt_iters)

    s = pipe.stats
    print(f"scans={s.scans} loop_closures={s.loop_closures} "
          f"ba_runs={s.ba_runs} gate_fallbacks={s.gate_fallbacks} "
          f"icp_iters={s.icp_iters}")
    print(f"wall: registration={s.wall_registration:.2f}s "
          f"lc={s.wall_lc:.2f}s ba={s.wall_ba:.2f}s "
          f"replay={s.wall_replay:.2f}s")
    prob = pipe.map_probability()
    for path in (cfg.out_csv, cfg.out_npy):
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
    np.savetxt(cfg.out_csv, prob, delimiter=",", fmt="%.4f")
    np.save(cfg.out_npy, prob)
    print(f"map saved: {cfg.out_csv}, {cfg.out_npy} "
          f"({pipe.ny}x{pipe.nx} cells)")
    if args.save_traj and pipe.trajectory:
        np.save(args.save_traj, np.stack(pipe.trajectory))
        print(f"trajectory saved: {args.save_traj} "
              f"({len(pipe.trajectory)} poses)")
    if args.checkpoint:
        pipe.save_checkpoint(args.checkpoint)
        print(f"checkpoint saved: {args.checkpoint}")


if __name__ == "__main__":
    main()
