"""Command-line entry: python -m icp_tpu_torch.cli --config configs/default.yaml

The run path of icp_tpu.cli on the port: load a YAML config (the same
schema), optionally write a synthetic sequence first (``--synth``), run
SLAM on ``--device`` (default cuda), loop closure included where the
config enables it, and save the occupancy grid; ``--checkpoint`` saves the
whole SLAM state at the end and ``--resume`` restores one first (the npz
of either package).
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

    from icp_tpu_torch.engine import run_slam

    global_pose, trajectory, mapper, engine = run_slam(
        cfg, verbose=not args.quiet, device=args.device, resume=args.resume)

    print("global_pose:\n", global_pose)
    s = engine.stats
    print(f"scans={s.scans} rejected={s.rejected} "
          f"submap_corr={s.submap_corrections} loop_closures={s.loop_closures} "
          f"icp_iters={s.icp_iters}")
    print(f"wall: registration={s.wall_registration:.2f}s "
          f"mapping={s.wall_mapping:.2f}s lc={s.wall_loop_closure:.2f}s")

    if mapper is not None:
        for path in (cfg.out_csv, cfg.out_npy):
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
        mapper.save_csv(cfg.out_csv)
        mapper.save_npy(cfg.out_npy)
        print(f"map saved: {cfg.out_csv}, {cfg.out_npy}")

    if args.save_traj and trajectory:
        np.save(args.save_traj, np.stack(trajectory))
        print(f"trajectory saved: {args.save_traj} ({len(trajectory)} poses)")

    if args.checkpoint:
        engine.save_checkpoint(args.checkpoint)
        print(f"checkpoint saved: {args.checkpoint}")


if __name__ == "__main__":
    main()
