"""The comparison that decides ``correct`` in the ``ScaledPipeline`` cells.

As for the engine, the reference follows the program from what it
reported, in float64:

* registration: for a sample of the window's scans that passed the
  agreement gate, the reference's point-to-line ICP (normals from the k
  nearest target voxels) of the whole scan against the submap (the
  keyframes of the previous ``submap_keyframes`` scans at the program's
  poses, each voxelized as the configuration states, then voxel-merged) is
  run from the program's pose; ``reg_gap_mm`` is how far that moves the
  scan's farthest point;
* the map: the reference paints every scan's keyframe at the program's
  pose into an unclamped grid, free space along every ``map_ray_stride``-th
  ray, and ``map_diff_pct`` is the share of observed cells whose log-odds
  differ once both are clamped to [log_odds_min, log_odds_max], as the
  program clamps its map at read (a float32 sum of 10^5 equal terms drifts
  by more than any fixed share of itself, and past the clamp it is never
  read).

With ``control`` the reference in bfloat16 takes the program's place.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from slambench.compare.engine import F64, LOW, _low, _rt
from slambench.reference import grid as M
from slambench.reference import icp as I

NORMAL_K = 8          # target voxels of 0.3 m: about 2.4 m of wall


def keyframe(scan, p, dev, dtype=F64):
    pts = torch.as_tensor(scan, dtype=dtype, device=dev)
    return I.voxel_mean(pts, p["kf_voxel"], p["kf_capacity"])


def check_registration(traj, scans, sample, p, dev, control):
    S = p["submap_keyframes"]
    worst = 0.0
    for k in sample:
        ring = []
        for j in range(max(0, k - S), k):
            R, t = _rt(traj[j], dev)
            ring.append(keyframe(scans[j], p, dev) @ R.T + t)
        tgt = I.voxel_mean(torch.cat(ring), p["kf_voxel"])
        nrm = I.knn_normals(tgt, NORMAL_K)
        src = torch.as_tensor(scans[k], dtype=F64, device=dev)
        R, t = _rt(traj[k], dev)
        method = "p2l" if p["icp_method"] == "point_to_line" else "p2p"
        if control:
            R, t = _low(R, t, lambda r, tt: I.refine(
                src.to(LOW), tgt.to(LOW), r, tt, max_corr=p["icp_max_corr"],
                method=method, normals=nrm.to(LOW), iters=30))
        Rr, tr, _, _ = I.refine(src, tgt, R, t, max_corr=p["icp_max_corr"],
                                method=method, normals=nrm, iters=100)
        worst = max(worst, I.pose_gap(src, R, t, Rr, tr))
    return 1000.0 * worst


def paint(traj, scans, p, dev, dtype=F64):
    lo = -p["extent"] - p["map_margin"]
    res = p["map_resolution"]
    nx = int(math.ceil((2 * (p["extent"] + p["map_margin"])) / res))
    ny = -(-nx // 64) * 64
    g = M.Grid((lo, lo), (ny, nx), res,
               l_hit=math.log(p["p_hit"] / (1 - p["p_hit"])),
               l_miss=math.log(p["p_miss"] / (1 - p["p_miss"])),
               max_steps=int(math.ceil(1.2 * p["max_range"] / res / 64)) * 64,
               dtype=dtype, device=dev)
    for k in range(len(traj)):
        R, t = _rt(traj[k], dev, dtype)
        g.add_scans([t], [keyframe(scans[k], p, dev, dtype) @ R.T + t],
                    ray_stride=p["map_ray_stride"])
    return g.array()


def check(out, traj, grid, scans, gate_ok, config, traffic, limits, seed,
          dev, control=False):
    p = config["program"]
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng([seed & (2**63 - 1), 7])
    pool = [k for k in range(1, len(traj)) if gate_ok[k]]
    pick = rng.choice(len(pool), size=min(len(pool), traffic["check_scans"]),
                      replace=False)
    sample = [pool[j] for j in sorted(pick)]
    out.notes.append(f"checked {len(sample)} of {len(pool)} gated poses "
                     f"and the map of {len(traj)} keyframes")
    got = numbers(traj, grid, scans, sample, p, dev, False)
    out.checks += [(k, v, limits[k]) for k, v in got.items()]
    if control:
        out.control = numbers(traj, grid, scans, sample, p, dev, True)


def numbers(traj, grid, scans, sample, p, dev, control) -> dict:
    """Each number compared, of the program's answers or (``control``) of
    the bfloat16 reference's in their place."""
    reg = check_registration(traj, scans, sample, p, dev, control)
    # the grid keeps unclamped sums and clamps at read: the map users see
    bounds = (p["log_odds_min"], p["log_odds_max"])
    ref = paint(traj, scans, p, dev).clamp(*bounds)
    prog = (paint(traj, scans, p, dev, LOW) if control
            else torch.as_tensor(grid)).clamp(*bounds)
    diff = (M.diff_share(prog.cpu(), ref.cpu())
            if tuple(prog.shape) == tuple(ref.shape) else 100.0)
    return {"reg_gap_mm": reg, "map_diff_pct": diff}
