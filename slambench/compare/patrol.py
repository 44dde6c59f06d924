"""The comparison that decides ``correct`` in the patrol cell of
``ScaledPipeline``: registration, loop closure, the bundle adjustment and
the replayed map, each judged from the program's own input to it, in
float64.

The driver records what the program held at each stage (``Record``):

* registration: for 32 seed-drawn window scans that passed the agreement
  gate, the reference's point-to-line ICP of the whole scan against the
  submap the program registered it against (the keyframes of the previous
  ``submap_keyframes`` scans at the poses they held in the ring then, each
  voxelized as the configuration states, then voxel-merged) is run from
  the pose the program gave it; ``reg_gap_mm`` is how far that moves the
  scan's farthest point;
* loop closure: for up to 16 seed-drawn accepted closures of the run, the
  accepted candidate must be among the reference's candidate gates over
  the keyframe positions at the time of the check (``lc_gate_misses``);
  the pair's keyframes placed by the program's transform (read from the
  closure edge, z = vec(T^-1)) must have the reference's gated inlier
  error under ``lc_error_threshold`` and inlier fraction at least
  ``lc_min_frac`` (``lc_err_excess``); the reference's gated
  point-to-point ICP of the pair from that transform moves the scan by
  ``lc_gap_mm``;
* the bundle adjustments: up to 8 seed-drawn ones of the run, its last
  always among them, are each solved again by the reference
  (``reference/robust_graph.py``: DCS on the flagged edges, the
  information cap) from the same initial nodes and edges for the same
  iterations; ``traj_gap_mm`` is the largest position gap to the program's
  optimised nodes (how far DCS moves a solve depends on the closure, so
  the last BA alone can miss a solve that ignores it);
* the map: after the final ``sync_map``, against the reference's paint of
  every keyframe into an unclamped grid at the pose the replay's contract
  leaves it painted at, both clamped to [log_odds_min, log_odds_max] (as
  ``compare/scaled.py``): ``map_diff_pct``, the share of observed cells
  that differ. The contract (``ScaledPipeline.sync_map``): a keyframe is
  painted at the pose it was registered at; each replay after a BA
  repaints the keyframes whose pose moved past 0.3 cell (or the arc of 0.3
  cell at the maximum range) since their last paint, or every keyframe
  when more than half moved. The reference applies that rule itself, in
  float64, to the trajectory as it stood at each replay. A replay that
  un-paints or repaints wrongly leaves cells behind.

With ``control`` the reference in bfloat16 takes the program's place.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from slambench.compare.engine import F64, LOW, _low, _rt, gate_candidates
from slambench.compare.scaled import NORMAL_K, keyframe, paint
from slambench.reference import grid as M
from slambench.reference import icp as I
from slambench.reference import robust_graph as RG


@dataclasses.dataclass
class Record:
    """What the program held at each stage, noted by the driver."""
    first: int = 0                     # the window's first scan
    poses: dict = dataclasses.field(default_factory=dict)   # k: 3x3
    rings: dict = dataclasses.field(default_factory=dict)   # k: [(j, 3x3)]
    gate_ok: dict = dataclasses.field(default_factory=dict)  # k: bool
    closures: list = dataclasses.field(default_factory=list)
    bas: list = dataclasses.field(default_factory=list)     # each BA
    replays: list = dataclasses.field(default_factory=list)  # trajectories


def _mat(z) -> np.ndarray:
    z = np.asarray(z, np.float64)
    c, s = math.cos(z[2]), math.sin(z[2])
    return np.array([[c, -s, z[0]], [s, c, z[1]], [0.0, 0.0, 1.0]])


def painted_poses(rec, traj, p) -> np.ndarray:
    """(K, 3, 3): the pose each of the ``len(traj)`` keyframes stands
    painted at under the replay's contract, from the registration poses
    and the trajectory at each replay after a BA (``rec.replays``)."""
    painted = np.stack([rec.poses[k] for k in range(len(traj))]
                       ).astype(np.float64)
    tol_t = 0.3 * p["map_resolution"]
    tol_y = tol_t / max(p["max_range"], 1e-6)

    def yaw(T):
        return np.arctan2(T[:, 1, 0], T[:, 0, 0])

    for cur in rec.replays:
        cur = np.stack(cur).astype(np.float64)
        K = len(cur)
        old = painted[:K]
        d_t = np.linalg.norm(cur[:, :2, 2] - old[:, :2, 2], axis=1)
        d_y = np.abs((yaw(cur) - yaw(old) + np.pi) % (2 * np.pi) - np.pi)
        moved = (d_t > tol_t) | (d_y > tol_y)
        if moved.sum() > 0.5 * K:
            moved[:] = True
        painted[:K][moved] = cur[moved]
    return painted


def check_registration(rec, scans, sample, p, dev, control):
    worst = 0.0
    for k in sample:
        ring = []
        for j, T in rec.rings[k]:
            R, t = _rt(T, dev)
            ring.append(keyframe(scans[j], p, dev) @ R.T + t)
        tgt = I.voxel_mean(torch.cat(ring), p["kf_voxel"])
        nrm = I.knn_normals(tgt, NORMAL_K)
        src = torch.as_tensor(scans[k], dtype=F64, device=dev)
        R, t = _rt(rec.poses[k], dev)
        method = "p2l" if p["icp_method"] == "point_to_line" else "p2p"
        if control:
            R, t = _low(R, t, lambda r, tt: I.refine(
                src.to(LOW), tgt.to(LOW), r, tt, max_corr=p["icp_max_corr"],
                method=method, normals=nrm.to(LOW), iters=30))
        Rr, tr, _, _ = I.refine(src, tgt, R, t, max_corr=p["icp_max_corr"],
                                method=method, normals=nrm, iters=100)
        worst = max(worst, I.pose_gap(src, R, t, Rr, tr))
    return 1000.0 * worst


def inliers(src, tgt, R, t, gate: float):
    """The gated inlier error (mean squared distance of the source points
    within ``gate`` of their nearest target) and inlier fraction of ``src``
    placed at (R, t) against ``tgt``."""
    d2, _ = I.nearest(src @ R.T + t, tgt)
    inl = d2 < gate * gate
    n = int(inl.sum())
    err = float(d2[inl].sum()) / max(n, 1)
    return err, n / max(len(src), 1)


def check_closures(rec, scans, sample, p, dev, control):
    """(lc_gate_misses, lc_err_excess, lc_gap_mm)."""
    lc = {"min_interval": p["lc_min_interval"],
          "distance_threshold": p["lc_distance"],
          "min_cumulative_travel": p["lc_min_travel"],
          "max_candidates": p["lc_max_candidates"]}
    gate = p["icp_max_corr"]          # the verification's fine gate
    misses = excess = 0
    gap = 0.0
    for c in sample:
        misses += c["cand"] not in gate_candidates(c["xy"], c["cur"], lc)
        src = keyframe(scans[c["cur"]], p, dev)
        tgt = keyframe(scans[c["cand"]], p, dev)
        R, t = _rt(np.linalg.inv(_mat(c["z"])), dev)
        err, frac = inliers(src, tgt, R, t, gate)
        excess += (err >= p["lc_error_threshold"]
                   or frac < p.get("lc_min_frac", 0.5))
        if control:
            R, t = _low(R, t, lambda r, tt: I.refine(
                src.to(LOW), tgt.to(LOW), r, tt, max_corr=gate,
                iters=40))
        Rr, tr, _, _ = I.refine(src, tgt, R, t, max_corr=gate, iters=300)
        gap = max(gap, I.pose_gap(src, R, t, Rr, tr))
    return float(misses), float(excess), 1000.0 * gap


def check_bas(bas, p, dev, control):
    """traj_gap_mm over the bundle adjustments ``bas``."""
    return max((check_ba(stacked(ba), p, dev, control) for ba in bas),
               default=0.0)


def check_ba(ba, p, dev, control):
    """traj_gap_mm of the bundle adjustment ``ba``."""
    kw = dict(phi=ba["phi"], cap=p.get("lc_info_cap", 0.0), fix=0,
              iters=ba["iterations"])
    args = (ba["ei"], ba["ej"], ba["z"], ba["om"], ba["rb"])
    nodes = torch.as_tensor(ba["before"], dtype=F64, device=dev)
    ref, _ = RG.solve(nodes, *args, **kw)
    if control:
        prog, _ = RG.solve(nodes.to(LOW), *args, **kw)
        prog = prog.to(F64)
    else:
        prog = torch.as_tensor(ba["after"], dtype=F64, device=dev)
    gap = (prog[:, :2] - ref[:, :2]).norm(dim=1).max()
    return 1000.0 * float(gap) if bool(torch.isfinite(gap)) else math.inf


def stacked(ba: dict) -> dict:
    """The driver's note of a bundle adjustment as arrays: the nodes
    before and after, and the edges it solved."""
    pg, e = ba["pg"], ba["edges"]
    return dict(ba, before=np.stack(ba["before"]), after=np.stack(ba["after"]),
                ei=np.array(pg._edges_i[:e]), ej=np.array(pg._edges_j[:e]),
                z=np.stack(pg._edges_z[:e]), om=np.stack(pg._edges_om[:e]),
                rb=np.array(pg._edges_rb[:e], bool))


def check(out, rec, traj, grid, scans, config, traffic, limits, seed, dev,
          control=False):
    """Fill ``out.checks`` with each number beside its limit."""
    p = config["program"]
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng([seed & (2**63 - 1), 7])
    pool = [k for k in sorted(rec.gate_ok)
            if k >= max(rec.first, 1) and rec.gate_ok[k]]
    pick = rng.choice(len(pool), size=min(len(pool), traffic["check_scans"]),
                      replace=False)
    sample = [pool[j] for j in sorted(pick)]
    pick = rng.choice(len(rec.closures),
                      size=min(len(rec.closures), traffic["check_closures"]),
                      replace=False)
    closures = [rec.closures[j] for j in sorted(pick)]
    n_ba = len(rec.bas)
    pick = (rng.choice(n_ba - 1, size=min(n_ba - 1, traffic["check_bas"] - 1),
                       replace=False).tolist() if n_ba > 1 else [])
    bas = [rec.bas[j] for j in sorted(pick)] + rec.bas[-1:]
    other = sorted({ba["strategy"] for ba in rec.bas} - {"dense"})
    if other:
        out.notes.append(f"BA solves other than dense: {other}")
    out.notes.append(
        f"checked {len(sample)} of {len(pool)} gated window poses, "
        f"{len(closures)} of {len(rec.closures)} closures, {len(bas)} of "
        f"{n_ba} bundle adjustments (the last at "
        f"{len(bas[-1]['before']) if bas else 0} nodes), {len(rec.replays)} "
        f"replays and the map of {len(traj)} keyframes")
    got = numbers(rec, traj, grid, scans, sample, closures, bas, p, dev,
                  False)
    out.checks += [(k, v, limits.get(k, 0.0)) for k, v in got.items()]
    if control:
        # the control's solves: the last BA alone (a bfloat16 solve of
        # hundreds of nodes diverges, and each takes seconds)
        out.control = numbers(rec, traj, grid, scans, sample, closures,
                              bas[-1:], p, dev, True)


def numbers(rec, traj, grid, scans, sample, closures, bas, p, dev,
            control) -> dict:
    """Each number compared, of the program's answers or (``control``) of
    the bfloat16 reference's in their place. Counts have the limit 0."""
    reg = check_registration(rec, scans, sample, p, dev, control)
    misses, excess, lc_gap = check_closures(rec, scans, closures, p, dev,
                                            control)
    traj_gap = check_bas(bas, p, dev, control)
    bounds = (p["log_odds_min"], p["log_odds_max"])
    at = painted_poses(rec, traj, p)
    ref = paint(at, scans, p, dev).clamp(*bounds)
    prog = (paint(at, scans, p, dev, LOW) if control
            else torch.as_tensor(grid)).clamp(*bounds)
    diff = (M.diff_share(prog.cpu(), ref.cpu())
            if tuple(prog.shape) == tuple(ref.shape) else 100.0)
    return {"reg_gap_mm": reg, "lc_gate_misses": misses,
            "lc_err_excess": excess, "lc_gap_mm": lc_gap,
            "traj_gap_mm": traj_gap, "map_diff_pct": diff}
