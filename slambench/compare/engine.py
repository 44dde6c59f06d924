"""The comparison that decides ``correct`` in the ``SlamEngine`` cells.

It follows the program step by step from what the program reported (its
poses as it bookkept them, the keyframes its registration saw) and judges
each stage against the plain reference, in float64:

* registration: for a sample of the window's scans whose pose the submap
  correction set, the reference's point-to-point ICP of the scan's voxels
  against the submap (the ring of keyframes at the poses the program held,
  voxel-merged as the configuration states) is run from the program's
  pose; ``reg_gap_mm`` is how far that moves the scan's farthest voxel;
* loop closure: each accepted closure must pass the reference's candidate
  gates (``lc_gate_misses``); the reference's point-to-line ICP of the pair
  from the program's transform must stay under the configured error
  (``lc_err_excess``) and moves the scan by ``lc_gap_mm``; the pose graph
  built from the program's bookkept outputs and its verified closures is
  solved to convergence and compared with the program's optimised poses
  (``traj_gap_mm``), so each stage is judged from the program's input to
  it;
* the map: for a sample of the logs, the reference paints every keyframe
  at the program's final poses, clamping as the program's updates do, and
  ``map_diff_pct`` is the share of observed cells whose log-odds differ.

With ``control`` the reference is put in the program's place in bfloat16
(the precision below the configuration's float32): its answers are judged
by the same numbers, which must then fail.
"""
from __future__ import annotations

import gc
import math

import numpy as np
import torch

from slambench.reference import graph as G
from slambench.reference import grid as M
from slambench.reference import icp as I

F64 = torch.float64
LOW = torch.bfloat16


def _vec(T) -> np.ndarray:
    T = np.asarray(T, np.float64)
    return np.array([T[0, 2], T[1, 2], math.atan2(T[1, 0], T[0, 0])])


def _rt(T, dev, dtype=F64):
    T = torch.as_tensor(np.asarray(T, np.float64), dtype=dtype, device=dev)
    return T[:2, :2], T[:2, 2]


def _world(scan, pose, dev):
    R, t = _rt(pose, dev)
    return torch.as_tensor(scan, dtype=F64, device=dev) @ R.T + t


def _low(R, t, fn):
    """Run ``fn`` on (R, t) in bfloat16 and hand back float64."""
    R2, t2 = fn(R.to(LOW), t.to(LOW))[:2]
    return R2.to(F64), t2.to(F64)


def check_registration(logs, p, sample, dev, control):
    """reg_gap_mm over ``sample`` [(log index, scan)]."""
    vox, sub_vox = p["icp"]["voxel_size"], p["submap"]["voxel_size"]
    cap, corr = p["tpu"]["submap_capacity"], p["submap"]["max_corr_dist"]
    worst = 0.0
    for li, s in sample:
        lg = logs[li]
        st = lg.steps[s]
        ring = torch.cat([_world(lg.scans[i], pose, dev)
                          for i, pose in st["ring"]])
        tgt = I.voxel_mean(I.voxel_mean(ring, sub_vox, cap), vox)
        src = I.voxel_mean(torch.as_tensor(lg.scans[s], dtype=F64,
                                           device=dev), vox)
        R, t = _rt(st["pose"], dev)
        if control:
            R, t = _low(R, t, lambda r, tt: I.refine(
                src.to(LOW), tgt.to(LOW), r, tt, max_corr=corr, iters=150))
        Rr, tr, _, _ = I.refine(src, tgt, R, t, max_corr=corr, iters=300)
        worst = max(worst, I.pose_gap(src, R, t, Rr, tr))
    return 1000.0 * worst


def gate_candidates(xy: np.ndarray, cur: int, lc: dict):
    """The upstream candidate gates on node positions ``xy`` (n, 2): node
    gap >= min_interval, distance < distance_threshold, travel since >=
    min_cumulative_travel; nearest first, at most max_candidates."""
    steps = np.linalg.norm(np.diff(xy, axis=0), axis=1)
    cum = np.concatenate([[0.0], np.cumsum(steps)])
    idx = np.arange(len(xy))
    dist = np.linalg.norm(xy - xy[cur], axis=1)
    ok = ((cur - idx >= lc["min_interval"])
          & (dist < lc["distance_threshold"])
          & (cum[cur] - cum >= lc["min_cumulative_travel"]))
    order = sorted(idx[ok], key=lambda i: dist[i])
    return [int(i) for i in order[:lc["max_candidates"]]]


def check_closures(logs, p, dev, control):
    """(lc_gate_misses, lc_err_excess, lc_gap_mm, traj_gap_mm)."""
    lc = p["loop_closure"]
    vox, k = p["icp"]["voxel_size"], p["icp"]["normal_k"]
    misses = excess = 0
    lc_gap = traj_gap = 0.0
    for lg in logs:
        edges_lc = []
        for c in lg.closures:
            pre = c["pre"]
            xy = np.stack([np.asarray(pose, np.float64)[:2, 2]
                           for _, pose in pre])
            misses += c["cand"] not in gate_candidates(xy, c["cur"], lc)
            src = I.voxel_mean(torch.as_tensor(
                lg.scans[pre[c["cur"]][0]], dtype=F64, device=dev), vox)
            tgt = I.voxel_mean(torch.as_tensor(
                lg.scans[pre[c["cand"]][0]], dtype=F64, device=dev), vox)
            nrm = I.knn_normals(tgt, k)
            R = torch.as_tensor(c["r"], dtype=F64, device=dev)
            t = torch.as_tensor(c["t"], dtype=F64, device=dev)
            if control:
                R, t = _low(R, t, lambda r, tt: I.refine(
                    src.to(LOW), tgt.to(LOW), r, tt, max_corr=math.inf,
                    method="p2l", normals=nrm.to(LOW), iters=150))
            Rr, tr, _, _ = I.refine(src, tgt, R, t, max_corr=math.inf,
                                    method="p2l", normals=nrm, iters=300)
            lc_gap = max(lc_gap, I.pose_gap(src, R, t, Rr, tr))
            d2, _ = I.nearest(src @ Rr.T + tr, tgt)
            err = float(d2.mean())
            excess += err >= lc["error_threshold"]
            # the graph stage is judged on its own, from the closure the
            # program verified (the verification is judged just above)
            T = np.eye(3)
            T[:2, :2], T[:2, 2] = c["r"], c["t"]
            w = lc["information_scale"] / max(c["err"], 1e-6)
            if lc.get("information_cap", 0.0) > 0:
                w = min(w, lc["information_cap"])
            edges_lc.append((c["cur"], c["cand"], _vec(np.linalg.inv(T)), w))
            traj_gap = max(traj_gap, _graph_gap(lg, c, edges_lc, dev,
                                                control))
    return misses, excess, 1000.0 * lc_gap, 1000.0 * traj_gap


def _graph_gap(lg, c, edges_lc, dev, control):
    """Largest position gap (m) between the program's optimised poses
    after closure ``c`` and the reference's solve of the same graph."""
    pre = c["pre"]
    nodes = torch.as_tensor(np.stack([_vec(p) for _, p in pre]), dtype=F64,
                            device=dev)
    edges = []
    for node in range(1, len(pre)):
        st = lg.steps[pre[node][0]]
        z = G.relative(torch.as_tensor(_vec(st["prev"][1]), dtype=F64),
                       torch.as_tensor(_vec(st["pose"]), dtype=F64))
        edges.append((node - 1, node, z.to(dev),
                      torch.eye(3, dtype=F64, device=dev)
                      / max(st["err"], 1e-6)))
    for i, j, z, w in edges_lc:
        edges.append((i, j, torch.as_tensor(z, dtype=F64, device=dev),
                      torch.eye(3, dtype=F64, device=dev) * w))
    ref = G.solve(nodes, edges, fix=0)
    if control:
        low = [(i, j, z.to(LOW), om.to(LOW)) for i, j, z, om in edges]
        prog = G.solve(nodes.to(LOW), low, fix=0, iters=30).to(F64)
    else:
        prog = torch.as_tensor(np.stack([_vec(p) for _, p in c["post"]]),
                               dtype=F64, device=dev)
    return float((prog[:, :2] - ref[:, :2]).norm(dim=1).max())


def paint_log(lg, p, dev, dtype=F64):
    """The reference's map of one log at the program's final poses."""
    m, tpu = p["mapping"], p["tpu"]
    first = lg.scans[0].astype(np.float64)
    lo = first.min(0) - m["margin"]
    hi = first.max(0) + m["margin"]
    shape = (int(math.ceil((hi[1] - lo[1]) / m["resolution"])),
             int(math.ceil((hi[0] - lo[0]) / m["resolution"])))
    lh = math.log(m["p_hit"] / (1 - m["p_hit"]))
    lm = math.log(m["p_miss"] / (1 - m["p_miss"]))
    g = M.Grid(lo, shape, m["resolution"], l_hit=lh, l_miss=lm,
               max_steps=tpu["max_ray_cells"],
               clamp=(m["log_odds_min"], m["log_odds_max"]), dtype=dtype,
               device=dev)
    pose_of = dict(lg.history)

    def add(scans):
        origins, hits = [], []
        for s in scans:
            R, t = _rt(pose_of[s], dev, dtype)
            origins.append(t)
            hits.append(torch.as_tensor(lg.scans[s], dtype=dtype,
                                        device=dev) @ R.T + t)
        g.add_scans(origins, hits)
        g.finish_update()

    if lg.closures:
        # the program replays every keyframe, one update each
        for s, _ in lg.history:
            add([s])
    else:
        # scan 0 alone, then one update for each hand-over call
        for idx in lg.batches:
            add([s for s in idx if s in pose_of])
    return g.array()


def check(out, logs, config, traffic, limits, seed, dev, control=False):
    """Fill ``out.checks`` with each number beside its limit."""
    p = config["program"]
    rng = np.random.default_rng([seed & (2**63 - 1), 7])
    done = [i for i, lg in enumerate(logs) if lg.complete]
    map_logs = sorted(rng.choice(done, size=min(len(done),
                                                traffic["check_map_logs"]),
                                 replace=False).tolist())
    maps = {}
    for i, lg in enumerate(logs):
        eng = lg.engine
        lg.history = [(r.scan_idx, r.pose) for r in eng.scan_history]
        if i in map_logs:
            eng.sync_map()
            maps[i] = eng.mapper.log_odds.cpu().numpy()
        lg.engine = None
    del eng
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False

    pool = [(i, s) for i, lg in enumerate(logs)
            for s, st in sorted(lg.steps.items())
            if st["accepted"] and st["sub"]]
    pick = rng.choice(len(pool), size=min(len(pool),
                                          traffic["check_scans"]),
                      replace=False)
    sample = [pool[j] for j in sorted(pick)]
    out.notes.append(
        f"checked {len(sample)} of {len(pool)} submap-set poses, "
        f"{sum(len(lg.closures) for lg in logs)} closures, the maps of "
        f"logs {map_logs}")
    got = numbers(logs, maps, map_logs, sample, p, dev, False)
    out.checks += [(k, v, limits.get(k, 0.0)) for k, v in got.items()]
    if control:
        out.control = numbers(logs, maps, map_logs, sample, p, dev, True)


def numbers(logs, maps, map_logs, sample, p, dev, control) -> dict:
    """Each number compared, of the program's answers or (``control``) of
    the bfloat16 reference's in their place. Counts have the limit 0."""
    reg = check_registration(logs, p, sample, dev, control)
    misses, excess, lc_gap, traj_gap = check_closures(logs, p, dev, control)
    diff = 0.0
    for i in map_logs:
        ref = paint_log(logs[i], p, dev)
        prog = (paint_log(logs[i], p, dev, LOW) if control
                else torch.as_tensor(maps[i]))
        diff = max(diff, M.diff_share(prog.cpu(), ref.cpu())
                   if prog.shape == ref.shape else 100.0)
    return {"reg_gap_mm": reg, "lc_gate_misses": float(misses),
            "lc_err_excess": float(excess), "lc_gap_mm": lc_gap,
            "traj_gap_mm": traj_gap, "map_diff_pct": diff}
