"""scans/s of one checkout's main path and config #5, for A/B runs on a card.

    python3 icp_tpu_torch/tools/ab_throughput.py TREE LABEL

TREE is the root of a checkout that has ``icp_tpu_torch/bench/headline.py``
(this repository, or an earlier commit unpacked with ``git archive``); its
``chip_smoke.py`` and ``icp_tpu_torch`` are imported, so the same script
times either. It runs two passes of the headline's protocol
(``bench.headline.run_pass``: bench.py's configuration on the 200 x 720
bench sequence, scan 0 and 3 warm batches, then the full batches timed),
chip_smoke.py's loop-closure pass (phase 6), phase 7's pose-graph solves
at 1,024 nodes (dense and PCG, 30 GN iterations) and its phase 12 (the
scaled pipeline at full width, 400 scans, the terminal BA) with
``time_gn_step`` on its graph (Schur and PCG, one shard), and prints one
JSON line: scans/s of each headline pass (``main_sps_cold`` the first,
``main_sps_warm`` the second) and of config #5 after 3 warm scans, both
ATEs, the largest pose difference between the two headline passes, the
loop-closure pass's ATE and closures, the solves' ms, the GN
steps' ms, and the card with its power limit. Run it as a file, not with
``-m``: the package must come from TREE. Compare two checkouts only
within one call on one card, in turns (A, B, B, A).
"""
import json
import os
import sys
import tempfile
import time


def main(argv=None):
    tree, label = argv if argv is not None else sys.argv[1:3]
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import numpy as np
    import torch

    import chip_smoke as C
    from icp_tpu_torch.bench import common as BC
    from icp_tpu_torch.bench.headline import run_pass
    from icp_tpu_torch.models.pose_graph import PoseGraph2D
    from icp_tpu_torch.utils.config import SlamConfig
    from icp_tpu_torch.utils.metrics import ate

    if not torch.cuda.is_available():
        raise SystemExit("ab_throughput needs a CUDA card")
    dev = torch.device("cuda:0")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        gt, scans, rels, imu = C.load_sequence(td)
        cfg = SlamConfig.from_dict(BC.headline_config())
        e1, _, sps1, _ = run_pass(cfg, imu, scans, rels, dev)
        e2, _, sps2, _ = run_pass(cfg, imu, scans, rels, dev)
        t1, t2 = np.stack(e1.pose_trajectory), np.stack(e2.pose_trajectory)
        ate_m = ate(t2[:, :2, 2], gt, indices=e2.pose_scan_indices)
        spread = float(np.abs(t1 - t2).max()) if t1.shape == t2.shape else None
        lc_cfg = SlamConfig.from_dict(dict(C.BENCH_CFG,
                                           loop_closure=C.LC_SECTION))
        lc_cfg.num_scans = len(scans)
        e_lc, _ = C.run_engine(lc_cfg, imu, scans, rels, dev, warmup=True)
        ate_lc = ate(np.stack(e_lc.pose_trajectory)[:, :2, 2], gt,
                     indices=e_lc.pose_scan_indices)
        solve_ms = {}
        for strategy in ("dense", "cg"):
            pg = C._chain_with_closures(PoseGraph2D(dev), 1024)
            pg._cg_node_threshold = 10**9 if strategy == "dense" else 2
            torch.cuda.synchronize()
            ts = time.perf_counter()
            pg.optimize(n_iterations=30)
            torch.cuda.synchronize()
            solve_ms[strategy] = 1e3 * (time.perf_counter() - ts)
        pipe, g, sps = C.run_scaled(dev)
        gn_ms = {"schur": 1e3 * pipe.time_gn_step(reps=5)}
        limit, pipe.pose_graph._max_separators = \
            pipe.pose_graph._max_separators, 0
        gn_ms["cg"] = 1e3 * pipe.time_gn_step(reps=5)
        pipe.pose_graph._max_separators = limit
        pipe.optimize(n_iterations=15)
        ate_s = ate(np.stack(pipe.trajectory), g, gt_offset=0)
    print(json.dumps({"label": label, "card": C.gpu_line(),
                      "main_sps_warm": sps2, "main_sps_cold": sps1,
                      "main_ate": ate_m,
                      "main_two_pass_max_abs": spread,
                      "lc_ate": ate_lc, "lc_closures": e_lc.stats.loop_closures,
                      "optimize_1024_ms": solve_ms,
                      "time_gn_step_ms": gn_ms,
                      "gn_nodes": pipe.pose_graph.n_nodes,
                      "scaled_sps": sps, "scaled_ate": ate_s,
                      "wall": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
