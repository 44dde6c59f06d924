"""scans/s of one checkout's main path and config #5, for A/B runs on a card.

    python3 icp_tpu_torch/tools/ab_throughput.py TREE LABEL

TREE is the root of a checkout (this repository, or an earlier commit
unpacked with ``git archive``); its ``chip_smoke.py`` and
``icp_tpu_torch`` are imported, so the same script times either. It runs
chip_smoke.py's main path (the 200 x 720 bench sequence through
``SlamEngine``, bench.py's configuration) twice, cold then warm, and its
phase 12 (the scaled pipeline at full width, 400 scans, the terminal BA),
and prints one JSON line: scans/s of the warm main-path pass and of
config #5 after 3 warm scans, both ATEs, the largest pose difference
between the two main-path passes, and the card with its power limit. Run
it as a file, not with ``-m``: the package must come from TREE. Compare
two checkouts only within one call on one card, in turns (A, B, B, A).
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
    from icp_tpu_torch.utils.config import SlamConfig
    from icp_tpu_torch.utils.metrics import ate

    if not torch.cuda.is_available():
        raise SystemExit("ab_throughput needs a CUDA card")
    dev = torch.device("cuda:0")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        gt, scans, rels, imu = C.load_sequence(td)
        cfg = SlamConfig.from_dict(C.BENCH_CFG)
        e1, w1 = C.run_engine(cfg, imu, scans, rels, dev)
        e2, w2 = C.run_engine(cfg, imu, scans, rels, dev)
        t1, t2 = np.stack(e1.pose_trajectory), np.stack(e2.pose_trajectory)
        ate_m = ate(t2[:, :2, 2], gt, indices=e2.pose_scan_indices)
        spread = float(np.abs(t1 - t2).max()) if t1.shape == t2.shape else None
        pipe, g, sps = C.run_scaled(dev)
        pipe.optimize(n_iterations=15)
        ate_s = ate(np.stack(pipe.trajectory), g, gt_offset=0)
    print(json.dumps({"label": label, "card": C.gpu_line(),
                      "main_sps_warm": (len(scans) - 1) / w2,
                      "main_sps_cold": (len(scans) - 1) / w1, "main_ate": ate_m,
                      "main_two_pass_max_abs": spread, "scaled_sps": sps,
                      "scaled_ate": ate_s, "wall": time.perf_counter() - t0}),
          flush=True)


if __name__ == "__main__":
    main()
