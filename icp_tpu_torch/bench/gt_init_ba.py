"""Information-floor check of a large pose graph (benchmarks/gt_init_ba.py on
icp_tpu_torch's ``PoseGraph2D``, on the card).

    python -m icp_tpu_torch.bench.gt_init_ba GRAPH.npz [n_iterations] [--device cuda]

Loads a pose graph dumped by bench_scaled.py (``benchmarks/graph50k_*.npz``:
nodes, edges, robust flags, robust_phi and ground truth), solves it from
its streamed estimate, then solves it again from ground truth expressed in
the first pose's frame, with the same ``optimize`` (15 GN iterations by
default, node 0 fixed), and prints one JSON line with the original's keys
(ATE of the streamed estimate, after each solve, chi2 before and after
each, the strategy each took) plus ``card``, each solve's wall ms (device
synchronized), GN iterations (``last_iterations``), segment plans built,
each kernel's launches (``kernel_launches``; ``segment_add_launches``
too), peak device memory, the graph's load time and, per solve, the
model's spans (``utils.spans``, ``pose_graph.*``: the solve as a whole,
the coarse supernode solve, packing, the PCG's GN steps, writing the nodes
back, the chi2 evaluations of the divergence guard; and
``scatter.segment_plan``, the segment plan builds), recorded with CUDA
events and no synchronize inside the solve.

If the GT-init solve lands materially below the streamed one in ATE, the
streamed solve has solver slack; if they agree, the residual is the
information floor of the measurements.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from icp_tpu_torch.bench import common as C


def graph_from_arrays(d, dev):
    """A ``PoseGraph2D`` on ``dev`` from a graph dump's arrays (nodes, ei,
    ej, z, om, rb, robust_phi), node by node and edge by edge as the
    original loads it."""
    from icp_tpu_torch.models.pose_graph import PoseGraph2D

    pg = PoseGraph2D(dev)
    pg.robust_phi = float(d["robust_phi"])
    for v in d["nodes"]:
        pg.add_node(v)
    for i, j, z, om, rb in zip(d["ei"], d["ej"], d["z"], d["om"], d["rb"]):
        pg.add_edge(int(i), int(j), z, om, robust=bool(rb))
    return pg


def gt_init_graph(d, dev):
    """``graph_from_arrays`` with every node at its ground-truth pose in the
    first pose's frame (``utils.metrics.gt_relative``)."""
    from icp_tpu_torch.utils.metrics import gt_relative

    pg = graph_from_arrays(d, dev)
    gt_rel = gt_relative(d["gt"]).astype(np.float32)
    for k in range(pg.n_nodes):
        pg._nodes[k] = gt_rel[k].copy()
    return pg


def timed_solve(pg, n_iterations, dev) -> dict:
    """``pg.optimize(n_iterations, fix_node=0)`` with its wall ms (device
    synchronized), GN iterations, strategy, segment plans built, each
    kernel's launches, peak device memory and span ms."""
    from icp_tpu_torch.ops import scatter as SC
    from icp_tpu_torch.utils import spans

    C.synchronize(dev)
    C.reset_peak(dev)
    C.reset_counts()
    with spans.record(dev) as spent:
        t0 = time.perf_counter()
        pg.optimize(n_iterations=n_iterations, fix_node=0)
        C.synchronize(dev)
        wall = time.perf_counter() - t0
    counts = C.read_counts()
    return {"wall_ms": 1e3 * wall, "last_iterations": pg.last_iterations,
            "strategy": pg.last_strategy,
            "segment_plan_builds": SC.segment_plan_builds,
            "segment_add_launches": counts["segment_add"],
            **C.launch_fields(counts),
            "span_ms": spent,
            "peak_device_mb": C.peak_mb(dev)}


def warm_up(dev):
    """First-use costs out of the timed solves (the kernels' build and
    load, the solver and BLAS handles, the allocator): a 64-node chain
    with a closure, its nodes off their edges by a few centimetres, through
    the coarse solve and the PCG."""
    from icp_tpu_torch.models.pose_graph import PoseGraph2D
    from icp_tpu_torch.ops.hopper import build

    if dev.type == "cuda":
        build.load_all()
    pg = PoseGraph2D(dev)
    for k in range(64):
        pg.add_node([0.1 * k, 0.03 * np.sin(k), 0.01 * np.cos(k)])
        if k:
            pg.add_edge(k - 1, k, [0.1, 0.0, 0.0])
    pg.add_edge(0, 63, [6.3, 0.0, 0.0], robust=True)
    pg._cg_node_threshold, pg._coarse_threshold = 16, 32
    pg.optimize(n_iterations=2)
    C.synchronize(dev)


def run(dev, d, n_iterations=15) -> dict:
    """Both solves of the graph dump ``d`` on ``dev``; returns the line."""
    from icp_tpu_torch.utils.metrics import ate as ate_fn

    card = C.card_line(dev)
    warm_up(dev)
    gt = d["gt"]
    t0 = time.perf_counter()
    pg = graph_from_arrays(d, dev)
    load_ms = 1e3 * (time.perf_counter() - t0)
    n = pg.n_nodes
    C.log(f"{n} nodes, {pg.n_edges} edges (loaded in {load_ms:.0f} ms); "
          f"optimize {n_iterations} iterations on {card}")
    streamed = np.stack(d["nodes"])
    ate_stream = ate_fn(streamed[:, :2], gt, gt_offset=0)

    # solve A: streamed init (what the pipeline's terminal BA does)
    chi2_before = pg.total_error()
    a = timed_solve(pg, n_iterations, dev)
    ate_streamed = ate_fn(np.stack(pg.nodes)[:, :2], gt, gt_offset=0)
    chi2_streamed = pg.total_error()
    C.log(f"streamed init: {a}")

    # solve B: ground-truth init, same graph, same optimize
    pg2 = gt_init_graph(d, dev)
    chi2_gt_init = pg2.total_error()
    b = timed_solve(pg2, n_iterations, dev)
    ate_gt = ate_fn(np.stack(pg2.nodes)[:, :2], gt, gt_offset=0)
    chi2_gt = pg2.total_error()
    C.log(f"ground-truth init: {b}")

    line = {
        "metric": "gt_init_ba_ate_m", "n_nodes": n, "n_edges": pg.n_edges,
        "n_iterations": n_iterations,
        "ate_stream_m": float(ate_stream),
        "ate_streamed_init_m": float(ate_streamed),
        "ate_gt_init_m": float(ate_gt),
        "chi2_streamed_pre": float(chi2_before),
        "chi2_streamed_post": float(chi2_streamed),
        "chi2_at_gt": float(chi2_gt_init),
        "chi2_gt_init_post": float(chi2_gt),
        "strategy_streamed": a["strategy"], "strategy_gt": b["strategy"],
        "card": card, "load_ms": load_ms}
    for tag, solve in (("streamed", a), ("gt", b)):
        for k, v in solve.items():
            if k != "strategy":
                line[f"{k}_{tag}"] = v
    return line


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("graph", help="graph dump (.npz), e.g. "
                                  "benchmarks/graph50k_r05.npz")
    ap.add_argument("n_iterations", nargs="?", type=int, default=15)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = C.resolve_device(a.device)
    line = run(dev, np.load(a.graph), a.n_iterations)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
