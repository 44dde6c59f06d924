"""The distributed pose-graph GN step on icp_tpu_torch
(benchmarks/bench_distributed.py, BASELINE config #5's graph scale): a
synthetic trajectory-shaped SE(2) graph (odometry chain plus a closure
every 97 nodes) of 50k keyframes, one matrix-free PCG GN step with the
edges sharded over the mesh, timed at each mesh size, and the exact
Schur-complement step at 4,096 nodes over the whole mesh.

    python -m icp_tpu_torch.bench.distributed [--device cuda] [--virtual-devices N]

Prints ONE JSON line with every key of bench_distributed.py's line
(``backend`` is the torch device type) plus ``card``, ``step_ms`` (each
mesh size's CG step), ``plan_build_ms`` (each mesh's segment plans,
``dist_pose_graph.cg_plans``, built once before its steps as a solve
builds them), ``schur_setup_ms`` (``partition_graph`` on the host and
``schur_shards``' plans), the kernels' launches in each timed region
(``kernel_launches_cg`` by mesh size, ``kernel_launches_schur``, and
their sum ``kernel_launches``) and ``virtual_devices`` (the virtual
shards' count, else 0: such a line shows correctness and collective
overhead, not scaling).

Protocol (bench_distributed.py's): mesh sizes ``sorted({1, min(2, D),
min(4, D), D})`` over the D visible devices of --device's kind; at each,
the edges padded to a multiple of the mesh size (masked), one untimed
``gn_step_cg_sharded(..., cg_iters=25)``, then 5 timed, the devices
synchronized at both ends. Knobs: BENCH_PG_NODES (50000),
BENCH_PG_SCHUR_NODES (4096).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from icp_tpu_torch.bench import common as C

REPS = 5
CG_ITERS = 25


def build_graph(n_nodes: int, lc_every: int = 97, seed: int = 0):
    """bench_distributed.build_graph (a copy; the same arrays bit for bit):
    a smooth noisy trajectory of 0.5 m steps, its odometry chain and a
    closure every ``lc_every`` nodes, measurements the true relative
    poses plus noise. Returns numpy (nodes, ei, ej, z, omega)."""
    rng = np.random.default_rng(seed)
    dyaw = rng.normal(0.02, 0.05, n_nodes)
    yaw = np.cumsum(dyaw)
    step = np.stack([0.5 * np.cos(yaw), 0.5 * np.sin(yaw)], 1)
    xy = np.cumsum(step, 0)
    nodes = np.concatenate([xy, yaw[:, None]], 1).astype(np.float32)
    nodes += rng.normal(scale=0.05, size=nodes.shape).astype(np.float32)

    ei = list(range(n_nodes - 1))
    ej = list(range(1, n_nodes))
    for k in range(lc_every, n_nodes, lc_every):
        ei.append(k)
        ej.append(max(k - lc_every + 3, 0))
    ei = np.asarray(ei, np.int32)
    ej = np.asarray(ej, np.int32)
    z = []
    for a, b in zip(ei, ej):
        T = np.linalg.inv(_pose(nodes[a])) @ _pose(nodes[b])
        z.append([T[0, 2], T[1, 2], np.arctan2(T[1, 0], T[0, 0])])
    z = np.asarray(z, np.float32) + rng.normal(
        scale=0.01, size=(len(ei), 3)).astype(np.float32)
    om = np.broadcast_to(np.eye(3, dtype=np.float32), (len(ei), 3, 3)).copy()
    return nodes, ei, ej, z, om


def _pose(v):
    c, s = np.cos(v[2]), np.sin(v[2])
    return np.array([[c, -s, v[0]], [s, c, v[1]], [0, 0, 1]], np.float64)


def mesh_sizes(n_avail: int) -> list[int]:
    return sorted({1, min(2, n_avail), min(4, n_avail), n_avail})


def padded_edges(ei, ej, z, om, n_dev: int):
    """The edges padded with masked ones to a multiple of ``n_dev``:
    (ei, ej, z, omega, edge mask), numpy."""
    E = len(ei)
    pad = (-E) % n_dev
    return (np.concatenate([ei, np.zeros(pad, np.int32)]),
            np.concatenate([ej, np.zeros(pad, np.int32)]),
            np.concatenate([z, np.zeros((pad, 3), np.float32)]),
            np.concatenate([om, np.zeros((pad, 3, 3), np.float32)]),
            np.concatenate([np.ones(E, bool), np.zeros(pad, bool)]))


def _timed(mesh, fn, reps=REPS):
    """(ms a call over ``reps`` calls after one untimed, the devices
    synchronized at both ends; the last output; kernel launches in the
    timed calls)."""
    fn()
    C.sync_mesh(mesh)
    C.reset_counts()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    C.sync_mesh(mesh)
    ms = 1e3 * (time.perf_counter() - t0) / reps
    return ms, out, C.read_counts()


def cg_step(mesh, nodes, ei, ej, z, om):
    """Each mesh size's timed CG step: (ms a step, plan build ms, the
    step's nodes on the host, launches in the timed steps)."""
    from icp_tpu_torch.parallel.dist_pose_graph import (cg_plans,
                                                        gn_step_cg_sharded)

    d0 = mesh.devices[0]
    n = len(nodes)
    eip, ejp, zp, omp, emask = padded_edges(ei, ej, z, om, mesh.size)
    i64 = torch.int64
    nd, nm = torch.as_tensor(nodes, device=d0), torch.ones(n, dtype=torch.bool,
                                                           device=d0)
    eit, ejt = (torch.as_tensor(a, dtype=i64, device=d0) for a in (eip, ejp))
    zt, omt, emt = (torch.as_tensor(a, device=d0) for a in (zp, omp, emask))
    C.sync_mesh(mesh)
    t0 = time.perf_counter()
    plans = cg_plans(mesh, n, eit, ejt, emt)
    C.sync_mesh(mesh)
    plan_ms = 1e3 * (time.perf_counter() - t0)
    ms, out, counts = _timed(mesh, lambda: gn_step_cg_sharded(
        mesh, nd, nm, eit, ejt, zt, omt, emt, 0, cg_iters=CG_ITERS,
        plans=plans))
    return ms, plan_ms, out.cpu().numpy(), counts


def schur_step(mesh, nodes, ei, ej, z, om):
    """The exact Schur step over ``mesh``: (ms a step, setup ms, the
    partition, the step's nodes on the host, launches in the timed
    steps)."""
    from icp_tpu_torch.parallel.dist_pose_graph import (gn_step_schur_sharded,
                                                        partition_graph,
                                                        schur_shards)

    n = len(nodes)
    d0 = mesh.devices[0]
    nd = torch.as_tensor(nodes, device=d0)
    nm = torch.ones(n, dtype=torch.bool, device=d0)
    C.sync_mesh(mesh)
    t0 = time.perf_counter()
    part = partition_graph(n, ei, ej, z, om, np.ones(len(ei), bool),
                           mesh.size, 0)
    shards = schur_shards(mesh, part, n)
    C.sync_mesh(mesh)
    setup_ms = 1e3 * (time.perf_counter() - t0)
    ms, out, counts = _timed(mesh, lambda: gn_step_schur_sharded(
        mesh, nd, nm, part, shards=shards))
    return ms, setup_ms, part, out.cpu().numpy(), counts


def run(dev, env=None):
    """bench_distributed.py on ``dev``'s devices (knobs from ``env``,
    default ``os.environ``). Returns (line, {mesh size: the CG step's
    nodes}, the Schur step's nodes)."""
    from icp_tpu_torch.bench import startup
    from icp_tpu_torch.parallel.mesh import make_mesh, virtual_count

    env = os.environ if env is None else env
    card = C.card_line(dev)
    n_nodes = int(env.get("BENCH_PG_NODES", 50_000))
    t0 = time.perf_counter()
    graph = build_graph(n_nodes)
    n_avail = make_mesh(device=dev).size
    C.log(f"devices: {n_avail} x {dev.type} ({card}); graph of {n_nodes} "
          f"nodes built in {time.perf_counter() - t0:.1f} s (host)")
    # the path runs icp_segment_add only: no sweep shape for nn_min_cuda
    err = startup.check(dev, {})
    C.log(f"kernel guard on {dev}: every kernel equals its plain version "
          f"(max abs err {err})")

    sizes = mesh_sizes(n_avail)
    step_ms, plan_ms, outs, launches = {}, {}, {}, {}
    for nd in sizes:
        mesh = make_mesh(nd, device=dev)
        step_ms[nd], plan_ms[nd], outs[nd], launches[nd] = cg_step(mesh, *graph)
        C.log(f"mesh={nd}: GN-CG step {step_ms[nd]:.2f} ms (plans "
              f"{plan_ms[nd]:.2f} ms once; {len(graph[1])} edges, {n_nodes} "
              f"nodes); launches {launches[nd]}")

    n_schur = min(n_nodes, int(env.get("BENCH_PG_SCHUR_NODES", 4096)))
    mesh = make_mesh(n_avail, device=dev)
    schur_ms, setup_ms, part, schur_out, schur_launches = schur_step(
        mesh, *build_graph(n_schur))
    C.log(f"mesh={n_avail}: Schur exact GN step {schur_ms:.2f} ms "
          f"({n_schur} nodes, {len(part.sep_ids)} separators; setup "
          f"{setup_ms:.1f} ms once); launches {schur_launches}")

    base = step_ms[sizes[0]]
    eff = {nd: base / (step_ms[nd] * nd / sizes[0]) for nd in sizes[1:]}
    total = {k: sum(c[k] for c in launches.values()) + schur_launches[k]
             for k in schur_launches}
    line = {
        "metric": "dist_pose_graph_gn_step_ms", "value": step_ms[sizes[-1]],
        "unit": "ms/step", "n_nodes": n_nodes, "n_devices": sizes[-1],
        "scaling_efficiency": {str(k): v for k, v in eff.items()},
        "schur_exact_step_ms": schur_ms, "schur_nodes": n_schur,
        "schur_separators": int(len(part.sep_ids)),
        "backend": dev.type, "card": card,
        "virtual_devices": virtual_count(dev.type),
        "n_edges": len(graph[1]), "cg_iters": CG_ITERS, "reps": REPS,
        "step_ms": {str(k): v for k, v in step_ms.items()},
        "plan_build_ms": {str(k): v for k, v in plan_ms.items()},
        "schur_setup_ms": setup_ms,
        "kernel_launches_cg": {
            str(nd): C.launch_fields(c)["kernel_launches"]
            for nd, c in launches.items()},
        "kernel_launches_schur": C.launch_fields(schur_launches)["kernel_launches"],
        **C.launch_fields(total)}
    return line, outs, schur_out


def main(argv=None, env=None):
    """Runs the benchmark, prints its line; returns what ``run`` returns."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    C.add_device_args(ap)
    a = ap.parse_args(argv)
    dev = C.resolve_device(a.device)
    with C.virtual_shards(a.virtual_devices, dev):
        out = run(dev, env)
    print(json.dumps(out[0]), flush=True)
    return out


if __name__ == "__main__":
    main()
