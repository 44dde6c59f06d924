"""Run one cell of the benchmark of icp_tpu_torch once and print its line.

    python3 -m slambench.run --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout, on a machine with the cards the cell asks
for. Set-up (the program's import, its kernels' build or load, the
traffic made from ``--seed``, one warm pass) runs first; then the window
measures for ``--seconds``; then the outputs are checked against the
plain reference in ``slambench/reference``. The last lines of standard
error give each number compared beside its limit; the last line of
standard output is the result, a JSON object. With ``--trace 1`` the
metrics are the cell's per-layer ones, read from a profiled slice of the
window and from the program's own counters.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()       # before any import of weight

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

from slambench import harness as H  # noqa: E402
from slambench import stats  # noqa: E402


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def device_info(torch, dev, run: H.Run, chips: int) -> dict:
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": chips, "memory_peak_bytes": int(run.memory_peak_bytes)}
    if run.trace is not None:
        info["busy_s"] = run.trace["busy_s"]
        info["window_s"] = run.trace["window_s"]
    return info


def measure(workload: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda", traffic: dict | None = None,
            config: dict | None = None, t_process: float | None = None,
            control: bool = False):
    """Run ``workload`` once on ``device``. Returns (run, metrics, cell).
    ``traffic`` and ``config`` update the cell's files' values, nested
    sections key by key (the tests' small sizes); ``control`` also judges
    the bfloat16 reference in the program's place (``run.control``)."""
    bench = H.benchmark()
    cell = H.cell(bench, workload)
    traffic = H.merged(H.traffic(cell["traffic"]), traffic or {})
    drv = H.driver(traffic["driver"])
    config = H.merged(H.config(cell["config"]), config or {})
    run = drv.run(config=config, traffic=traffic,
                  limits=H.limits(workload), seed=seed, seconds=seconds,
                  trace=trace, device=device,
                  t_process=T_PROCESS if t_process is None else t_process,
                  control=control)
    lat = stats.latencies_ms(run.handed, run.accounted)
    lat = lat[np.isfinite(lat)]
    if lat.size:
        run.notes.append(f"pose latency over {lat.size} scans: median "
                         f"{np.median(lat):.1f} ms")
    metrics = {}
    for m in H.metrics_for(bench, workload, trace):
        v = H.metric_reader(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    return run, metrics, cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    import torch

    # one process, few threads: the host's other cores stay free for the
    # program's single launching thread
    torch.set_num_threads(1)
    cell = H.cell(H.benchmark(), a.workload)
    if not torch.cuda.is_available():
        log("no CUDA device: torch.cuda.is_available() is False")
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        log(f"{a.workload} needs {cell['chips']} cards, "
            f"{torch.cuda.device_count()} visible")
        return 2
    dev = torch.device("cuda", 0)
    run, metrics, cell = measure(a.workload, a.seed, a.seconds,
                                 bool(a.trace), device=str(dev))
    bad = H.loaded_forbidden()
    if bad:
        log(f"refused: the run loaded {', '.join(bad)}")
        return 3
    for line in run.notes:
        log(line)
    for name, v, lim in run.checks:
        log(f"check {name}: {v!r} (limit {lim!r})")
    out = H.result_line(run, metrics, device_info(torch, dev, run,
                                                  cell["chips"]),
                        run.trace and {k: run.trace[k] for k in
                                       ("device_ops", "idle_gaps")})
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
