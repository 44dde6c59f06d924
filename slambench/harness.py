"""What every cell shares: finding a cell's files by name, the record a
driver fills, the metric readers, the import guard and the result line.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration, ``slambench/configs/<config>.json``, and a traffic mix,
``slambench/traffic/<traffic>.json``, whose ``driver`` key names the
module ``slambench/drivers/<driver>.py`` that runs it. Its correctness
limits are in ``slambench/checks/<workload>.json``. Each metric is read by
``slambench/metrics/<metric>.py``, which defines ``read(run)``: the value,
or None where the run has nothing to read.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "icp_tpu", "benchmarks")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"({', '.join(w['name'] for w in bench['workloads'])})")


def config(name: str, here: Path = HERE) -> dict:
    return load_json(here / "configs" / f"{name}.json")


def traffic(name: str, here: Path = HERE) -> dict:
    return load_json(here / "traffic" / f"{name}.json")


def limits(workload: str, here: Path = HERE) -> dict:
    return load_json(here / "checks" / f"{workload}.json")["limits"]


def merged(base: dict, update: dict) -> dict:
    """``base`` with ``update``'s values, nested dicts merged key by key."""
    out = dict(base)
    for k, v in update.items():
        out[k] = (merged(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out


def driver(name: str):
    return importlib.import_module(f"slambench.drivers.{name}")


def metric_reader(name: str, here: Path = HERE):
    """The module ``metrics/<name>.py``, loaded by its path (metric names
    hold dots)."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"slambench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_for(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of ``workload`` reports: its end-to-end metrics
    with --trace 0, its per-layer metrics with --trace 1. A metric with a
    ``workloads`` list is a metric of those cells only; a per-layer metric
    without one is a metric of every cell that reports its ``moves``."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload])
            and ("workloads" in m or m["moves"] in names)]


@dataclasses.dataclass
class Run:
    """What a driver hands back: the window's record and the checks'."""
    setup_s: float = math.nan
    window_s: float = math.nan
    attempted: int = 0
    failed: int = 0
    handed: np.ndarray = None          # per scan: start of the handing call
    accounted: np.ndarray = None       # per scan: return that accounted it
    rejected: int = 0                  # gate rejections (the algorithm's)
    ate_m: float = math.nan
    walls: dict = dataclasses.field(default_factory=dict)   # summed stats
    trace: dict | None = None          # trace.reduce's summary
    memory_peak_bytes: int = 0
    checks: list = dataclasses.field(default_factory=list)  # (name, v, lim)
    notes: list = dataclasses.field(default_factory=list)   # stderr lines
    control: dict | None = None        # the bfloat16 control's numbers

    @property
    def accounted_scans(self) -> int:
        return int(np.isfinite(self.accounted).sum())

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(
            math.isfinite(v) and v <= lim for _, v, lim in self.checks)


def loaded_forbidden() -> list[str]:
    """Top-level names in ``sys.modules`` that a run may not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def result_line(run: Run, metrics: dict, device: dict,
                breakdown: dict | None) -> dict:
    out = {"correct": run.correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in run.checks}
    return out
