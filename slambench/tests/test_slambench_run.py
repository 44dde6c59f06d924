"""Whole runs of each cell at tiny sizes on the CPU (the harness's look for
a card skipped): the result line, ``correct`` on a sound run, ``correct``
false with the timed path broken underneath (a step that returns its
state unchanged, half of a batch left out, an answer altered where it is
produced), the bfloat16 control failing the comparison, and one run on
the card, skipped here."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from slambench import harness as H
from slambench import run as R

REPO = Path(__file__).resolve().parents[2]

# a short lap of few beams, loop closure reachable within it
ENGINE_TRAFFIC = {"scans_per_log": 48, "beams": 180, "max_scans_per_s": 100,
                  "ate_logs": 1, "check_scans": 6, "check_map_logs": 1,
                  "trace_start_call": 2, "trace_calls": 3}
ENGINE_CONFIG = {"program": {"loop_closure": {"min_interval": 20,
                                              "min_cumulative_travel": 3.0},
                             "tpu": {"batch_scans": 8}}}
SCALED_TRAFFIC = {"warm_scans": 1, "ate_scans": 3,
                  "check_scans": 8, "trace_start_call": 1, "trace_calls": 2}
SCALED_CONFIG = {"points_per_scan": 4096, "keyframes": 1200,
                 "program": {"scan_capacity": 4096}}
SEED = 2**31 + 977


def engine_run(seconds=50.0, trace=False, control=False):
    return R.measure("engine_full.logs", SEED, seconds, trace, device="cpu",
                     traffic=ENGINE_TRAFFIC, config=ENGINE_CONFIG,
                     control=control)


def scaled_run(seconds=12.0, trace=False, control=False):
    return R.measure("scaled_100k.lap50k", SEED, seconds, trace,
                     device="cpu", traffic=SCALED_TRAFFIC,
                     config=SCALED_CONFIG, control=control)


@pytest.fixture(scope="module")
def engine_sound():
    return engine_run(trace=True, control=True)


@pytest.fixture(scope="module")
def scaled_sound():
    return scaled_run(trace=True, control=True)


def test_engine_line(engine_sound):
    run, metrics, cell = engine_sound
    line = H.result_line(run, metrics, {"platform": "cpu"}, None)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"], run.checks
    assert run.attempted > 0 and run.failed == 0
    assert set(metrics) == {"engine.registration_ms_per_scan",
                            "engine.loop_closure_ms_per_scan"}
    assert {n for n, _, _ in run.checks} == {
        "reg_gap_mm", "lc_gate_misses", "lc_err_excess", "lc_gap_mm",
        "traj_gap_mm", "map_diff_pct"}
    json.dumps(line)


def test_engine_control_fails(engine_sound):
    run, _, _ = engine_sound
    lim = {n: lim for n, _, lim in run.checks}
    assert any(v > lim[n] for n, v in run.control.items()), run.control


def test_scaled_line_and_control(scaled_sound):
    run, metrics, _ = scaled_sound
    assert run.correct, run.checks
    assert set(metrics) == {"scaled.registration_ms_per_scan",
                            "scaled.drain_wait_ms_per_scan"}
    lim = {n: lim for n, _, lim in run.checks}
    assert any(v > lim[n] for n, v in run.control.items()), run.control


# ── the timed path broken underneath ─────────────────────────────────────
def _engine_stuck(monkeypatch):
    """Every batch returns the state it was given: no scan moves the
    pose."""
    from icp_tpu_torch.engine import SlamEngine

    orig = SlamEngine._dispatch_chunk_async

    def stuck(self, scans, rel_times):
        pose = self._state.global_pose.clone()
        outs = orig(self, scans, rel_times)
        self._state = self._state._replace(global_pose=pose)
        return outs._replace(pose=pose.expand_as(outs.pose).clone())
    monkeypatch.setattr(SlamEngine, "_dispatch_chunk_async", stuck)


def _engine_half(monkeypatch):
    """Half of each batch is left out."""
    from icp_tpu_torch.engine import SlamEngine

    orig = SlamEngine.process_scans_batched

    def half(self, scans, rel_times):
        k = max(1, len(scans) // 2)
        return orig(self, scans[:k], rel_times[:k])
    monkeypatch.setattr(SlamEngine, "process_scans_batched", half)


def _engine_altered(monkeypatch):
    """One pose of each batch is moved by 5 cm where it is produced."""
    from icp_tpu_torch.engine import SlamEngine

    orig = SlamEngine._dispatch_chunk_async

    def altered(self, scans, rel_times):
        outs = orig(self, scans, rel_times)
        pose = outs.pose.clone()
        pose[-1, 0, 2] += 0.05
        return outs._replace(pose=pose)
    monkeypatch.setattr(SlamEngine, "_dispatch_chunk_async", altered)


@pytest.mark.parametrize("fault", [_engine_stuck, _engine_half,
                                   _engine_altered])
def test_engine_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    run, _, _ = engine_run()
    assert not run.correct, run.checks


def _scaled_stuck(monkeypatch):
    from icp_tpu_torch.parallel.scaled import ScaledPipeline

    orig = ScaledPipeline._fused_reg

    def stuck(self, sp, sm, slot):
        R, t = self._dev_pR.clone(), self._dev_pt.clone()
        out = orig(self, sp, sm, slot)
        self._dev_pR, self._dev_pt = R, t
        return (R, t) + tuple(out[2:])
    monkeypatch.setattr(ScaledPipeline, "_fused_reg", stuck)


def _scaled_half(monkeypatch):
    from icp_tpu_torch.parallel.scaled import ScaledPipeline

    orig = ScaledPipeline.step
    calls = [0]

    def half(self, points):
        """Every other scan is dropped on its way in."""
        calls[0] += 1
        if calls[0] % 2:
            return orig(self, points)
    monkeypatch.setattr(ScaledPipeline, "step", half)


def _scaled_altered(monkeypatch):
    from icp_tpu_torch.parallel.scaled import ScaledPipeline

    orig = ScaledPipeline._fused_reg

    def altered(self, sp, sm, slot):
        """Every third pose is moved by 5 cm where it is produced."""
        out = orig(self, sp, sm, slot)
        if slot % 3:
            return out
        return (out[0], out[1] + 0.05) + tuple(out[2:])
    monkeypatch.setattr(ScaledPipeline, "_fused_reg", altered)


@pytest.mark.parametrize("fault", [_scaled_stuck, _scaled_half,
                                   _scaled_altered])
def test_scaled_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    run, _, _ = scaled_run()
    assert not run.correct, run.checks


# ── the entry point ──────────────────────────────────────────────────────
def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "slambench.run", "--workload",
         "engine_full.logs", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=REPO, capture_output=True, text=True,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(REPO)})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_a_cell_loads_nothing_forbidden():
    """Every module a run of each cell imports, in a fresh process: no
    top-level jax, jaxlib, flax, icp_tpu or benchmarks."""
    code = (
        "import sys; from slambench import harness as H; "
        "b = H.benchmark(); "
        "[H.driver(H.traffic(w['traffic'])['driver']) for w in "
        "b['workloads']]; "
        "[H.metric_reader(m['name']) for m in b['end_to_end'] + "
        "b['per_layer']]; "
        "import slambench.run, slambench.control, slambench.compare.engine,"
        " slambench.compare.scaled, icp_tpu_torch.engine, "
        "icp_tpu_torch.parallel.scaled, icp_tpu_torch.services.imu, "
        "icp_tpu_torch.utils.config, icp_tpu_torch.ops.hopper.build; "
        "print(H.loaded_forbidden())")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "icp_tpu_torch_extra", sys)
    assert "icp_tpu" not in H.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "icp_tpu.utils", sys)
    assert "icp_tpu" in H.loaded_forbidden()


@pytest.fixture
def card():
    """The card, or a skip with the reason (decided here, never at
    import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_cell_on_the_card(card):
    """A run of each cell through the entry point, correct."""
    seconds = str(H.benchmark()["run_seconds"])
    for w in ("engine_full.logs", "scaled_100k.lap50k"):
        out = subprocess.run(
            [sys.executable, "-m", "slambench.run", "--workload", w,
             "--seed", str(SEED), "--seconds", seconds, "--trace", "0"],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-2000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["correct"] and line["device"]["platform"] == "gpu"
        assert np.isfinite(line["metrics"]["scans_per_s"]["value"])
