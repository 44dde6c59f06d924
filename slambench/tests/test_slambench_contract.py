"""BENCHMARK.json against the benchmark's contract, and discovery by name:
every cell, configuration, traffic mix, limit file and metric reader is
found from its name alone, and a new traffic mix or metric is found
without an edit to any existing file."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from slambench import harness as H

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return H.benchmark()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["slambench"]
    assert bench["command"][:3] == ["python3", "-m", "slambench.run"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


def test_names_units_and_keys(bench):
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"slambench/configs/{c['name']}.json"
        assert len(c["reduced"]) <= 16
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e


def test_every_cell_reports_what_it_must(bench):
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m.get("workloads", [])) <= cells
    for w in cells:
        e2e = {m["name"] for m in H.metrics_for(bench, w, False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = H.metrics_for(bench, w, True)
        assert layer
        for m in layer:
            assert m["moves"] in e2e


def test_every_file_is_found_by_name(bench):
    used = set()
    for w in bench["workloads"]:
        cfg = H.config(w["config"])
        assert cfg["name"] == w["config"]
        tr = H.traffic(w["traffic"])
        assert H.driver(tr["driver"]).run
        assert H.limits(w["name"])
        used.add(w["config"])
    assert used == {c["name"] for c in bench["configs"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(H.metric_reader(m["name"]).read)
    for c in bench["configs"]:
        cfg = H.load_json(H.ROOT / c["file"])
        assert cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]


def test_new_files_are_found_without_edits(tmp_path, bench):
    """A later PR adds a traffic mix, a limit file, a metric reader and
    their entries; the harness finds them by name."""
    here = tmp_path / "slambench"
    shutil.copytree(H.HERE, here, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    before = {p.relative_to(here): p.read_bytes()
              for p in here.rglob("*") if p.is_file()}
    tr = dict(H.traffic("logs"), why="a second mix")
    (here / "traffic" / "logs_dense.json").write_text(json.dumps(tr))
    (here / "checks" / "engine_full.logs_dense.json").write_text(
        json.dumps({"limits": {"reg_gap_mm": 1.0}}))
    (here / "metrics" / "engine.extra_ms_per_scan.py").write_text(
        "def read(run):\n    return 42.0\n")
    b = dict(bench)
    b["workloads"] = bench["workloads"] + [
        {"name": "engine_full.logs_dense", "config": "engine_full",
         "traffic": "logs_dense", "chips": 1, "why": "test"}]
    b["per_layer"] = bench["per_layer"] + [
        {"name": "engine.extra_ms_per_scan", "unit": "ms/scan",
         "better": "lower", "source": "program_span", "layer": "engine",
         "moves": "scans_per_s", "workloads": ["engine_full.logs_dense"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))

    b2 = H.benchmark(tmp_path)
    w = H.cell(b2, "engine_full.logs_dense")
    assert H.traffic(w["traffic"], here)["why"] == "a second mix"
    assert H.limits(w["name"], here) == {"reg_gap_mm": 1.0}
    names = [m["name"] for m in H.metrics_for(b2, w["name"], True)]
    assert "engine.extra_ms_per_scan" in names
    assert "engine.registration_ms_per_scan" not in names
    assert H.metric_reader("engine.extra_ms_per_scan", here).read(None) == 42.0
    after = {p.relative_to(here): p.read_bytes()
             for p in here.rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())
