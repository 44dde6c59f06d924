"""The bench layer of icp_tpu_torch (``icp_tpu_torch/bench``) on the CPU:
its import hygiene; the headline's line against an engine driven directly;
the suite's scan2scan pipeline and teapot batch against icp_tpu's (JAX on
the CPU); the suite's refusals, its dist and scaled rows (a subprocess
each) and its exit code; gt_init_ba's streamed-init solve against
icp_tpu's on a cut of the 50k-node loop graph; the model's time spans; and
the kernel guard, which must catch a kernel that differs from its plain
version.

Small sizes: the bench sequence cut to 40 scans x 180 beams with scan /
submap capacities 256 / 1024 and batches of 8 (the full size runs on the
card, ``chip_smoke.py`` phase 17).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from icp_tpu_torch.bench import common as C  # noqa: E402
from icp_tpu_torch.bench import gt_init_ba, headline, startup, suite  # noqa: E402
from icp_tpu_torch.utils.config import SlamConfig as TConfig  # noqa: E402
from icp_tpu_torch.utils.metrics import ate, rpe  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_KEYS = {"metric", "value", "unit", "timing", "mean_scans_per_sec",
              "vs_baseline", "baseline_scans_per_sec", "ate_m", "rpe_trans_m",
              "rpe_rot_deg", "baseline_ate_m", "n_scans", "backend"}
SMALL_TPU = {"scan_capacity": 256, "submap_capacity": 1024, "batch_scans": 8}
N_SMALL, BEAMS_SMALL = 40, 180
POS_ATOL_M = 5e-3            # the main path's bound (test_torch_slam)
# gt_init_ba's cut: node 0 and the last 2,500 nodes of the 50k loop graph
GRAPH50K = os.path.join(REPO, "benchmarks", "graph50k_r05.npz")
CUT_FIRST = 47500
CHI2_RTOL = 1e-3
CUT_POS_TOL_M = 5e-4         # the packages came 4.8e-6 m apart on a CPU


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("bench_seq"))
    return d, C.load_sequence(d, N_SMALL, BEAMS_SMALL)


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return env


@pytest.mark.parametrize("module", ["common", "startup", "headline", "suite",
                                    "gt_init_ba", "scaled", "distributed",
                                    "scaling"])
def test_bench_module_imports_no_jax(module):
    """Importing each bench module leaves jax and icp_tpu out of
    sys.modules (the NumPy baseline is loaded only when the headline
    runs)."""
    code = (f"import sys, icp_tpu_torch.bench.{module}\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'icp_tpu')]\n"
            "assert not bad, bad\nprint('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("argv", [
    ["icp_tpu_torch.bench.headline"],
    ["icp_tpu_torch.bench.suite", "scan2scan"],
    ["icp_tpu_torch.bench.gt_init_ba", GRAPH50K],
    ["icp_tpu_torch.bench.scaled"], ["icp_tpu_torch.bench.distributed"],
    ["icp_tpu_torch.bench.scaling"]], ids=lambda a: a[0])
def test_entry_point_without_a_card_exits_non_zero(argv):
    """Without a card and without --device cpu each entry point fails and
    names --device cpu: nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the entry point would run on it")
    out = subprocess.run([sys.executable, "-m", *argv], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "--device cpu" in out.stderr
    assert out.stdout.strip() == ""


def _drive_headline_protocol(cfg, seq):
    """bench.py's pass, written out here: scan 0, 3 warm batches, then the
    full batches."""
    from icp_tpu_torch.engine import SlamEngine

    gt, scans, rels, imu = seq
    B = cfg.batch_scans
    eng = SlamEngine(cfg, imu=imu, verbose=False, device="cpu")
    eng.process_scan(scans[0], rels[0])
    start = 1 + 3 * B
    stop = start + ((len(scans) - start) // B) * B
    for k in range(1, stop, B):
        eng.process_scans_batched(scans[k:k + B], rels[k:k + B])
    eng.finish()
    return eng


def test_headline_line_and_ate_of_a_direct_run(small, capsys):
    """headline.main on the CPU at the small size prints one JSON line with
    every key of bench.py's line plus card and poses_kept, and its ATE,
    RPE and poses are those of the same engine driven directly."""
    data_dir, seq = small
    line = headline.main(["--device", "cpu", "--scans", str(N_SMALL),
                          "--beams", str(BEAMS_SMALL), "--base-warm", "2",
                          "--base-scans", "2", "--passes", "1",
                          "--data-dir", data_dir], tpu=SMALL_TPU)
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1]) == line
    missing = (BENCH_KEYS | {"card", "poses_kept", "kernel_launches"}) - set(line)
    assert not missing, missing
    assert line["backend"] == "cpu" and line["nn_impl"] == "auto"
    assert line["n_scans"] == 8
    # on the CPU the wrappers run their plain versions and count nothing
    assert set(line["kernel_launches"]) == {"nn_cuda", "nn_min_cuda",
                                            "icp_segment_add"}
    assert not any(line["kernel_launches"].values())

    eng = _drive_headline_protocol(TConfig.from_dict(C.headline_config(SMALL_TPU)), seq)
    traj = np.stack(eng.pose_trajectory)
    gt = seq[0]
    assert line["poses_kept"] == len(traj)
    assert line["ate_m"] == ate(traj[:, :2, 2], gt, indices=eng.pose_scan_indices)
    rpe_t, _ = rpe(traj, gt, indices=eng.pose_scan_indices)
    assert line["rpe_trans_m"] == rpe_t


def _drive_suite_protocol(eng, scans, rels, B):
    """bench_suite._run_pipeline's protocol without loop closure: 6 single
    scans, warmup, 3 warm batches, then the full batches."""
    for k in range(suite.WARM_SCANS):
        eng.process_scan(scans[k], rels[k])
    eng.warmup()
    start = suite.WARM_SCANS + suite.WARM_BATCHES * B
    stop = start + ((len(scans) - start) // B) * B
    for k in range(suite.WARM_SCANS, stop, B):
        eng.process_scans_batched(scans[k:k + B], rels[k:k + B])
    eng.finish()
    return eng


def test_scan2scan_row_matches_icp_tpu(small):
    """The scan2scan row's pipeline (submap off, loop closure off) through
    both packages on the small sequence: the same poses kept, positions
    within 5 mm."""
    from icp_tpu.engine import SlamEngine
    from icp_tpu.services.imu import IMUService
    from icp_tpu.utils.config import SlamConfig

    data_dir, seq = small
    sps, et, _, counts, n = suite.run_pipeline(
        torch.device("cpu"), seq, submap=False, lc=False, tpu=SMALL_TPU)
    assert n == 8 and sps > 0 and not any(counts.values())
    _, scans, rels, _ = seq
    cfg = SlamConfig.from_dict(C.pipeline_config(False, False, tpu=SMALL_TPU))
    cfg.num_scans = len(scans)
    imu_csv = C.sequence_paths(data_dir, N_SMALL, BEAMS_SMALL)[1]
    ej = _drive_suite_protocol(SlamEngine(cfg, imu=IMUService(imu_csv),
                                          verbose=False),
                               scans, rels, cfg.batch_scans)
    np.testing.assert_array_equal(et.pose_scan_indices, ej.pose_scan_indices)
    pt, pj = np.stack(et.pose_trajectory), np.stack(ej.pose_trajectory)
    np.testing.assert_allclose(pt[:, :2, 2], pj[:, :2, 2], atol=POS_ATOL_M)


def test_teapot_batch_matches_icp_tpu():
    """teapot_batch at B = 4: the port's loop of icp_core calls against
    icp_tpu's vmapped icp_core on the same clouds (bench_suite's inputs):
    iterations equal, R and t within 1e-5, error within 1e-3 relative or
    1e-9."""
    from icp_tpu.models.icp import icp_core

    inputs = suite.teapot_batch_inputs(4)
    got = suite.teapot_batch_align(torch.device("cpu"),
                                   *(torch.as_tensor(a) for a in inputs))

    @jax.jit
    def run(sp, sm, tp, tm):
        def one(a, am, b, bm):
            return icp_core(a, am, b, bm, jnp.eye(3, dtype=jnp.float32),
                            jnp.zeros(3, jnp.float32), method="point_to_point",
                            max_iterations=100, error_threshold=0.0)
        return jax.vmap(one)(sp, sm, tp, tm)

    want = run(*(jnp.asarray(a) for a in inputs))
    for b, r in enumerate(got):
        assert int(r.iters) == int(want.iters[b]), (b, int(r.iters), int(want.iters[b]))
        np.testing.assert_allclose(r.R.numpy(), np.asarray(want.R[b]), atol=1e-5)
        np.testing.assert_allclose(r.t.numpy(), np.asarray(want.t[b]), atol=1e-5)
        np.testing.assert_allclose(float(r.error), float(want.error[b]),
                                   rtol=1e-3, atol=1e-9)


class _Subprocess:
    """Stands in for subprocess.run in the suite: records each call and
    answers as ``result`` says ("ok": a JSON line, "fail": exit 1 with an
    error on stderr, "timeout": past the limit)."""

    def __init__(self, result="ok"):
        self.result, self.calls = result, []

    def __call__(self, argv, *, env, timeout, **kw):
        self.calls.append({"argv": argv, "env": env, "timeout": timeout})
        if self.result == "timeout":
            raise subprocess.TimeoutExpired(argv, timeout)
        if self.result == "fail":
            return subprocess.CompletedProcess(argv, 1, "",
                                               "progress\nValueError: boom\n")
        return subprocess.CompletedProcess(
            argv, 0, 'progress on stdout\n{"metric": "m", "value": 1.0}\n', "")


SUITE_MODULES = {"dist": ("icp_tpu_torch.bench.distributed",
                          {"BENCH_PG_NODES": "50000"}),
                 "scaled": ("icp_tpu_torch.bench.scaled",
                            {"BENCH_SCALED_SCANS": "600"})}


@pytest.mark.parametrize("names", [["dist"], ["scaled"], ["no_such_row"],
                                   ["scan2scan", "dist"]],
                         ids=lambda n: "+".join(n))
def test_suite_refuses_rows_it_does_not_have(names, monkeypatch, capsys):
    """An unknown row is refused before any row runs (exit 1); dist and
    scaled are rows now: each runs its entry point in a subprocess
    (``python -m`` the module, ``--device`` passed on, this tree on
    PYTHONPATH, bench_suite.py's size as a default under the environment,
    the 580 s limit) and its last line of output is the row."""
    fake = _Subprocess()
    monkeypatch.setattr(suite.subprocess, "run", fake)
    monkeypatch.setitem(suite.ROWS, "scan2scan", lambda dev, seq: {"metric": "s"})
    monkeypatch.setattr(suite, "NEEDS_SEQUENCE", set())
    monkeypatch.delenv("BENCH_PG_NODES", raising=False)
    monkeypatch.setenv("BENCH_SCALED_SCANS", "12")     # the environment wins
    code = suite.main(names + ["--device", "cpu"])
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    if "no_such_row" in names:
        assert code == 1 and fake.calls == []
        assert [r["config"] for r in lines] == ["no_such_row"]
        assert lines[0]["error"].startswith("unknown row")
        return
    assert code == 0
    assert [r["config"] for r in lines] == names
    routed = [n for n in names if n in SUITE_MODULES]
    assert len(fake.calls) == len(routed)
    for name, call in zip(routed, fake.calls):
        module, defaults = SUITE_MODULES[name]
        assert call["argv"][1:] == ["-m", module, "--device", "cpu"]
        assert call["timeout"] == 580
        assert call["env"]["PYTHONPATH"].split(os.pathsep)[0] == REPO
        want = {"BENCH_PG_NODES": "50000"} if name == "dist" \
            else {"BENCH_SCALED_SCANS": "12"}
        assert {k: call["env"][k] for k in want} == want
        row = next(r for r in lines if r["config"] == name)
        assert row == {"metric": "m", "value": 1.0, "config": name,
                       "card": C.card_line(torch.device("cpu"))}


@pytest.mark.parametrize("result", ["fail", "timeout"])
@pytest.mark.parametrize("name", ["dist", "scaled"])
def test_suite_subprocess_failure_is_the_rows_error(name, result, monkeypatch,
                                                    capsys):
    """A dist or scaled subprocess that exits non-zero or runs past its
    limit prints that row's error, the next row still runs, and the suite
    exits 1."""
    monkeypatch.setattr(suite.subprocess, "run", _Subprocess(result))
    monkeypatch.setitem(suite.ROWS, "icp_large", lambda dev, seq: {"metric": "m"})
    assert suite.main([name, "icp_large", "--device", "cpu"]) == 1
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [r["config"] for r in lines] == [name, "icp_large"]
    err = lines[0]["error"]
    if result == "fail":
        assert err.startswith("RuntimeError") and "ValueError: boom" in err, err
    else:
        assert err.startswith("TimeoutExpired"), err
    assert "error" not in lines[1]


def test_suite_goes_on_after_a_failed_row_and_exits_non_zero(monkeypatch, capsys):
    """A row that raises prints its error, the next row still runs, and the
    exit code is non-zero; with every row run it is 0."""
    def broken(dev, seq):
        raise ValueError("row failed")

    monkeypatch.setitem(suite.ROWS, "teapot", broken)
    monkeypatch.setitem(suite.ROWS, "icp_large",
                        lambda dev, seq: {"metric": "m", "value": 1.0})
    assert suite.main(["teapot", "icp_large", "--device", "cpu"]) == 1
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert lines[0]["config"] == "teapot" and "row failed" in lines[0]["error"]
    assert lines[1] == {"metric": "m", "value": 1.0, "config": "icp_large",
                        "card": C.card_line(torch.device("cpu"))}
    assert suite.main(["icp_large", "--device", "cpu"]) == 0


def _cut_graph():
    """Node 0 and nodes CUT_FIRST.. of the 50k loop graph, renumbered, with
    the edges between them (the odometry chain of the tail and the
    closures back to node 0)."""
    d = np.load(GRAPH50K)
    n = d["nodes"].shape[0]
    keep = np.r_[0, np.arange(CUT_FIRST, n)]
    new = np.full(n, -1)
    new[keep] = np.arange(len(keep))
    e = (new[d["ei"]] >= 0) & (new[d["ej"]] >= 0)
    return {"nodes": d["nodes"][keep], "ei": new[d["ei"][e]],
            "ej": new[d["ej"][e]], "z": d["z"][e], "om": d["om"][e],
            "rb": d["rb"][e], "robust_phi": d["robust_phi"], "gt": d["gt"][keep]}


def test_gt_init_ba_cut_matches_icp_tpu():
    """The streamed-init solve (15 GN iterations, node 0 fixed) of the cut
    through both packages, with the coarse threshold at 2,000 nodes on both
    instances, so the cut takes the 50k graph's route (a coarse supernode
    solve, then the PCG): chi2 after it within 1e-3 relative, both through
    "cg", the positions within CUT_POS_TOL_M, and the port's solve built
    its segment plans once a solve (2 for the coarse dense solve, 1 for
    the PCG)."""
    from icp_tpu.models.pose_graph import PoseGraph2D

    cut = _cut_graph()
    assert len(cut["nodes"]) == 2501 and len(cut["ei"]) == 2542
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        pt = gt_init_ba.graph_from_arrays(cut, torch.device("cpu"))
        pt._coarse_threshold = 2000
        solve = gt_init_ba.timed_solve(pt, 15, torch.device("cpu"))
    finally:
        torch.set_num_threads(threads)
    pj = PoseGraph2D()
    pj.robust_phi = float(cut["robust_phi"])
    for v in cut["nodes"]:
        pj.add_node(v)
    for i, j, z, om, rb in zip(cut["ei"], cut["ej"], cut["z"], cut["om"],
                               cut["rb"]):
        pj.add_edge(int(i), int(j), z, om, robust=bool(rb))
    pj._coarse_threshold = 2000
    pj.optimize(n_iterations=15, fix_node=0)

    assert pt.last_strategy == pj.last_strategy == "cg"
    assert solve["strategy"] == "cg" and solve["last_iterations"] == 15
    assert solve["segment_plan_builds"] == 3, solve
    spent = solve["span_ms"]
    assert all(spent[f"pose_graph.{k}"] > 0
               for k in ("coarse_correct", "pack", "pcg", "store",
                         "total_error")), spent
    assert (spent["pose_graph.coarse_correct_calls"]
            == spent["pose_graph.pcg_calls"] == 1), spent
    # on the CPU every wrapper runs its plain version: nothing launches
    assert solve["kernel_launches"] == {"nn_cuda": 0, "nn_min_cuda": 0,
                                        "icp_segment_add": 0}, solve
    ct, cj = pt.total_error(), pj.total_error()
    assert abs(ct / cj - 1) <= CHI2_RTOL, (ct, cj)
    gap = float(np.abs(np.stack(pt.nodes)[:, :2] - np.stack(pj.nodes)[:, :2]).max())
    assert gap <= CUT_POS_TOL_M, f"max position gap {gap:.3g} m > {CUT_POS_TOL_M} m"


GT_INIT_KEYS = {"metric", "n_nodes", "n_edges", "n_iterations", "ate_stream_m",
                "ate_streamed_init_m", "ate_gt_init_m", "chi2_streamed_pre",
                "chi2_streamed_post", "chi2_at_gt", "chi2_gt_init_post",
                "strategy_streamed", "strategy_gt"}


def test_gt_init_ba_line_on_the_cut():
    """gt_init_ba.run on the cut (the dense-free PCG route, 2,501 nodes)
    prints benchmarks/gt_init_ba.py's keys plus ``card``, and for each
    solve its wall ms, GN iterations, segment plans, the launches counted
    around that solve alone and the model's spans; both solves descend and
    the ground-truth one ends nearer the truth."""
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        line = gt_init_ba.run(torch.device("cpu"), _cut_graph(), 15)
    finally:
        torch.set_num_threads(threads)
    assert GT_INIT_KEYS | {"card", "load_ms"} <= set(line), sorted(line)
    for tag in ("streamed", "gt"):
        assert line[f"last_iterations_{tag}"] == 15
        assert line[f"wall_ms_{tag}"] > 0
        assert line[f"segment_plan_builds_{tag}"] == 1    # the PCG's, once
        assert line[f"kernel_launches_{tag}"] == {
            "nn_cuda": 0, "nn_min_cuda": 0, "icp_segment_add": 0}
        spent = line[f"span_ms_{tag}"]
        assert (spent["pose_graph.pcg_calls"] == 1
                and spent["pose_graph.pcg"] > 0), spent
        # 2,501 < 5,000 nodes
        assert "pose_graph.coarse_correct" not in spent
        assert spent["pose_graph.pcg"] <= line[f"wall_ms_{tag}"]
    assert line["chi2_streamed_post"] < line["chi2_streamed_pre"]
    assert line["chi2_gt_init_post"] < line["chi2_at_gt"]
    assert line["ate_gt_init_m"] < line["ate_streamed_init_m"]


def test_spans_sum_their_entries_only_while_recording():
    """A span outside ``spans.record`` records nothing; inside, each name
    sums its entries' ms and counts them, nested spans included, and a
    second ``record`` inside the first is refused."""
    import time

    from icp_tpu_torch.utils import spans

    with spans.span("test.outer"):
        pass
    with spans.record("cpu") as spent:
        for _ in range(2):
            with spans.span("test.outer"):
                with spans.span("test.inner"):
                    time.sleep(0.002)
        with pytest.raises(RuntimeError, match="does not nest"):
            with spans.record("cpu"):
                pass
    assert spent["test.outer_calls"] == spent["test.inner_calls"] == 2, spent
    assert spent["test.outer"] >= spent["test.inner"] >= 4.0, spent
    with spans.span("test.outer"):          # off again
        pass
    assert spent["test.outer_calls"] == 2


@pytest.mark.parametrize("kernel", ["nn", "nn_min", "segment_add"])
def test_guard_catches_a_kernel_that_differs(kernel, monkeypatch):
    """startup.check passes with the wrappers as they are, and raises when
    a wrapper's result moves by one ulp."""
    from icp_tpu_torch.ops import scatter as SC
    from icp_tpu_torch.ops.hopper import nn_kernel as K

    dev = torch.device("cpu")
    shapes = {"main coarse": (13 * 256, 768)}
    assert startup.check(dev, shapes) == {"nn": 0.0, "nn_min": 0.0,
                                          "segment_add": 0.0}

    def nudge(x):
        return torch.nextafter(x, torch.full_like(x, float("inf")))

    if kernel == "nn":
        real = K.nn_cuda
        monkeypatch.setattr(K, "nn_cuda", lambda *a: (nudge(real(*a)[0]), real(*a)[1]))
    elif kernel == "nn_min":
        real = K.nn_min_cuda
        monkeypatch.setattr(K, "nn_min_cuda", lambda *a: nudge(real(*a)))
    else:
        real = SC.ordered_index_add_
        monkeypatch.setattr(SC, "ordered_index_add_",
                            lambda *a, **kw: nudge(real(*a, **kw)))
    with pytest.raises(AssertionError, match="bit-equal"):
        startup.check(dev, shapes)


@pytest.mark.gpu
def test_guard_passes_on_the_card():
    """On a card: the guard at the main path's sweep shapes (from the bench
    sequence's first scan), each kernel launched once a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import tempfile

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as td:
        _, scans, _, _ = C.load_sequence(td)
    cfg = TConfig.from_dict(C.headline_config())
    shapes = startup.main_sweep_shapes(cfg, scans[0], dev)
    C.reset_counts()
    err = startup.check(dev, shapes)
    assert err == {"nn": 0.0, "nn_min": 0.0, "segment_add": 0.0}
    assert C.read_counts() == {"nn": 1, "nn_min": len(shapes), "segment_add": 3}
