"""The mesh entry points of icp_tpu_torch's bench layer on the CPU:
``bench.scaled`` (benchmarks/bench_scaled.py), ``bench.distributed``
(benchmarks/bench_distributed.py) and ``bench.scaling``
(benchmarks/bench_scaling.py).

* Their configurations against the scripts': the keywords each script
  passes to icp_tpu's ``ScaledPipeline`` are recorded by a stand-in that
  stops the script there (no JAX compile), for the defaults and for every
  knob set away from its default.
* ``build_graph`` bit-equal to the script's (loaded by its path).
* One CG step (the 50k-node protocol at 400 nodes, ``cg_iters`` 25) on 1
  and 2 virtual CPU shards against icp_tpu's on 1 and 2 of its 8 virtual
  CPU devices, within rtol 1e-4 / atol 1e-5; one Schur step (256 nodes)
  likewise, held against the float64 step (its system is beyond float32:
  see ``test_schur_step_matches_icp_tpu``).
* A short ``bench.scaled`` run with its graph dump (the line's keys, the
  dump's keys and dtypes, icp_tpu's ``load_graph`` reading it) and a
  short ``bench.scaling`` run on 2 virtual shards (two lines, their keys).

The full sizes run on the card (``chip_smoke.py`` phases 12 and 18).
"""
import functools
import importlib.util
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from icp_tpu_torch.bench import distributed, scaled, scaling  # noqa: E402
from icp_tpu_torch.parallel.mesh import make_mesh, set_virtual_devices  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
RTOL, ATOL = 1e-4, 1e-5
# bench_scaled.py's line (:159-186) and bench_scaling.py's (:77-92)
SCALED_KEYS = {
    "metric", "value", "unit", "n_scans", "points_per_scan", "n_keyframes",
    "n_devices", "icp_method", "submap_keyframes", "gn_step_ms",
    "partition_ms", "ba_strategy", "gn_step_strategy", "ate_m",
    "ate_stream_m", "loop_closures", "lc_checked", "ba_runs",
    "gate_fallbacks", "reg_dropped_points", "wall_replay_s",
    "wall_replay_fill_s", "replayed_keyframes", "map_cells", "trajectory",
    "backend"}
SCALING_KEYS = {"metric", "n_devices", "value", "unit", "gn_step_ms",
                "gn_step_strategy", "n_scans", "points_per_scan",
                "n_processes", "backend", "virtual_devices"}
# every BENCH_SCALED_* knob at a value other than its default
SCALED_KNOBS = {
    "BENCH_SCALED_SCANS": "700", "BENCH_SCALED_POINTS": "5000",
    "BENCH_SCALED_DEVICES": "2", "BENCH_SCALED_METHOD": "point_to_point",
    "BENCH_SCALED_SUBMAP": "4", "BENCH_SCALED_BA_EVERY": "0",
    "BENCH_SCALED_TRAJ": "eight", "BENCH_SCALED_CELL_CAP": "128",
    "BENCH_SCALED_QCELLS": "16384", "BENCH_SCALED_RAY_STRIDE": "4",
    "BENCH_SCALED_KF_CAP": "4096", "BENCH_SCALED_LC_EVERY": "16",
    "BENCH_SCALED_LC_CAP": "500", "BENCH_SCALED_LC_ROBUST": "0",
    "BENCH_SCALED_LC_COOLDOWN": "0", "BENCH_SCALED_BA_ITERS": "5",
    "BENCH_SCALED_REPLAY_CHUNK": "32"}


def _load(name):
    """benchmarks/<name>.py, by its path (not a package)."""
    spec = importlib.util.spec_from_file_location(
        f"_bench_{name}", os.path.join(REPO, "benchmarks", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Stop(Exception):
    pass


@pytest.fixture
def recorder(monkeypatch):
    """icp_tpu's ScaledPipeline and make_mesh replaced: make_mesh records
    its size, the pipeline records its keywords and stops the script."""
    import icp_tpu.parallel.mesh as JM
    import icp_tpu.parallel.scaled as JS

    got = {}

    def pipeline(mesh, **kw):
        got["kwargs"] = kw
        raise _Stop

    monkeypatch.setattr(JM, "make_mesh", lambda n: got.setdefault("mesh", n))
    monkeypatch.setattr(JS, "ScaledPipeline", pipeline)
    return got


@pytest.mark.parametrize("knob", [None, *SCALED_KNOBS])
def test_scaled_pipeline_kwargs_equal_bench_scaled(knob, recorder, monkeypatch):
    """bench.scaled.pipeline_kwargs gives exactly the keywords
    bench_scaled.py's main passes to ScaledPipeline, at the defaults and
    with each knob set away from its default."""
    for k in SCALED_KNOBS:
        monkeypatch.delenv(k, raising=False)
    if knob is not None:
        monkeypatch.setenv(knob, SCALED_KNOBS[knob])
    with pytest.raises(_Stop):
        _load("bench_scaled").main()
    n_scans = int(os.environ.get("BENCH_SCALED_SCANS", 1200))
    n_points = int(os.environ.get("BENCH_SCALED_POINTS", 100_000))
    assert scaled.pipeline_kwargs(n_scans, n_points) == recorder["kwargs"]
    assert scaled.pipeline_kwargs(n_scans, n_points,
                                  env=dict(os.environ)) == recorder["kwargs"]
    if knob == "BENCH_SCALED_DEVICES":
        assert recorder["mesh"] == 2


@pytest.mark.parametrize("n_scans,n_points", [(120, 16384), (40, 16384),
                                              (1000, 5000)])
def test_scaling_pipeline_kwargs_equal_run_one(n_scans, n_points, recorder):
    """bench.scaling.pipeline_kwargs gives exactly the keywords
    bench_scaling.run_one passes (kf_capacity 4096; the rest of the
    pipeline's keywords at their defaults)."""
    scans = [np.zeros((n_points, 2), np.float32)] * n_scans
    with pytest.raises(_Stop):
        _load("bench_scaling").run_one(1, scans)
    assert scaling.pipeline_kwargs(n_scans, n_points) == recorder["kwargs"]


def test_scaled_pipeline_defaults_equal_icp_tpu():
    """The keywords the scripts leave out take the same defaults in both
    packages' ScaledPipeline."""
    import inspect

    from icp_tpu.parallel.scaled import ScaledPipeline as J
    from icp_tpu_torch.parallel.scaled import ScaledPipeline as T

    def defaults(cls):
        return {k: p.default for k, p in
                inspect.signature(cls.__init__).parameters.items()
                if k not in ("self", "mesh")}

    assert defaults(T) == defaults(J)


@pytest.mark.parametrize("n_nodes,kw", [(1000, {}),
                                        (257, {"lc_every": 31, "seed": 5})],
                         ids=["1000", "257-lc31-seed5"])
def test_build_graph_bit_equal_to_bench_distributed(n_nodes, kw):
    want = _load("bench_distributed").build_graph(n_nodes, **kw)
    got = distributed.build_graph(n_nodes, **kw)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.fixture
def shards(request):
    """A port mesh of ``request.param`` virtual CPU shards, cleared after."""
    set_virtual_devices(request.param, "cpu")
    try:
        yield make_mesh(request.param, device="cpu")
    finally:
        set_virtual_devices(0, "cpu")


@pytest.mark.parametrize("shards", [1, 2], indirect=True)
def test_cg_step_matches_icp_tpu(shards):
    """bench.distributed's CG step (edges padded to the mesh size, plans
    built once, cg_iters 25) at 400 nodes against icp_tpu's
    gn_step_cg_sharded as bench_distributed.py jits it."""
    from icp_tpu.parallel.dist_pose_graph import gn_step_cg_sharded
    from icp_tpu.parallel.mesh import make_mesh as jmake

    graph = distributed.build_graph(400)
    _, _, got, _ = distributed.cg_step(shards, *graph)
    eip, ejp, zp, omp, em = distributed.padded_edges(*graph[1:], shards.size)
    jm = jmake(shards.size)
    step = jax.jit(lambda *a: gn_step_cg_sharded(jm, *a, cg_iters=25))
    want = step(jnp.asarray(graph[0]), jnp.ones(400, bool), jnp.asarray(eip),
                jnp.asarray(ejp), jnp.asarray(zp), jnp.asarray(omp),
                jnp.asarray(em), jnp.int32(0))
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def _exact_step(nodes, ei, ej, z, om):
    """The GN step of the graph (node 0 fixed) solved in float64, the
    normal equations assembled from the port's edge Jacobians, and the
    condition number of their matrix."""
    from icp_tpu_torch.models.pose_graph import edge_terms

    n = len(nodes)
    t = lambda a, dt=torch.float64: torch.as_tensor(a, dtype=dt)  # noqa: E731
    e, A, B = (x.numpy() for x in edge_terms(
        t(nodes), t(ei, torch.int64), t(ej, torch.int64), t(z), t(om),
        torch.ones(len(ei), dtype=torch.bool)))
    H = np.zeros((n, 3, n, 3))
    b = np.zeros((n, 3))
    for Ja, a in ((A, ei), (B, ej)):
        np.add.at(b, a, np.einsum("eji,ej->ei", Ja, e))
        for Jc, c in ((A, ei), (B, ej)):
            np.add.at(H, (a, slice(None), c), np.einsum("eji,ejk->eik", Ja, Jc))
    H, b = H.reshape(3 * n, 3 * n), b.reshape(-1)
    H[:3], H[:, :3], b[:3] = 0.0, 0.0, 0.0
    H[:3, :3] = np.eye(3)
    return (nodes.astype(np.float64) + np.linalg.solve(H, -b).reshape(n, 3),
            np.linalg.cond(H))


def _gap(a, b):
    """Largest difference of two node arrays, yaw wrapped."""
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    d[:, 2] = (d[:, 2] + np.pi) % (2 * np.pi) - np.pi
    return float(np.abs(d).max())


@pytest.mark.parametrize("shards", [1, 2], indirect=True)
def test_schur_step_matches_icp_tpu(shards):
    """bench.distributed's Schur step at 256 nodes (partition and plans
    once) against icp_tpu's gn_step_schur_sharded on its partition. The
    step's system is too ill-conditioned for float32 (cond(H) ~2.5e9:
    a 256-node chain, two closures, unit information), so both packages
    land millimetres from the float64 step and from each other; the port
    is held to be no farther from the float64 step than icp_tpu, and
    within 1 cm of it."""
    from icp_tpu.parallel.dist_pose_graph import (gn_step_schur_sharded,
                                                  partition_graph)
    from icp_tpu.parallel.mesh import make_mesh as jmake

    graph = distributed.build_graph(256)
    _, _, part, got, _ = distributed.schur_step(shards, *graph)
    jpart = partition_graph(256, *graph[1:], np.ones(len(graph[1]), bool),
                            shards.size, 0)
    assert len(part.sep_ids) == len(jpart.sep_ids)
    jm = jmake(shards.size)
    want = jax.jit(functools.partial(gn_step_schur_sharded, jm))(
        jnp.asarray(graph[0]), jnp.ones(256, bool), jpart)
    exact, cond = _exact_step(*graph)
    port, ref = _gap(got, exact), _gap(np.asarray(want), exact)
    print(f"Schur step, 256 nodes, {shards.size} shard(s): cond(H) "
          f"{cond:.3g}; from the float64 step: port {port:.3g}, icp_tpu "
          f"{ref:.3g}; port from icp_tpu {_gap(got, np.asarray(want)):.3g}")
    assert port <= max(ref, ATOL), (port, ref, _gap(got, np.asarray(want)))
    assert port <= 1e-2, port


def test_distributed_line_on_two_shards(capsys):
    """bench.distributed.main on 2 virtual CPU shards at 400 / 256 nodes:
    one line with bench_distributed.py's keys, meshes 1 and 2, the plan
    builds apart from the step times, and the virtual shards named."""
    line, outs, schur = distributed.main(
        ["--device", "cpu", "--virtual-devices", "2"],
        env={"BENCH_PG_NODES": "400", "BENCH_PG_SCHUR_NODES": "256"})
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == line
    assert {"metric", "value", "unit", "n_nodes", "n_devices",
            "scaling_efficiency", "schur_exact_step_ms", "schur_nodes",
            "schur_separators", "backend"} <= set(line)
    assert line["n_devices"] == 2 and line["virtual_devices"] == 2
    assert set(line["step_ms"]) == set(line["plan_build_ms"]) == {"1", "2"}
    assert list(line["scaling_efficiency"]) == ["2"]
    assert line["n_edges"] == 403 and line["schur_nodes"] == 256
    np.testing.assert_allclose(outs[2], outs[1], rtol=RTOL, atol=ATOL)
    assert schur.shape == (256, 3) and np.isfinite(schur).all()
    assert make_mesh(device="cpu").size == 1          # the shards cleared


def test_scaled_run_line_and_graph_dump(tmp_path, capsys):
    """A short bench.scaled run on the CPU (5 scans of 2,048 points, the
    eight) with the graph dump: the line has bench_scaled.py's keys, the
    dump its keys, dtypes and shapes, icp_tpu's load_graph reads it, and
    both packages give its graph the same total_error (at the streamed
    nodes, and at ground truth in the first pose's frame)."""
    from icp_tpu.utils.metrics import gt_relative

    from icp_tpu_torch.bench import gt_init_ba

    dump = str(tmp_path / "graph.npz")
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        line, pipe, gt = scaled.main(["--device", "cpu"], env={
            "BENCH_SCALED_SCANS": "5", "BENCH_SCALED_POINTS": "2048",
            "BENCH_SCALED_TRAJ": "eight", "BENCH_SCALED_KF_CAP": "1024",
            "BENCH_SCALED_DUMP_GRAPH": dump})
    finally:
        torch.set_num_threads(threads)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == line
    assert SCALED_KEYS | {"card", "kernel_launches", "peak_device_mb",
                          "lm_retries", "rejected_solves"} <= set(line)
    assert line["backend"] == "cpu" and line["trajectory"] == "eight"
    assert line["n_scans"] == 5 and line["points_per_scan"] == 2048
    assert not any(line["kernel_launches"].values())
    assert len(pipe.trajectory) == 5 and gt.shape == (5, 3)

    d = np.load(dump)
    n, e = 5, pipe.pose_graph.n_edges
    want = {"nodes": (np.float32, (n, 3)), "ei": (np.int32, (e,)),
            "ej": (np.int32, (e,)), "z": (np.float32, (e, 3)),
            "om": (np.float32, (e, 3, 3)), "rb": (np.bool_, (e,)),
            "robust_phi": (np.float32, ()), "gt": (np.float64, (n, 3))}
    assert {k: (d[k].dtype.type, d[k].shape) for k in d.files} == want
    np.testing.assert_array_equal(d["gt"], gt)

    jpg, jd = _load("gt_init_ba").load_graph(dump)
    tpg = gt_init_ba.graph_from_arrays(d, CPU)
    assert jpg.n_nodes == tpg.n_nodes == n and jpg.n_edges == tpg.n_edges == e
    np.testing.assert_allclose(tpg.total_error(), jpg.total_error(),
                               rtol=1e-5, atol=1e-9)
    gt_rel = gt_relative(jd["gt"]).astype(np.float32)
    for k in range(n):
        jpg._nodes[k] = gt_rel[k].copy()
    tgt = gt_init_ba.gt_init_graph(d, CPU)
    assert jpg.total_error() > 1.0
    np.testing.assert_allclose(tgt.total_error(), jpg.total_error(), rtol=1e-5)


def test_scaling_lines_on_two_shards(capsys):
    """A short bench.scaling run on 2 virtual CPU shards (meshes "1,2,4":
    4 is clipped): two lines with bench_scaling.py's keys, the second with
    efficiency_vs_smallest, both saying the shards are virtual, and the
    same trajectory on both meshes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        runs = scaling.main(["--device", "cpu", "--virtual-devices", "2"], env={
            "BENCH_SCALING_SCANS": "4", "BENCH_SCALING_POINTS": "1024",
            "BENCH_SCALING_MESHES": "1,2,4"})
    finally:
        torch.set_num_threads(threads)
    printed = [json.loads(s) for s in capsys.readouterr().out.strip().splitlines()]
    assert printed == [line for line, _ in runs]
    (l1, p1), (l2, p2) = runs
    for line, nd in ((l1, 1), (l2, 2)):
        assert SCALING_KEYS | {"card", "kernel_launches"} <= set(line)
        assert line["n_devices"] == nd and line["virtual_devices"] is True
        assert line["n_processes"] == 1 and line["backend"] == "cpu"
        assert line["n_scans"] == 4 and line["points_per_scan"] == 1024
    assert "efficiency_vs_smallest" not in l1
    assert l2["efficiency_vs_smallest"] == pytest.approx(l2["value"] / l1["value"])
    np.testing.assert_allclose(np.stack(p2.trajectory), np.stack(p1.trajectory),
                               atol=1e-6)
