"""A config #5 run cut by ``ScaledPipeline.save_checkpoint`` and resumed
by ``load_checkpoint`` with ``bench.scaled``'s resumable scan stream, on
the CPU.

* The scan stream resumed at scan k (from the generator's saved state, or
  by drawing and discarding the first k scans) is byte-equal, scans and
  ground truth, to a straight stream from k; the stream's culled distance
  pass gives icp_tpu's ``large_scan_stream`` byte for byte at the bench's
  width (1M-point world, 8,192 points) and where no point is in range.
* ``bench.scaled``'s run of 8 scans x 2,048 points on the eight, saved
  at scans 3 and 6 and resumed twice from each file in a fresh pipeline,
  against the straight run: the same scans, ground truth, keyframes,
  closures, checks and BA runs, trajectories within 0.05 m RMS (the bound
  ``test_torch_scaled.py`` holds a run resumed across the packages to),
  the two resumes bit-equal; icp_tpu's ``ScaledPipeline`` loads each
  file. ``bench.scaled``'s line reports its stream's ms a scan.

The card runs the cut at full width (``chip_smoke.py`` phase 19).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from icp_tpu_torch.bench import scaled  # noqa: E402
from icp_tpu_torch.utils.synth import large_scan_stream  # noqa: E402

CPU = torch.device("cpu")
RESUME_GAP_M = 0.05
N_SCANS, N_POINTS = 8, 2048
BASE = {"BENCH_SCALED_SCANS": str(N_SCANS),
        "BENCH_SCALED_POINTS": str(N_POINTS), "BENCH_SCALED_TRAJ": "eight",
        "BENCH_SCALED_KF_CAP": "1024", "BENCH_SCALED_DEVICES": "1"}
CUTS = (3, 6)


def _rms(a, b):
    a, b = np.stack(a)[:, :2, 2], np.stack(b)[:, :2, 2]
    return float(np.sqrt(np.mean(np.sum((a - b) ** 2, axis=1))))


@pytest.mark.parametrize("traj", ["loop", "eight"])
@pytest.mark.parametrize("how", ["state", "discard"])
def test_scan_stream_resumes_byte_equal(traj, how):
    kw = dict(n_points=2048, seed=3, trajectory=traj)
    straight = list(large_scan_stream(12, **kw))
    first = large_scan_stream(12, **kw)
    for _ in range(5):
        next(first)
    state = first.state if how == "state" else None
    resumed = list(large_scan_stream(12, start=5, rng_state=state, **kw))
    assert len(resumed) == 7
    for (s, g), (rs, rg) in zip(straight[5:], resumed, strict=True):
        assert s.dtype == rs.dtype and s.shape == rs.shape
        assert s.tobytes() == rs.tobytes() and g.tobytes() == rg.tobytes()


@pytest.mark.parametrize("case", ["loop", "eight", "none in range"])
def test_culled_stream_equals_icp_tpu(case):
    """The distance pass reads only the point runs whose box is in range;
    icp_tpu's stream reads every point."""
    from icp_tpu.utils.synth import large_scan_stream as jax_stream

    if case == "none in range":
        world = np.random.default_rng(1).uniform(
            -10, 10, (1000, 2)).astype(np.float32)
        kw = dict(n_points=500, extent=10.0, max_range=1e-3, seed=2,
                  world_points=world)
        n = 12
    else:
        kw = dict(n_points=8192, seed=3, trajectory=case)
        n = 40                     # 40 poses spread over the whole loop
    for (s, g), (js, jg) in zip(large_scan_stream(n, **kw),
                                jax_stream(n, **kw), strict=True):
        assert s.tobytes() == js.tobytes() and g.tobytes() == jg.tobytes()


def _pipeline():
    from icp_tpu_torch.parallel.mesh import make_mesh
    from icp_tpu_torch.parallel.scaled import ScaledPipeline

    kw = scaled.pipeline_kwargs(N_SCANS, N_POINTS, env=BASE)
    return ScaledPipeline(make_mesh(1, device=CPU), **kw), kw


def _resume(path, cut, state):
    """A fresh pipeline resumed from ``path`` (saved after scan ``cut -
    1``) over the rest of the stream, then the terminal BA as
    ``bench.scaled`` runs it."""
    pipe, _ = _pipeline()
    pipe.load_checkpoint(str(path))
    assert len(pipe.trajectory) == pipe.stats.scans == cut
    pipe.warm_replay()
    gt = []
    for scan, g in scaled.scan_stream(N_SCANS, N_POINTS, "eight", start=cut,
                                      rng_state=state):
        gt.append(g)
        pipe.step(scan)
    pipe.finish()
    pipe.optimize(n_iterations=15)
    return pipe, np.stack(gt)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The straight ``bench.scaled`` run; one pipeline over the same
    stream saved after scans 3 and 6; two resumes from each file."""
    d = tmp_path_factory.mktemp("resume")
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        straight = scaled.run(CPU, env=BASE)
        pipe, kw = _pipeline()
        pipe.warm_replay()
        stream = scaled.scan_stream(N_SCANS, N_POINTS, "eight")
        saved = {}
        for k in range(N_SCANS):
            pipe.step(next(stream)[0])
            if k + 1 in CUTS:
                path = d / f"ck_{k + 1}.npz"
                pipe.save_checkpoint(str(path))
                saved[k + 1] = (path, stream.state)
        resumed = {cut: [_resume(path, cut, state) for _ in range(2)]
                   for cut, (path, state) in saved.items()}
    finally:
        torch.set_num_threads(threads)
    return {"straight": straight, "saved": saved, "resumed": resumed,
            "kw": kw}


@pytest.mark.parametrize("cut", CUTS)
def test_resumed_run_matches_straight(runs, cut):
    line0, pipe0, gt0 = runs["straight"]
    (p1, gt1), (p2, gt2) = runs["resumed"][cut]
    np.testing.assert_array_equal(gt1, gt0[cut:])
    np.testing.assert_array_equal(gt2, gt0[cut:])
    st = p1.stats
    got = {"n_scans": len(p1.trajectory), "n_keyframes": len(p1.kf_points),
           "loop_closures": st.loop_closures, "lc_checked": st.lc_checked,
           "ba_runs": st.ba_runs}
    assert got == {k: line0[k] for k in got}, (got, line0)
    gap = _rms(p1.trajectory, pipe0.trajectory)
    print(f"cut at {cut}, resumed against straight: {1e3 * gap:.4f} mm RMS")
    assert gap <= RESUME_GAP_M, gap
    np.testing.assert_array_equal(np.stack(p1.trajectory),
                                  np.stack(p2.trajectory))
    assert torch.equal(p1.log_odds, p2.log_odds)


@pytest.mark.parametrize("cut", CUTS)
def test_icp_tpu_loads_checkpoint(runs, cut):
    """The checkpoint keeps icp_tpu's keys: icp_tpu's pipeline, built with
    the same keywords, loads it and holds the same poses and keyframes."""
    from icp_tpu.parallel.mesh import make_mesh
    from icp_tpu.parallel.scaled import ScaledPipeline

    j = ScaledPipeline(make_mesh(1), **runs["kw"])
    ck = runs["saved"][cut][0]
    j.load_checkpoint(str(ck))
    d = np.load(ck)
    assert j.stats.scans == cut and len(j.trajectory) == cut
    np.testing.assert_array_equal(np.stack(j.trajectory), d["poses"])
    assert [len(p) for p in j.kf_points] == list(d["kf_lens"])
    np.testing.assert_array_equal(np.concatenate(j.kf_points), d["kf_flat"])


def test_line_reports_stream_ms(runs):
    """The stream's own host time a timed scan, beside the clock it sits
    in."""
    line = runs["straight"][0]
    ms = line["stream_ms_per_scan"]
    assert np.isfinite(ms) and 0 < ms
    assert ms * (N_SCANS - scaled.WARM) <= 1000 * line["timed_wall_s"]
