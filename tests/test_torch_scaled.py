"""The scaled pipeline (BASELINE config #5) of icp_tpu_torch against icp_tpu
(JAX on the CPU, one device): the whole 40-scan run, loop-closure
verification, checkpoints carried across the packages, the incremental map
replay and ``cli --scaled``.

The run is tests/test_scaled_pipeline.py's: 1536 points a scan, 40 scans
of ``large_scan_stream`` in a 10 m arena (seed 1), registration by
icp_large on a 32 x 32 grid, loop closure every 2 scans. Each package runs
it once per module (and saves a checkpoint on the way); every
test reads those runs. Tolerances:
* positions within 2 mm over all 40 scans. The keyframe voxel means are
  icp_tpu's deviation-from-centre form, summed in order (icp_tpu differences
  cumulative sums), so the packages still round apart by an ulp now and
  then; the pipeline carries that on (icp_tpu's own resume test measured
  ~1 mm over 20 scans from a 1-ulp change). On this run the gap grows
  ~10 um a scan to 0.37 mm before the first bundle adjustment and peaks
  at 1.14 mm after it (6.0 mm with raw-coordinate means, whose bound
  was 1 cm);
* loop closures, closure checks, BA runs and gate fallbacks equal;
  ``reg_dropped_points`` within 0.1 % (equal on this run; 9,127 against
  9,133 with raw-coordinate means, whose bound was 1 %);
* maps: log-odds of ``map_probability()`` within 1e-3 except at cells that
  a boundary hit moved (ROADMAP Queue 3), at most 1 % of the painted cells
  (19 of 4,870 on this run; 154 with raw-coordinate means, whose bound
  was 5 %);
* checkpoints: a run resumed from the other package's checkpoint (at scan
  20 from icp_tpu's, at scan 30 from the port's) ends within 0.05 m ATE
  of both uninterrupted runs.

The `gpu`-marked tests hold both kernels at the loop-closure shapes of the
full-width run (8192-point keyframes) against their plain versions, row
chunk by row chunk, and icp_large on the card against the CPU
(``python -m pytest --noconftest -m gpu tests/test_torch_scaled.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from icp_tpu_torch.parallel.scaled import ScaledPipeline as TPipe  # noqa: E402
from icp_tpu_torch.utils.masking import pad_points  # noqa: E402
from icp_tpu_torch.utils.synth import (large_scan_stream,  # noqa: E402
                                       make_dense_world)

N_SCANS = 40
N_POINTS = 1536
# checkpoint scans: icp_tpu's at 20 (the port resumes 20 scans), the
# port's at 30 (icp_tpu resumes 10 scans, both closures included: its
# scans cost ~1.5 s each on the CPU)
CUT = {"jax": 20, "torch": 30}
KW = dict(scan_capacity=N_POINTS, extent=10.0, map_resolution=0.25,
          map_margin=4.0, max_range=9.0,
          icp_max_corr=1.5, icp_max_iterations=25,
          icp_grid_shape=(32, 32), icp_cell_cap=64, icp_qcells=1024,
          kf_capacity=1024, kf_voxel=0.2,
          lc_every=2, lc_min_interval=16, lc_distance=3.0,
          lc_min_travel=8.0, lc_error_threshold=0.08,
          dist_node_threshold=2)


def _jax_pipe():
    from icp_tpu.parallel.mesh import make_mesh
    from icp_tpu.parallel.scaled import ScaledPipeline
    return ScaledPipeline(make_mesh(1), **KW)


def _torch_pipe():
    return TPipe("cpu", **KW)


@pytest.fixture(scope="module")
def scans():
    rng = np.random.default_rng(0)
    world = make_dense_world(rng, n_points=120_000, extent=10.0, n_walls=60)
    out = list(large_scan_stream(N_SCANS, n_points=N_POINTS, extent=10.0,
                                 max_range=9.0, noise=0.01, seed=1,
                                 world_points=world))
    return [s for s, _ in out], np.stack([g for _, g in out])


def _rel(gt):
    """Ground truth relative to its first pose (the pipeline's frame)."""
    x0, y0, th0 = gt[0]
    c, s = np.cos(-th0), np.sin(-th0)
    return (gt[:, :2] - [x0, y0]) @ np.array([[c, -s], [s, c]]).T


def _ate(traj, ref_xy):
    est = np.stack([m[:2, 2] for m in traj])
    assert len(est) == len(ref_xy)
    return float(np.sqrt(np.mean(np.sum((est - ref_xy) ** 2, axis=1))))


def _xy(traj):
    return np.stack([m[:2, 2] for m in traj])


def _run(pipe, pts, ck, cut):
    for k, p in enumerate(pts):
        pipe.step(p)
        if k + 1 == cut:
            pipe.save_checkpoint(ck)
    pipe.finish()
    stats = dict(pipe.stats.__dict__)
    prob = pipe.map_probability()
    return dict(traj=[m.copy() for m in pipe.trajectory], stats=stats,
                prob=prob, ck=ck, pipe=pipe)


@pytest.fixture(scope="module")
def runs(scans, tmp_path_factory):
    pts, _ = scans
    d = tmp_path_factory.mktemp("scaled")
    return {"jax": _run(_jax_pipe(), pts, str(d / "jax_ck.npz"), CUT["jax"]),
            "torch": _run(_torch_pipe(), pts, str(d / "torch_ck.npz"),
                          CUT["torch"])}


def _logit(p):
    return np.log(p / (1.0 - p))


def test_scaled_pipeline_matches_icp_tpu(runs, scans):
    _, gt = scans
    j, t = runs["jax"], runs["torch"]
    assert len(t["traj"]) == len(j["traj"]) == N_SCANS
    gap = np.abs(_xy(t["traj"]) - _xy(j["traj"])).max()
    assert gap < 2e-3, f"positions differ by {gap:.4g} m"
    for k in ("scans", "loop_closures", "lc_checked", "lc_candidates",
              "ba_runs", "gate_fallbacks"):
        assert t["stats"][k] == j["stats"][k], (k, t["stats"][k], j["stats"][k])
    assert t["stats"]["loop_closures"] >= 1 and t["stats"]["ba_runs"] >= 1
    dj, dt = j["stats"]["reg_dropped_points"], t["stats"]["reg_dropped_points"]
    assert dj > 0 and abs(dt - dj) <= 0.001 * dj, (dt, dj)
    # both trajectories are as accurate as test_scaled_pipeline.py asks
    for r in (j, t):
        assert _ate(r["traj"], _rel(gt)) < 0.5

    pj, pt = j["prob"], t["prob"]
    assert pt.shape == pj.shape
    lj, lt = _logit(pj), _logit(pt)
    painted = int((np.abs(lj) > 1e-6).sum())
    moved = int((np.abs(lt - lj) > 1e-3).sum())
    assert painted > 2000
    assert moved <= 0.01 * painted, (moved, painted)
    assert (pt > 0.6).sum() > 200 and (pt < 0.4).sum() > 2000
    assert np.isfinite(pt).all()


def test_scaled_grid_shape_and_pipeline_state(runs):
    p = runs["torch"]["pipe"]
    # ceil(2 (extent + margin) / resolution) = 112 columns; rows rounded
    # up to a multiple of 64, as icp_tpu allocates them
    assert (p.ny, p.nx) == (128, 112)
    assert not p._map_dirty                   # map_probability replayed it
    assert p.stats.replayed_keyframes > 0 and p.stats.wall_replay > 0


def _kf_cloud(world, rng, pos, pipe_fn, rmax=9.0):
    d2 = np.sum((world - pos) ** 2, axis=1)
    pts = world[d2 < rmax * rmax]
    pick = pts[rng.integers(0, len(pts), 6000)]
    raw = (pick - pos + rng.normal(scale=0.02, size=(6000, 2))
           ).astype(np.float32)
    return pipe_fn(*pad_points(raw, 8192))


def test_lc_verify_matches_icp_tpu():
    """tests/test_scaled_pipeline.py's partial-overlap and junk cases:
    the port's per-candidate ``_lc_verify`` against icp_tpu's vmapped
    ``_lc_verify_batch`` (one lane) on the same keyframes. R within 1e-4,
    t within 1e-3 m, inlier error within 1e-5 and fraction within 1e-3;
    the known transform recovered and the junk rejected in both."""
    import jax.numpy as jnp

    jp, tp = _jax_pipe(), _torch_pipe()
    rng = np.random.default_rng(0)
    world = make_dense_world(rng, n_points=120_000, extent=10.0, n_walls=16)

    def kf(p, m):
        return tp._downsample_kf(torch.tensor(p), torch.tensor(m))

    a = _kf_cloud(world, rng, np.array([2.0, 0.0]), kf)
    b = _kf_cloud(world, rng, np.array([-2.0, 0.0]), kf)
    junk = (rng.uniform(-1, 1, (1000, 2)) + 50.0).astype(np.float32)
    ap, am = pad_points(a, tp.kf_cap)
    for cloud, good in ((b, True), (junk, False)):
        bp, bm = pad_points(cloud, tp.kf_cap)
        jr, jerr, jfrac = jp._lc_verify_batch(
            jnp.asarray(ap), jnp.asarray(am), jnp.asarray(bp)[None],
            jnp.asarray(bm)[None])
        tr, terr, tfrac = tp._lc_verify(*(torch.tensor(x)
                                          for x in (ap, am, bp, bm)))
        np.testing.assert_allclose(tr.R.numpy(), np.asarray(jr.R)[0],
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(tr.t.numpy(), np.asarray(jr.t)[0],
                                   atol=1e-3, rtol=0)
        np.testing.assert_allclose(float(terr), float(jerr[0]), atol=1e-5)
        np.testing.assert_allclose(float(tfrac), float(jfrac[0]), atol=1e-3)
        if good:
            assert float(tfrac) > 0.5
            assert float(terr) < tp.lc_error_threshold
            np.testing.assert_allclose(tr.t.numpy(), [4.0, 0.0], atol=0.2)
            th = float(torch.atan2(tr.R[1, 0], tr.R[0, 0]))
            assert abs(th) < np.deg2rad(2.0)
        else:
            assert float(tfrac) < 0.5
            assert np.isfinite(float(terr))


def _resume(pipe, ck, pts, cut):
    pipe.load_checkpoint(ck)
    assert pipe.stats.scans == cut and len(pipe.kf_points) == cut
    for p in pts[cut:]:
        pipe.step(p)
    pipe.finish()
    return pipe


def test_port_resumes_icp_tpu_checkpoint(runs, scans):
    pts, _ = scans
    t = _resume(_torch_pipe(), runs["jax"]["ck"], pts, CUT["jax"])
    assert t.stats.scans == N_SCANS
    for r in runs.values():
        assert _ate(t.trajectory, _xy(r["traj"])) < 0.05
    assert t.stats.loop_closures == runs["torch"]["stats"]["loop_closures"]


def test_icp_tpu_resumes_port_checkpoint(runs, scans):
    pts, _ = scans
    j = _resume(_jax_pipe(), runs["torch"]["ck"], pts, CUT["torch"])
    assert j.stats.scans == N_SCANS
    for r in runs.values():
        assert _ate(j.trajectory, _xy(r["traj"])) < 0.05
    assert j.stats.loop_closures == runs["jax"]["stats"]["loop_closures"]


def test_incremental_replay_matches_full(scans):
    """sync_map's un-paint / repaint of the keyframes that moved against a
    full replay of the same state (test_scaled_pipeline.py:284-321's
    tolerances: clamped maps within 5e-3, unclamped within 1e-4
    relative)."""
    pts, _ = scans
    pipe = _torch_pipe()
    for p in pts[:14]:
        pipe.step(p)
    pipe.finish()
    pipe.sync_map()
    rng = np.random.default_rng(5)
    for k in (2, 5, 9):
        pipe.trajectory[k] = pipe.trajectory[k].copy()
        pipe.trajectory[k][:2, 2] += rng.uniform(-0.6, 0.6, 2).astype(
            np.float32)
    pipe._map_dirty = True
    pipe.sync_map()                        # incremental: 3 of 14 moved
    assert 0 < pipe.stats.replayed_keyframes <= 6
    inc = pipe.log_odds.numpy().copy()
    pipe._painted_T = []                   # force the full rebuild
    pipe._map_dirty = True
    pipe.sync_map()
    full = pipe.log_odds.numpy()
    lo, hi = pipe.lo_min, pipe.lo_max
    np.testing.assert_allclose(np.clip(inc, lo, hi), np.clip(full, lo, hi),
                               atol=5e-3)
    rel = np.abs(inc - full) / np.maximum(np.abs(full), 1.0)
    assert float(rel.max()) < 1e-4, float(rel.max())
    assert (np.abs(full) > 0.1).sum() > 100


def test_full_replay_keeps_steps_in_flight(scans):
    """A full replay while steps are still in flight (painted, not yet
    bookkept) repaints them too: the map equals a full replay of the
    drained state."""
    pts, _ = scans
    pipe = _torch_pipe()
    pipe._pending_done = lambda: False     # keep the steps in flight
    for p in pts[:10]:
        pipe.step(p)
    pipe.finish()
    for p in pts[10:14]:
        pipe.step(p)
    assert len(pipe._pending) == 4
    pipe._painted_T = []                   # every keyframe moved: full
    pipe._map_dirty = True
    pipe.sync_map()
    assert not pipe._pending and pipe.stats.replayed_keyframes == 14
    got = pipe.log_odds.numpy().copy()
    pipe._painted_T = []
    pipe._map_dirty = True
    pipe.sync_map()
    np.testing.assert_array_equal(got, pipe.log_odds.numpy())


def test_step_is_bookkept_one_call_later(scans):
    """Each step drains the steps before it once the device has finished
    them: after call k returns, the record holds steps 0..k-1."""
    pts, _ = scans
    pipe = _torch_pipe()
    for k, p in enumerate(pts[:6]):
        pipe.step(p)
        assert len(pipe.trajectory) == len(pipe.kf_points) == k
        assert pipe.stats.scans == pipe.pose_graph.n_nodes == k
        assert len(pipe._pending) == 1
    pipe.finish()
    assert len(pipe.trajectory) == 6 and not pipe._pending


def _watched_run(device, pts, never_ready: bool):
    """The module's run with a closure check every 3 scans and a map read
    after every step (the drains then leave different steps in flight at
    each read), each drained step's gate flag noted through the bound
    ``_drain`` as the benchmark's drivers note it. ``never_ready`` bookkeeps
    only at the waiting drains: every 64 steps and before each check."""
    pipe = TPipe(device, **dict(KW, lc_every=3))
    if never_ready:
        pipe._pending_done = lambda: False
    drain, gate_ok = pipe._drain, []

    def drain_noted():
        pending = list(pipe._pending)
        drain()
        gate_ok.extend(bool(out[4]) for out in pending)

    pipe._drain = drain_noted
    for p in pts:
        pipe.step(p)
        pipe.sync_map()
    pipe.finish()
    pipe.sync_map()
    return pipe, gate_ok


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_ready_drains_change_no_result(scans, device):
    """Bookkeeping a step as soon as the device has finished it, rather
    than at the next waiting drain, changes no result: through closure
    checks, BAs and map reads, the trajectory, keyframes, graph, stats,
    ATE and map are bit-equal, and every step passes through ``_drain``."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m gpu)")
    pts, gt = scans
    ready, ok_r = _watched_run(device, pts, never_ready=False)
    late, ok_l = _watched_run(device, pts, never_ready=True)
    assert ready.stats.ba_runs >= 2 and ready.stats.replayed_keyframes > 0
    assert ok_r == ok_l and len(ok_r) == len(pts)
    for a, b in ((ready.trajectory, late.trajectory),
                 (ready.kf_points, late.kf_points),
                 (ready.pose_graph.nodes, late.pose_graph.nodes),
                 (ready.pose_graph._edges_z, late.pose_graph._edges_z),
                 (ready.pose_graph._edges_om, late.pose_graph._edges_om)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for name in ("_edges_i", "_edges_j", "_edges_rb"):
        assert getattr(ready.pose_graph, name) == getattr(late.pose_graph,
                                                          name)
    counts = {k: v for k, v in ready.stats.__dict__.items()
              if not k.startswith("wall") and k != "partition_wall"}
    assert counts == {k: late.stats.__dict__[k] for k in counts}
    ref = _rel(gt)
    assert _ate(ready.trajectory, ref) == _ate(late.trajectory, ref)
    np.testing.assert_array_equal(ready.log_odds.cpu().numpy(),
                                  late.log_odds.cpu().numpy())


def test_scaled_cli_mode_cpu(tmp_path):
    """``python -m icp_tpu_torch.cli --scaled --device cpu`` on
    test_scaled_pipeline.py:242-281's config: the map written, 30 poses,
    and icp_tpu's grid shape (rows rounded up to a multiple of 64)."""
    import yaml
    from icp_tpu_torch.cli import main as cli_main
    from icp_tpu_torch.utils.synth import generate_sequence

    lidar = str(tmp_path / "lidar.csv")
    generate_sequence(lidar, str(tmp_path / "imu.csv"), n_scans=30,
                      n_beams=360, noise=0.005, trajectory="loop", seed=7)
    cfg = {
        "data_file": lidar,
        "imu": {"enabled": False},
        "icp": {"method": "point_to_line"},
        "submap": {"enabled": False},
        "loop_closure": {"enabled": True, "min_interval": 16,
                         "distance_threshold": 3.0,
                         "min_cumulative_travel": 8.0,
                         "error_threshold": 0.08},
        "filter": {"z_min": 0.0, "z_max": 3.0},
        "mapping": {"resolution": 0.25, "margin": 4.0},
        "display": {"live_map": False},
        "output": {"csv": str(tmp_path / "map.csv"),
                   "npy": str(tmp_path / "map.npy")},
        "scaled": {"extent": 14.0, "icp_grid_shape": [32, 32],
                   "icp_max_corr": 1.5, "icp_qcells": 1024,
                   "kf_capacity": 1024, "kf_voxel": 0.2, "lc_every": 2},
    }
    cfg_path = str(tmp_path / "cfg.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    traj_path = str(tmp_path / "traj.npy")
    ck = str(tmp_path / "ck.npz")
    cli_main(["--config", cfg_path, "--scaled", "--quiet", "--device", "cpu",
              "--save-traj", traj_path, "--checkpoint", ck])
    prob = np.load(str(tmp_path / "map.npy"))
    n_cells = int(np.ceil((2 * (14.0 + 4.0)) / 0.25))        # 144
    assert prob.shape == (-(-n_cells // 64) * 64, n_cells) == (192, 144)
    assert np.isfinite(prob).all() and (prob > 0.6).sum() > 50
    traj = np.load(traj_path)
    assert traj.shape == (30, 3, 3)
    assert int(np.load(ck)["stats"][0]) == 30


def test_default_device_is_cuda(tmp_path):
    """Without --device (or device=) the pipeline runs on cuda, and raises
    where there is no card rather than falling back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TPipe(**KW)
    import yaml
    from icp_tpu_torch.cli import main as cli_main
    cfg_path = str(tmp_path / "cfg.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({"data_file": str(tmp_path / "none.csv"),
                        "scaled": {"scan_capacity": 64, "max_range": 5.0}}, f)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(["--config", cfg_path, "--scaled", "--quiet"])


# ── on the card ──────────────────────────────────────────────────────────

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m gpu)")
    return torch.device("cuda:0")


def _chunked_equal(kern, plain, rows, tgt, msk, chunk=32768):
    """kern on all rows against plain on each row chunk, bit for bit (the
    plain (rows, M) matrix at once would not fit)."""
    got = kern(rows, tgt, msk)
    got = got if isinstance(got, tuple) else (got,)
    for c0 in range(0, rows.shape[0], chunk):
        want = plain(rows[c0:c0 + chunk], tgt, msk)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            assert torch.equal(g[c0:c0 + chunk], w), c0


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [983_040, 98_304])
def test_nn_min_cuda_at_lc_shapes_on_card(cuda_device, rows):
    """nn_min_cuda at the full-width run's loop-closure sweeps (120 coarse
    and 12 fine angles x 8192 keyframe slots, against 8192 targets), bit
    for bit against nn_min_plain in row chunks."""
    from icp_tpu_torch.ops.hopper import nn_kernel as K

    g = torch.Generator().manual_seed(rows)
    r = (torch.rand(rows, 2, generator=g) * 70 - 35).to(cuda_device)
    t = (torch.rand(8192, 2, generator=g) * 70 - 35).to(cuda_device)
    m = (torch.rand(8192, generator=g) < 0.8).to(cuda_device)
    _chunked_equal(K.nn_min_cuda, K.nn_min_plain, r, t, m)


@pytest.mark.gpu
def test_nn_cuda_at_8192_on_card(cuda_device):
    """nn_cuda at 8192 x 8192 (both ICP passes of a loop-closure lane),
    with duplicated targets for ties, against nn_plain in row chunks."""
    from icp_tpu_torch.ops.hopper import nn_kernel as K

    g = torch.Generator().manual_seed(5)
    t = torch.rand(8192, 2, generator=g) * 70 - 35
    t[4096:6000] = t[:1904]
    s = t + torch.randn(8192, 2, generator=g) * 0.05
    m = torch.rand(8192, generator=g) < 0.8
    _chunked_equal(K.nn_cuda, K.nn_plain, *(x.to(cuda_device)
                                            for x in (s, t, m)), chunk=2048)


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["point_to_point", "point_to_line"])
def test_icp_large_on_card_matches_cpu(cuda_device, method):
    """icp_large on the card against the same call on the CPU: R within
    1e-5, t within 1e-4 m, iterations and drops equal."""
    from icp_tpu_torch.models.icp import icp_large

    rng = np.random.default_rng(8)
    base = make_dense_world(rng, n_points=30_000, extent=40.0, n_walls=60)
    th = 0.04
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]],
                 np.float32)
    src = ((base - np.float32([0.4, -0.25])) @ R).astype(np.float32)
    sp, sm = pad_points(src, 32768)
    tp_, tm = pad_points(base, 32768)
    kw = dict(max_corr_dist=1.0, max_iterations=30, error_threshold=1e-7,
              grid_shape=(64, 64), cap=64, qcap=64, qcells=2048,
              method=method)
    out = {}
    for dev in ("cpu", cuda_device):
        args = [torch.tensor(a).to(dev) for a in (sp, sm, tp_, tm)]
        out[str(dev)] = icp_large(*args, torch.eye(2, device=dev),
                                  torch.zeros(2, device=dev), **kw)
    c, g = out["cpu"], out[str(cuda_device)]
    np.testing.assert_allclose(g.R.cpu().numpy(), c.R.numpy(), atol=1e-5)
    np.testing.assert_allclose(g.t.cpu().numpy(), c.t.numpy(), atol=1e-4)
    assert int(g.iters) == int(c.iters) and int(g.dropped) == int(c.dropped)
