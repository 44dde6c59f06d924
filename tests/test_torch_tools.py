"""The leaves of icp_tpu_torch against icp_tpu's: the PNG writer and the
canvas, the occupancy grid's display map and PNG, the live map (window
plumbing under Agg, headless snapshots), the CLI's ``--map-png`` and
``--profile``, the tools (pcview, pcman, pcplayer, ab_ate, entry), the
teapot demo, and the device defaults of the classes users construct.

Tolerances: PNG bytes equal for equal arrays; ``to_display`` within 1e-6
(numpy on the same log-odds; the grids themselves agree within 1e-5);
``entry()``'s step within 1e-4 of icp_tpu's in R and t. The `gpu`-marked
test holds the 3-D ICP on the card to the CPU
(``python -m pytest --noconftest -m gpu tests/test_torch_tools.py``).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from icp_tpu_torch.engine import SlamEngine, run_slam  # noqa: E402
from icp_tpu_torch.models.icp import icp, identity_init  # noqa: E402
from icp_tpu_torch.models.occupancy import OccupancyGrid2D  # noqa: E402
from icp_tpu_torch.models.pose_graph import PoseGraph2D  # noqa: E402
from icp_tpu_torch.utils import raster  # noqa: E402
from icp_tpu_torch.utils.config import SlamConfig  # noqa: E402
from icp_tpu_torch.utils.synth import generate_sequence  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd=REPO, timeout=300):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return subprocess.run([sys.executable] + args, capture_output=True,
                          text=True, cwd=cwd, env=env, timeout=timeout)


def _write_cloud_csv(path, pts):
    with open(path, "w") as f:
        f.write(",".join(f"{v:.5f}" for v in np.asarray(pts).reshape(-1)))


def _write_lidar_csv(path, scans):
    with open(path, "w") as f:
        for k, pts in enumerate(scans):
            row = ";".join(f"{v:.4f}" for v in np.asarray(pts).reshape(-1))
            f.write(f"{1000 + k};{row}\n")


def _ring_scans(n, seed=0):
    rng = np.random.default_rng(seed)
    ang = np.linspace(0, 2 * np.pi, 180, endpoint=False)
    out = []
    for _ in range(n):
        pts = np.stack([4 * np.cos(ang), 4 * np.sin(ang)], 1)
        pts += rng.normal(scale=0.005, size=pts.shape)
        out.append(pts.astype(np.float32))
    return out


# ── device defaults ──────────────────────────────────────────────────────
def test_grid_and_graph_default_to_the_card():
    """OccupancyGrid2D and PoseGraph2D run on cuda unless the caller asks
    for the CPU: without a card they raise and name device='cpu'."""
    if torch.cuda.is_available():
        assert OccupancyGrid2D(-1, 1, -1, 1).log_odds.is_cuda
        assert PoseGraph2D().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OccupancyGrid2D(-1, 1, -1, 1, 0.1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PoseGraph2D()
    assert PoseGraph2D("cpu").device.type == "cpu"


def test_grid_accepts_free_cells_cap():
    g = OccupancyGrid2D(-5, 5, -5, 5, 0.1, free_cells_cap=4096, device="cpu")
    assert g.free_cells_cap == 4096
    assert OccupancyGrid2D(-5, 5, -5, 5, device="cpu").free_cells_cap is None


# ── PNG writer, canvas, display map ──────────────────────────────────────
def test_write_png_and_canvas_bytes_equal_icp_tpu(tmp_path):
    from icp_tpu.utils import raster as j_raster

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    gray = rng.integers(0, 256, (20, 31)).astype(np.uint8)
    for name, arr in (("rgb", img), ("gray", gray)):
        a, b = str(tmp_path / f"{name}_t.png"), str(tmp_path / f"{name}_j.png")
        raster.write_png(a, arr)
        j_raster.write_png(b, arr)
        data = open(a, "rb").read()
        assert data[:8] == b"\x89PNG\r\n\x1a\n"
        assert data == open(b, "rb").read()
    assert raster.COLORS == j_raster.COLORS
    pts = rng.uniform(-1, 1, (40, 2))
    field = rng.random((12, 16))
    paths = []
    for mod, tag in ((raster, "t"), (j_raster, "j")):
        c = mod.Canvas.for_points(pts, width=96, background="gray")
        c.image(field, (-0.5, -0.5), 0.05)
        c.scatter(pts, "red", 3).polyline(pts[:6], "cyan")
        paths.append(c.save(str(tmp_path / f"canvas_{tag}.png")))
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()


def test_to_display_and_save_png_match_icp_tpu(tmp_path):
    from icp_tpu.models.occupancy import OccupancyGrid2D as JGrid

    rng = np.random.default_rng(9)
    kw = dict(resolution=0.1, p_hit=0.85, p_miss=0.42, max_ray_cells=128)
    gt = OccupancyGrid2D(-5, 5, -4, 4.5, device="cpu", **kw)
    gj = JGrid(-5, 5, -4, 4.5, **kw)
    for _ in range(3):
        origin = rng.uniform(-1, 1, 2).astype(np.float32)
        hits = rng.uniform(-4, 4, (150, 2)).astype(np.float32)
        gt.update_scan(origin, hits)
        gj.update_scan(origin, hits)
    dt, dj = gt.to_display(), gj.to_display()
    assert dt.shape == (gt.ny, gt.nx) and dt.dtype == dj.dtype
    np.testing.assert_allclose(dt, dj, atol=1e-6)
    assert (dt == 1.0).any() and (dt == 0.85).any() and (dt < 0.5).any()
    # equal log-odds -> equal bytes, trajectory overlay included
    gt.log_odds = torch.as_tensor(np.array(gj.log_odds))
    traj = np.array([[0.0, 0.0], [0.5, 0.1], [1.0, 0.3], [9.0, -9.0]])
    for t, tag in ((None, "plain"), (traj, "traj")):
        a, b = str(tmp_path / f"{tag}_t.png"), str(tmp_path / f"{tag}_j.png")
        assert gt.save_png(a, trajectory=t) is True
        gj.save_png(b, trajectory=t)
        assert open(a, "rb").read() == open(b, "rb").read()


# ── live map ─────────────────────────────────────────────────────────────
def _snapshot_cfg(tmp_path, fused):
    return SlamConfig.from_dict({
        "icp": {"method": "point_to_point", "voxel_size": 0.1,
                "max_iterations": 20},
        "features": {"method": "none"},
        "submap": {"enabled": False},
        "loop_closure": {"enabled": False},
        "mapping": {"resolution": 0.1, "margin": 5.0},
        "display": {"live_map": True, "snapshot_every": 2,
                    "snapshot_dir": str(tmp_path / "live")},
        "tpu": {"scan_capacity": 256, "batch_scans": 1, "fused": fused},
    })


@pytest.mark.parametrize("fused", [False, True], ids=["modular", "fused"])
def test_engine_snapshot_fallback(tmp_path, monkeypatch, fused):
    """Headless live_map=true writes PNG snapshots via maybe_snapshot, of
    the grid's size, every snapshot_every scans, on both engine paths."""
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    engine = SlamEngine(_snapshot_cfg(tmp_path, fused), verbose=False,
                        device="cpu")
    written = []
    for k, pts in enumerate(_ring_scans(5)):
        engine.process_scan(pts, rel_time_us=k * 1000)
        written.append(engine.maybe_snapshot())
    assert (engine._state is not None) == fused
    snaps = sorted(p.name for p in (tmp_path / "live").glob("*.png"))
    assert snaps == ["map_00002.png", "map_00004.png"]
    assert [w is not None for w in written] == [False, False, True, False, True]
    data = open(written[-1], "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = int.from_bytes(data[16:20], "big"), int.from_bytes(data[20:24], "big")
    assert (w, h) == (engine.mapper.nx, engine.mapper.ny)
    # off by default: nothing is pulled or written
    off = _snapshot_cfg(tmp_path / "off", fused)
    off.live_map = False
    eng2 = SlamEngine(off, verbose=False, device="cpu")
    eng2.process_scan(_ring_scans(1)[0], rel_time_us=0)
    assert eng2.maybe_snapshot() is None and not (tmp_path / "off").exists()


def test_live_map_view_headless():
    """LiveMapView renders under the Agg backend (window plumbing without a
    display): image, trajectory and pose artists update, zoom keys
    rescale, and the window names the port."""
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg", force=True)
    from icp_tpu_torch.utils.liveview import LiveMapView

    mapper = OccupancyGrid2D(-5, 5, -5, 5, 0.1, device="cpu")
    ang = np.linspace(0, 2 * np.pi, 90, endpoint=False)
    hits = np.stack([3 * np.cos(ang), 3 * np.sin(ang)], 1).astype(np.float32)
    mapper.update_scan(np.zeros(2, np.float32), hits)

    view = LiveMapView(mapper, window_width=400, window_height=300,
                       background="white", trajectory_color="red")
    traj = np.array([[0.0, 0.0], [0.5, 0.1], [1.0, 0.3]])
    view.update(traj)
    assert view.img.get_array().shape == (mapper.ny, mapper.nx)
    np.testing.assert_allclose(view.img.get_array(), mapper.to_probability())
    np.testing.assert_allclose(view.traj_line.get_xdata(), traj[:, 0])
    x0 = view.ax.get_xlim()

    class _Ev:
        key = "+"
    view._on_key(_Ev())
    x1 = view.ax.get_xlim()
    assert (x1[1] - x1[0]) < (x0[1] - x0[0])      # zoomed in
    view.close()


def test_live_map_view_unavailable_without_display(monkeypatch):
    from icp_tpu_torch.utils.liveview import LiveMapView

    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    if os.name != "nt" and os.uname().sysname != "Darwin":
        assert LiveMapView.available() is False
    monkeypatch.setitem(sys.modules, "matplotlib", None)   # not installed
    monkeypatch.setenv("DISPLAY", ":0")
    assert LiveMapView.available() is False


# ── CLI: --map-png, --profile, the live map through run_slam ─────────────
def _small_yaml(tmp_path, extra=""):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(
        f'data_file: "{tmp_path / "lidar.csv"}"\n'
        f'imu: {{enabled: true, file: "{tmp_path / "imu.csv"}"}}\n'
        "icp: {voxel_size: 0.08, max_iterations: 12, error_reject_threshold: 5.0}\n"
        "submap: {enabled: true, size: 4, voxel_size: 0.08, rotation_voxel_size: 0.3}\n"
        "loop_closure: {enabled: false}\n"
        "filter: {z_min: 0.0, z_max: 3.0}\n"
        "mapping: {resolution: 0.2, margin: 5.0}\n"
        "service: {loop: false}\n"
        f'output: {{csv: "{tmp_path / "map.csv"}", npy: "{tmp_path / "map.npy"}"}}\n'
        "tpu: {scan_capacity: 128, submap_capacity: 512, max_ray_cells: 128, "
        "batch_scans: 4}\n" + extra)
    return cfg


def test_cli_map_png_and_profile(tmp_path, capsys):
    """--map-png and --profile with --device cpu on 12 synthetic scans,
    with the live map on: the PNG has the grid's size, a Chrome trace lands
    in the directory, snapshots are written headless, the CSV went through
    the native parser, and nothing says 'not ported'."""
    from icp_tpu_torch.cli import main

    live = tmp_path / "live"
    cfg = _small_yaml(tmp_path, "display: {live_map: true, snapshot_every: 4, "
                                f'snapshot_dir: "{live}"}}\n')
    png, prof = tmp_path / "map.png", tmp_path / "prof"
    main(["--config", str(cfg), "--synth", "--synth-scans", "12",
          "--synth-beams", "120", "--device", "cpu", "--quiet",
          "--map-png", str(png), "--profile", str(prof),
          "--save-traj", str(tmp_path / "traj.npy")])
    out = capsys.readouterr().out
    assert "not ported" not in out
    assert f"map render: {png}" in out
    assert "profiler trace written to" in out
    assert "lidar parser: native" in out
    grid = np.load(tmp_path / "map.npy")
    data = open(png, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert (int.from_bytes(data[16:20], "big"),
            int.from_bytes(data[20:24], "big")) == grid.shape[::-1]
    traces = list(prof.glob("*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 1000
    assert '"traceEvents"' in traces[0].read_text()[:4096]
    traj = np.load(tmp_path / "traj.npy")       # fast loop: some rejected
    assert traj.shape[1:] == (3, 3) and 3 <= len(traj) <= 11
    assert "scans=11 " in out
    assert sorted(p.name for p in live.glob("*.png")) == [
        "map_00004.png", "map_00008.png"]


def test_run_slam_live_map_snapshots(tmp_path, capsys, monkeypatch):
    """run_slam with display.live_map: true writes snapshots headless as it
    streams, records the parser, and prints no warning."""
    monkeypatch.delenv("DISPLAY", raising=False)
    lidar, imu = str(tmp_path / "lidar.csv"), str(tmp_path / "imu.csv")
    generate_sequence(lidar, imu, n_scans=9, n_beams=120, noise=0.005,
                      trajectory="straight", seed=5)
    cfg = SlamConfig.from_dict({
        "data_file": lidar, "imu": {"enabled": True, "file": imu},
        "icp": {"voxel_size": 0.08, "max_iterations": 12,
                "error_reject_threshold": 5.0},
        "submap": {"enabled": True, "size": 4, "voxel_size": 0.08,
                   "rotation_voxel_size": 0.3},
        "loop_closure": {"enabled": False},
        "filter": {"z_min": 0.0, "z_max": 3.0},
        "mapping": {"resolution": 0.2, "margin": 5.0},
        "service": {"loop": False},
        "display": {"live_map": True, "snapshot_every": 3,
                    "snapshot_dir": str(tmp_path / "live")},
        "tpu": {"scan_capacity": 128, "submap_capacity": 512,
                "max_ray_cells": 128, "batch_scans": 4},
    })
    _, traj, mapper, engine = run_slam(cfg, verbose=False, device="cpu")
    assert capsys.readouterr().out == ""
    assert engine.lidar_parser == "native"
    assert 7 <= len(traj) <= 8 and mapper is not None
    # batches of 4: the count moves 4, 8; each passes a multiple of 3 once
    assert sorted(p.name for p in (tmp_path / "live").glob("*.png")) == [
        "map_00004.png", "map_00008.png"]


# ── tools and the demo, as a user runs them ──────────────────────────────
def test_pcview_tool(tmp_path, capsys):
    rng = np.random.default_rng(0)
    f = str(tmp_path / "cloud.csv")
    _write_cloud_csv(f, rng.uniform(-1, 1, (50, 3)))
    lidar = str(tmp_path / "scans.csv")
    _write_lidar_csv(lidar, [rng.uniform(-2, 2, (30, 3)) for _ in range(3)])
    out = str(tmp_path / "view.png")
    r = _run(["-m", "icp_tpu_torch.tools.pcview", f, lidar, "-o", out, "--png"])
    assert r.returncode == 0, r.stderr[-500:]
    assert "50 points" in r.stdout and "90 points" in r.stdout
    assert open(out, "rb").read()[:4] == b"\x89PNG"
    # trajectory mode
    poses = np.tile(np.eye(3, dtype=np.float32), (5, 1, 1))
    poses[:, 0, 2] = np.arange(5)
    np.save(tmp_path / "traj.npy", poses)
    from icp_tpu_torch.tools import pcview
    out2 = str(tmp_path / "traj.png")
    pcview.main([str(tmp_path / "traj.npy"), "--trajectory", "-o", out2])
    assert "5 poses" in capsys.readouterr().out and os.path.exists(out2)


def test_pcman_tool(tmp_path):
    from icp_tpu_torch.tools.pcview import load_cloud

    rng = np.random.default_rng(2)
    f = str(tmp_path / "cloud.csv")
    _write_cloud_csv(f, rng.uniform(-1, 1, (40, 3)))
    out = str(tmp_path / "tr.csv")
    r = _run(["-m", "icp_tpu_torch.tools.pcman", f, "-o", out, "--yaw", "30",
              "--tx", "0.5", "--png", str(tmp_path / "ba.png")])
    assert r.returncode == 0, r.stderr[-500:]
    orig, got = load_cloud(f), load_cloud(out)
    assert got.shape == orig.shape
    # the transform kept pairwise distances (rigid) and moved the cloud
    d0 = np.linalg.norm(orig[0] - orig[1])
    d1 = np.linalg.norm(got[0] - got[1])
    assert abs(d0 - d1) < 1e-4 and np.abs(got - orig).max() > 0.1
    assert os.path.getsize(tmp_path / "ba.png") > 100


def test_pcman_transform_matches_tools_pcman():
    sys.path.insert(0, REPO)
    from tools.pcman import transform_points as j_transform

    from icp_tpu_torch.tools.pcman import transform_points

    pts = np.random.default_rng(5).uniform(-2, 2, (30, 3))
    kw = dict(scale=1.5, yaw_deg=30.0, pitch_deg=-12.0,
              translate=(0.5, -1.0, 0.25))
    np.testing.assert_array_equal(transform_points(pts, **kw),
                                  j_transform(pts, **kw))


def _player_scans(seed, n, pts=30):
    rng = np.random.default_rng(seed)
    return [np.column_stack([rng.uniform(-2, 2, (pts, 2)), np.full(pts, 1.2)])
            for _ in range(n)]


def test_pcplayer_frames(tmp_path):
    f = str(tmp_path / "scans.csv")
    _write_lidar_csv(f, _player_scans(1, 6))
    outdir = str(tmp_path / "frames")
    r = _run(["-m", "icp_tpu_torch.tools.pcplayer", f, "--frames", "-o",
              outdir, "--every", "2"])
    assert r.returncode == 0, r.stderr[-500:]
    assert os.path.exists(os.path.join(outdir, "overlay.png"))
    assert sorted(x for x in os.listdir(outdir) if x.startswith("scan_")) == [
        "scan_00000.png", "scan_00002.png", "scan_00004.png"]
    # an empty file is an error
    from icp_tpu_torch.tools import pcplayer
    empty = tmp_path / "empty.csv"
    empty.write_text("")
    assert pcplayer.main([str(empty), "--frames"]) == 1


def test_pcplayer_gif_playback(tmp_path):
    """Animated playback, headless: a GIF via the pillow writer."""
    pytest.importorskip("matplotlib")
    pytest.importorskip("PIL")
    f = str(tmp_path / "scans.csv")
    _write_lidar_csv(f, _player_scans(3, 5))
    gif = str(tmp_path / "play.gif")
    r = _run(["-m", "icp_tpu_torch.tools.pcplayer", f, "--gif", gif,
              "--fps", "5"])
    assert r.returncode == 0, r.stderr[-500:]
    assert os.path.exists(gif) and os.path.getsize(gif) > 500


def test_pcplayer_stream_loader(tmp_path):
    """The background-thread loader yields every scan, in order."""
    from icp_tpu_torch.tools.pcplayer import LidarFrameStream

    f = str(tmp_path / "scans.csv")
    _write_lidar_csv(f, _player_scans(4, 12, pts=25))
    frames = LidarFrameStream(f, stride=1, prefetch=4).drain()
    assert [i for i, _ in frames] == list(range(12))
    assert all(fr.shape == (25, 2) for _, fr in frames)
    cut = LidarFrameStream(f, stride=5, max_scans=3).drain()
    assert [i for i, _ in cut] == [0, 1, 2]
    assert all(fr.shape == (5, 2) for _, fr in cut)


def test_teapot_demo_runs(tmp_path):
    out = str(tmp_path / "teapot.png")
    r = _run(["-m", "icp_tpu_torch.demos.teapot_icp_demo", "--device", "cpu",
              "-o", out])
    assert r.returncode == 0, r.stdout[-800:] + r.stderr[-500:]
    assert "teapot: 418 points" in r.stdout and "PASS" in r.stdout
    assert open(out, "rb").read()[:4] == b"\x89PNG"
    if not torch.cuda.is_available():       # the default device is the card
        from icp_tpu_torch.demos import teapot_icp_demo
        with pytest.raises(RuntimeError, match="--device cpu"):
            teapot_icp_demo.main(["-o", out])


def test_ab_ate_on_a_cut_sequence(tmp_path):
    """The A/B harness on the first 20 scans of the bench sequence, which
    it writes into data/ under the working directory first."""
    r = _run(["-m", "icp_tpu_torch.tools.ab_ate", "--device", "cpu",
              "--scans", "20", "sub_rot_fine=0.1"], cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-800:]
    assert (tmp_path / "data" / "bench_lidar.csv").exists()
    line = r.stdout.strip().splitlines()[-1]
    assert "overrides={'sub_rot_fine': '0.1'}" in line and "poses=19" in line
    ate = float(line.split("ATE=")[1].split()[0])
    assert 0.0 < ate < 0.05


def test_ab_ate_overrides_cast_to_the_fields_type():
    from icp_tpu_torch.tools.ab_ate import BENCH_CFG, apply_overrides

    cfg = SlamConfig.from_dict(BENCH_CFG)
    apply_overrides(cfg, ["sub_rot_fine=0.1", "submap_size=20",
                          "lc_enabled=true", "icp_method=point_to_point"])
    assert cfg.sub_rot_fine == 0.1 and cfg.submap_size == 20
    assert cfg.lc_enabled is True and cfg.icp_method == "point_to_point"


def test_entry_matches_graft_entry():
    """entry()'s registration step on its example scene against
    __graft_entry__.entry()'s: the same inputs, R and t within 1e-4."""
    sys.path.insert(0, REPO)
    import __graft_entry__ as graft

    from icp_tpu_torch.tools.entry import entry

    fn_t, args_t = entry("cpu")
    fn_j, args_j = graft.entry()
    for a, b in zip(args_t, args_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    Rt, tt, et = fn_t(*args_t)
    Rj, tj, ej = fn_j(*args_j)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    assert np.isfinite(float(et)) and float(et) < 1e-6 and float(ej) < 1e-6
    assert abs(np.arctan2(float(Rt[1, 0]), float(Rt[0, 0])) - 0.3) < 1e-3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry()


# ── on the card ──────────────────────────────────────────────────────────
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m gpu)")
    return torch.device("cuda:0")


@pytest.mark.gpu
def test_icp_3d_on_card_matches_cpu(cuda_device):
    """tests/test_icp.py's 3-D case on the card against the CPU: R and t
    within 1e-4, error < 1e-4, iterations within 1; no 2-D kernel runs."""
    from icp_tpu_torch.ops.hopper import nn_kernel as K
    from test_torch_3d_io import teapot_case

    sp, sm, tp, tm, R_true = teapot_case()
    kw = dict(voxel_size=0.005, method="point_to_point", max_iterations=300,
              error_threshold=1e-12)
    cpu = icp(*(torch.as_tensor(a) for a in (sp, sm, tp, tm)),
              *identity_init(3, "cpu"), **kw)
    K.reset_launch_counts()
    gpu = icp(*(torch.as_tensor(a, device=cuda_device)
                for a in (sp, sm, tp, tm)),
              *identity_init(3, cuda_device), **kw)
    assert K.nn_launches == 0 and K.nn_min_launches == 0
    assert gpu.R.is_cuda and float(gpu.error) < 1e-4
    np.testing.assert_allclose(gpu.R.cpu().numpy(), R_true, atol=2e-2)
    np.testing.assert_allclose(gpu.R.cpu().numpy(), cpu.R.numpy(), atol=1e-4)
    np.testing.assert_allclose(gpu.t.cpu().numpy(), cpu.t.numpy(), atol=1e-4)
    assert abs(int(gpu.iters) - int(cpu.iters)) <= 1
