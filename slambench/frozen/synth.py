"""The benchmark's traffic generators, frozen here so that later changes to
the program cannot move the yardstick.

``make_world``, ``ray_cast``, ``make_trajectory`` and ``make_dense_world``
are copies of ``icp_tpu_torch/utils/synth.py`` (itself a numpy copy of the
original's generator). ``generate_log`` is its ``generate_sequence`` with
the same draws in the same order, handing back arrays where the original
writes the CSV files: the points are the CSV's (rounded to 4 decimals, the
z column dropped as the z filter keeps every row), the IMU log is the CSV's
text. ``LapStream`` makes ``large_scan_stream``'s scans (the same world,
lap and noise) on the device: each scan samples its points with replacement
from the world points within range of the pose, from a ``torch.Generator``
seeded per scan, so set-up takes seconds where the host stream takes
~11 ms a scan.
"""
from __future__ import annotations

import numpy as np


def make_world(rng, kind="rooms"):
    """World = list of wall segments ((x0,y0),(x1,y1))."""
    segs = []

    def box(x0, y0, x1, y1):
        segs.extend([
            ((x0, y0), (x1, y0)), ((x1, y0), (x1, y1)),
            ((x1, y1), (x0, y1)), ((x0, y1), (x0, y0)),
        ])

    if kind == "rooms":
        box(-12, -9, 12, 9)                     # outer walls
        box(-5, -3, -2, 0)                      # interior box A
        box(2.5, 1.5, 5, 4)                     # interior box B
        segs.append(((-12, 3), (-10, 3)))       # partial wall / corridor
        segs.append(((0, -9), (0, -7.5)))       # spur (clear of trajectory)
        box(9.5, -6, 11, -4.5)                  # pillar near outer wall
    elif kind == "corridor":
        box(-20, -2, 20, 2)
        segs.append(((-10, -2), (-10, 0.5)))
        segs.append(((10, -0.5), (10, 2)))
    return np.asarray(segs, np.float64)         # (S, 2, 2)


def ray_cast(origin, angles, segs, max_range=30.0):
    """Batched ray-segment intersection: first hit distance per angle
    (inf when no hit). origin (2,), angles (A,), segs (S, 2, 2)."""
    d = np.stack([np.cos(angles), np.sin(angles)], axis=1)   # (A, 2)
    p = origin[None, :]
    a = segs[:, 0]                                           # (S, 2)
    b = segs[:, 1]
    e = b - a                                                # (S, 2)
    dx, dy = d[:, 0:1], d[:, 1:2]                            # (A, 1)
    ex, ey = e[None, :, 0], e[None, :, 1]                    # (1, S)
    denom = dx * ey - dy * ex                                # (A, S)
    apx = a[None, :, 0] - p[:, 0:1]
    apy = a[None, :, 1] - p[:, 1:2]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (apx * ey - apy * ex) / denom
        u = (apx * dy - apy * dx) / denom
    valid = (np.abs(denom) > 1e-12) & (t > 1e-6) & (u >= 0.0) & (u <= 1.0)
    t = np.where(valid, t, np.inf)
    tmin = t.min(axis=1)
    return np.minimum(tmin, np.where(np.isinf(tmin), np.inf, tmin))


def make_trajectory(n_scans, kind="loop"):
    """Ground-truth poses (n, 3) [x, y, yaw]: a smooth loop back to the
    start, so loop closure triggers."""
    if kind == "loop":
        s = np.linspace(0, 2 * np.pi, n_scans)
        x = 7.0 * np.cos(s - np.pi / 2)
        y = 5.8 * np.sin(s - np.pi / 2) + 0.5
        yaw = np.arctan2(np.gradient(y), np.gradient(x))
    elif kind == "straight":
        x = np.linspace(-8, 8, n_scans)
        y = np.zeros(n_scans)
        yaw = np.zeros(n_scans)
    else:
        raise ValueError(kind)
    return np.stack([x, y, yaw], axis=1)


def make_dense_world(rng, n_points=1_000_000, extent=100.0, n_walls=220):
    """Dense structured point world: wall segments sampled at high density
    inside a [-extent, extent] arena. Returns an (n_points, 2) f32 cloud."""
    starts = rng.uniform(-extent, extent, (n_walls, 2))
    horiz = rng.integers(0, 2, n_walls).astype(bool)
    lengths = rng.uniform(extent * 0.1, extent * 0.35, n_walls)
    per = n_points // n_walls
    pts = []
    for s, h, L in zip(starts, horiz, lengths):
        t = rng.uniform(0, L, per)
        pts.append(np.stack([s[0] + np.where(h, t, 0.0),
                             s[1] + np.where(h, 0.0, t)], axis=1))
    cloud = np.concatenate(pts).astype(np.float32)
    return np.clip(cloud, -extent, extent)


def generate_log(seed, n_scans=200, n_beams=720, noise=0.005,
                 z_band=(1.0, 1.4), world="rooms", trajectory="loop",
                 scan_period_us=100_000, imu_rate_mult=4):
    """One recorded drive. Returns (scans: list of (n, 2) float32
    sensor-frame points, rel_times_us: (n_scans,) int64, imu_csv: str,
    ground truth (n_scans, 3))."""
    rng = np.random.default_rng(seed)
    segs = make_world(rng, world)
    poses = make_trajectory(n_scans, trajectory)
    beam_angles = np.linspace(-np.pi, np.pi, n_beams, endpoint=False)
    scans = []
    for k in range(n_scans):
        x, y, yaw = poses[k]
        r = ray_cast(np.array([x, y]), yaw + beam_angles, segs)
        hit = np.isfinite(r)
        r = r + rng.normal(scale=noise, size=r.shape)
        px = r * np.cos(beam_angles)
        py = r * np.sin(beam_angles)
        rng.uniform(z_band[0], z_band[1], size=r.shape)     # the z column
        pts = np.stack([px[hit], py[hit]], 1)
        # the CSV's "%.4f", read back as float64, then the engine's f32
        scans.append(np.round(pts, 4).astype(np.float32))
    t0 = 1_000_000_000
    lines = []
    n_imu = n_scans * imu_rate_mult
    for k in range(n_imu):
        ts = t0 + int(k * scan_period_us / imu_rate_mult)
        frac = k / imu_rate_mult
        i0 = min(int(frac), n_scans - 1)
        i1 = min(i0 + 1, n_scans - 1)
        a = frac - i0
        y0, y1 = poses[i0, 2], poses[i1, 2]
        dy = (y1 - y0 + np.pi) % (2 * np.pi) - np.pi
        yaw = y0 + a * dy + rng.normal(scale=0.002)
        lines.append(f"{ts};0.0;0.0;{np.sin(yaw / 2):.6f};"
                     f"{np.cos(yaw / 2):.6f}\n")
    rel = np.arange(n_scans, dtype=np.int64) * scan_period_us
    return scans, rel, "".join(lines), poses


def lap_trajectory(n_scans, extent=100.0, kind="loop"):
    """``large_scan_stream``'s ground truth: an ellipse (or a lemniscate,
    "eight") sized to the arena, ``n_scans`` poses a lap."""
    s = np.linspace(0, 2 * np.pi, int(n_scans))
    rad = extent * 0.55
    if kind == "eight":
        den = 1.0 + np.sin(s) ** 2
        x = rad * np.cos(s) / den
        y = rad * 0.9 * np.sin(s) * np.cos(s) / den
    else:
        x = rad * np.cos(s - np.pi / 2)
        y = rad * 0.8 * np.sin(s - np.pi / 2)
    yaw = np.arctan2(np.gradient(y), np.gradient(x))
    return np.stack([x, y, yaw], axis=1)


class LapStream:
    """Scans of ``n_points`` sensor-frame points, each drawn with
    replacement from the dense world's points within ``max_range`` of its
    pose, with Gaussian noise, made on ``device``. The world comes from
    ``world_seed`` (part of the deployment: every run maps the same
    place); scan k's draws from a generator seeded with (seed, k), so a
    scan does not depend on how many came before it. The first ``head``
    scans draw with ``world_seed`` in place of ``seed``: every run starts
    with the same scans."""

    def __init__(self, seed, lap_scans, n_points=100_000, extent=100.0,
                 max_range=35.0, noise=0.02, trajectory="loop",
                 world_seed=3, world_points=1_000_000, walls=220, head=0,
                 device="cuda"):
        import torch

        self.torch = torch
        self.seed = int(seed)
        self.world_seed, self.head = int(world_seed), int(head)
        self.n_points, self.noise = int(n_points), float(noise)
        self.r2 = float(max_range) ** 2
        self.device = torch.device(device)
        world = make_dense_world(np.random.default_rng(int(world_seed)),
                                 n_points=int(world_points), extent=extent,
                                 n_walls=int(walls))
        self.world = torch.as_tensor(world, device=self.device)
        self.gt = lap_trajectory(lap_scans, extent, trajectory)

    def scans(self, start, count):
        """Scans start .. start + count - 1 as one (count, n, 2) float32
        host array."""
        torch = self.torch
        out = torch.empty((count, self.n_points, 2), dtype=torch.float32,
                          pin_memory=self.device.type == "cuda")
        g = torch.Generator(device=self.device)
        for i in range(count):
            k = start + i
            base = self.world_seed if k < self.head else self.seed
            g.manual_seed((base * 1_000_003 + k) % (1 << 63))
            x, y, yaw = (float(v) for v in self.gt[k])
            pos = torch.tensor([x, y], dtype=torch.float32,
                               device=self.device)
            d = self.world - pos
            near = torch.nonzero((d * d).sum(1) < self.r2).squeeze(1)
            pick = near[torch.randint(0, len(near), (self.n_points,),
                                      generator=g, device=self.device)]
            c, s = np.cos(yaw), np.sin(yaw)
            rwt = torch.tensor([[c, s], [-s, c]], dtype=torch.float32,
                               device=self.device)          # world->sensor
            pts = (self.world[pick] - pos) @ rwt.T
            pts = pts + self.noise * torch.randn(
                pts.shape, generator=g, device=self.device)
            out[i].copy_(pts, non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out.numpy()
