"""Synthetic lidar+IMU sequence generator (reference CSV formats).

A numpy copy of icp_tpu.utils.synth, so the port and its tests make the
same sequences without importing icp_tpu (which imports jax).

The reference's benchmark dataset (data/1007lidar.csv + data/1007imu.csv)
is gitignored upstream and not shipped (reference .gitignore), so
benchmarks and integration tests use a faithful synthetic sequence: a 2D
world of walls/obstacles, a smooth robot trajectory, ray-cast 360-degree
scans with noise, emitted in the exact CSV formats the reference documents
(reference README.md data formats; lidar: ``ts;x;y;z;...`` in the
sensor frame, imu: ``ts;qx;qy;qz;qw``).
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
    # solve p + t d = a + u e ; per (A, S)
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
    """Ground-truth poses (n, 3) [x, y, yaw] — smooth loop with a return to
    the start so loop closure triggers."""
    if kind == "loop":
        s = np.linspace(0, 2 * np.pi, n_scans)
        x = 7.0 * np.cos(s - np.pi / 2)
        y = 5.8 * np.sin(s - np.pi / 2) + 0.5
        dx = np.gradient(x)
        dy = np.gradient(y)
        yaw = np.arctan2(dy, dx)
    elif kind == "straight":
        x = np.linspace(-8, 8, n_scans)
        y = np.zeros(n_scans)
        yaw = np.zeros(n_scans)
    else:
        raise ValueError(kind)
    return np.stack([x, y, yaw], axis=1)


def make_dense_world(rng, n_points=1_000_000, extent=100.0, n_walls=220):
    """Dense structured point world: wall segments sampled at high density
    inside a [-extent, extent] arena. Returns an (n_points, 2) f32 cloud.

    The point-scale world of the scaled pipeline (100k-point scans): scans
    are range-limited views of this cloud, so inter-scan correspondences
    are real.
    """
    starts = rng.uniform(-extent, extent, (n_walls, 2))
    horiz = rng.integers(0, 2, n_walls).astype(bool)
    lengths = rng.uniform(extent * 0.1, extent * 0.35, n_walls)
    per = n_points // n_walls
    pts = []
    for s, h, L in zip(starts, horiz, lengths):
        t = rng.uniform(0, L, per)
        seg = np.stack([s[0] + np.where(h, t, 0.0),
                        s[1] + np.where(h, 0.0, t)], axis=1)
        pts.append(seg)
    cloud = np.concatenate(pts).astype(np.float32)
    return np.clip(cloud, -extent, extent)


class _BlockCull:
    """The world's points in runs of ``RUN`` consecutive indices, each
    run with its bounding box: a query within radius r reads only the runs
    whose box lies within r, so the distance pass covers a fraction of the
    world. The points it selects, their order and their distances are the
    full pass's, bit for bit (the coordinates are widened to float64
    exactly, and dx * dx + dy * dy is the two-term sum the full pass
    takes)."""

    RUN = 256        # 0.5-2 m of a dense-world wall: tight boxes, few runs

    def __init__(self, world: np.ndarray):
        self.world = world
        pad = -len(world) % self.RUN
        w = (np.concatenate([world, np.repeat(world[-1:], pad, 0)])
             if pad else world).astype(np.float64)
        self.x = w[:, 0].reshape(-1, self.RUN)
        self.y = w[:, 1].reshape(-1, self.RUN)
        self.lo = np.stack([self.x.min(axis=1), self.y.min(axis=1)], 1)
        self.hi = np.stack([self.x.max(axis=1), self.y.max(axis=1)], 1)

    def near(self, pos: np.ndarray, r2: float):
        """The ascending indices of the points whose squared distance to
        ``pos`` (float64) is below ``r2``; where there is none, the
        nearest point's index."""
        dx = np.maximum(np.maximum(self.lo[:, 0] - pos[0],
                                   pos[0] - self.hi[:, 0]), 0.0)
        dy = np.maximum(np.maximum(self.lo[:, 1] - pos[1],
                                   pos[1] - self.hi[:, 1]), 0.0)
        # a box's distance is a lower bound of its points'; the margin
        # covers the rounding of both
        runs = np.flatnonzero(dx * dx + dy * dy <= r2 * (1.0 + 1e-6))
        x = self.x[runs].reshape(-1) - pos[0]
        y = self.y[runs].reshape(-1) - pos[1]
        idx = (runs[:, None] * self.RUN + np.arange(self.RUN)).reshape(-1)
        near = idx[(x * x + y * y < r2) & (idx < len(self.world))]
        if near.size == 0:
            d2 = np.sum((self.world - pos) ** 2, axis=1)
            near = np.array([int(np.argmin(d2))])
        return near


class LargeScanStream:
    """Iterator of (scan, gt_pose) for the scaled pipeline: each scan is
    ``n_points`` sensor-frame points sampled (with replacement) from the
    dense world within ``max_range`` of the pose. Ground truth is a loop
    (an ellipse, or with ``trajectory="eight"`` a self-intersecting
    lemniscate) sized to the arena, so loop closures are real. Scans are
    made one at a time, all from one sequential generator.

    Resuming: ``start`` is the first scan to yield; ``rng_state`` the
    generator's ``state`` saved after scan ``start - 1`` was taken (the
    world is rebuilt from ``seed`` first). With ``start`` and no state the
    first ``start`` scans are drawn and discarded. Either way the scans and
    ground truth from ``start`` on are byte-equal to a stream from 0.
    """

    def __init__(self, n_scans, n_points=100_000, extent=100.0,
                 max_range=35.0, noise=0.02, seed=0, world_points=None,
                 trajectory="loop", start=0, rng_state=None):
        self.n_scans, self.n_points = int(n_scans), int(n_points)
        self.r2, self.noise = max_range * max_range, noise
        self.rng = np.random.default_rng(seed)
        world = (make_dense_world(self.rng, extent=extent)
                 if world_points is None else world_points)
        self._cull = _BlockCull(world)
        s = np.linspace(0, 2 * np.pi, self.n_scans)
        rad = extent * 0.55
        if trajectory == "eight":
            den = 1.0 + np.sin(s) ** 2
            x = rad * np.cos(s) / den
            y = rad * 0.9 * np.sin(s) * np.cos(s) / den
        else:
            x = rad * np.cos(s - np.pi / 2)
            y = rad * 0.8 * np.sin(s - np.pi / 2)
        yaw = np.arctan2(np.gradient(y), np.gradient(x))
        self.gt = np.stack([x, y, yaw], axis=1)
        self.position = 0
        if rng_state is not None:
            self.rng.bit_generator.state = rng_state
            self.position = int(start)
        else:
            for _ in range(int(start)):
                next(self)

    @property
    def state(self) -> dict:
        """The generator's state after the last scan taken."""
        return self.rng.bit_generator.state

    def __iter__(self):
        return self

    def __next__(self):
        k = self.position
        if k >= self.n_scans:
            raise StopIteration
        pos = self.gt[k, :2]
        near = self._cull.near(pos, self.r2)
        pick = near[self.rng.integers(0, near.size, self.n_points)]
        pts_w = self._cull.world[pick]
        c, si = np.cos(self.gt[k, 2]), np.sin(self.gt[k, 2])
        Rwt = np.array([[c, si], [-si, c]], np.float32)   # world->sensor
        pts_s = (pts_w - pos.astype(np.float32)) @ Rwt.T
        pts_s = pts_s + self.rng.normal(scale=self.noise, size=pts_s.shape)
        self.position = k + 1
        return pts_s.astype(np.float32), self.gt[k]


# icp_tpu's name: a generator function there
large_scan_stream = LargeScanStream


def generate_sequence(
    out_lidar,
    out_imu,
    n_scans=120,
    n_beams=360,
    noise=0.01,
    z_band=(1.0, 1.4),
    world="rooms",
    trajectory="loop",
    seed=0,
    scan_period_us=100_000,
    imu_rate_mult=4,
):
    """Write lidar+imu CSVs; returns ground-truth poses (n, 3).

    Scans are expressed in the SENSOR frame (the reference pipeline
    z-filters then registers sensor-frame scans, slam.py:24-27,383), with z
    drawn inside the config z-band so the filter keeps them.
    """
    rng = np.random.default_rng(seed)
    segs = make_world(rng, world)
    poses = make_trajectory(n_scans, trajectory)
    beam_angles = np.linspace(-np.pi, np.pi, n_beams, endpoint=False)

    t0 = 1_000_000_000
    with open(out_lidar, "w") as f:
        for k in range(n_scans):
            x, y, yaw = poses[k]
            world_angles = yaw + beam_angles
            r = ray_cast(np.array([x, y]), world_angles, segs)
            hit = np.isfinite(r)
            r = r + rng.normal(scale=noise, size=r.shape)
            # sensor-frame 2D points
            px = r * np.cos(beam_angles)
            py = r * np.sin(beam_angles)
            pz = rng.uniform(z_band[0], z_band[1], size=r.shape)
            ts = t0 + k * scan_period_us
            cols = []
            for i in range(n_beams):
                if hit[i]:
                    cols.append(f"{px[i]:.4f};{py[i]:.4f};{pz[i]:.4f}")
            f.write(f"{ts};" + ";".join(cols) + "\n")

    with open(out_imu, "w") as f:
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
            qz, qw = np.sin(yaw / 2), np.cos(yaw / 2)
            f.write(f"{ts};0.0;0.0;{qz:.6f};{qw:.6f}\n")

    return poses
