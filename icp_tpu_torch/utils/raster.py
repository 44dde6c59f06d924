"""Dependency-free 2D rasterisation and PNG export (the port's own copy
of icp_tpu.utils.raster: numpy + zlib, no pillow).

Point clouds, trajectories and occupancy maps are rendered to PNG files,
so every tool and the live-map snapshots work without a display. The bytes
``write_png`` writes equal icp_tpu's for the same array.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

# A small readable palette (RGB 0-255)
COLORS = {
    "white": (255, 255, 255), "black": (0, 0, 0), "red": (220, 60, 50),
    "green": (60, 180, 90), "blue": (70, 110, 230), "orange": (240, 150, 40),
    "cyan": (80, 200, 220), "magenta": (200, 80, 200), "gray": (128, 128, 128),
    "lime": (130, 220, 60), "yellow": (235, 200, 60),
}


def write_png(path: str, img: np.ndarray):
    """Write an (H, W, 3) uint8 array as a PNG file."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape[:2]
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload)))

    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    out = b"\x89PNG\r\n\x1a\n"
    out += chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
    out += chunk(b"IDAT", zlib.compress(raw, 6))
    out += chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(out)


class Canvas:
    """Fixed-extent 2D canvas for scatter/line rendering."""

    def __init__(self, min_x, max_x, min_y, max_y, width=1000,
                 background="black"):
        self.min_x, self.max_x = float(min_x), float(max_x)
        self.min_y, self.max_y = float(min_y), float(max_y)
        span_x = max(self.max_x - self.min_x, 1e-9)
        span_y = max(self.max_y - self.min_y, 1e-9)
        self.w = int(width)
        self.h = max(int(round(width * span_y / span_x)), 1)
        self.sx = (self.w - 1) / span_x
        self.sy = (self.h - 1) / span_y
        bg = COLORS.get(background, (0, 0, 0))
        self.img = np.tile(np.array(bg, np.uint8), (self.h, self.w, 1))

    @classmethod
    def for_points(cls, points, margin=0.05, **kw):
        p = np.asarray(points)
        mn, mx = p.min(axis=0), p.max(axis=0)
        pad = (mx - mn).max() * margin + 1e-6
        return cls(mn[0] - pad, mx[0] + pad, mn[1] - pad, mx[1] + pad, **kw)

    def _to_px(self, pts):
        px = ((np.asarray(pts)[:, 0] - self.min_x) * self.sx).astype(int)
        py = ((np.asarray(pts)[:, 1] - self.min_y) * self.sy).astype(int)
        # flip y so +y is up
        return px, (self.h - 1) - py

    def scatter(self, points, color="white", size=1):
        if len(points) == 0:
            return self
        c = np.array(COLORS.get(color, color), np.uint8)
        px, py = self._to_px(points)
        r = max(int(size) // 2, 0)
        for dx in range(-r, r + 1):
            for dy in range(-r, r + 1):
                x = np.clip(px + dx, 0, self.w - 1)
                y = np.clip(py + dy, 0, self.h - 1)
                ok = (px + dx >= 0) & (px + dx < self.w) & \
                     (py + dy >= 0) & (py + dy < self.h)
                self.img[y[ok], x[ok]] = c
        return self

    def polyline(self, points, color="cyan"):
        p = np.asarray(points)
        if len(p) < 2:
            return self
        c = np.array(COLORS.get(color, color), np.uint8)
        for a, b in zip(p[:-1], p[1:]):
            n = int(max(abs(b[0] - a[0]) * self.sx,
                        abs(b[1] - a[1]) * self.sy, 1)) + 1
            t = np.linspace(0, 1, n)
            seg = a[None, :] + t[:, None] * (b - a)[None, :]
            px, py = self._to_px(seg)
            ok = (px >= 0) & (px < self.w) & (py >= 0) & (py < self.h)
            self.img[py[ok], px[ok]] = c
        return self

    def image(self, gray, origin_xy, resolution):
        """Blit a (ny, nx) grayscale [0,1] field (e.g. occupancy display)."""
        g = (np.clip(gray, 0, 1) * 255).astype(np.uint8)
        ny, nx = g.shape
        ys = np.arange(ny)
        xs = np.arange(nx)
        wx = origin_xy[0] + (xs + 0.5) * resolution
        wy = origin_xy[1] + (ys + 0.5) * resolution
        px = ((wx - self.min_x) * self.sx).astype(int)
        py = (self.h - 1) - ((wy - self.min_y) * self.sy).astype(int)
        okx = (px >= 0) & (px < self.w)
        oky = (py >= 0) & (py < self.h)
        sub = g[np.ix_(oky, okx)]
        self.img[np.ix_(py[oky], px[okx])] = sub[..., None]
        return self

    def save(self, path):
        write_png(path, self.img)
        return path
