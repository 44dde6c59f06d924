"""Scan player: animated playback of a lidar sequence (counterpart of
tools/pcplayer.py, the reference's pcplayer).

    python -m icp_tpu_torch.tools.pcplayer scans.csv --frames -o frames/
    python -m icp_tpu_torch.tools.pcplayer scans.csv --gif play.gif

A background-thread streaming loader, point-stride downsampling, animated
playback and a static overlay view. With an interactive matplotlib backend
the animation plays in a window; headless it renders a GIF (``--gif``) or
PNG frames (``--frames``), so the tool works over SSH and in CI.
"""
from __future__ import annotations

import argparse
import os
import sys
import threading
import time
from collections import deque

import numpy as np

from icp_tpu_torch.services.lidar import LidarService
from icp_tpu_torch.utils.raster import Canvas


class LidarFrameStream:
    """Background-thread scan loader with a bounded prefetch queue.

    Playback pulls parsed frames from the queue while the file keeps
    parsing on the loader thread, so the animation never stalls on disk or
    parse (the reference tool uses the same pattern).
    """

    def __init__(self, path: str, stride: int = 1, max_scans=None,
                 prefetch: int = 64):
        self.path = path
        self.stride = max(int(stride), 1)
        self.max_scans = max_scans
        self._q: deque = deque()
        self._lock = threading.Lock()
        self._done = False
        self._thread = threading.Thread(target=self._load, daemon=True)
        self._prefetch = prefetch
        self._thread.start()

    def _load(self):
        for i, (ts, rel, pts) in enumerate(LidarService(self.path).scans()):
            if self.max_scans is not None and i >= self.max_scans:
                break
            frame = pts[::self.stride, :2].astype(np.float32)
            while True:
                with self._lock:
                    if len(self._q) < self._prefetch:
                        self._q.append((i, frame))
                        break
                time.sleep(0.002)
        with self._lock:
            self._done = True

    def get(self, timeout: float = 5.0):
        """Next (index, frame) or None when the stream is exhausted."""
        t0 = time.time()
        while True:
            with self._lock:
                if self._q:
                    return self._q.popleft()
                if self._done:
                    return None
            if time.time() - t0 > timeout:
                return None
            time.sleep(0.002)

    def drain(self):
        out = []
        while True:
            item = self.get()
            if item is None:
                return out
            out.append(item)


def _bounds(frames, margin=1.0):
    allp = np.concatenate([f for _, f in frames]) if frames else np.zeros((1, 2))
    return (allp[:, 0].min() - margin, allp[:, 0].max() + margin,
            allp[:, 1].min() - margin, allp[:, 1].max() + margin)


def play(frames, fps: float, out_gif: str | None, point_size: float = 2.0):
    """Animated playback: interactive window when a display exists,
    otherwise (or when ``out_gif`` is set) a GIF via the pillow writer.
    matplotlib and pillow are needed here only."""
    import matplotlib
    from icp_tpu_torch.utils.liveview import LiveMapView
    interactive = LiveMapView.available() and not out_gif
    if not interactive:
        matplotlib.use("agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation, PillowWriter

    x0, x1, y0, y1 = _bounds(frames)
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.set_facecolor("black")
    fig.patch.set_facecolor("black")
    ax.set_aspect("equal")
    ax.set_xlim(x0, x1)
    ax.set_ylim(y0, y1)
    scat = ax.scatter([], [], s=point_size, c="lime")
    ax.scatter([0], [0], s=30, c="red", marker="x")   # sensor origin
    title = ax.set_title("", color="white")

    def update(k):
        i, f = frames[k]
        scat.set_offsets(f)
        title.set_text(f"scan {i}  ({len(f)} pts)")
        return scat, title

    anim = FuncAnimation(fig, update, frames=len(frames),
                         interval=1000.0 / fps, blit=False, repeat=True)
    if interactive:
        plt.show()
    else:
        out = out_gif or "playback.gif"
        anim.save(out, writer=PillowWriter(fps=fps))
        print(f"wrote {out} ({len(frames)} frames @ {fps} fps)")
    plt.close(fig)


def render_frames(frames, outdir: str, every: int, width: int):
    """PNG frame dump + overlay (headless batch mode)."""
    os.makedirs(outdir, exist_ok=True)
    n = 0
    for i, f in frames:
        if i % max(every, 1) != 0:
            continue
        canvas = Canvas.for_points(f, width=width)
        canvas.scatter(f, color="lime", size=2)
        canvas.scatter(np.zeros((1, 2)), color="red", size=6)
        canvas.save(os.path.join(outdir, f"scan_{i:05d}.png"))
        n += 1
    allp = np.concatenate([f[::5] for _, f in frames])
    Canvas.for_points(allp, width=width).scatter(
        allp, color="cyan", size=1
    ).save(os.path.join(outdir, "overlay.png"))
    print(f"{len(frames)} scans, {n} frames -> {outdir}/")


def main(argv=None):
    ap = argparse.ArgumentParser(description="Play back a lidar sequence")
    ap.add_argument("file", help="lidar CSV (ts;x;y;z;... rows)")
    ap.add_argument("--stride", type=int, default=1, help="point stride")
    ap.add_argument("--max-scans", type=int, default=None)
    ap.add_argument("--fps", type=float, default=10.0)
    ap.add_argument("--gif", default=None,
                    help="write an animated GIF to this path")
    ap.add_argument("--frames", action="store_true",
                    help="dump PNG frames instead of animating")
    ap.add_argument("-o", "--outdir", default="frames",
                    help="PNG frame directory (--frames mode)")
    ap.add_argument("--every", type=int, default=10,
                    help="render every Nth scan (--frames mode)")
    ap.add_argument("--width", type=int, default=800)
    args = ap.parse_args(argv)

    stream = LidarFrameStream(args.file, stride=args.stride,
                              max_scans=args.max_scans)
    frames = stream.drain()
    if not frames:
        print("no scans found", file=sys.stderr)
        return 1
    if args.frames:
        render_frames(frames, args.outdir, args.every, args.width)
    else:
        play(frames, args.fps, args.gif)
    return 0


if __name__ == "__main__":
    sys.exit(main())
