"""Headless point-cloud viewer: renders clouds and trajectories to PNG
(counterpart of tools/pcview.py, the reference's interactive pcview).

    python -m icp_tpu_torch.tools.pcview cloud.csv [more.csv ...] -o out.png

Multi-cloud overlay with per-cloud colours and a trajectory mode. With a
display and matplotlib it opens a window, otherwise (or with ``--png``) it
writes a file. Input formats: lidar CSV rows (``ts;x;y;z;...``) or flat
comma/space-separated xyz lists.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from icp_tpu_torch.utils.raster import Canvas


def load_cloud(path: str) -> np.ndarray:
    """Load a cloud: lidar CSV (first line has ts + triples) or flat xyz."""
    with open(path) as f:
        first = f.readline()
    if ";" in first:
        from icp_tpu_torch.services.lidar import parse_lidar_line
        pts = []
        with open(path) as f:
            for line in f:
                if line.strip():
                    _, p = parse_lidar_line(line)
                    pts.append(p)
        return np.concatenate(pts) if pts else np.zeros((0, 3))
    with open(path) as f:
        vals = np.fromstring(f.read().replace(",", " ").replace("\n", " "),
                             sep=" ")
    return vals.reshape(-1, 3)


def visualize_trajectory(path, out, width=1200):
    """Trajectory viewer (reference pcview visualize_trajectory): reads a
    .npy of (N, 3, 3) SE(2) poses (or (N, 2)/(N, 3) positions) and renders
    the path."""
    arr = np.load(path)
    if arr.ndim == 3:
        xy = arr[:, :2, 2]
    else:
        xy = arr[:, :2]
    c = Canvas.for_points(xy, width=width)
    c.polyline(xy, "cyan")
    c.scatter(xy[:1], "lime", 6)
    c.scatter(xy[-1:], "red", 6)
    c.save(out)
    print(f"{path}: {len(xy)} poses -> {out}")


def show_interactive(files, clouds, palette, size, background):
    """Interactive multi-cloud window: legend + per-cloud visibility
    checkboxes (reference pcview). matplotlib is needed here only."""
    import matplotlib.pyplot as plt
    from matplotlib.widgets import CheckButtons

    fig, ax = plt.subplots(figsize=(10, 8))
    fig.patch.set_facecolor(background)
    ax.set_facecolor(background)
    ax.set_aspect("equal")
    artists = []
    labels = []
    for i, (f, c) in enumerate(zip(files, clouds)):
        lbl = f"{os.path.basename(f)} ({len(c)})"
        sc = ax.scatter(c[:, 0], c[:, 1], s=size,
                        c=palette[i % len(palette)], label=lbl)
        artists.append(sc)
        labels.append(lbl)
    leg = ax.legend(loc="upper right", facecolor="dimgray",
                    labelcolor="white")
    leg.set_draggable(True)
    # visibility checkboxes, one per cloud
    rax = fig.add_axes([0.01, 0.4, 0.16, 0.05 * max(len(labels), 1)])
    rax.set_facecolor("dimgray")
    checks = CheckButtons(rax, labels, [True] * len(labels))

    def toggle(label):
        idx = labels.index(label)
        artists[idx].set_visible(not artists[idx].get_visible())
        fig.canvas.draw_idle()

    checks.on_clicked(toggle)
    plt.show()


def main(argv=None):
    ap = argparse.ArgumentParser(description="View/render point clouds")
    ap.add_argument("files", nargs="+", help="cloud CSV files")
    ap.add_argument("-o", "--out", default="clouds.png")
    ap.add_argument("--colors", default="green,blue,orange,red,cyan,magenta")
    ap.add_argument("--size", type=int, default=2)
    ap.add_argument("--width", type=int, default=1200)
    ap.add_argument("--background", default="black")
    ap.add_argument("--trajectory", action="store_true",
                    help="treat input as a .npy pose/position array")
    ap.add_argument("--png", action="store_true",
                    help="force PNG output even with a display")
    args = ap.parse_args(argv)

    if args.trajectory:
        for f in args.files:
            visualize_trajectory(f, args.out, width=args.width)
        return

    clouds = [load_cloud(f) for f in args.files]
    palette = args.colors.split(",")
    for f, c in zip(args.files, clouds):
        print(f"{f}: {len(c)} points")

    from icp_tpu_torch.utils.liveview import LiveMapView
    if LiveMapView.available() and not args.png:
        show_interactive(args.files, [c[:, :2] for c in clouds], palette,
                         args.size, args.background)
        return

    all_pts = np.concatenate([c[:, :2] for c in clouds if len(c)])
    canvas = Canvas.for_points(all_pts, width=args.width,
                               background=args.background)
    for i, c in enumerate(clouds):
        canvas.scatter(c[:, :2], color=palette[i % len(palette)],
                       size=args.size)
    canvas.save(args.out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
