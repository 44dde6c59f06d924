"""Point-cloud manipulation tool: scale / rotate / translate + export
(counterpart of tools/pcman.py, the reference's pcman).

    python -m icp_tpu_torch.tools.pcman cloud.csv -o out.csv --yaw 30 --tx 0.5

Applies a similarity transform to a cloud, exports the result (used to
fabricate test fixtures with known transforms), and renders a before/after
overlay PNG (``--png``).
"""
from __future__ import annotations

import argparse

import numpy as np

from icp_tpu_torch.tools.pcview import load_cloud
from icp_tpu_torch.utils.raster import Canvas


def transform_points(points, scale=1.0, yaw_deg=0.0, pitch_deg=0.0,
                     translate=(0.0, 0.0, 0.0)):
    """Scale -> rotate (Z yaw then Y pitch) -> translate, 3D."""
    p = np.asarray(points, np.float64) * scale
    yz = np.deg2rad(yaw_deg)
    c, s = np.cos(yz), np.sin(yz)
    Rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    py = np.deg2rad(pitch_deg)
    c, s = np.cos(py), np.sin(py)
    Ry = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    return p @ (Ry @ Rz).T + np.asarray(translate)


def export_points(points, path):
    with open(path, "w") as f:
        f.write(",".join(f"{v:.6f}" for v in np.asarray(points).reshape(-1)))
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description="Transform and export a cloud")
    ap.add_argument("file")
    ap.add_argument("-o", "--out", default="transformed.csv")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--yaw", type=float, default=0.0)
    ap.add_argument("--pitch", type=float, default=0.0)
    ap.add_argument("--tx", type=float, default=0.0)
    ap.add_argument("--ty", type=float, default=0.0)
    ap.add_argument("--tz", type=float, default=0.0)
    ap.add_argument("--png", default=None, help="before/after overlay PNG")
    args = ap.parse_args(argv)

    cloud = load_cloud(args.file)
    out = transform_points(cloud, args.scale, args.yaw, args.pitch,
                           (args.tx, args.ty, args.tz))
    export_points(out, args.out)
    print(f"{args.file}: {len(cloud)} points -> {args.out}")
    if args.png:
        both = np.concatenate([cloud[:, :2], out[:, :2]])
        Canvas.for_points(both).scatter(cloud[:, :2], "green", 2).scatter(
            out[:, :2], "orange", 2).save(args.png)
        print(f"wrote {args.png}")


if __name__ == "__main__":
    main()
