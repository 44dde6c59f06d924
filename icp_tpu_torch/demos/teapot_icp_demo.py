"""3D ICP correctness demo (counterpart of demos/teapot_icp_demo.py, the
reference's teapot demo): apply a KNOWN 25-degree Y-rotation + translation
to a 3D cloud, run point-to-point ICP, and report mean/max nearest-neighbour
residuals. Renders a before/after overlay PNG instead of a window.

    python -m icp_tpu_torch.demos.teapot_icp_demo [--device cpu]

The cloud is ``--cloud FILE`` (a flat comma/space-separated xyz list, the
reference's teapot.csv format) or, without one, the generated 418-point
test body icp_tpu's demo falls back to (seed 7).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from icp_tpu_torch.models.icp import icp, identity_init
from icp_tpu_torch.ops.nn import nn_query
from icp_tpu_torch.utils.masking import pad_points
from icp_tpu_torch.utils.raster import Canvas


def load_teapot(path=None):
    if path:
        with open(path) as f:
            vals = np.fromstring(f.read().replace(",", " ").replace("\n", " "),
                                 sep=" ")
        return vals.reshape(-1, 3).astype(np.float32)
    rng = np.random.default_rng(7)
    # teapot-ish test body: ellipsoid shell + spout line
    u = rng.uniform(0, 2 * np.pi, 380)
    v = rng.uniform(0, np.pi, 380)
    body = np.stack([0.1 * np.cos(u) * np.sin(v),
                     0.07 * np.sin(u) * np.sin(v),
                     0.06 * np.cos(v)], 1)
    t = np.linspace(0, 1, 38)
    spout = np.stack([0.1 + 0.08 * t, np.zeros_like(t), 0.02 + 0.05 * t], 1)
    return np.concatenate([body, spout]).astype(np.float32)


def known_transform():
    """The demo's transform (reference demo lines 38-47): 25 degrees about
    Y, then a shift."""
    th = np.deg2rad(25.0)
    R_true = np.array(
        [[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]],
        np.float32)
    return R_true, np.array([0.05, 0.03, -0.02], np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser(description="3D ICP correctness demo")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    ap.add_argument("--cloud", default=None,
                    help="xyz cloud file (default: the generated test body)")
    ap.add_argument("-o", "--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "teapot_alignment.png"))
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but CUDA is not available; pass "
                           "--device cpu explicitly")

    original = load_teapot(args.cloud)
    n = len(original)
    print(f"teapot: {n} points")
    R_true, t_true = known_transform()
    transformed = original @ R_true.T + t_true

    cap = 512
    sp, sm, tp, tm = (torch.as_tensor(a, device=dev) for a in (
        *pad_points(transformed, cap), *pad_points(original, cap)))
    res = icp(
        sp, sm, tp, tm, *identity_init(3, dev),
        voxel_size=0.005, method="point_to_point",
        max_iterations=300, error_threshold=1e-12,
    )
    R, t = res.R.cpu().numpy(), res.t.cpu().numpy()
    aligned = transformed @ R.T + t

    ap_, am = (torch.as_tensor(a, device=dev)
               for a in pad_points(aligned.astype(np.float32), cap))
    d, _ = nn_query(ap_, tp, tm, am)
    d = d.cpu().numpy()[:n]
    print(f"ICP iters={int(res.iters)} error={float(res.error):.3e}")
    print(f"residual mean={d.mean():.6f} max={d.max():.6f}")

    pts2 = np.concatenate([original[:, [0, 2]], transformed[:, [0, 2]],
                           aligned[:, [0, 2]]])
    Canvas.for_points(pts2, width=900).scatter(
        original[:, [0, 2]], "green", 3).scatter(
        transformed[:, [0, 2]], "red", 2).scatter(
        aligned[:, [0, 2]], "cyan", 2).save(args.out)
    print(f"wrote {args.out} (green=target, red=misaligned, cyan=after ICP)")

    ok = d.mean() < 0.01
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
