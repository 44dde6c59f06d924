"""Time nn_min_cuda's kernel at every launch geometry on one CUDA card.

    python3 -m icp_tpu_torch.tools.nn_min_sweep [--against OLD.cu] [--out FILE]

Builds ``csrc/nn_kernel.cu``, and at each of the six sweep shapes holds
icp_nn_min at every candidate geometry (k rows a lane, csize blocks a
cluster, the slice they give) bit for bit against ``nn_min_plain`` and
times it by CUDA-graph replays (device only), beside the bound (6 flops a
pair at 67 TFLOP/s) and ``nn_min_geometry``'s pick. With ``--against``, it
also builds OLD.cu, an earlier ``nn_kernel.cu`` whose ``icp_nn_min`` takes
(src, tgt, mask, n, m, out, stream), and times that kernel on the same
inputs before and after the sweep. With ``--detail``, it also times the
picked geometry against the target count at 15,360 and 115,968 rows (the
fixed cost and the cost a target), an empty graph node, and reads the SM
clock and power while the largest shape runs for 2 s. Prints the card's
name and power limit; ``--out`` writes every figure as JSON. Needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import tempfile
import time

# (rows, targets) of the sweep passes: angles x 768 rows against the 1792
# submap or 768 scan voxels (the IMU main path, no IMU, loop closure)
SHAPES = {"main coarse": (13 * 768, 1792), "main fine": (20 * 768, 1792),
          "no-IMU coarse": (151 * 768, 1792), "no-IMU fine": (32 * 768, 1792),
          "LC coarse": (240 * 768, 768), "LC fine": (30 * 768, 768)}
PEAK_F32_FLOPS = 67e12


def graph_us(fn, calls=20, replays=10) -> float:
    """Device-only us per call of fn(): ``calls`` calls in one CUDA graph,
    replayed ``replays`` times between two CUDA events."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return 1e3 * start.elapsed_time(end) / (calls * replays)


def _load_old(source: str, workdir: str):
    from icp_tpu_torch.ops.hopper import build

    so = f"{workdir}/libold_nn.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", so, source],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    lib = ctypes.CDLL(so)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.icp_nn_min.argtypes = [vp, vp, vp, ci, ci, vp, vp]
    lib.icp_nn_min.restype = ci
    return lib


def main(argv=None):
    import numpy as np
    import torch

    from icp_tpu_torch.ops.hopper import build
    from icp_tpu_torch.ops.hopper import nn_kernel as K

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", help="an earlier nn_kernel.cu to time too")
    ap.add_argument("--detail", action="store_true",
                    help="also the cost against M, an empty node, the clock")
    ap.add_argument("--out", help="write the figures to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("nn_min_sweep needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda:0")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = build.load()
    workdir = tempfile.mkdtemp()
    old = _load_old(args.against, workdir) if args.against else None

    def launch(r, g, m, k, c, sl):
        out = torch.empty(r.shape[0], dtype=torch.float32, device=dev)
        err = lib.icp_nn_min(r.data_ptr(), g.data_ptr(), m.data_ptr(), r.shape[0],
                             g.shape[0], k, c, sl, out.data_ptr(),
                             torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"icp_nn_min ({k}, {c}, {sl}): cudaError {err}")
        return out

    def launch_old(r, g, m):
        out = torch.empty(r.shape[0], dtype=torch.float32, device=dev)
        err = old.icp_nn_min(r.data_ptr(), g.data_ptr(), m.data_ptr(), r.shape[0],
                             g.shape[0], out.data_ptr(),
                             torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"old icp_nn_min: cudaError {err}")
        return out

    rng = np.random.default_rng(0)
    results = {}
    for label, (n, mt) in SHAPES.items():
        r, g = (torch.as_tensor(rng.uniform(-20, 20, (s, 2)).astype(np.float32),
                                device=dev) for s in (n, mt))
        m = torch.as_tensor(rng.random(mt) < 0.9, device=dev)
        plain = K.nn_min_plain(r, g, m)
        pick = K.nn_min_geometry(n, mt, sms)
        row = {"shape": f"{n}x{mt}", "pick": list(pick),
               "bound_us": 1e6 * 6 * n * mt / PEAK_F32_FLOPS,
               "plain_us": graph_us(lambda: K.nn_min_plain(r, g, m), calls=5, replays=4)}
        if old is not None:
            assert torch.equal(launch_old(r, g, m), plain), f"old kernel at {label}"
            row["old_us"] = [graph_us(lambda: launch_old(r, g, m))]
        row["us"] = {}
        for k, c, sl in K.nn_min_candidates(mt):
            assert torch.equal(launch(r, g, m, k, c, sl), plain), (label, k, c, sl)
            row["us"][f"{k},{c},{sl}"] = graph_us(lambda: launch(r, g, m, k, c, sl))
        key = ",".join(map(str, pick))
        row["pick_again_us"] = graph_us(lambda: launch(r, g, m, *pick))
        if old is not None:
            row["old_us"].append(graph_us(lambda: launch_old(r, g, m)))
        best = min(row["us"], key=row["us"].get)
        results[label] = row
        print(f"{label} {n}x{mt}: bound {row['bound_us']:.2f} us; pick {key} "
              f"{row['us'][key]:.2f} / {row['pick_again_us']:.2f} us "
              f"({100 * row['bound_us'] / row['us'][key]:.1f} % of the bound); "
              f"best {best} {row['us'][best]:.2f} us; plain {row['plain_us']:.1f} us"
              + (f"; old kernel {row['old_us'][0]:.2f} / {row['old_us'][1]:.2f} us"
                 if old is not None else "") + f" on {card}", flush=True)
        print("    " + " ".join(f"{g_}:{t:.2f}" for g_, t in
                                sorted(row["us"].items(), key=lambda x: x[1])),
              flush=True)
    if args.detail:
        results["detail"] = detail(launch, K.nn_min_geometry, sms, dev, card)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "results": results}, f, indent=1)


def detail(launch, geometry, sms, dev, card) -> dict:
    """The picked geometry's time against M at two row counts (each with
    its time at one instruction a cycle a sub-partition at 1.98 GHz: 6 a
    pair), an empty graph node, and the SM clock and power under load."""
    import numpy as np
    import torch

    rng = np.random.default_rng(1)

    def cloud(k):
        return torch.as_tensor(rng.uniform(-20, 20, (k, 2)).astype(np.float32),
                               device=dev)

    out = {"empty_node_us": graph_us(lambda: torch.cuda._sleep(0))}
    print(f"empty graph node: {out['empty_node_us']:.2f} us on {card}", flush=True)
    for n in (15360, 115968):
        r = cloud(n)
        for mt in (2, 896, 1792, 3584):
            g, m = cloud(mt), torch.ones(mt, dtype=torch.bool, device=dev)
            geo = geometry(n, mt, sms)
            us = graph_us(lambda: launch(r, g, m, *geo))
            issue = 1e6 * 6 * n * mt / (sms * 4 * 32 * 1.98e9)
            out[f"{n}x{mt}"] = {"pick": list(geo), "us": us, "issue_us": issue}
            print(f"{n}x{mt} at {geo}: {us:.2f} us (6 instructions a pair at one "
                  f"a cycle: {issue:.2f} us) on {card}", flush=True)
    n, mt = 115968, 1792
    r, g = cloud(n), cloud(mt)
    m = torch.ones(mt, dtype=torch.bool, device=dev)
    geo = geometry(n, mt, sms)
    mon = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader", "-lms", "250"],
                           stdout=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 2.0:
        for _ in range(200):
            launch(r, g, m, *geo)
        torch.cuda.synchronize()
    mon.terminate()
    out["clock_power_under_load"] = mon.communicate()[0].split("\n")[2:8]
    print(f"SM clock, power under load: {out['clock_power_under_load']}", flush=True)
    return out


if __name__ == "__main__":
    main()
