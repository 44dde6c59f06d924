#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (icp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --mesh     # phase 16 and phases 4-6 and 12 it
                                     # is held against (on 1-4 cards)

Phases (any failed check ends the run with a non-zero exit code):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from icp_tpu_torch/csrc with nvcc;
  3. hold each kernel against its plain torch version on the card, bit for
     bit: icp_segment_add (ordered_index_add_) against CPU index_add_ at
     the adds the paths make (the submap merge's 30,720 rows into 4,096
     slots, a scan's 768, config #5's 131,072-row keyframe, a 1,024-node
     graph's H, b and per-node blocks, f32 and f64) and its edges (no
     rows, one run, an unsorted index into a non-zero out), one launch a
     call; nn_cuda at the main path's shapes plus ragged and tie cases,
     nn_min_cuda at the six sweep shapes (the IMU main path's, the no-IMU
     path's and loop-closure verification's coarse and fine passes) and
     its edge cases (M = 0, all masked, R = 1, M odd, an unaligned target,
     rows equal to targets, M over one staged tile, d2 above BIG), one
     launch a call; and icp_core with the kernel against icp_core with the
     plain query;
  4. drive the main path: the 200-scan x 720-beam bench sequence through
     SlamEngine (first scan, then batches of 16, finish, sync_map) with
     the kernels' launch counters reset just before; check both counters
     are > 0, the poses and map are finite, and ATE <= 0.050 m;
  5. time a second, warm pass (scans/s) and check it repeats the first bit
     for bit (trajectory and log-odds map); time each kernel against its
     plain version at the paths' shapes (nn_cuda at scan x scan and scan x
     submap capacity, nn_min_cuda at the six sweep shapes), by CUDA events
     around back-to-back calls and by CUDA-graph replays (device time
     only), each shape beside its bound (7 or 6 FP32 instructions a pair
     at the H100's 33.5 T a second, the 67 TFLOP/s peak without FMA, or
     its bytes at 3.35 TB/s if more); and icp_segment_add against CUDA
     index_add_ and CPU index_add_ (its plain version) at phase 3's path
     shapes, beside each one's bytes at 3.35 TB/s;
  6. drive the loop-closure path: the same sequence with bench_suite's
     loop-closure section (first scan, warmup, batches of 16 with rollback
     at accepted closures, finish, sync_map), counters reset just before;
     check >= 1 closure, ATE <= 0.030 m and below phase 4's, finite poses
     and map, and more nn_min_cuda launches than phase 4; then run it again
     and check the two runs bit-equal (trajectory, map, closures);
  7. time PoseGraph2D.optimize through the dense and the PCG solve at
     1024 and 4096 nodes (printed only);
  8. drive the features path: the sequence without IMU and with
     bench_suite's features section (curvature keypoints, descriptors,
     RANSAC; the submap sweep over +-60 degrees), counters reset just
     before; check both counters > 0, >= 190 finite poses, a finite
     non-empty map and ATE <= 0.050 m; print scans/s of a warm pass, the
     kernel launches per scan and the host-to-device copies per feature
     extraction (torch.profiler);
  9. drive loop closure with features.method "both" and IMU (verification
     by rotation search, feature alignment and ICP); check >= 1 closure,
     ATE <= 0.030 m and below phase 4's, and nn_cuda launches > 0;
 10. drive the modular path (tpu.fused: false) with the features section
     on the first 48 scans; check both counters > 0, positions within
     0.01 m of phase 8's over the first 10 poses and submap corrections
     within 1 of phase 8's over the same scans;
 11. icp_large at 100k points in benchmarks/bench_suite.py's configuration
     (its 100k-point world, seed 11; theta 0.04, t (0.4, -0.25); a 160 x
     160 grid, cell and query caps 64, 4096 query cells, 30 iterations),
     point-to-point and point-to-line: check the yaw within 2e-3 rad; print
     ms per alignment (3 warm repetitions), iterations, drops, and each
     dense-grid op's time by CUDA events beside its bound;
 12. the scaled pipeline (ScaledPipeline, BASELINE config #5) at
     benchmarks/bench_scaled.py's full width, 100k-point scans, cut to 400
     of its 1,200 scans, counters reset just before: check 400 poses, >= 1
     closure, >= 1 BA run, both counters > 0, finite poses and map, the map
     clean after optimize(15), and ATE <= 0.15 m after it; print scans/s,
     ATE while streaming, the stats, the wall split, kernel launches per
     loop-closure check and peak device memory; then run it again to the
     scan of its first bundle adjustment (the first closure's) and check
     the trajectory and map there bit-equal to the first run's; then time
     the parts of 12 scaled scans (each step, icp_large and compact_nn
     synchronized).
 13. the file-driven path: the bench sequence's CSVs and a YAML of bench.py's
     configuration with display.live_map on (snapshot_every 50) through
     icp_tpu_torch.cli.main with --map-png, --profile, --save-traj, all
     200 scans at full width, counters reset just before: check both
     counters > 0, the saved trajectory's ATE <= 0.050 m, a map PNG of the
     grid's size, >= 3 snapshots map_NNNNN.png, a Chrome trace, and that
     the CSV went through the native parser; print scans/s (the profiler is
     on: judged by nothing). Needs no matplotlib;
 14. the native CSV parser against the numpy line parser on the whole
     bench file: timestamps and points equal; print both parse times (host
     times) with the host's CPU count;
 15. 3-D ICP: the teapot demo on the card (exit 0, PASS) and
     tests/test_icp.py's 3-D case (418 points in 512 slots, 25 degrees
     about Y): error < 1e-4, R within 2e-2; print iterations, ms an
     alignment and ms a 3 x 3 SVD by CUDA events, and kernel launches an
     iteration; then entry()'s registration step once: finite R, t, error;
 16. the device mesh (parallel/): 4 virtual shards of the one card, or
     min(4, count) real cards. The sharded sweep at the LC shape bit-equal
     to the unsharded one; block paint and replay at config #5's 896 x 880
     grid within 1e-4 of the whole-grid paint; sharded dense, PCG and Schur
     GN steps on a 1024-node chain with closures against their one-shard
     versions (rtol 1e-4 / atol 1e-5); psum and paint times; phase 6's run
     with distributed: true and dist_node_threshold 2 (the same closures,
     Schur reached, ATE <= 0.030 m, positions within 5 mm plus phase 5's
     spread of phase 6's); phase 12's run over the mesh (ATE <= 0.15 m,
     >= 1 closure and BA through schur or dist_cg, positions within 1 cm of
     phase 12's, the gathered map of its shape) and time_gn_step by
     strategy, counters reset before each run; two processes joined by
     init_distributed (gloo on one card, nccl with a card each) through a
     psum, a GN step and a 30-scan pipeline, held to each other and to one
     process; and dryrun_multichip(D).
Phases 11-12, 14-16 run after phase 7 and before phases 8-10, whose
torch.profiler window slows what comes after it; phase 13 (profiled
itself), a profile of 12 scaled scans and the 3-D ICP's launch count come
last.
Phases 3 and 5 also hold the kernels at that run's loop-closure shapes:
nn_cuda at 8192 x 8192 and nn_min_cuda at 983,040 and 98,304 x 8192, each
compared with its plain version in row chunks (the plain version at once
would need 32 GB).
The last two lines are a JSON summary of the kernels and
{"ok": true, "device": {...}}. Imports neither jax nor icp_tpu nor yaml.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_SCANS, N_BEAMS, BATCH = 200, 720, 16
ATE_BOUND_M = 0.050       # icp_tpu scores 0.0416 m on this sequence
LC_ATE_BOUND_M = 0.030    # icp_tpu scores 0.0186 m with loop closure
# an H100 SXM's published peaks: float32 outside the tensor cores, HBM3
PEAK_F32_FLOPS, PEAK_BYTES_S = 67e12, 3.35e12
FLOPS_PER_PAIR = 6        # 2 subtracts, 2 multiplies, 1 add, 1 min
# FP32 instructions a second at the issue rate: the 67 TFLOP/s counts an
# FMA as two flops. The kernels round every operation on its own to stay
# bit-equal to torch, so none fuses: each operation is one instruction.
PEAK_F32_INSTR_S = PEAK_F32_FLOPS / 2
# a (row, target) pair: 2 subtracts, 2 multiplies, 1 add, then nn_min_cuda's
# min, or nn_cuda's argmin compare and select
INSTR_PER_PAIR = {"nn": 7, "nn_min": 6}

# bench.py's configuration (BASELINE config #3: IMU + submap, no loop closure)
BENCH_CFG = {
    "imu": {"enabled": True, "narrow_search_range": 3.0},
    "icp": {"method": "point_to_line", "normal_k": 16, "voxel_size": 0.04,
            "error_threshold": 1e-10, "max_iterations": 150,
            "error_reject_threshold": 0.5},
    "features": {"method": "rotation_search", "rotation_voxel_size": 0.15,
                 "angle_step_coarse": 1.5, "angle_step_fine": 0.1},
    "submap": {"enabled": True, "size": 40, "voxel_size": 0.05,
               "max_corr_dist": 1.5, "rotation_range": 60.0,
               "rotation_step": 0.8, "rotation_fine_step": 0.05,
               "rotation_voxel_size": 0.15},
    "loop_closure": {"enabled": False},
    "filter": {"z_min": 0.5, "z_max": 2.0},
    "mapping": {"resolution": 0.05, "margin": 50.0},
    "service": {"loop": False},
    "display": {"live_map": False},
    "tpu": {"scan_capacity": 768, "submap_capacity": 4096,
            "max_ray_cells": 448, "batch_scans": BATCH, "nn_impl": "auto",
            # one card even where more are visible; phase 16 sets true
            "distributed": False},
}
# benchmarks/bench_suite.py's loop-closure section (its "lc" row)
LC_SECTION = {"enabled": True, "distance_threshold": 3.0, "min_interval": 80,
              "min_cumulative_travel": 6.0, "max_candidates": 5,
              "error_threshold": 0.08, "optimization_iterations": 30,
              "information_scale": 5.0, "cooldown": 30}
# LC verification's rotation_search on scan-capacity clouds: 360 / 1.5 =
# 240 coarse angles and 30 fine angles of 768 rows, against 768 targets
LC_SWEEP_ROWS = (240 * 768, 30 * 768)
# benchmarks/bench_suite.py's features section (its "features" row runs it
# without IMU, submap on, loop closure off)
FEAT_SECTION = {"method": "features", "rotation_voxel_size": 0.15,
                "angle_step_coarse": 1.5, "angle_step_fine": 0.1,
                "voxel_size": 0.1, "k_curvature": 10, "top_n": 100,
                "min_kp_dist": 0.2, "k_descriptor": 16, "ratio_threshold": 0.8,
                "ransac_iterations": 512, "inlier_threshold": 0.3,
                "min_inliers": 4}
FEAT_ATE_BOUND_M = 0.050  # icp_tpu scores 0.0430 m (no IMU, CPU battery)
MODULAR_SCANS = 48        # phase 10's depth (scans after the first)
MIN_POSES = 190           # of the 199 scans after the first
# the scaled pipeline's loop-closure lanes (kf_capacity 8192): rotation
# search over 120 coarse (3 degrees) and 12 fine (0.5 degrees) angles, then
# two ICP passes at 8192 x 8192
KF_CAP = 8192
LC8K_SWEEP_ROWS = (120 * KF_CAP, 12 * KF_CAP)
PLAIN_CHUNK = 32768       # rows a plain-version call at the 8192-target shapes
ICP_LARGE_YAW_TOL = 2e-3  # bench_suite.py's own assertion
SCALED_SCANS = 400        # of bench_scaled.py's 1,200 (icp_tpu's published run)
SCALED_ATE_BOUND_M = 0.15  # icp_tpu's 400-scan run: 0.078 m (BENCHMARKS.md:15)


def log(*a):
    print(*a, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, iters=100, warmup=5):
    """Mean ms per call of fn() over ``iters`` back-to-back calls between
    two CUDA events: where the host launches slower than the device runs,
    the host's launch gaps count."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def sync_ms(fn, devices, iters=20, warmup=3):
    """Mean ms per call of fn() by the host clock over ``iters`` calls,
    every card in ``devices`` synchronized before and after: a call whose
    work spans several cards is timed to its last card's end."""
    cards = [d for d in dict.fromkeys(devices) if d.type == "cuda"]
    for _ in range(warmup):
        fn()
    for d in cards:
        torch.cuda.synchronize(d)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    for d in cards:
        torch.cuda.synchronize(d)
    return 1e3 * (time.perf_counter() - t0) / iters


def graph_ms(fn, calls=20, replays=10):
    """Device-only ms per call of fn(): ``calls`` calls captured in one
    CUDA graph and replayed ``replays`` times between two CUDA events, so
    the host's launch gaps do not count (the device's gaps between the
    graph's kernels do)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(min(3, calls)):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def _cloud(rng, n, lo=-20.0, hi=20.0):
    return rng.uniform(lo, hi, (n, 2)).astype(np.float32)


def nn_cases(rng):
    """(label, src, tgt, mask) cases for nn_cuda: the main path's shapes,
    ties that straddle the kernel's target slices, and the edges of its
    launch geometry (M below one slice, M = 0, N = 1, every cluster size,
    a target that is not 16-byte aligned)."""
    base = rng.uniform(-5, 5, (512, 2)).astype(np.float32)
    cases = [
        # the tie case of bench.py (duplicate targets), random data at both
        # main-path shapes, and a ragged shape
        ("bench tie", rng.uniform(-5, 5, (768, 2)).astype(np.float32),
         np.concatenate([base, base[:256]]), np.arange(768) < 700),
        ("random", _cloud(rng, 768), _cloud(rng, 4096), rng.random(4096) < 0.9),
        ("ragged", _cloud(rng, 700), _cloud(rng, 4000), rng.random(4000) < 0.9),
        ("random", _cloud(rng, 768), _cloud(rng, 768), rng.random(768) < 0.9),
    ]
    # the target set concatenated with a copy of itself: every row's
    # nearest target has a twin in a later slice, and the lower index wins
    for half in (2048, 384, 1000):
        tgt = _cloud(rng, half)
        msk = rng.random(half) < 0.9
        src = _cloud(rng, 768)
        src[:32] = tgt[:32]                         # zero distances
        cases.append(("self-concat", src, np.concatenate([tgt, tgt]),
                      np.concatenate([msk, msk])))
    # all-equal targets: every valid target ties
    for m, frac in ((4096, 0.9), (768, 1.0)):
        cases.append(("all-equal", _cloud(rng, 768),
                      np.tile(np.float32([[1.5, -0.5]]), (m, 1)),
                      rng.random(m) < frac))
    cases += [
        ("M < slice", _cloud(rng, 768), _cloud(rng, 5), np.ones(5, bool)),
        ("M = 0", _cloud(rng, 768), np.zeros((0, 2), np.float32),
         np.zeros(0, bool)),
        ("N = 1", _cloud(rng, 1), _cloud(rng, 4096), rng.random(4096) < 0.9),
        ("misaligned", _cloud(rng, 768), _cloud(rng, 4095),
         rng.random(4095) < 0.9),
    ]
    # 2..7 chunks of 64 targets: clusters of 2..7 blocks, last chunk ragged
    for c in range(2, 8):
        m = 64 * c - 13
        cases.append((f"cluster {c}", _cloud(rng, 100), _cloud(rng, m),
                      rng.random(m) < 0.9))
    return cases


def nn_min_cases(rng, sweep_shapes):
    """(label, rows, tgt, mask) cases for nn_min_cuda: every sweep shape
    (10 % of the targets masked) and the edges of the kernel's staging and
    launch geometry."""
    cases = [(label, _cloud(rng, r), _cloud(rng, m), rng.random(m) < 0.9)
             for label, (r, m) in sweep_shapes.items()]
    same = _cloud(rng, 1792)
    far = (-1e16, 1e16)           # nearest d2 around 1e30, on both sides of BIG
    cases += [
        ("M = 0", _cloud(rng, 300), np.zeros((0, 2), np.float32), np.zeros(0, bool)),
        ("all masked", _cloud(rng, 300), _cloud(rng, 1000), np.zeros(1000, bool)),
        ("R = 1", _cloud(rng, 1), _cloud(rng, 1792), rng.random(1792) < 0.9),
        ("M odd", _cloud(rng, 777), _cloud(rng, 1791), rng.random(1791) < 0.9),
        ("M = 5", _cloud(rng, 500), _cloud(rng, 5), np.ones(5, bool)),
        ("misaligned", _cloud(rng, 2000), _cloud(rng, 1792), rng.random(1792) < 0.9),
        ("rows = targets", same.copy(), same, rng.random(1792) < 0.9),
        ("M = 4096", _cloud(rng, 3000), _cloud(rng, 4096), rng.random(4096) < 0.9),
        ("M = 9000", _cloud(rng, 3000), _cloud(rng, 9000), rng.random(9000) < 0.9),
        ("far, none masked", _cloud(rng, 600, *far), _cloud(rng, 700, *far),
         np.ones(700, bool)),
    ]
    return cases


def lc8k_cases(rng):
    """(key, label, rows, tgt, mask) at the scaled pipeline's loop-closure
    shapes: clouds within +-35 m (the max range), 60 % of the 8192 slots
    valid (a voxelized keyframe fills part of its capacity); the targets
    repeat a block of themselves, so ties cross the kernels' slices."""
    tgt = _cloud(rng, KF_CAP, -35.0, 35.0)
    tgt[6000:] = tgt[:KF_CAP - 6000]
    msk = rng.random(KF_CAP) < 0.6
    cases = [("nn", "LC8k ICP", _cloud(rng, KF_CAP, -35.0, 35.0), tgt, msk)]
    for label, rows in zip(("LC8k coarse", "LC8k fine"), LC8K_SWEEP_ROWS):
        cases.append(("nn_min", label, _cloud(rng, rows, -35.0, 35.0), tgt,
                      msk))
    return cases


def chunked(plain):
    """plain(rows, tgt, mask) taken PLAIN_CHUNK rows at a time: the same
    answer (rows are independent) without the (rows, M) matrix at once."""
    def run(rows, tgt, msk):
        outs = [plain(rows[c0:c0 + PLAIN_CHUNK], tgt, msk)
                for c0 in range(0, rows.shape[0], PLAIN_CHUNK)]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(o) for o in zip(*outs))
        return torch.cat(outs)
    return run


def imu_sweep_rows(cfg, src_cap):
    """Rows of the IMU main path's submap sweep: the coarse pass over
    +-imu_narrow at 0.5 degrees, then _fine_count(0.5, fine step) angles."""
    from icp_tpu_torch.models.prealign import _fine_count

    r = cfg.imu_narrow
    coarse = len(np.arange(-r, r + 0.5, 0.5))
    return coarse * src_cap, _fine_count(0.5, cfg.sub_rot_fine) * src_cap


def no_imu_sweep_rows(cfg, src_cap):
    """Rows of the no-IMU submap sweep's coarse and fine passes: one
    src_cap cloud per angle of +-rotation_range at rotation_step, and
    _fine_count(step, fine step) angles around the best."""
    from icp_tpu_torch.models.prealign import _fine_count

    r, st = cfg.sub_rot_range, cfg.sub_rot_step
    coarse = len(np.arange(-r, r + st, st))
    return coarse * src_cap, _fine_count(st, cfg.sub_rot_fine) * src_cap


def check_kernels(dev, sweep_shapes) -> dict:
    """Phase 3: each kernel against its plain version; returns the max
    absolute d2 error per kernel. ``sweep_shapes``: {label: (rows,
    targets)} of nn_min_cuda's calls on the paths."""
    from icp_tpu_torch.models.icp import icp_core
    from icp_tpu_torch.ops.hopper import nn_kernel as K

    def t(a):
        return torch.as_tensor(a, device=dev)

    rng = np.random.default_rng(3)
    err = {"nn": 0.0, "nn_min": 0.0}

    # nn_cuda: indices equal and d2 bit-equal on every case
    for label, src, tgt, msk in nn_cases(rng):
        s, g, m = t(src), t(tgt), t(msk)
        if label == "misaligned":
            # a contiguous view one row into its storage: not 16-byte
            # aligned, so the kernel stages with scalar loads
            g = t(np.concatenate([tgt[:1], tgt]))[1:]
            assert g.data_ptr() % 16 == 8 and g.is_contiguous()
        d_k, i_k = K.nn_cuda(s, g, m)
        d_p, i_p = K.nn_plain(s, g, m)
        torch.cuda.synchronize()
        shape = f"{src.shape[0]}x{tgt.shape[0]}"
        assert torch.equal(i_k, i_p), f"nn_cuda indices != plain: {label} {shape}"
        assert torch.equal(d_k, d_p), f"nn_cuda d2 not bit-equal to plain: {label} {shape}"
        e = float((d_k - d_p).abs().max()) if d_k.numel() else 0.0
        err["nn"] = max(err["nn"], e)
        log(f"  nn_cuda {label} {shape}: indices equal, d2 bit-equal")

    # nn_min_cuda: bit-equal, one launch a call, at every sweep shape and
    # edge case
    for label, rows, tgt, msk in nn_min_cases(rng, sweep_shapes):
        r, g, m = t(rows), t(tgt), t(msk)
        if label == "misaligned":    # a view one row into its storage
            g = t(np.concatenate([tgt[:1], tgt]))[1:]
            assert g.data_ptr() % 16 == 8 and g.is_contiguous()
        before = K.nn_min_launches
        d_k = K.nn_min_cuda(r, g, m)
        d_p = K.nn_min_plain(r, g, m)
        torch.cuda.synchronize()
        shape = f"{rows.shape[0]}x{tgt.shape[0]}"
        assert K.nn_min_launches == before + 1, f"nn_min_cuda launches: {label} {shape}"
        assert torch.equal(d_k, d_p), f"nn_min_cuda not bit-equal to plain: {label} {shape}"
        if not msk.any():
            assert bool((d_k == np.float32(1e30)).all()), "all-masked rows must be BIG"
        err["nn_min"] = max(err["nn_min"], float((d_k - d_p).abs().max())
                            if d_k.numel() else 0.0)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        log(f"  nn_min_cuda {label} {shape} (geometry k, cluster, slice "
            f"{K.nn_min_geometry(rows.shape[0], tgt.shape[0], sms)}): bit-equal")

    # the scaled pipeline's loop-closure shapes, against the plain version
    # in row chunks
    for key, label, rows, tgt, msk in lc8k_cases(rng):
        r, g, m = t(rows), t(tgt), t(msk)
        kern = K.nn_cuda if key == "nn" else K.nn_min_cuda
        plain = chunked(K.nn_plain if key == "nn" else K.nn_min_plain)
        before = (K.nn_launches, K.nn_min_launches)
        got = kern(r, g, m)
        after = (K.nn_launches, K.nn_min_launches)
        want = plain(r, g, m)
        torch.cuda.synchronize()
        shape = f"{rows.shape[0]}x{tgt.shape[0]}"
        assert sum(after) == sum(before) + 1, f"{key} launches: {label} {shape}"
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for a, b in zip(got, want):
            assert torch.equal(a, b), f"{key} not bit-equal to plain: {label} {shape}"
        err[key] = max(err[key], float((got[0] - want[0]).abs().max()))
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        geo = (f" (geometry k, cluster, slice "
               f"{K.nn_min_geometry(rows.shape[0], tgt.shape[0], sms)})"
               if key == "nn_min" else "")
        log(f"  {'nn_cuda' if key == 'nn' else 'nn_min_cuda'} {label} {shape}"
            f"{geo}: bit-equal to the plain version in row chunks of "
            f"{PLAIN_CHUNK}")

    # icp_core with the kernel ("auto") against the plain query ("xla")
    tgt = rng.uniform(-5, 5, (768, 2)).astype(np.float32)
    th = 0.05
    c, s_ = np.cos(th), np.sin(th)
    src = (tgt - [0.2, -0.1]) @ np.array([[c, -s_], [s_, c]], np.float32)
    m = torch.ones(768, dtype=torch.bool, device=dev)
    eye = torch.eye(2, device=dev)
    z = torch.zeros(2, device=dev)
    kw = dict(method="point_to_point", max_iterations=60, error_threshold=1e-10)
    a = icp_core(t(src.astype(np.float32)), m, t(tgt), m, eye, z, nn_impl="xla", **kw)
    b = icp_core(t(src.astype(np.float32)), m, t(tgt), m, eye, z, nn_impl="auto", **kw)
    assert int(a.iters) == int(b.iters), (int(a.iters), int(b.iters))
    assert torch.allclose(b.R, a.R, atol=1e-6, rtol=0), "icp_core R: kernel != plain"
    assert torch.allclose(b.t, a.t, atol=1e-5, rtol=0), "icp_core t: kernel != plain"
    log(f"  icp_core kernel vs plain query: {int(a.iters)} iterations each, "
        f"|dR| {float((b.R - a.R).abs().max()):.3g}, "
        f"|dt| {float((b.t - a.t).abs().max()):.3g}")
    return err


def reset_counts():
    """Every kernel wrapper's launch counter to 0."""
    from icp_tpu_torch.ops import scatter as SC
    from icp_tpu_torch.ops.hopper import nn_kernel as K

    K.reset_launch_counts()
    SC.reset_launch_counts()


def read_counts() -> dict:
    """{kernel key: launches since reset_counts()}."""
    from icp_tpu_torch.ops import scatter as SC
    from icp_tpu_torch.ops.hopper import nn_kernel as K

    return {"nn": K.nn_launches, "nn_min": K.nn_min_launches,
            "segment_add": SC.segment_add_launches}


def all_launched(counts) -> bool:
    return all(v > 0 for v in counts.values())


def recorded_adds(fn, *modules):
    """Run fn() with every ordered_index_add_ call that ``modules`` make
    recorded: [(out before the add, index, src, sorted_index)]."""
    from icp_tpu_torch.ops import scatter as SC

    calls, real = [], SC.ordered_index_add_

    def rec(out, index, src, *, sorted_index=False):
        calls.append((out.clone(), index.clone(), src.clone(), sorted_index))
        return real(out, index, src, sorted_index=sorted_index)

    for m in modules:
        m.ordered_index_add_ = rec
    try:
        fn()
    finally:
        for m in modules:
            m.ordered_index_add_ = real
    return calls


def segment_cases(scans, gt):
    """(path cases, edge cases), each a list of (label, out, index, src,
    sorted_index) on the CPU for icp_segment_add. The path cases are the
    adds the paths make, recorded from the functions that make them on the
    CPU: the main path's 40-scan submap merge and a scan's voxels, config
    #5's 100k-point keyframe into 8,192 slots, a 1,024-node graph's dense
    H and b (f32 and f64) and the PCG step's per-node blocks. The edges:
    no rows, one run holding every row, an unsorted index into a non-zero
    out."""
    from icp_tpu_torch.models import pose_graph as PG
    from icp_tpu_torch.models.pose_graph import PoseGraph2D, optimize_dense
    from icp_tpu_torch.ops import voxel as V
    from icp_tpu_torch.parallel import dist_pose_graph as DP
    from icp_tpu_torch.utils.masking import pad_points

    cases = []
    ring = []
    for k in range(40):                     # scans placed at their true poses
        c, s_ = np.cos(gt[k, 2]), np.sin(gt[k, 2])
        ring.append(pad_points(scans[k] @ np.array([[c, s_], [-s_, c]])
                               + gt[k, :2], 768))
    rp = torch.as_tensor(np.concatenate([p for p, _ in ring]))
    rm = torch.as_tensor(np.concatenate([m for _, m in ring]))
    (c0,) = recorded_adds(lambda: V.voxel_downsample_fixed(rp, rm, 0.05, 4096), V)
    cases.append(("submap merge 30720 -> 4096", *c0))
    (c1,) = recorded_adds(lambda: V.voxel_downsample(rp[:768], rm[:768], 0.04), V)
    cases.append(("scan voxels 768", *c1))
    scan, _ = next(make_scaled("cpu")[1])      # phase 12's first scan
    kp, km = (torch.as_tensor(a) for a in pad_points(scan, 131072))
    (c2,) = recorded_adds(lambda: V.voxel_downsample_fixed(kp, km, 0.3, KF_CAP), V)
    cases.append(("keyframe 131072 -> 8192", *c2))
    pg = _chain_with_closures(PoseGraph2D("cpu"), 1024, every=16)
    g = pg._packed_device()
    H, b = recorded_adds(lambda: optimize_dense(*g[:7], 0, n_iterations=1,
                                                convergence_eps=0.0), PG)
    cases += [("graph H 1024 nodes (width 1)", *H), ("graph b (width 1)", *b)]
    g64 = [x.double() if x.is_floating_point() else x for x in g]
    H64, _ = recorded_adds(lambda: optimize_dense(*g64[:7], 0, n_iterations=1,
                                                  convergence_eps=0.0), PG)
    cases.append(("graph H f64 (width 1)", *H64))
    cg = recorded_adds(lambda: DP.gn_step_cg(*g[:7], 0, cg_iters=1), DP)
    cases += [("PCG b (width 3)", *cg[0]), ("PCG blocks (width 9)", *cg[1])]
    rng = np.random.default_rng(9)
    edges = [
        ("no rows", torch.zeros((16, 3)), torch.zeros(0, dtype=torch.int64),
         torch.zeros((0, 3)), False),
        ("one run, every row", torch.as_tensor(rng.normal(size=(16, 3)).astype(np.float32)),
         torch.full((30720,), 7, dtype=torch.int64),
         torch.as_tensor(rng.normal(size=(30720, 3)).astype(np.float32)), True),
        ("unsorted into non-zero out",
         torch.as_tensor(rng.normal(size=(4096, 3)).astype(np.float32)),
         torch.as_tensor(rng.integers(0, 4096, 30720)),
         torch.as_tensor((rng.normal(size=(30720, 3))
                          * 10.0 ** rng.uniform(-3, 3, (30720, 3))).astype(np.float32)),
         False)]
    return cases, edges


def check_segment_add(dev, cases) -> float:
    """Phase 3: icp_segment_add against CPU index_add_ on each case, bit
    for bit, one launch a call (none without rows). Returns the max
    absolute error (0.0)."""
    from icp_tpu_torch.ops import scatter as SC

    err = 0.0
    for label, out, index, src, srt in cases:
        want = out.clone().index_add_(0, index, src)
        before = SC.segment_add_launches
        got = SC.ordered_index_add_(out.to(dev), index.to(dev), src.to(dev),
                                    sorted_index=srt)
        torch.cuda.synchronize()
        assert SC.segment_add_launches == before + (index.numel() > 0), label
        assert torch.equal(got.cpu(), want), \
            f"icp_segment_add not bit-equal to CPU index_add_: {label}"
        err = max(err, float((got.cpu() - want).abs().max()) if want.numel() else 0.0)
        log(f"  icp_segment_add {label}: {index.numel()} rows x "
            f"{src[0].numel() if len(src) else src.shape[-1]} into "
            f"{out.shape[0]} slots, {out.dtype}, "
            f"{'sorted' if srt else 'unsorted'}: bit-equal to CPU index_add_")
    return err


def segment_bound(out, index, src):
    """(bound_ms, "bytes") of one ordered scatter-sum on this data: each
    index and source value read once, each touched slot read and written
    once, at PEAK_BYTES_S (one add a source value: never the bound)."""
    width = src[0].numel()
    touched = int(torch.unique(index).numel())
    b = (index.numel() * 8 + src.numel() * src.element_size()
         + 2 * touched * width * out.element_size())
    return 1e3 * b / PEAK_BYTES_S, "bytes"


def time_segment_add(dev, cases, card) -> dict:
    """Phase 5: icp_segment_add (through ordered_index_add_, as the paths
    call it: the sort included where the index is unsorted) against CUDA
    index_add_ (the library call: same sums, in no fixed order) at the
    recorded shapes, by CUDA events and CUDA-graph replays, in turns; the
    plain version (CPU index_add_) by the host clock; each beside its
    bytes bound."""
    from icp_tpu_torch.ops import scatter as SC

    timings = {}
    for label, out, index, src, srt in cases:
        o, i, s = out.to(dev), index.to(dev), src.to(dev)
        kern = lambda: SC.ordered_index_add_(o, i, s, sorted_index=srt)  # noqa: E731
        lib = lambda: o.index_add_(0, i, s)  # noqa: E731
        bound_ms, bound_by = segment_bound(out, index, src)
        fig = {"bound_ms": bound_ms, "bound_by": bound_by,
               "rows": index.numel(), "slots": out.shape[0],
               "width": src[0].numel(), "dtype": str(out.dtype).split(".")[-1]}
        for measure, timer in (("", time_ms), ("device_", graph_ms)):
            l1, k1, k2, l2 = timer(lib), timer(kern), timer(kern), timer(lib)
            fig[f"{measure}ms"] = (k1 + k2) / 2
            fig[f"library_{measure}ms"] = (l1 + l2) / 2
        oc = out.clone()
        t0 = time.perf_counter()
        for _ in range(10):
            oc.index_add_(0, index, src)
        fig["plain_ms"] = 1e3 * (time.perf_counter() - t0) / 10
        fig["bound_share"] = bound_ms / fig["device_ms"]
        log(f"icp_segment_add {label}: kernel {1e3 * fig['ms']:.2f} us (events) / "
            f"{1e3 * fig['device_ms']:.2f} us (device only), CUDA index_add_ "
            f"{1e3 * fig['library_ms']:.2f} / {1e3 * fig['library_device_ms']:.2f} us, "
            f"plain (CPU index_add_, host clock) {1e3 * fig['plain_ms']:.1f} us; "
            f"bound {1e3 * bound_ms:.3f} us ({bound_by}), device time "
            f"{100 * fig['bound_share']:.1f} % of it, on {card}")
        timings[label] = fig
    return timings


def kernel_bound(key, n, m):
    """(bound_ms, bound_by) of one call at n rows x m targets: the larger of
    INSTR_PER_PAIR FP32 instructions a pair at PEAK_F32_INSTR_S and its
    bytes (inputs read once, outputs written once) at PEAK_BYTES_S."""
    out_bytes = 8 if key == "nn" else 4
    ops_ms = 1e3 * INSTR_PER_PAIR[key] * n * m / PEAK_F32_INSTR_S
    bytes_ms = 1e3 * (8 * n + 9 * m + out_bytes * n) / PEAK_BYTES_S
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def time_kernels(dev, scan_cap, submap_cap, sweep_shapes, card) -> dict:
    """Each kernel against its plain version at the paths' shapes (nn_cuda
    at scan x scan and scan x submap capacity and at the scaled pipeline's
    8192 x 8192, nn_min_cuda at each of ``sweep_shapes`` and at 983,040 and
    98,304 x 8192), in turns (plain, kernel, kernel, plain) by both
    measures: CUDA events around back-to-back calls (100; 5 at the 8192
    shapes, where the plain version runs in row chunks; the host's launch
    gaps count) and CUDA-graph replays (device only), beside the shape's
    bound and the device time's share of it. Returns {key: {shape:
    figures}}."""
    from icp_tpu_torch.ops.hopper import nn_kernel as K

    rng = np.random.default_rng(7)

    def t(a):
        return torch.as_tensor(a, device=dev)

    s = t(_cloud(rng, scan_cap))
    small = ({}, {})                 # the timers' default counts
    runs = [("nn", K.nn_cuda, K.nn_plain, (s, t(_cloud(rng, m)),
                                           t(rng.random(m) < 0.9)), small)
            for m in (scan_cap, submap_cap)]
    runs += [("nn_min", K.nn_min_cuda, K.nn_min_plain,
              (t(_cloud(rng, r)), t(_cloud(rng, m)), t(rng.random(m) < 0.9)),
              small)
             for r, m in sweep_shapes.values()]
    # the scaled pipeline's loop-closure shapes: fewer calls (the plain
    # version takes ~0.1 s a call there), the plain version in row chunks
    big = (dict(iters=5, warmup=1), dict(calls=2, replays=2))
    runs += [(key, K.nn_cuda if key == "nn" else K.nn_min_cuda,
              chunked(K.nn_plain if key == "nn" else K.nn_min_plain),
              (t(rows), t(tgt), t(msk)), big)
             for key, _, rows, tgt, msk in lc8k_cases(rng)]
    timings = {}
    for key, kern, plain, args, counts in runs:
        n, m = args[0].shape[0], args[1].shape[0]
        shape = f"{n}x{m}"
        bound_ms, bound_by = kernel_bound(key, n, m)
        fig = {"bound_ms": bound_ms, "bound_by": bound_by}
        for measure, timer, kw in (("", time_ms, counts[0]),
                                   ("device_", graph_ms, counts[1])):
            p1 = timer(lambda: plain(*args), **kw)
            k1 = timer(lambda: kern(*args), **kw)
            k2 = timer(lambda: kern(*args), **kw)
            p2 = timer(lambda: plain(*args), **kw)
            fig[f"{measure}ms"] = (k1 + k2) / 2
            fig[f"plain_{measure}ms"] = (p1 + p2) / 2
            log(f"{key} at {shape}, {'device only (CUDA graph)' if measure else 'CUDA events'}: "
                f"kernel {1e3 * fig[f'{measure}ms']:.2f} us, plain "
                f"{1e3 * fig[f'plain_{measure}ms']:.2f} us (runs {k1 * 1e3:.2f}/"
                f"{k2 * 1e3:.2f} vs {p1 * 1e3:.2f}/{p2 * 1e3:.2f}) on {card}")
        fig["bound_share"] = bound_ms / fig["device_ms"]
        log(f"{key} at {shape}: bound {1e3 * bound_ms:.2f} us ({bound_by}), "
            f"device time {100 * fig['bound_share']:.1f} % of it on {card}")
        timings.setdefault(key, {})[shape] = fig
    return timings


def load_sequence(td):
    from icp_tpu_torch.engine import filter_and_flatten
    from icp_tpu_torch.services.imu import IMUService
    from icp_tpu_torch.services.lidar import LidarService
    from icp_tpu_torch.utils.synth import generate_sequence

    lidar_csv = os.path.join(td, "bench_lidar.csv")
    imu_csv = os.path.join(td, "bench_imu.csv")
    gt = generate_sequence(lidar_csv, imu_csv, n_scans=N_SCANS,
                           n_beams=N_BEAMS, noise=0.005, trajectory="loop",
                           seed=42)
    scans, rels = [], []
    for _, rel, raw in LidarService(lidar_csv).scans():
        scans.append(filter_and_flatten(raw, BENCH_CFG["filter"]["z_min"],
                                        BENCH_CFG["filter"]["z_max"]))
        rels.append(rel)
    return gt, scans, rels, IMUService(imu_csv)


def run_engine(cfg, imu, scans, rels, dev, warmup=False, probe=None):
    """A path as a user drives it; returns (engine, seconds). ``probe(eng)``
    runs after each batch."""
    from icp_tpu_torch.engine import SlamEngine

    eng = SlamEngine(cfg, imu=imu, verbose=False, device=dev)
    t0 = time.perf_counter()
    eng.process_scan(scans[0], rels[0])
    if warmup:
        eng.warmup()
    for k in range(1, len(scans), BATCH):
        eng.process_scans_batched(scans[k:k + BATCH], rels[k:k + BATCH])
        if probe is not None:
            probe(eng)
    eng.finish()
    eng.sync_map()
    torch.cuda.synchronize()
    return eng, time.perf_counter() - t0


def _chain_with_closures(pg, n, every=None):
    """tests/test_pose_graph.py's noisy circular chain (radius 5 m) with
    its three closures scaled to n nodes; ``every``: also a closure from
    each every-th node to the one ``every`` nodes on."""
    rng = np.random.default_rng(1)
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    true = np.stack([np.cos(ang) * 5, np.sin(ang) * 5,
                     (ang + np.pi / 2 + np.pi) % (2 * np.pi) - np.pi], 1)

    def rel(a, b):
        ca, sa = np.cos(a[2]), np.sin(a[2])
        d = b[:2] - a[:2]
        return np.array([ca * d[0] + sa * d[1], -sa * d[0] + ca * d[1],
                         (b[2] - a[2] + np.pi) % (2 * np.pi) - np.pi])
    for k in range(n):
        noise = rng.normal(scale=0.05, size=3) * [1, 1, 0.2] if k else 0
        pg.add_node(true[k] + noise)
    for k in range(1, n):
        pg.add_edge(k - 1, k, rel(true[k - 1], true[k]), np.eye(3))
    for i, j in ((0, n // 2), (10 * n // 96, 60 * n // 96),
                 (20 * n // 96, 80 * n // 96)):
        pg.add_edge(i, j, rel(true[i], true[j]), np.eye(3) * 50.0)
    for i in range(0, n, every) if every else ():
        j = (i + every) % n
        pg.add_edge(i, j, rel(true[i], true[j]), np.eye(3) * 50.0)
    return pg


def time_pose_graph(dev, card) -> dict:
    """Phase 7: one PoseGraph2D.optimize (30 iterations) per solve and
    size, forced through the dense or the PCG route by the node threshold.
    Printed only: the data for the 2000-node switch."""
    from icp_tpu_torch.models.pose_graph import PoseGraph2D

    _chain_with_closures(PoseGraph2D(dev), 256).optimize(n_iterations=2)
    out = {}
    for n in (1024, 4096):
        nodes = {}
        for strategy in ("dense", "cg"):
            pg = _chain_with_closures(PoseGraph2D(dev), n)
            pg._cg_node_threshold = 10**9 if strategy == "dense" else 2
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pg.optimize(n_iterations=30)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            assert pg.last_strategy == strategy, pg.last_strategy
            nodes[strategy] = np.stack(pg.nodes)
            out[f"{strategy}_{n}"] = ms
            log(f"pose graph {n} nodes, {strategy}: optimize {ms:.1f} ms "
                f"(30 iterations max), chi2 {pg.total_error():.4g} on {card}")
        gap = float(np.abs(nodes["dense"][:, :2] - nodes["cg"][:, :2]).max())
        log(f"pose graph {n} nodes: max |dense - cg| position {gap:.3g} m")
    return out


def profile_counts(fn, n):
    """{launches, h2d, d2h} per call of fn() over n calls: kernel launches
    and host-to-device / device-to-host copies, from torch.profiler's CUDA
    runtime and memcpy events; None for a count the profiler did not
    record."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    launches = sum(nm.startswith(("cudaLaunchKernel", "cuLaunchKernel"))
                   for nm in names)
    copies = any(nm.startswith("cudaMemcpy") for nm in names)
    h2d = sum("HtoD" in nm for nm in names)
    d2h = sum("DtoH" in nm for nm in names)
    return {"launches": launches / n if launches else None,
            "h2d": h2d / n if (h2d or copies) else None,
            "d2h": d2h / n if (d2h or copies) else None}


def features_phases(SlamConfig, ate, dev, card, gt, scans, rels, imu,
                    ate_m) -> dict:
    """Phases 8-10: the features path, loop closure with "both", and the
    modular path. Returns the kernels' launch counts per path."""
    from icp_tpu_torch.engine import _pad_fixed
    from icp_tpu_torch.models.features import extract_features

    n_steps = len(scans) - 1
    launches = {}

    # ── 8. the features path (no IMU) ────────────────────────────────────
    feat_dict = dict(BENCH_CFG, imu={"enabled": False}, features=FEAT_SECTION)
    feat_cfg = SlamConfig.from_dict(feat_dict)
    # (scans bookkept, submap corrections) after each batch: phase 10
    # reads the corrections over its first MODULAR_SCANS scans
    progress = []
    reset_counts()
    eng_f, wall_f = run_engine(
        feat_cfg, None, scans, rels, dev,
        probe=lambda e: progress.append((e.stats.scans,
                                         e.stats.submap_corrections)))
    launches["features"] = read_counts()
    traj_f = np.stack(eng_f.pose_trajectory)
    lo_f = eng_f.mapper.log_odds
    ate_f = ate(traj_f[:, :2, 2], gt, indices=eng_f.pose_scan_indices)
    lf = launches["features"]
    log(f"features path: {len(traj_f)} poses, "
        f"{eng_f.stats.submap_corrections} submap corrections, "
        f"{eng_f.stats.rejected} rejected, {eng_f.stats.icp_iters} ICP "
        f"iterations, {wall_f:.2f} s cold; launches {lf}, per scan "
        f"nn {lf['nn'] / n_steps:.2f} nn_min {lf['nn_min'] / n_steps:.2f}; "
        f"sweep caps {eng_f._sweep_caps}, dropped voxels "
        f"{eng_f.stats.sweep_dropped_voxels}; on {card}")
    log(f"features ATE {ate_f:.4f} m over {len(traj_f)} poses (bound "
        f"{FEAT_ATE_BOUND_M} m; IMU path {ate_m:.4f} m)")
    assert all_launched(lf), lf
    assert np.isfinite(traj_f).all(), "non-finite pose (features)"
    assert len(traj_f) >= MIN_POSES, f"only {len(traj_f)} poses (features)"
    assert bool(torch.isfinite(lo_f).all()), "non-finite map (features)"
    assert int((lo_f != 0).sum()) > 0, "empty map (features)"
    assert ate_f <= FEAT_ATE_BOUND_M, \
        f"features ATE {ate_f:.4f} m > {FEAT_ATE_BOUND_M} m"

    _, wall_f2 = run_engine(feat_cfg, None, scans, rels, dev)
    log(f"features scans/s (warm pass): {n_steps / wall_f2:.2f} "
        f"({wall_f2:.2f} s; cold pass {n_steps / wall_f:.2f}) on {card}")
    kw = {k: FEAT_SECTION[k] for k in ("k_curvature", "top_n", "min_kp_dist",
                                       "k_descriptor")}
    kw["voxel_size"] = FEAT_SECTION["voxel_size"]
    p, m = (torch.as_tensor(a, device=dev)
            for a in _pad_fixed(scans[1], feat_cfg.scan_capacity))
    extract_ms = time_ms(lambda: extract_features(p, m, **kw), iters=20)
    log(f"feature extraction (one per scan on this path): {extract_ms:.3f} ms "
        f"by CUDA events on {card}")

    # ── 9. loop closure with features.method "both" (IMU on) ─────────────
    both_cfg = SlamConfig.from_dict(dict(
        BENCH_CFG, loop_closure=LC_SECTION,
        features=dict(FEAT_SECTION, method="both")))
    both_cfg.num_scans = len(scans)
    reset_counts()
    eng_b, wall_b = run_engine(both_cfg, imu, scans, rels, dev, warmup=True)
    launches["lc_both"] = read_counts()
    s = eng_b.stats
    traj_b = np.stack(eng_b.pose_trajectory)
    ate_b = ate(traj_b[:, :2, 2], gt, indices=eng_b.pose_scan_indices)
    log(f"loop closure with 'both': loop_closures={s.loop_closures} "
        f"lc_checks={s.lc_checks} lc_pairs={s.lc_pairs} "
        f"lc_requeued_scans={s.lc_requeued_scans} "
        f"wall_lc_verify={s.wall_lc_verify:.3f} s "
        f"wall_loop_closure={s.wall_loop_closure:.3f} s; "
        f"{n_steps / wall_b:.2f} scans/s ({wall_b:.2f} s, warmup included) "
        f"on {card}; launches {launches['lc_both']}")
    log(f"'both' loop-closure ATE {ate_b:.4f} m over {len(traj_b)} poses "
        f"(bound {LC_ATE_BOUND_M} m; without loop closure {ate_m:.4f} m)")
    assert s.loop_closures >= 1, "no loop closure accepted ('both')"
    assert np.isfinite(traj_b).all(), "non-finite pose ('both')"
    assert ate_b <= LC_ATE_BOUND_M, f"'both' ATE {ate_b:.4f} m > {LC_ATE_BOUND_M} m"
    assert ate_b < ate_m, f"'both' ATE {ate_b:.4f} m >= no-LC ATE {ate_m:.4f} m"
    assert launches["lc_both"]["nn"] > 0 and launches["lc_both"]["segment_add"] > 0, \
        launches["lc_both"]

    # ── 10. the modular path (tpu.fused: false), features, cut depth ─────
    mod_cfg = SlamConfig.from_dict(dict(
        feat_dict, tpu=dict(BENCH_CFG["tpu"], fused=False)))
    n_mod = MODULAR_SCANS + 1
    reset_counts()
    eng_m, wall_m = run_engine(mod_cfg, None, scans[:n_mod], rels[:n_mod], dev)
    launches["modular"] = read_counts()
    traj_m = np.stack(eng_m.pose_trajectory)
    gap = float(np.abs(traj_m[:10, :2, 2] - traj_f[:10, :2, 2]).max())
    sub_f = dict(progress).get(MODULAR_SCANS)
    log(f"modular path: {len(traj_m)} poses over {MODULAR_SCANS} scans, "
        f"{eng_m.stats.submap_corrections} submap corrections (fused path "
        f"over the same scans: {sub_f}), {n_mod - 1} scans in {wall_m:.2f} s "
        f"({(n_mod - 1) / wall_m:.2f} scans/s) on {card}; max |position - "
        f"fused| over the first 10 poses {gap:.4g} m; launches "
        f"{launches['modular']}")
    assert eng_m._state is None, "the modular run built a fused state"
    assert all_launched(launches["modular"]), launches["modular"]
    assert np.isfinite(traj_m).all(), "non-finite pose (modular)"
    assert gap <= 0.01, f"modular vs fused positions {gap:.4g} m > 0.01 m"
    assert sub_f is not None and abs(eng_m.stats.submap_corrections - sub_f) <= 1, \
        (eng_m.stats.submap_corrections, sub_f)

    # profiled last: passes run after a torch.profiler window are slower
    # (phase 9's pass: 9.96 against 15.83 scans/s on an H100 80GB HBM3)
    counts = profile_counts(lambda: extract_features(p, m, **kw), 5)
    log(f"feature extraction, per call: {counts['launches']} kernel "
        f"launches, {counts['h2d']} host-to-device and {counts['d2h']} "
        f"device-to-host copies (torch.profiler) on {card}")
    return launches


def _large_world(n_points=100_000, seed=11):
    """benchmarks/bench_suite.py's 100k-point world: random wall segments in
    a 200 m arena (a copy: benchmarks/ is not imported here)."""
    rng = np.random.default_rng(seed)
    n_walls = 200
    starts = rng.uniform(-100, 100, (n_walls, 2))
    horiz = rng.integers(0, 2, n_walls).astype(bool)
    lengths = rng.uniform(10, 30, n_walls)
    per = n_points // n_walls
    pts = []
    for s, h, L in zip(starts, horiz, lengths):
        t = rng.uniform(0, L, per)
        pts.append(np.stack([s[0] + np.where(h, t, 0.0),
                             s[1] + np.where(h, 0.0, t)], axis=1))
    cloud = np.concatenate(pts).astype(np.float32)
    cloud += rng.normal(scale=0.02, size=cloud.shape).astype(np.float32)
    return cloud


def compact_nn_bound(cq, grid):
    """(bound_ms, bound_by, pairs) of one compact_nn call on this data: 6
    flops for each (valid query, valid target of its 3x3 cells) pair, and
    the bytes it must move: each valid query's x, y read and its d2, idx,
    x, y written, each valid target of a cell next to an occupied query
    cell read once (x, y, idx), each occupied row's cell read."""
    cnt = grid.mask.sum(-1)                          # (Cy+2, Cx+2)
    Cy, Cx = cnt.shape[0] - 2, cnt.shape[1] - 2
    rows = cq.cell_mask
    cy = cq.cell_yx[rows, 0].long()
    cx = cq.cell_yx[rows, 1].long()
    nq = cq.mask[rows].sum(1)
    used = torch.zeros_like(cnt, dtype=torch.bool)
    nt = torch.zeros_like(nq)
    for dy in range(3):
        for dx in range(3):
            used[cy + dy, cx + dx] = True
            nt = nt + cnt[cy + dy, cx + dx]
    pairs = int((nq * nt).sum())
    n_q = int(nq.sum())
    n_bytes = 24 * n_q + 12 * int(cnt[used].sum()) + 8 * int(rows.sum())
    ops_ms = 1e3 * FLOPS_PER_PAIR * pairs / PEAK_F32_FLOPS
    bytes_ms = 1e3 * n_bytes / PEAK_BYTES_S
    assert Cy > 0 and Cx > 0
    return ((ops_ms, "operations", pairs) if ops_ms >= bytes_ms
            else (bytes_ms, "bytes", pairs))


def grid_op_bounds(grid, cq, n_points):
    """Bytes bounds (ms) of the other dense-grid ops, which sort and move
    data: each input read once and each output written once at
    PEAK_BYTES_S. build_dense_grid reads n points (x, y, mask) and writes
    the padded grid's x, y, idx and mask planes; bin_queries reads n
    queries and writes the compact planes, cell_yx and cell_mask;
    cell_normals reads the grid's x, y and mask planes and writes nx, ny
    and valid per cell."""
    slots = grid.x.numel()
    cy, cx = grid.x.shape[0] - 2, grid.x.shape[1] - 2
    qslots = cq.x.numel()
    by = {"build_dense_grid": 9 * n_points + 13 * slots,
          "bin_queries": 9 * n_points + 13 * qslots + 9 * cq.cell_mask.numel(),
          "cell_normals": 9 * slots + 9 * cy * cx}
    return {k: 1e3 * v / PEAK_BYTES_S for k, v in by.items()}


def icp_large_phase(dev, card, n_points=100_000) -> dict:
    """Phase 11: icp_large at 100k points, bench_suite's configuration."""
    from icp_tpu_torch.models.icp import _row_bound, icp_large
    from icp_tpu_torch.ops import densegrid as DG
    from icp_tpu_torch.utils.masking import pad_points

    base = _large_world(n_points)
    th = 0.04
    c, s = np.cos(th), np.sin(th)
    R_true = np.array([[c, -s], [s, c]], np.float32)
    t_true = np.array([0.4, -0.25], np.float32)
    src = (base - t_true) @ R_true
    cap = 131072
    sp, sm, tp, tm = (torch.as_tensor(a, device=dev)
                      for a in (*pad_points(src, cap), *pad_points(base, cap)))
    eye = torch.eye(2, device=dev)
    zero = torch.zeros(2, device=dev)
    kw = dict(max_corr_dist=1.0, max_iterations=30, error_threshold=0.0,
              grid_shape=(160, 160), cap=64, qcap=64, qcells=4096)
    out = {}
    for method in ("point_to_point", "point_to_line"):
        res = icp_large(sp, sm, tp, tm, eye, zero, method=method, **kw)
        got = float(torch.atan2(res.R[1, 0], res.R[0, 0]))
        assert abs(got - th) < ICP_LARGE_YAW_TOL, (method, got)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            res = icp_large(sp, sm, tp, tm, eye, zero, method=method, **kw)
            float(res.error)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / 3
        # each dense-grid op at the recovered pose, by CUDA events
        cell = torch.tensor(1.5, device=dev)
        origin = DG.grid_origin(tp, tm, cell)
        grid = DG.build_dense_grid(tp, tm, cell, origin, grid_shape=(160, 160),
                                   cap=64)
        moved = sp @ res.R.T + res.t
        cq = DG.bin_queries(moved, sm, origin, cell, grid_shape=(160, 160),
                            qcells=4096, qcap=64)
        rows = _row_bound(int(cq.cell_mask.sum()), 4096)
        ops = {
            "build_dense_grid": lambda: DG.build_dense_grid(
                tp, tm, cell, origin, grid_shape=(160, 160), cap=64),
            "bin_queries": lambda: DG.bin_queries(
                moved, sm, origin, cell, grid_shape=(160, 160), qcells=4096,
                qcap=64),
            "compact_nn": lambda: DG.compact_nn(cq, grid, rows),
        }
        if method == "point_to_line":
            ops["cell_normals"] = lambda: DG.cell_normals(grid)
        op_ms = {name: time_ms(fn, iters=20, warmup=2) for name, fn in ops.items()}
        bound_ms, bound_by, pairs = compact_nn_bound(cq, grid)
        op_bound = {"compact_nn": bound_ms, **grid_op_bounds(grid, cq, cap)}
        fig = {"ms": ms, "iters": int(res.iters), "dropped": int(res.dropped),
               "yaw": got, "op_ms": op_ms, "op_bound_ms": op_bound,
               "compact_nn_rows": rows,
               "compact_nn_pairs": pairs, "compact_nn_bound_ms": bound_ms,
               "compact_nn_bound_by": bound_by,
               "occupied_rows": int(cq.cell_mask.sum()),
               "valid_queries": int(cq.mask.sum())}
        out[method] = fig
        log(f"icp_large 100k {method}: {ms:.2f} ms an alignment (3 warm "
            f"repetitions, host clock to synchronize), {fig['iters']} "
            f"iterations, {fig['dropped']} dropped, yaw {got:.5f} (true {th}) "
            f"on {card}")
        log(f"  ops by CUDA events (bound, share): " + ", ".join(
            f"{k} {v:.3f} ms ({1e3 * op_bound[k]:.2f} us, "
            f"{100 * op_bound[k] / v:.2f} %)" for k, v in op_ms.items())
            + f"; compact_nn over {rows} of 4096 rows ({fig['occupied_rows']} "
            f"occupied, {fig['valid_queries']} valid queries, {pairs} pairs): "
            f"bound {1e3 * bound_ms:.2f} us ({bound_by}), "
            f"{100 * bound_ms / op_ms['compact_nn']:.2f} % of it")
    return out


def make_scaled(dev, n_scans=SCALED_SCANS, n_points=100_000):
    """The scaled pipeline at benchmarks/bench_scaled.py's configuration,
    every capacity unchanged, and its scan stream as the bench makes it."""
    from icp_tpu_torch.parallel.scaled import ScaledPipeline
    from icp_tpu_torch.utils.synth import large_scan_stream

    cap = 1 << int(np.ceil(np.log2(n_points)))
    pipe = ScaledPipeline(
        dev, scan_capacity=cap, extent=100.0, map_resolution=0.25,
        map_margin=10.0, max_range=35.0, icp_max_corr=1.0,
        icp_max_iterations=30, icp_method="point_to_line",
        icp_grid_shape=(160, 160), icp_cell_cap=64, icp_qcells=8192,
        map_ray_stride=8, kf_capacity=KF_CAP, kf_voxel=0.3,
        submap_keyframes=8, lc_every=8, lc_min_interval=max(50, n_scans // 10),
        lc_distance=15.0, lc_min_travel=60.0, lc_error_threshold=0.05,
        lc_max_candidates=4, ba_every=1, lc_info_cap=1e3, lc_robust=True,
        lc_cooldown=25, ba_iterations=10, replay_chunk=64,
        dist_node_threshold=2)
    stream = large_scan_stream(n_scans, n_points=n_points, extent=100.0,
                               max_range=35.0, noise=0.02, seed=3,
                               trajectory="loop")
    return pipe, stream


def run_scaled(dev, n_scans=SCALED_SCANS, n_points=100_000, probe=None,
               stop=None):
    """Drive the scaled pipeline over the stream as bench_scaled.py does.
    ``probe(k, pipe)`` runs after step k; ``stop``: end after that step.
    Returns (pipeline, ground truth, scans/s after 3 warm scans)."""
    pipe, stream = make_scaled(dev, n_scans, n_points)
    pipe.warm_replay()
    gt = []
    warm, t0 = 3, None
    for k, (scan, g) in enumerate(stream):
        gt.append(g)
        pipe.step(scan)
        if probe is not None:
            probe(k, pipe)
        if k + 1 == warm:          # as bench_scaled.py starts its clock
            pipe.log_odds[:1, :1].cpu()
            t0 = time.perf_counter()
        if k == stop:
            break
    pipe.finish()
    pipe.log_odds[:1, :1].cpu()
    return pipe, np.stack(gt), (len(gt) - warm) / (time.perf_counter() - t0)


def scaled_breakdown(dev, card, n_scans=24, window=12) -> dict:
    """Where a scaled scan's time goes: the first n_scans of the stream,
    each step timed by the host clock ending in synchronize(), each
    icp_large call likewise, and each compact_nn call by CUDA events
    (launch gaps included), over the last ``window`` scans."""
    import icp_tpu_torch.ops.densegrid as DG
    import icp_tpu_torch.parallel.scaled as SC

    real_icp, real_nn = SC.icp_large, DG.compact_nn
    rec = {"icp": [], "nn": []}

    def icp_timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_icp(*a, **k)
        torch.cuda.synchronize()
        rec["icp"].append(time.perf_counter() - t0)
        return out

    def nn_timed(cq, grid, rows=None):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = real_nn(cq, grid, rows)
        ev[1].record()
        rec["last"] = (cq, grid)
        rec["nn"].append((ev, rows, len(rec["icp"])))   # scan = that + 1
        return out

    SC.icp_large, DG.compact_nn = icp_timed, nn_timed
    try:
        pipe, stream = make_scaled(dev, n_scans)
        gen, step = [], []
        for k in range(n_scans):
            t0 = time.perf_counter()
            scan, _ = next(stream)
            t1 = time.perf_counter()
            pipe.step(scan)
            torch.cuda.synchronize()
            gen.append(t1 - t0)
            step.append(time.perf_counter() - t1)
    finally:
        SC.icp_large, DG.compact_nn = real_icp, real_nn
    torch.cuda.synchronize()
    first = n_scans - window               # the window's first scan index
    icp_ms = 1e3 * float(np.mean(rec["icp"][first - 1:]))   # scan 0 has none
    nn = [(e[0].elapsed_time(e[1]), rows) for e, rows, i in rec["nn"]
          if i + 1 >= first]               # calls inside the window's scans
    nn_per_scan = len(nn) / window
    nn_ms = float(np.mean([m for m, _ in nn]))
    step_ms = 1e3 * float(np.mean(step[first:]))
    gen_ms = 1e3 * float(np.mean(gen[first:]))
    nn_bound, nn_by, pairs = compact_nn_bound(*rec["last"])
    out = {"step_ms": step_ms, "gen_ms": gen_ms, "icp_large_ms": icp_ms,
           "compact_nn_bound_ms": nn_bound, "compact_nn_bound_by": nn_by,
           "compact_nn_pairs": pairs,
           "compact_nn_ms": nn_ms, "compact_nn_calls_per_scan": nn_per_scan,
           "compact_nn_rows": float(np.mean([r for _, r in nn])),
           "icp_share": icp_ms / step_ms,
           "compact_nn_share": nn_ms * nn_per_scan / step_ms}
    log(f"scaled scan breakdown (scans {first}-{n_scans - 1}, synchronized "
        f"after each step): step {step_ms:.2f} ms + scan generation "
        f"{gen_ms:.2f} ms on the host; icp_large {icp_ms:.2f} ms "
        f"({100 * out['icp_share']:.1f} % of the step); compact_nn "
        f"{nn_ms:.3f} ms a call by CUDA events x {nn_per_scan:.1f} calls "
        f"({100 * out['compact_nn_share']:.1f} % of the step), "
        f"{out['compact_nn_rows']:.0f} rows a call; the last call's bound "
        f"{1e3 * nn_bound:.2f} us ({nn_by}, {pairs} pairs), "
        f"{100 * nn_bound / nn_ms:.2f} % of the mean call, on {card}")

    return out


def scaled_profile(dev, card, n_scans=24, window=12) -> dict:
    """Device kernel time of the scans scaled_breakdown times, by
    torch.profiler on a fresh pipeline (run last: a profiler window slows
    what comes after it)."""
    from torch.profiler import ProfilerActivity, profile

    first = n_scans - window
    out = {}
    pipe, stream = make_scaled(dev, n_scans)
    scans = [next(stream)[0] for _ in range(n_scans)]
    for sc in scans[:first]:
        pipe.step(sc)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for sc in scans[first:]:
            pipe.step(sc)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the device's kernel events (not the ops that launched them)
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    out["profiled_wall_ms"] = 1e3 * wall / window
    out["device_ms"] = sum(by_name.values()) / 1e3 / window
    log(f"scaled scans {first}-{n_scans - 1} profiled: "
        f"{out['profiled_wall_ms']:.2f} ms a step (profiler on), device "
        f"kernel time {out['device_ms']:.2f} ms a step "
        f"({100 * out['device_ms'] / out['profiled_wall_ms']:.1f} % busy) on "
        f"{card}; top kernels a step: " + "; ".join(
            f"{name[:60]} {us / 1e3 / window:.3f} ms" for name, us in top))
    return out


def scaled_phase(dev, card) -> dict:
    """Phase 12: the scaled pipeline at full width, 400 scans."""
    from icp_tpu_torch.utils.metrics import ate

    # the state right after the first bundle adjustment (the first
    # closure's), for the second run to be held to
    first = {}

    def probe(k, p):
        if not first and p.stats.ba_runs >= 1:
            first.update(k=k, closures=p.stats.loop_closures,
                         traj=np.stack(p.trajectory),
                         lo=p.log_odds.cpu().clone())

    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    pipe, gt, sps = run_scaled(dev, probe=probe)
    ate_stream = ate(np.stack(pipe.trajectory), gt, gt_offset=0)
    pipe.optimize(n_iterations=15)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    traj = np.stack(pipe.trajectory)
    ate_ba = ate(traj, gt, gt_offset=0)
    st = pipe.stats
    peak = torch.cuda.max_memory_allocated(dev)
    checks = max(st.lc_checked, 1)
    log(f"scaled pipeline: {len(traj)} poses, {sps:.2f} scans/s after 3 warm "
        f"scans (host scan generation inside, as bench_scaled.py), "
        f"{wall:.1f} s for the phase, on {card}")
    log(f"  ATE {ate_stream:.4f} m streaming -> {ate_ba:.4f} m after the "
        f"terminal BA (bound {SCALED_ATE_BOUND_M} m); loop_closures="
        f"{st.loop_closures} lc_checked={st.lc_checked} lc_candidates="
        f"{st.lc_candidates} ba_runs={st.ba_runs} gate_fallbacks="
        f"{st.gate_fallbacks} reg_dropped_points={st.reg_dropped_points} "
        f"replayed_keyframes={st.replayed_keyframes} icp_iters={st.icp_iters}")
    log(f"  wall: registration {st.wall_registration:.2f} s, lc "
        f"{st.wall_lc:.2f} s, ba {st.wall_ba:.2f} s, replay "
        f"{st.wall_replay:.2f} s (fill {st.wall_replay_fill:.2f} s); "
        f"launches {launches}, per loop-closure check nn "
        f"{launches['nn'] / checks:.1f} nn_min {launches['nn_min'] / checks:.1f}; "
        f"peak device memory {peak / 2**30:.2f} GiB; grid {pipe.ny}x{pipe.nx}")
    lo = pipe.log_odds
    assert len(traj) == SCALED_SCANS, f"{len(traj)} poses"
    assert np.isfinite(traj).all(), "non-finite pose (scaled)"
    assert bool(torch.isfinite(lo).all()), "non-finite map (scaled)"
    assert int((lo != 0).sum()) > 0, "empty map (scaled)"
    assert st.loop_closures >= 1, "no loop closure accepted (scaled)"
    assert st.ba_runs >= 1, "no bundle adjustment (scaled)"
    assert not pipe._map_dirty, "map still dirty after optimize (scaled)"
    assert all_launched(launches), launches
    assert ate_ba <= SCALED_ATE_BOUND_M, \
        f"scaled ATE {ate_ba:.4f} m > {SCALED_ATE_BOUND_M} m"

    # the same run again, cut after the scan of its first bundle adjustment
    assert first, "no bundle adjustment while streaming (scaled)"
    t0 = time.perf_counter()
    again, _, _ = run_scaled(dev, stop=first["k"])
    traj2, lo2 = np.stack(again.trajectory), again.log_odds
    same = (traj2.shape == first["traj"].shape
            and np.array_equal(traj2, first["traj"])
            and torch.equal(lo2.cpu(), first["lo"]))
    log(f"  second run, cut to scans 0-{first['k']} (the first bundle "
        f"adjustment, after {first['closures']} closure(s)) in "
        f"{time.perf_counter() - t0:.1f} s: trajectory and map bit-equal to "
        f"the first run's there: {same}; max |pose diff| "
        f"{float(np.abs(traj2 - first['traj']).max()) if traj2.shape == first['traj'].shape else 'n/a'}")
    assert again.stats.ba_runs == 1 and again.stats.loop_closures == first["closures"]
    assert same, "scaled pipeline: the second run differs from the first"
    return {"launches": launches, "sps": sps, "ate_stream": ate_stream,
            "ate": ate_ba, "peak_bytes": peak, "traj": traj,
            "map_shape": tuple(lo.shape),
            "stats": {k: v for k, v in st.__dict__.items()}}


def file_driven_phase(dev, card, td, gt, n_steps) -> dict:
    """Phase 13: the CLI over the bench CSVs in ``td``, live map, map PNG
    and profiler on. Returns the kernels' launch counts."""
    import yaml                # the CLI reads its config with it

    import icp_tpu_torch.engine as E
    from icp_tpu_torch import cli
    from icp_tpu_torch.utils.metrics import ate

    out = os.path.join(td, "file_driven")
    live, prof_dir = os.path.join(out, "live"), os.path.join(out, "profile")
    os.makedirs(out)
    cfg = dict(
        BENCH_CFG, data_file=os.path.join(td, "bench_lidar.csv"),
        imu=dict(BENCH_CFG["imu"], file=os.path.join(td, "bench_imu.csv")),
        display={"live_map": True, "snapshot_every": 50, "snapshot_dir": live},
        output={"csv": os.path.join(out, "map.csv"),
                "npy": os.path.join(out, "map.npy")})
    yaml_path = os.path.join(out, "bench.yaml")
    with open(yaml_path, "w") as f:
        yaml.safe_dump(cfg, f)
    png, npy = os.path.join(out, "map.png"), os.path.join(out, "traj.npy")

    # the CLI returns nothing: keep the engine its run_slam call returns
    seen = {}
    real_run = E.run_slam

    def recording_run(*a, **k):
        res = real_run(*a, **k)
        seen["engine"] = res[3]
        return res

    E.run_slam = recording_run
    reset_counts()
    t0 = time.perf_counter()
    try:
        cli.main(["--config", yaml_path, "--device", str(dev), "--quiet",
                  "--map-png", png, "--profile", prof_dir, "--save-traj", npy])
    finally:
        E.run_slam = real_run
    wall = time.perf_counter() - t0
    launches = read_counts()
    eng = seen["engine"]
    traj = np.load(npy)
    ate_f = ate(traj[:, :2, 2], gt, indices=eng.pose_scan_indices)
    data = open(png, "rb").read()
    size = (int.from_bytes(data[16:20], "big"), int.from_bytes(data[20:24], "big"))
    snaps = sorted(x for x in (os.listdir(live) if os.path.isdir(live) else [])
                   if x.startswith("map_") and x.endswith(".png"))
    traces = [os.path.join(prof_dir, x) for x in os.listdir(prof_dir)]
    log(f"file-driven path (cli, live map, --map-png, --profile): "
        f"{len(traj)} poses, {eng.stats.rejected} rejected, ATE {ate_f:.4f} m "
        f"(bound {ATE_BOUND_M} m); {n_steps / wall:.2f} scans/s with the "
        f"profiler on and the trace's export inside ({wall:.2f} s) on {card}; "
        f"launches {launches}; map PNG {size[0]}x{size[1]}, snapshots {snaps}, "
        f"trace {sum(os.path.getsize(t) for t in traces) / 2**20:.1f} MiB; "
        f"lidar parser {eng.lidar_parser}; matplotlib imported: "
        f"{'matplotlib' in sys.modules}")
    assert all_launched(launches), launches
    assert np.isfinite(traj).all() and len(traj) >= MIN_POSES, len(traj)
    assert ate_f <= ATE_BOUND_M, f"file-driven ATE {ate_f:.4f} m > {ATE_BOUND_M} m"
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "map PNG signature"
    assert size == (eng.mapper.nx, eng.mapper.ny), (size, eng.mapper.nx, eng.mapper.ny)
    assert len(snaps) >= 3, snaps
    assert traces and all(os.path.getsize(t) > 0 for t in traces), traces
    assert eng.lidar_parser == "native", eng.lidar_parser
    assert eng._live_view is None, "phase 13 opened a window"
    return launches


def parser_phase(lidar_csv) -> dict:
    """Phase 14: the native parser against the numpy line parser on the
    whole bench file. The times are the host's, not the card's."""
    from icp_tpu_torch.runtime.loader import load_lidar_csv
    from icp_tpu_torch.services.lidar import parse_lidar_line

    def numpy_parse():
        with open(lidar_csv) as f:
            return [parse_lidar_line(line) for line in f if line.strip()]

    times = {"native": [], "numpy": []}
    for _ in range(3):
        for name, fn in (("native", lambda: load_lidar_csv(lidar_csv)),
                         ("numpy", numpy_parse)):
            t0 = time.perf_counter()
            scans = fn()
            times[name].append(1e3 * (time.perf_counter() - t0))
            times[name + "_scans"] = scans
    a, b = times.pop("native_scans"), times.pop("numpy_scans")
    assert len(a) == len(b) == N_SCANS, (len(a), len(b))
    for (ts_a, pts_a), (ts_b, pts_b) in zip(a, b):
        assert ts_a == ts_b, (ts_a, ts_b)
        assert pts_a.dtype == pts_b.dtype and np.array_equal(pts_a, pts_b), \
            "native parser != numpy parser"
    mib = os.path.getsize(lidar_csv) / 2**20
    log(f"lidar CSV parse ({len(a)} scans, {sum(len(p) for _, p in a)} points, "
        f"{mib:.1f} MiB), scans, timestamps and points equal; HOST times, 3 "
        f"runs each on a host of {os.cpu_count()} CPUs: native "
        f"{'/'.join(f'{t:.1f}' for t in times['native'])} ms, numpy "
        f"{'/'.join(f'{t:.1f}' for t in times['numpy'])} ms")
    return times


def icp3d_phase(dev, card, td):
    """Phase 15: the teapot demo and tests/test_icp.py's 3-D case on the
    card, then entry()'s step. Returns (alignment, iterations icp_core
    computed: whole chunks) for the launch count taken at the end."""
    from icp_tpu_torch.demos import teapot_icp_demo
    from icp_tpu_torch.models.icp import _CHUNK, icp, identity_init
    from icp_tpu_torch.ops.hopper import nn_kernel as K
    from icp_tpu_torch.tools.entry import entry
    from icp_tpu_torch.utils.masking import pad_points

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = teapot_icp_demo.main(["--device", str(dev), "-o",
                                   os.path.join(td, "teapot_alignment.png")])
    for line in buf.getvalue().splitlines():
        log(f"  teapot demo: {line}")
    assert rc == 0 and "PASS" in buf.getvalue(), "teapot demo failed"

    rng = np.random.default_rng(4)
    target = rng.uniform(-1.5, 1.5, size=(418, 3)).astype(np.float32)
    target[:, 2] *= 0.5
    th = np.deg2rad(25.0)
    R_true = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                       [-np.sin(th), 0, np.cos(th)]], np.float32)
    source = (target - np.float32([0.3, -0.2, 0.25])) @ R_true
    sp, sm, tp, tm = (torch.as_tensor(a, device=dev) for a in (
        *pad_points(source, 512), *pad_points(target, 512)))
    eye, zero = identity_init(3, dev)

    def align():
        return icp(sp, sm, tp, tm, eye, zero, voxel_size=0.005,
                   method="point_to_point", max_iterations=300,
                   error_threshold=1e-12)

    reset_counts()
    res = align()
    err, iters = float(res.error), int(res.iters)
    gap = float((res.R.cpu() - torch.as_tensor(R_true)).abs().max())
    assert K.nn_launches == 0 and K.nn_min_launches == 0, "a 2-D kernel ran at D = 3"
    assert np.isfinite(err) and err < 1e-4, f"3-D ICP error {err}"
    assert gap < 2e-2, f"3-D ICP |R - R_true| {gap}"
    ms = time_ms(align, iters=5, warmup=1)
    W = torch.as_tensor(rng.normal(size=(3, 3)).astype(np.float32), device=dev)
    svd_ms = time_ms(lambda: torch.linalg.svd(W), iters=50)
    log(f"3-D ICP (418 points in 512 slots, 25 degrees about Y): {iters} "
        f"iterations, error {err:.3e}, |R - R_true| {gap:.3g}; {ms:.2f} ms an "
        f"alignment and {svd_ms:.3f} ms a 3 x 3 torch.linalg.svd by CUDA "
        f"events (host launch gaps inside) on {card}")

    fn, args = entry(dev)
    R, t, e = fn(*args)
    assert bool(torch.isfinite(R).all() and torch.isfinite(t).all()
                and torch.isfinite(e)), "entry(): non-finite R, t or error"
    yaw = float(torch.atan2(R[1, 0], R[0, 0]))
    log(f"entry() registration step on the card: yaw {yaw:.4f} (true 0.3), "
        f"|t| {float(t.norm()):.3g}, error {float(e):.3g}")
    assert abs(yaw - 0.3) < 1e-2, yaw
    return align, -(-iters // _CHUNK) * _CHUNK


# tests/test_multiprocess_dist.py's 30-scan pipeline, through the port
PIPE_KW = dict(scan_capacity=1536, extent=10.0, map_resolution=0.25,
               map_margin=4.0, max_range=9.0, icp_max_corr=1.5,
               icp_max_iterations=25, icp_grid_shape=(32, 32),
               icp_cell_cap=64, icp_qcells=1024, kf_capacity=1024,
               kf_voxel=0.2, lc_every=2, lc_min_interval=16, lc_distance=3.0,
               lc_min_travel=8.0, lc_error_threshold=0.08,
               dist_node_threshold=2)

MP_WORKER = r"""
import json, os, sys
import numpy as np
import torch
from icp_tpu_torch.parallel.dist_pose_graph import gn_step_sharded
from icp_tpu_torch.parallel.mesh import init_distributed, make_mesh
from icp_tpu_torch.parallel.scaled import ScaledPipeline
from icp_tpu_torch.utils.synth import large_scan_stream, make_dense_world

rank, world = int(os.environ["MP_RANK"]), int(os.environ["MP_WORLD"])
assert init_distributed(os.environ["MP_COORD"], world, rank,
                        backend=os.environ["MP_BACKEND"])
mesh = make_mesh(world, device="cuda")      # one shard a process
assert mesh.size == world and mesh.local_size == 1, mesh
dev = mesh.devices[0]
local = torch.arange(8.0, device=dev) + 100.0 * rank
psum = float(mesh.psum([local.sum()])[0])
rng = np.random.default_rng(7)
n = 16
nodes = np.cumsum(rng.normal(scale=0.1, size=(n, 3)), 0).astype(np.float32)
ei = np.concatenate([np.arange(n - 1), [n - 1]])
ej = np.concatenate([np.arange(1, n), [0]])
z = rng.normal(scale=0.05, size=(n, 3)).astype(np.float32)
om = np.broadcast_to(np.eye(3, dtype=np.float32), (n, 3, 3)).copy()
t = lambda a: torch.as_tensor(a, device=dev)
ones = torch.ones(n, dtype=torch.bool, device=dev)
gn = gn_step_sharded(mesh, t(nodes), ones, t(ei), t(ej), t(z), t(om), ones, 0)
world = make_dense_world(np.random.default_rng(0), n_points=120_000,
                         extent=10.0, n_walls=60)
pipe = ScaledPipeline(mesh, **json.loads(os.environ["MP_KW"]))
for scan, _ in large_scan_stream(30, n_points=1536, extent=10.0, max_range=9.0,
                                 noise=0.01, seed=1, world_points=world):
    pipe.step(scan)
pipe.optimize(n_iterations=10)
prob = pipe.map_probability()
np.savez(os.environ["MP_OUT"], gn=gn.cpu().numpy(),
         traj=np.stack([m[:2, 2] for m in pipe.trajectory]), prob=prob)
print("MP_OK", rank, psum, pipe.stats.scans, pipe.stats.ba_runs,
      pipe.pose_graph.last_strategy, flush=True)
torch.distributed.destroy_process_group()
"""


def two_process_check(dev, card, td) -> dict:
    """Two processes joined by init_distributed: gloo over CUDA tensors
    (host-staged) where the ranks share one card, NCCL where each rank has
    its own. Both run test_multiprocess_dist.py's psum and GN step and its
    30-scan ScaledPipeline (grid one block a process, Schur BA across the
    processes); both must exit 0 and agree with each other and with a
    one-process run (ATE under 1e-3 m)."""
    import socket

    from icp_tpu_torch.parallel.dist_pose_graph import gn_step_sharded
    from icp_tpu_torch.parallel.mesh import make_mesh, set_virtual_devices
    from icp_tpu_torch.parallel.scaled import ScaledPipeline
    from icp_tpu_torch.utils.synth import large_scan_stream, make_dense_world

    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = os.path.join(td, "mp_worker.py")
    with open(script, "w") as f:
        f.write(MP_WORKER)
    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = []
    for rank in (0, 1):
        env = dict(os.environ, PYTHONPATH=repo, MP_RANK=str(rank), MP_WORLD="2",
                   OMP_NUM_THREADS="2",
                   MP_COORD=f"127.0.0.1:{port}", MP_BACKEND=backend,
                   MP_KW=json.dumps(PIPE_KW),
                   MP_OUT=os.path.join(td, f"mp{rank}.npz"))
        procs.append(subprocess.Popen([sys.executable, script], env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for rank, (p, (so, se)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} exit {p.returncode}: {se[-2000:]}"
        assert f"MP_OK {rank} 856.0 30" in so, so
    r0, r1 = (np.load(os.path.join(td, f"mp{k}.npz")) for k in (0, 1))
    for key in ("gn", "traj", "prob"):
        assert np.array_equal(r0[key], r1[key]), f"ranks disagree on {key}"

    # the same in one process: a 2-shard virtual mesh for the GN step, one
    # device for the pipeline
    rng = np.random.default_rng(7)
    n = 16
    nodes = np.cumsum(rng.normal(scale=0.1, size=(n, 3)), 0).astype(np.float32)
    ei = np.concatenate([np.arange(n - 1), [n - 1]])
    ej = np.concatenate([np.arange(1, n), [0]])
    z = rng.normal(scale=0.05, size=(n, 3)).astype(np.float32)
    om = np.broadcast_to(np.eye(3, dtype=np.float32), (n, 3, 3)).copy()
    set_virtual_devices(2, dev)
    mesh2 = make_mesh(2, device="cuda")
    set_virtual_devices(0, dev)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    gn = gn_step_sharded(mesh2, t(nodes), ones, t(ei), t(ej), t(z), t(om),
                         ones, 0).cpu().numpy()
    gn_gap = float(np.abs(gn - r0["gn"]).max())
    world = make_dense_world(np.random.default_rng(0), n_points=120_000,
                             extent=10.0, n_walls=60)
    pipe = ScaledPipeline(dev, **PIPE_KW)
    for scan, _ in large_scan_stream(30, n_points=1536, extent=10.0,
                                     max_range=9.0, noise=0.01, seed=1,
                                     world_points=world):
        pipe.step(scan)
    pipe.optimize(n_iterations=10)
    want = np.stack([m[:2, 2] for m in pipe.trajectory])
    traj = r0["traj"]
    assert traj.shape == want.shape, (traj.shape, want.shape)
    mp_ate = float(np.sqrt(np.mean(np.sum((traj - want) ** 2, axis=1))))
    log(f"two processes ({backend}, {'one card' if backend == 'gloo' else 'a card each'}): "
        f"psum 856.0 on both ranks, GN step equal on both and within "
        f"{gn_gap:.3g} of one process's 2-shard mesh; 30-scan ScaledPipeline "
        f"equal on both ranks, {mp_ate:.3g} m ATE against one process "
        f"(bound 1e-3 m); {wall:.1f} s for the two processes on {card}")
    assert gn_gap <= 1e-5, gn_gap
    assert mp_ate < 1e-3, f"2-process vs 1-process ATE {mp_ate:.5f} m"
    return {"backend": backend, "ate": mp_ate, "gn_gap": gn_gap, "wall": wall}


def mesh_phase(dev, card, td, base) -> dict:
    """Phase 16: the device mesh. ``base`` holds phase 5's single-device
    pose spread, phase 6's engine and phase 12's pipeline. With one card,
    4 virtual shards of it; with 2 or more, min(4, count) real cards.
    Returns the kernels' launch counts of the engine and the scaled
    pipeline on the mesh."""
    from icp_tpu_torch.models.pose_graph import PoseGraph2D, optimize_dense
    from icp_tpu_torch.ops.raytrace import (raytrace_update,
                                            raytrace_update_batched)
    from icp_tpu_torch.ops.sweep import sweep_scores
    from icp_tpu_torch.parallel import dist_pose_graph as DP
    from icp_tpu_torch.parallel import sharded_grid as SG
    from icp_tpu_torch.parallel.mesh import make_mesh, set_virtual_devices
    from icp_tpu_torch.parallel.sweep_shard import sweep_scores_sharded
    from icp_tpu_torch.tools.entry import dryrun_multichip
    from icp_tpu_torch.utils.config import SlamConfig
    from icp_tpu_torch.utils.metrics import ate

    t_phase = time.perf_counter()
    count = torch.cuda.device_count()
    virtual = count < 2
    if virtual:
        set_virtual_devices(4, dev)
    mesh = make_mesh(4 if virtual else min(4, count), device="cuda")
    D = mesh.size
    log(f"mesh phase: {'4 virtual shards of one card' if virtual else f'{D} real cards'} "
        f"({mesh}); card {card}")
    rng = np.random.default_rng(16)

    def c(a, dt=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

    # the sharded sweep at the LC sweep shape, bit for bit
    src, tgt = c(_cloud(rng, 768, -9, 9)), c(_cloud(rng, 768, -9, 9))
    m = torch.ones(768, dtype=torch.bool, device=dev)
    angles, toff = c(np.deg2rad(np.arange(240) * 1.5 - 180.0)), c([0.3, -0.2])
    got = sweep_scores_sharded(mesh, src, m, tgt, m, angles, toff)
    want = sweep_scores(src, m, tgt, m, angles, toff)
    torch.cuda.synchronize()
    assert torch.equal(got.to(dev), want), "sharded sweep != unsharded"
    log(f"  sweep_scores_sharded, 240 angles x 768 rows vs 768 targets on "
        f"{D} shards: bit-equal to sweep_scores")

    # block paint and replay at config #5's grid, an 8192-point keyframe
    ny, nx, max_steps = 896, 880, 192
    ang = rng.uniform(-np.pi, np.pi, 8192)
    rad = rng.uniform(2.0, 35.0, 8192) / 0.25
    origin = np.array([440, 448])
    hits = c(np.stack([origin[0] + rad * np.cos(ang),
                       origin[1] + rad * np.sin(ang)], 1), torch.int64)
    ok = c(rng.random(8192) > 0.05, torch.bool)
    o = c(origin, torch.int64)
    kw = dict(max_steps=max_steps, ray_cells=hits[::8], ray_valid=ok[::8])
    blocks = SG.raytrace_update_block_sharded(
        mesh, SG.block_sharding(mesh, torch.zeros((ny, nx), device=dev)),
        o, hits, ok, 0.85, -0.4, -np.inf, np.inf, **kw)
    whole = raytrace_update(torch.zeros((ny, nx), device=dev), o, hits, ok,
                            0.85, -0.4, -np.inf, np.inf, **kw)
    paint_gap = float((mesh.all_gather(blocks).to(dev) - whole).abs().max())
    B = 4
    bo = c(np.tile(origin, (B, 1)) + rng.integers(-20, 20, (B, 2)), torch.int64)
    bh = torch.stack([hits + c(rng.integers(-20, 20, 2), torch.int64)
                      for _ in range(B)])
    bok = ok.expand(B, -1)
    bkw = dict(max_steps=max_steps, ray_cells=bh[:, ::8], ray_valid=bok[:, ::8])
    blocks = SG.raytrace_replay_block_sharded(
        mesh, SG.block_sharding(mesh, torch.zeros((ny, nx), device=dev)),
        bo, bh, bok, 0.85, -0.4, -np.inf, np.inf, **bkw)
    whole_b = raytrace_update_batched(torch.zeros((ny, nx), device=dev), bo,
                                      bh, bok, 0.85, -0.4, -np.inf, np.inf,
                                      **bkw)
    replay_gap = float((mesh.all_gather(blocks).to(dev) - whole_b).abs().max())
    grids = SG.block_sharding(mesh, torch.zeros((ny, nx), device=dev))
    g1 = torch.zeros((ny, nx), device=dev)
    paint_ms = sync_ms(lambda: SG.raytrace_update_block_sharded(
        mesh, grids, o, hits, ok, 0.85, -0.4, -np.inf, np.inf, **kw),
        mesh.devices)
    whole_ms = sync_ms(lambda: raytrace_update(
        g1, o, hits, ok, 0.85, -0.4, -np.inf, np.inf, **kw), [dev])
    log(f"  block paint {ny}x{nx}, 8192 hits, 1024 rays: max |blocks - whole "
        f"grid| {paint_gap:.3g}, replay of {B}: {replay_gap:.3g} (atol 1e-4); "
        f"{paint_ms:.3f} ms on {D} shards against {whole_ms:.3f} ms whole "
        f"(host clock, every card synchronized) on {card}")
    assert paint_gap <= 1e-4 and replay_gap <= 1e-4, (paint_gap, replay_gap)

    # dense, PCG and Schur GN steps on a 1024-node chain with closures: the
    # three long ones of phase 7 and one every 16 nodes. With the long ones
    # alone the f32 dense step is itself ~5e-4 m from a float64 step (an
    # ill-conditioned H), too far for the rtol 1e-4 / atol 1e-5 check
    pg = _chain_with_closures(PoseGraph2D(dev), 1024, every=16)
    nodes, nm, ei, ej, z, om, em, rb = pg._packed_device()
    dense, _ = optimize_dense(nodes, nm, ei, ej, z, om, em, 0,
                              n_iterations=1, convergence_eps=0.0)
    step_d = DP.gn_step_sharded(mesh, nodes, nm, ei, ej, z, om, em, 0)
    step_c = DP.gn_step_cg_sharded(mesh, nodes, nm, ei, ej, z, om, em, 0,
                                   cg_iters=50)
    one_c = DP.gn_step_cg(nodes, nm, ei, ej, z, om, em, 0, cg_iters=50)
    np_ = lambda x: x.cpu().numpy()  # noqa: E731
    part = DP.partition_graph(nodes.shape[0], *(np_(x) for x in
                                                (ei, ej, z, om, em)), D, 0)
    step_s = DP.gn_step_schur_sharded(mesh, nodes, nm, part)
    f64, _ = optimize_dense(nodes.double(), nm, ei, ej, z.double(),
                            om.double(), em, 0, n_iterations=1,
                            convergence_eps=0.0)
    f64 = f64.float()
    gaps = {"dense": float((step_d - dense).abs().max()),
            "pcg": float((step_c - one_c).abs().max()),
            "schur": float((step_s - dense).abs().max()),
            "dense_f64": float((dense - f64).abs().max()),
            "schur_f64": float((step_s - f64).abs().max())}
    log(f"  GN steps on 1024 nodes ({int(part.sep_valid.sum())} separators): "
        f"max |sharded dense - dense| {gaps['dense']:.3g}, |sharded PCG - "
        f"one-shard PCG| {gaps['pcg']:.3g}, |Schur - dense| {gaps['schur']:.3g}; "
        f"against a float64 dense step: f32 dense {gaps['dense_f64']:.3g}, "
        f"Schur {gaps['schur_f64']:.3g}")
    assert torch.allclose(step_d, dense, rtol=1e-4, atol=1e-5), gaps
    assert torch.allclose(step_s, dense, rtol=1e-4, atol=1e-5), gaps
    assert torch.allclose(step_c, one_c, rtol=0, atol=1e-4), gaps
    Hs = [torch.randn(3 * 1024, 3 * 1024, device=d) for d in mesh.devices]
    psum_ms = sync_ms(lambda: mesh.psum(Hs), mesh.devices)
    log(f"  psum of {D} dense 3072x3072 f32 partials: {psum_ms:.3f} ms "
        f"(host clock, every card synchronized) on {card}")

    # the main path on the mesh: counters reset just before
    reset_counts()
    lc_dict = dict(BENCH_CFG, loop_closure=LC_SECTION,
                   tpu=dict(BENCH_CFG["tpu"], distributed=True,
                            dist_node_threshold=2))
    lc_cfg = SlamConfig.from_dict(lc_dict)
    lc_cfg.num_scans = len(base["scans"])
    eng, wall_e = run_engine(lc_cfg, base["imu"], base["scans"], base["rels"],
                             dev, warmup=True)
    launches_e = read_counts()
    s = eng.stats
    traj = np.stack(eng.pose_trajectory)
    ate_e = ate(traj[:, :2, 2], base["gt"], indices=eng.pose_scan_indices)
    ref = base["eng_lc"]
    closures = lambda e: sorted((i, j) for i, j in zip(  # noqa: E731
        e.pose_graph._edges_i, e.pose_graph._edges_j) if abs(i - j) != 1)
    ref_traj = np.stack(ref.pose_trajectory)
    assert traj.shape == ref_traj.shape, (traj.shape, ref_traj.shape)
    gap_e = float(np.linalg.norm(traj[:, :2, 2] - ref_traj[:, :2, 2],
                                 axis=1).max())
    bound_e = 5e-3 + base["spread"]
    log(f"  engine on the mesh (phase 6's loop closure, distributed: true, "
        f"dist_node_threshold 2): loop_closures={s.loop_closures} "
        f"closures {closures(eng)} (phase 6: {closures(ref)}), "
        f"last_strategy {eng.pose_graph.last_strategy}, lc_pairs={s.lc_pairs} "
        f"lc_groups={s.lc_groups} wall_lc_verify={s.wall_lc_verify:.3f} s "
        f"wall_lc_apply={s.wall_lc_apply:.3f} s; ATE {ate_e:.4f} m (bound "
        f"{LC_ATE_BOUND_M} m), max |mesh - phase 6| position {1e3 * gap_e:.3f} mm "
        f"(bound 5 mm + the single-device spread {1e3 * base['spread']:.3f} mm); "
        f"{(len(base['scans']) - 1) / wall_e:.2f} scans/s; launches {launches_e} "
        f"on {card}")
    assert eng.mesh is not None and eng.mesh.size == D, eng.mesh
    assert eng.pose_graph.last_strategy.startswith("schur"), \
        eng.pose_graph.last_strategy
    assert s.loop_closures >= 1 and closures(eng) == closures(ref), \
        (closures(eng), closures(ref))
    assert ate_e <= LC_ATE_BOUND_M, f"mesh engine ATE {ate_e:.4f} m"
    assert gap_e <= bound_e, f"mesh engine {gap_e:.5f} m from phase 6"

    # config #5 on the mesh at full width, 400 scans
    reset_counts()
    t0 = time.perf_counter()
    pipe, gt, sps = run_scaled(mesh)
    ate_stream = ate(np.stack(pipe.trajectory), gt, gt_offset=0)
    pipe.optimize(n_iterations=15)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches_s = read_counts()
    st = pipe.stats
    straj = np.stack(pipe.trajectory)
    ate_s = ate(straj, gt, gt_offset=0)
    gap_s = float(np.linalg.norm(straj[:, :2, 2] - base["scaled_traj"][:, :2, 2],
                                 axis=1).max())
    grid = pipe.log_odds
    log(f"  scaled pipeline on the mesh: {len(straj)} poses, {sps:.2f} scans/s "
        f"after 3 warm scans, {wall_s:.1f} s; ATE {ate_stream:.4f} m streaming "
        f"-> {ate_s:.4f} m after BA (bound {SCALED_ATE_BOUND_M} m); "
        f"loop_closures={st.loop_closures} ba_runs={st.ba_runs} "
        f"last_strategy {pipe.pose_graph.last_strategy}; wall_ba "
        f"{st.wall_ba:.3f} s, wall_replay {st.wall_replay:.3f} s, wall_lc "
        f"{st.wall_lc:.3f} s; max |mesh - phase 12| position "
        f"{1e3 * gap_s:.3f} mm (bound 10 mm); map {tuple(grid.shape)} "
        f"(phase 12 {base['scaled_shape']}) in {len(pipe.blocks)} blocks; "
        f"launches {launches_s} on {card}")
    assert len(straj) == SCALED_SCANS and np.isfinite(straj).all()
    assert ate_s <= SCALED_ATE_BOUND_M, f"mesh scaled ATE {ate_s:.4f} m"
    assert st.loop_closures >= 1 and st.ba_runs >= 1, st
    assert pipe.pose_graph.last_strategy.split("+")[0] in ("schur", "dist_cg"), \
        pipe.pose_graph.last_strategy
    assert gap_s <= 1e-2, f"mesh scaled {gap_s:.5f} m from phase 12"
    assert tuple(grid.shape) == base["scaled_shape"], grid.shape
    assert bool(torch.isfinite(grid).all()) and not pipe._map_dirty
    gn = {}
    for strategy in ("schur", "cg"):
        if strategy == "cg":
            limit, pipe.pose_graph._max_separators = \
                pipe.pose_graph._max_separators, 0
        gn[strategy] = 1e3 * pipe.time_gn_step(reps=5)
        assert pipe.gn_step_strategy == strategy, pipe.gn_step_strategy
    pipe.pose_graph._max_separators = limit
    log(f"  time_gn_step on the {pipe.pose_graph.n_nodes}-node graph, D = {D}: "
        f"schur {gn['schur']:.2f} ms, cg {gn['cg']:.2f} ms a step "
        f"(partition {1e3 * st.partition_wall:.2f} ms, host) on {card}")
    assert all_launched(launches_e) and all_launched(launches_s), \
        (launches_e, launches_s)
    if virtual:
        set_virtual_devices(0, dev)

    mp = two_process_check(dev, card, td)
    t0 = time.perf_counter()
    if virtual:
        set_virtual_devices(D, dev)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dryrun_multichip(D, device="cuda")
    if virtual:
        set_virtual_devices(0, dev)
    log(f"  {buf.getvalue().strip()} ({time.perf_counter() - t0:.1f} s)")
    wall = time.perf_counter() - t_phase
    log(f"mesh phase: {wall:.1f} s on {card}")
    return {"engine": launches_e, "scaled": launches_s, "mp": mp, "gn_ms": gn,
            "wall": wall, "D": D, "virtual": virtual}


def main():
    mesh_only = sys.argv[1:] == ["--mesh"]
    if sys.argv[1:] and not mesh_only:
        sys.exit("usage: python3 chip_smoke.py [--mesh]")
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "smoke test needs a CUDA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    with tempfile.TemporaryDirectory() as td:
        run(td, mesh_only)


def run(td, mesh_only=False):
    """Every phase, or with ``mesh_only`` phase 16 and the phases it is
    held against (4-6 without the kernel timings, 12); ``td`` holds the
    bench CSVs and what phase 13 writes."""
    from icp_tpu_torch.engine import SlamEngine
    from icp_tpu_torch.ops.hopper import build
    from icp_tpu_torch.utils.config import SlamConfig
    from icp_tpu_torch.utils.metrics import ate

    dev = torch.device("cuda:0")
    card = gpu_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # ── 2. build ─────────────────────────────────────────────────────────
    t0 = time.perf_counter()
    build.load_all()                 # one nvcc a source, all at once
    log(f"kernel build+load ({', '.join(build.SOURCES)}): "
        f"{time.perf_counter() - t0:.2f} s (nvcc "
        f"{build.build_seconds if build.build_seconds is not None else 'cached'})")
    for name, text in build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"  ptxas ({name}): {line.strip()}")

    # ── 3. kernels against their plain versions ──────────────────────────
    gt, scans, rels, imu = load_sequence(td)
    log(f"sequence: {len(scans)} scans, mean "
        f"{np.mean([len(s) for s in scans]):.0f} points")
    cfg = SlamConfig.from_dict(BENCH_CFG)
    # the sweep caps every path sizes from the first scan
    probe_eng = SlamEngine(cfg, verbose=False, device=dev)
    probe_eng._resolve_sweep_caps(scans[0])
    src_cap, tgt_cap = probe_eng._sweep_caps
    # nn_min_cuda's calls on the paths: (rows, targets) of each sweep pass
    imu_rows, no_imu_rows = imu_sweep_rows(cfg, src_cap), no_imu_sweep_rows(cfg, src_cap)
    sweep_shapes = {
        "main coarse": (imu_rows[0], tgt_cap), "main fine": (imu_rows[1], tgt_cap),
        "no-IMU coarse": (no_imu_rows[0], tgt_cap),
        "no-IMU fine": (no_imu_rows[1], tgt_cap),
        "LC coarse": (LC_SWEEP_ROWS[0], cfg.scan_capacity),
        "LC fine": (LC_SWEEP_ROWS[1], cfg.scan_capacity)}
    log(f"kernel checks (sweep caps {src_cap}, {tgt_cap}; nn_min_cuda sweep "
        f"shapes {sweep_shapes}):")
    err = None if mesh_only else check_kernels(dev, sweep_shapes)
    if not mesh_only:
        seg_cases, seg_edges = segment_cases(scans, gt)
        err["segment_add"] = check_segment_add(dev, seg_cases + seg_edges)

    # ── 4. the main path ─────────────────────────────────────────────────
    reset_counts()
    eng, wall1 = run_engine(cfg, imu, scans, rels, dev)
    launches = read_counts()
    n_steps = len(scans) - 1
    log(f"main path: {len(eng.pose_trajectory)} poses, "
        f"{eng.stats.submap_corrections} submap corrections, "
        f"{eng.stats.rejected} rejected, {eng.stats.icp_iters} s2s ICP "
        f"iterations, {wall1:.2f} s cold; launches {launches}, per scan "
        f"nn {launches['nn'] / n_steps:.2f} nn_min "
        f"{launches['nn_min'] / n_steps:.2f}")
    assert all_launched(launches), launches
    traj = np.stack(eng.pose_trajectory)
    assert np.isfinite(traj).all(), "non-finite pose"
    assert len(traj) >= MIN_POSES, f"only {len(traj)} poses"
    lo = eng.mapper.log_odds
    assert bool(torch.isfinite(lo).all()), "non-finite map"
    n_cells = int((lo != 0).sum())
    assert n_cells > 0, "empty map"
    ate_m = ate(traj[:, :2, 2], gt, indices=eng.pose_scan_indices)
    log(f"ATE {ate_m:.4f} m over {len(traj)} poses (bound {ATE_BOUND_M} m); "
        f"map {lo.shape[0]}x{lo.shape[1]} cells, {n_cells} painted")
    assert ate_m <= ATE_BOUND_M, f"ATE {ate_m:.4f} m > {ATE_BOUND_M} m"

    # ── 5. warm pass and kernel timings ──────────────────────────────────
    eng2, wall2 = run_engine(cfg, imu, scans, rels, dev)
    traj2 = np.stack(eng2.pose_trajectory)
    # the ordered scatter-sums make the two passes bit-equal
    spread = (float(np.linalg.norm(traj2[:, :2, 2] - traj[:, :2, 2],
                                   axis=1).max())
              if traj2.shape == traj.shape else None)
    log(f"scans/s (warm pass, {n_steps} scans after the first): "
        f"{n_steps / wall2:.2f} ({wall2:.2f} s; cold pass {n_steps / wall1:.2f}) "
        f"on {card}; warm-pass max |pose diff| vs cold "
        f"{float(np.abs(traj2 - traj).max()) if traj2.shape == traj.shape else 'n/a'}"
        f", position {spread}")
    assert traj2.shape == traj.shape and np.array_equal(traj2, traj), \
        f"the warm pass's trajectory differs from the cold pass's ({spread} m)"
    assert torch.equal(eng2.mapper.log_odds, lo), \
        "the warm pass's log-odds map differs from the cold pass's"
    log("warm pass bit-equal to the cold pass: trajectory and log-odds map")

    assert eng._sweep_caps == (src_cap, tgt_cap), eng._sweep_caps
    if not mesh_only:
        timings = time_kernels(dev, cfg.scan_capacity, cfg.submap_capacity,
                               sweep_shapes, card)
        timings["segment_add"] = time_segment_add(dev, seg_cases, card)

    # ── 6. the loop-closure path ─────────────────────────────────────────
    lc_dict = dict(BENCH_CFG, loop_closure=LC_SECTION)
    lc_cfg = SlamConfig.from_dict(lc_dict)
    lc_cfg.num_scans = len(scans)      # as bench_suite sets it
    reset_counts()
    eng_lc, wall_lc = run_engine(lc_cfg, imu, scans, rels, dev, warmup=True)
    launches_lc = read_counts()
    s = eng_lc.stats
    traj_lc = np.stack(eng_lc.pose_trajectory)
    lo_lc = eng_lc.mapper.log_odds
    ate_lc = ate(traj_lc[:, :2, 2], gt, indices=eng_lc.pose_scan_indices)
    log(f"loop-closure path: loop_closures={s.loop_closures} "
        f"lc_checks={s.lc_checks} lc_pairs={s.lc_pairs} "
        f"lc_groups={s.lc_groups} lc_requeued_scans={s.lc_requeued_scans} "
        f"wall_lc_verify={s.wall_lc_verify:.3f} s "
        f"wall_lc_apply={s.wall_lc_apply:.3f} s "
        f"wall_loop_closure={s.wall_loop_closure:.3f} s; "
        f"{n_steps / wall_lc:.2f} scans/s ({wall_lc:.2f} s, warmup included) "
        f"on {card}; launches {launches_lc}")
    log(f"loop-closure ATE {ate_lc:.4f} m over {len(traj_lc)} poses (bound "
        f"{LC_ATE_BOUND_M} m; without loop closure {ate_m:.4f} m)")
    assert s.loop_closures >= 1, "no loop closure accepted"
    assert np.isfinite(traj_lc).all(), "non-finite pose (loop closure)"
    assert bool(torch.isfinite(lo_lc).all()), "non-finite map (loop closure)"
    assert int((lo_lc != 0).sum()) > 0, "empty map (loop closure)"
    assert ate_lc <= LC_ATE_BOUND_M, f"LC ATE {ate_lc:.4f} m > {LC_ATE_BOUND_M} m"
    assert ate_lc < ate_m, f"LC ATE {ate_lc:.4f} m >= no-LC ATE {ate_m:.4f} m"
    assert launches_lc["nn"] > 0 and launches_lc["segment_add"] > 0, launches_lc
    assert launches_lc["nn_min"] > launches["nn_min"], (launches_lc, launches)
    eng_lc2, _ = run_engine(lc_cfg, imu, scans, rels, dev, warmup=True)
    traj_lc2 = np.stack(eng_lc2.pose_trajectory)
    same = (traj_lc2.shape == traj_lc.shape
            and np.array_equal(traj_lc2, traj_lc)
            and torch.equal(eng_lc2.mapper.log_odds, lo_lc)
            and eng_lc2.stats.loop_closures == s.loop_closures)
    log(f"loop-closure path run again: loop_closures="
        f"{eng_lc2.stats.loop_closures}; trajectory, map and closures "
        f"bit-equal to the first run: {same}")
    assert same, "the loop-closure path's second run differs from its first"

    if not mesh_only:
        # ── 7. pose-graph solve timings ──────────────────────────────────
        time_pose_graph(dev, card)
        # ── 11. icp_large at 100k points ─────────────────────────────────
        icp_large_phase(dev, card)

    # ── 12. the scaled pipeline (BASELINE config #5), 400 scans ──────────
    scaled = scaled_phase(dev, card)
    if not mesh_only:
        scaled_breakdown(dev, card)

    # ── 16. the device mesh ──────────────────────────────────────────────
    mesh = mesh_phase(dev, card, td, {
        "scans": scans, "rels": rels, "imu": imu, "gt": gt, "eng_lc": eng_lc,
        "spread": spread if spread is not None else 0.0,
        "scaled_traj": scaled["traj"], "scaled_shape": scaled["map_shape"]})
    if mesh_only:
        print(card, flush=True)
        print(json.dumps({"mesh": mesh}, default=str), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return

    # ── 14. the native CSV parser; 15. 3-D ICP and entry() ───────────────
    parser_phase(os.path.join(td, "bench_lidar.csv"))
    align3d, computed3d = icp3d_phase(dev, card, td)

    # ── 8-10. the features path, "both" with loop closure, modular ───────
    launches_feat = features_phases(SlamConfig, ate, dev, card, gt, scans,
                                    rels, imu, ate_m)
    launches_feat["scaled"] = scaled["launches"]
    launches_feat["mesh_engine"] = mesh["engine"]
    launches_feat["mesh_scaled"] = mesh["scaled"]

    # ── 13. the file-driven path (profiled itself) ───────────────────────
    launches_feat["file_driven"] = file_driven_phase(dev, card, td, gt, n_steps)

    scaled_profile(dev, card)
    counts = profile_counts(align3d, 1)
    log(f"3-D ICP, one alignment ({computed3d} iterations computed, in whole "
        f"chunks): {counts['launches']} kernel launches, "
        f"{counts['launches'] / computed3d if counts['launches'] else None} "
        f"an iteration, {counts['d2h']} device-to-host copies "
        f"(torch.profiler) on {card}")
    kernels = []
    # the top-level figures are those of the main path's heaviest call: the
    # submap ICP's query and the submap sweep's fine pass
    tops = {"nn": f"{cfg.scan_capacity}x{cfg.submap_capacity}",
            "nn_min": "x".join(map(str, sweep_shapes["main fine"]))}
    for name, key, line in (("nn_cuda", "nn", 30), ("nn_min_cuda", "nn_min", 64)):
        shapes = timings[key]
        top = shapes[tops[key]]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "icp_tpu_torch/csrc/nn_kernel.cu",
            "replaces": f"icp_tpu/ops/pallas/nn_kernel.py:{line}",
            "launches": launches[key],
            "launches_by_path": {"main": launches[key],
                                 "loop_closure": launches_lc[key],
                                 **{path: n[key]
                                    for path, n in launches_feat.items()}},
            "launches_per_main_scan": launches[key] / n_steps,
            "launches_per_scaled_lc_check":
                scaled["launches"][key] / max(scaled["stats"]["lc_checked"], 1),
            "max_abs_err": err[key], "shape": tops[key],
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "device_ms": top["device_ms"],
            "plain_device_ms": top["plain_device_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "bound_share": top["bound_share"],
            # no one torch call gives the masked min squared distance:
            # torch.cdist returns square roots, through the matmul expansion
            "library_ms": None, "shapes": shapes})
    # icp_segment_add: port-only, in place of CUDA index_add_'s atomics; its
    # top-level figures are the main path's submap merge
    seg = timings["segment_add"]
    top = seg["submap merge 30720 -> 4096"]
    kernels.append({
        "name": "icp_segment_add", "route": "cuda",
        "source": "icp_tpu_torch/csrc/segment_add.cu",
        # no Pallas kernel: it stands for icp_tpu's XLA scatter-adds (the
        # voxel means'), which XLA runs in a fixed order
        "replaces": "icp_tpu/ops/voxel.py:65",
        "launches": launches["segment_add"],
        "launches_by_path": {"main": launches["segment_add"],
                             "loop_closure": launches_lc["segment_add"],
                             **{path: n["segment_add"]
                                for path, n in launches_feat.items()}},
        "launches_per_main_scan": launches["segment_add"] / n_steps,
        "max_abs_err": err["segment_add"], "shape": "30720x3 -> 4096",
        "ms": top["ms"], "plain_ms": top["plain_ms"], "plain_device": "cpu",
        "device_ms": top["device_ms"], "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"], "bound_share": top["bound_share"],
        # one torch call, the same sums in no fixed order: CUDA index_add_
        "library_ms": top["library_ms"],
        "library_device_ms": top["library_device_ms"], "shapes": seg})
    print(card, flush=True)       # as nvidia-smi gives it: name, power limit
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
