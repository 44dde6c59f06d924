#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (icp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --mesh     # phase 16 and phases 4-6 and 12 it
                                     # is held against (on 1-4 cards)
    python3 chip_smoke.py --syncs    # phases 1-2 and 20
    python3 chip_smoke.py --graphs   # phases 1-2 and 21

Phases (any failed check ends the run with a non-zero exit code):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from icp_tpu_torch/csrc with nvcc;
  3. hold each kernel against its plain torch version on the card, bit for
     bit: icp_segment_add (ordered_index_add_) against CPU index_add_ at
     the adds the paths make (the submap merge's 30,720 rows into 4,096
     slots, a scan's 768, config #5's 131,072-row keyframe, a 1,024-node
     graph's H, b and per-node blocks, f32 and f64: with every row, as
     before segment plans, and on plans built on the card with the padded
     edges left out, held to index_add_ of every row and of the kept rows;
     the same graph with a hub node of 256 edges) and its edges (no rows,
     one run, an unsorted index into a non-zero out), one launch a call;
     nn_cuda at the main path's shapes plus ragged and tie cases,
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
     index_add_, CPU index_add_ (its plain version) and an empty kernel at
     its grid (the floor of one launch) at the paths' shapes as they call
     it (the voxel means on a sorted index; the pose graph's H, b, PCG b
     and blocks on plans), beside each one's bytes at 3.35 TB/s, and each
     plan's build (the sort a solve makes once) on a line of its own;
  6. drive the loop-closure path: the same sequence with bench_suite's
     loop-closure section (first scan, warmup, batches of 16 with rollback
     at accepted closures, finish, sync_map), counters reset just before;
     check >= 1 closure, ATE <= 0.030 m and below phase 4's, finite poses
     and map, and more nn_min_cuda launches than phase 4; then run it again
     and check the two runs bit-equal (trajectory, map, closures);
  7. time PoseGraph2D.optimize through the dense and the PCG solve at
     1024 and 4096 nodes (printed only), and check that each solve built
     its segment plans once (2 dense, 1 PCG) against its GN iterations;
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
 12. the scaled pipeline (ScaledPipeline, BASELINE config #5) through
     icp_tpu_torch.bench.scaled (its kernel guard and protocol) at
     benchmarks/bench_scaled.py's full width, 100k-point scans, cut to 400
     of its 1,200 scans, its graph dumped: check its line has every key of
     bench_scaled.py's, 400 poses, >= 1 closure, >= 1 BA run, every kernel
     launched in its timed region, finite poses and map, the map clean
     after optimize(15), a finite GN step time and ATE <= 0.15 m after the
     terminal BA; print the line, ATE while streaming, the stats, LM
     retries, the wall split, kernel launches per loop-closure check and
     peak device memory; then run it again to the scan of its first bundle
     adjustment (the first closure's) and check the trajectory and map
     there bit-equal to the first run's; then time the parts of 12 scaled
     scans (each step, icp_large and compact_nn synchronized).
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
 17. the bench layer (icp_tpu_torch/bench): one headline pass in
     BENCH_ENGINE_ONLY form after its kernel guard (ATE <= 0.050 m, >= 190
     poses, both NN kernels launched in its timed region), the suite's
     scan2scan and teapot_batch rows, and gt_init_ba on
     benchmarks/graph50k_r05.npz: both solves through "cg"; the streamed
     solve's chi2 within 1e-3 relative of icp_tpu's CPU figure and raised
     by at most 0.1 %, its ATE within 0.05 m of icp_tpu's; the GT-init
     solve lowering chi2 and landing below the streamed ATE (its chi2 gap
     to icp_tpu's printed); each line printed.
 18. the rest of the bench layer: bench.distributed at its 50,000 nodes on
     2 virtual shards of the card (--virtual-devices 2: meshes 1 and 2):
     the 2-shard CG step's nodes within rtol 1e-4 / atol 1e-5 of the
     1-shard step's, every step time finite and > 0, icp_segment_add
     launched; bench.scaling on 2 virtual shards at 40 of its 120 scans
     (16,384 points, meshes 1 and 2; no loop closes): two lines, the second
     with efficiency_vs_smallest, positions within 1 cm of each other; and
     bench.gt_init_ba on phase 12's graph dump: the streamed-init solve
     raising chi2 by at most 0.1 % (phase 17's bound) plus the chi2 the
     graph cannot resolve in float32 (chi2_floor). Each line printed.
 19. the checkpoint path: phase 12's run (config #5, 100k points, 400
     scans) cut at scan 200 by ScaledPipeline.save_checkpoint, then
     resumed from that file twice, each time by load_checkpoint into a
     fresh ScaledPipeline with the scan stream resumed from its saved
     generator state, through the closure, the online BA and the replay
     to the end, then optimize(n_iterations=15) as phase 12. Each resumed run against phase 12's straight run:
     400 poses, the same closures, closure checks and BA runs, the
     trajectory within 0.05 m RMS (the bound test_torch_scaled.py's
     cross-package resume holds on the CPU) and ATE <= 0.15 m after the
     terminal BA; the two resumes bit-equal (trajectory and log-odds map);
     every kernel launched in the resumed timed region. The checkpoint's
     size, its save and load seconds and the gap are printed, and go into
     the summary line.
 20. every host-device sync counted where it is made: phase 6's path
     (the bench sequence with loop closure, one closure; scan 0 to
     finish), 64 steps of phase 12's pipeline and a patrol slice of config
     #5 at its 1,200-scan closure settings (``make_patrol``: from the first
     closure check of the second lap, the map read every 16 steps, through
     BAs to the first read that replays keyframes), each under
     a live ``utils.spans`` record with torch.cuda.set_sync_debug_mode("warn"):
     the sum of the ``sync.*`` counters equal to torch's sync warnings,
     less the event waits and device synchronizes torch does not flag
     (``sync.scaled.drain_wait``, ``sync.scaled.sync_devices``);
     both tables printed by site. Then the cost of the spans and counters
     with nothing recording: one span and one count timed off, times the
     spans and counts a scan made, against a scan's host time unrecorded.
Phases 11-12, 14-20 run after phase 7 and before phases 8-10, whose
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

from icp_tpu_torch.bench.common import (
    BATCH, BENCH_CFG, FEAT_SECTION, KERNEL_NAMES, LC_SECTION, N_SCANS,
    gpu_line, large_world as _large_world, load_sequence, read_counts,
    reset_counts)
from icp_tpu_torch.bench.startup import (
    _cloud, imu_sweep_rows, nn_cases, nn_min_cases, no_imu_sweep_rows)

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

# LC verification's rotation_search on scan-capacity clouds: 360 / 1.5 =
# 240 coarse angles and 30 fine angles of 768 rows, against 768 targets
LC_SWEEP_ROWS = (240 * 768, 30 * 768)
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
# phase 17: the 50k-node loop graph and icp_tpu's figures for it
# (benchmarks/gt_init_ba.py, 15 iterations, JAX on the CPU; PERF.md §6 has
# every reading these limits were set from). The streamed-init solve (the
# pipeline's terminal BA) is held to them: chi2 within 1e-3 relative, its
# drop (pre - post) within [0.5, 3] x icp_tpu's (a solve that does nothing
# drops 0; one GN step raises chi2), ATE within 0.05 m (it moves by
# millimetres between backends). The ground-truth-init solve, 15 GN steps
# from chi2 19.4 and not converged, moves with rounding between backends
# (the coarse supernode solve's f32 LU), so it is held to 1e-2; a
# one-step solve from the same start, the control, must land outside it
GT_INIT_GRAPH = "benchmarks/graph50k_r05.npz"
GT_INIT_CPU = {"chi2_streamed_pre": 0.03289954, "chi2_streamed_post": 0.03289603,
               "chi2_gt_init_post": 0.04426118, "ate_streamed_init_m": 0.8073}
GT_INIT_CHI2_RTOL = 1e-3
GT_INIT_DROP_RANGE = (0.5, 3.0)
GT_INIT_GT_RTOL = 1e-2
GT_INIT_CONTROL_ITERS = 1
GT_INIT_ATE_TOL_M = 0.05
# benchmarks/bench_scaled.py's line (:159-186): bench.scaled prints each key
BENCH_SCALED_KEYS = {
    "metric", "value", "unit", "n_scans", "points_per_scan", "n_keyframes",
    "n_devices", "icp_method", "submap_keyframes", "gn_step_ms",
    "partition_ms", "ba_strategy", "gn_step_strategy", "ate_m",
    "ate_stream_m", "loop_closures", "lc_checked", "ba_runs",
    "gate_fallbacks", "reg_dropped_points", "wall_replay_s",
    "wall_replay_fill_s", "replayed_keyframes", "map_cells", "trajectory",
    "backend"}
# phase 18: the sharded GN steps against one shard (phase 16's tolerance),
# the scaling run's two meshes against each other (phase 16's bound for
# the scaled run over a mesh), the closing solve of phase 12's graph dump
# (phase 17's 0.1 %, plus the graph's f32 floor: see chi2_floor)
DIST_RTOL, DIST_ATOL = 1e-4, 1e-5
SCALING_SCANS = 40            # of bench_scaling.py's 120: closes no loop
SCALING_GAP_M = 1e-2
DUMP_CHI2_RAISE = 1.001
# phase 19: phase 12's run cut at RESUME_CUT and resumed; the resumed
# trajectory held to the straight one within test_torch_scaled.py's bound
# for a resumed run
RESUME_CUT = 200
RESUME_GAP_M = 0.05


def log(*a):
    print(*a, flush=True)


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


def all_launched(counts) -> bool:
    return all(v > 0 for v in counts.values())


def recorded_adds(fn, *modules):
    """Run fn() with every ordered_index_add_ call that ``modules`` make
    recorded: [(out before the add, index or segment plan, src,
    sorted_index)]."""
    from icp_tpu_torch.ops import scatter as SC

    calls, real = [], SC.ordered_index_add_

    def rec(out, index, src, *, sorted_index=False):
        if not isinstance(index, SC.SegmentPlan):
            index = index.clone()
        calls.append((out.clone(), index, src.clone(), sorted_index))
        return real(out, index, src, sorted_index=sorted_index)

    for m in modules:
        m.ordered_index_add_ = rec
    try:
        fn()
    finally:
        for m in modules:
            m.ordered_index_add_ = real
    return calls


def _every_row(call):
    """A recorded pose-graph add as the paths made it before segment
    plans: every row, padded edges included, the index sorted in the call
    (the dense H and b) or beforehand (the PCG step's)."""
    out, plan, src, _ = call
    return out, plan.index, src, False


def _presorted(call):
    out, plan, src, _ = call
    sidx, perm = torch.sort(plan.index, stable=True)
    return out, sidx, src[perm], True


def segment_cases(scans, gt):
    """(path cases, edge cases), each a list of (label, out, index, src,
    sorted_index) on the CPU for icp_segment_add; ``index`` is a tensor or
    a CPU segment plan (``ops.scatter.SegmentPlan``, padded edges left
    out), which the checks rebuild on the card. The path cases are the
    adds the paths make, recorded from the functions that make them on the
    CPU: the main path's 40-scan submap merge and a scan's voxels, config
    #5's 100k-point keyframe into 8,192 slots, a 1,024-node graph's dense
    H and b (f32 and f64) and the PCG step's per-node b, blocks and Hx,
    each as the paths make them now (on plans) and as they made them
    before (every row), and the same graph with a hub, one node of 256
    real edges. The edges: no rows, one run holding every row, an
    unsorted index into a non-zero out."""
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
    cases += [("graph H 1024 nodes (width 1)", *_every_row(H)),
              ("graph b (width 1)", *_every_row(b))]
    g64 = [x.double() if x.is_floating_point() else x for x in g]
    H64, _ = recorded_adds(lambda: optimize_dense(*g64[:7], 0, n_iterations=1,
                                                  convergence_eps=0.0), PG)
    cases.append(("graph H f64 (width 1)", *_every_row(H64)))
    cg = recorded_adds(lambda: DP.gn_step_cg(*g[:7], 0, cg_iters=1), DP)
    cases += [("PCG b (width 3)", *_presorted(cg[0])),
              ("PCG blocks (width 9)", *_presorted(cg[1]))]
    cases += [("plan: graph H 1024 nodes (width 1)", *H),
              ("plan: graph b (width 1)", *b),
              ("plan: graph H f64 (width 1)", *H64),
              ("plan: PCG b (width 3)", *cg[0]),
              ("plan: PCG blocks (width 9)", *cg[1]),
              ("plan: PCG Hx (width 3)", *cg[2])]
    # the hub: node n // 2 gets closures to every 4th node until it has 256
    hub = _chain_with_closures(PoseGraph2D("cpu"), 1024, every=16)
    deg = sum((i == 512) + (j == 512) for i, j in zip(hub._edges_i,
                                                        hub._edges_j))
    for j in [j for j in range(2, 1024, 4)][:256 - deg]:
        hub.add_edge(512, j, [0.1, 0.0, 0.0], np.eye(3) * 50.0)
    gh = hub._packed_device()
    Hh, bh = recorded_adds(lambda: optimize_dense(*gh[:7], 0, n_iterations=1,
                                                  convergence_eps=0.0), PG)
    cgh = recorded_adds(lambda: DP.gn_step_cg(*gh[:7], 0, cg_iters=1), DP)
    cases += [("plan: hub H (width 1)", *Hh), ("plan: hub b (width 1)", *bh),
              ("plan: hub PCG b (width 3)", *cgh[0]),
              ("plan: hub PCG blocks (width 9)", *cgh[1])]
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


def card_plan(index, dev):
    """A recorded CPU segment plan built again on ``dev``, as the path
    builds it there (None for a plain index)."""
    from icp_tpu_torch.ops import scatter as SC

    if not isinstance(index, SC.SegmentPlan):
        return None
    return SC.segment_plan(index.index.to(dev), index.n_slots,
                           keep=None if index.keep is None
                           else index.keep.to(dev))


def check_segment_add(dev, cases) -> float:
    """Phase 3: icp_segment_add against CPU index_add_ on each case, bit
    for bit, one launch a call (none without rows). A plan case (padded
    edges left out) is held against index_add_ of every row and of the
    kept rows. Returns the max absolute error (0.0)."""
    from icp_tpu_torch.ops import scatter as SC

    err = 0.0
    for label, out, index, src, srt in cases:
        plan = card_plan(index, dev)
        rows = index.index if plan is not None else index
        want = out.clone().index_add_(0, rows, src)
        before = SC.segment_add_launches
        got = SC.ordered_index_add_(out.to(dev),
                                    plan if plan is not None else rows.to(dev),
                                    src.to(dev), sorted_index=srt)
        torch.cuda.synchronize()
        assert SC.segment_add_launches == before + (rows.numel() > 0), label
        assert torch.equal(got.cpu(), want), \
            f"icp_segment_add not bit-equal to CPU index_add_: {label}"
        kept = ""
        if plan is not None:
            k = index.keep
            assert torch.equal(got.cpu(), out.clone().index_add_(
                0, rows[k], src[k])), f"{label}: not index_add_ of the kept rows"
            kept = f" ({int(k.sum())} kept, {int((~k).sum())} left out)"
        err = max(err, float((got.cpu() - want).abs().max()) if want.numel() else 0.0)
        log(f"  icp_segment_add {label}: {rows.numel()} rows{kept} x "
            f"{src[0].numel() if len(src) else src.shape[-1]} into "
            f"{out.shape[0]} slots, {out.dtype}, "
            f"{'plan' if plan is not None else 'sorted' if srt else 'unsorted'}"
            f": bit-equal to CPU index_add_")
    return err


def segment_bound(out, index, src):
    """(bound_ms, "bytes") of one ordered scatter-sum on this data: each
    added row's slot (8 bytes; 4 and a 4-byte permutation entry on a
    plan) and values read once, each touched slot read and written once,
    at PEAK_BYTES_S (one add a source value: never the bound). A plan's
    left-out rows are not read."""
    from icp_tpu_torch.ops import scatter as SC

    width = src[0].numel()
    if isinstance(index, SC.SegmentPlan):
        rows = index.index if index.keep is None else index.index[index.keep]
        per_row = 4 + 4
    else:
        rows, per_row = index, 8
    touched = int(torch.unique(rows).numel())
    b = (rows.numel() * (per_row + width * src.element_size())
         + 2 * touched * width * out.element_size())
    return 1e3 * b / PEAK_BYTES_S, "bytes"


def empty_launch(lib, n_rows, width):
    """icp_segment_add's grid for (n_rows, width), launched empty."""
    with torch.cuda.device(torch.cuda.current_device()):
        err = lib.icp_segment_add_empty(
            n_rows, width, torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"empty launch failed: cudaError {err}"


# phase 5's shapes, as the paths call them: the voxel means on a sorted
# index, the pose graph on plans built once a solve
SEGMENT_TIMED = ("submap merge 30720 -> 4096", "scan voxels 768",
                 "keyframe 131072 -> 8192", "plan: graph H 1024 nodes (width 1)",
                 "plan: graph b (width 1)", "plan: PCG b (width 3)",
                 "plan: PCG blocks (width 9)")


def time_segment_add(dev, cases, card) -> dict:
    """Phase 5: icp_segment_add (through ordered_index_add_, as the paths
    call it: on a plan built once beforehand for the pose graph) against
    CUDA index_add_ of every row (the library call: same sums, in no fixed
    order) and an empty kernel at the same grid (the floor of one launch)
    at the SEGMENT_TIMED shapes, by CUDA events and CUDA-graph replays, in
    turns; a plan's build (the once-a-solve sort) on a line of its own;
    the plain version (CPU index_add_) by the host clock; each beside its
    bytes bound."""
    from icp_tpu_torch.ops import scatter as SC
    from icp_tpu_torch.ops.hopper.build import load

    seg_lib = load("segment_add")
    timings = {}
    for label, out, index, src, srt in cases:
        if label not in SEGMENT_TIMED:
            continue
        plan = card_plan(index, dev)
        rows = index.index if plan is not None else index
        o, i, s = out.to(dev), rows.to(dev), src.to(dev)
        arg = plan if plan is not None else i
        kern = lambda: SC.ordered_index_add_(o, arg, s, sorted_index=srt)  # noqa: E731
        lib = lambda: o.index_add_(0, i, s)  # noqa: E731
        n, w = rows.numel(), src[0].numel()
        empty = lambda: empty_launch(seg_lib, n, w)  # noqa: E731
        bound_ms, bound_by = segment_bound(out, index, src)
        fig = {"bound_ms": bound_ms, "bound_by": bound_by,
               "rows": n, "slots": out.shape[0], "width": w,
               "dtype": str(out.dtype).split(".")[-1]}
        if plan is not None:
            fig["kept_rows"] = int(index.keep.sum())
        for measure, timer in (("", time_ms), ("device_", graph_ms)):
            l1, k1, e1 = timer(lib), timer(kern), timer(empty)
            e2, k2, l2 = timer(empty), timer(kern), timer(lib)
            fig[f"{measure}ms"] = (k1 + k2) / 2
            fig[f"library_{measure}ms"] = (l1 + l2) / 2
            fig[f"empty_{measure}ms"] = (e1 + e2) / 2
        oc = out.clone()
        t0 = time.perf_counter()
        for _ in range(10):
            oc.index_add_(0, rows, src)
        fig["plain_ms"] = 1e3 * (time.perf_counter() - t0) / 10
        fig["bound_share"] = bound_ms / fig["device_ms"]
        log(f"icp_segment_add {label}: kernel {1e3 * fig['ms']:.2f} us (events) / "
            f"{1e3 * fig['device_ms']:.2f} us (device only), CUDA index_add_ "
            f"{1e3 * fig['library_ms']:.2f} / {1e3 * fig['library_device_ms']:.2f} us, "
            f"empty launch {1e3 * fig['empty_ms']:.2f} / "
            f"{1e3 * fig['empty_device_ms']:.2f} us, "
            f"plain (CPU index_add_, host clock) {1e3 * fig['plain_ms']:.1f} us; "
            f"bound {1e3 * bound_ms:.3f} us ({bound_by}), device time "
            f"{100 * fig['bound_share']:.1f} % of it, on {card}")
        if plan is not None:
            keep_d = index.keep.to(dev)
            build = lambda: SC.segment_plan(i, index.n_slots, keep=keep_d)  # noqa: E731
            fig["plan_ms"] = time_ms(build)
            try:
                fig["plan_device_ms"] = graph_ms(build)
            except RuntimeError as exc:          # a sort the graph refuses
                fig["plan_device_ms"] = None
                log(f"  (plan build not capturable in a CUDA graph: {exc})")
            dev_ms = fig["plan_device_ms"]
            log(f"icp_segment_add {label}: plan build (once a solve: sort of "
                f"{n} 32-bit keys, {n - fig['kept_rows']} left out) "
                f"{1e3 * fig['plan_ms']:.2f} us (events) / "
                f"{'not measured' if dev_ms is None else f'{1e3 * dev_ms:.2f} us'}"
                f" (device only), on {card}")
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
    from icp_tpu_torch.ops import scatter as SC

    _chain_with_closures(PoseGraph2D(dev), 256).optimize(n_iterations=2)
    out = {}
    for n in (1024, 4096):
        nodes = {}
        for strategy in ("dense", "cg"):
            pg = _chain_with_closures(PoseGraph2D(dev), n)
            pg._cg_node_threshold = 10**9 if strategy == "dense" else 2
            torch.cuda.synchronize()
            builds = SC.segment_plan_builds
            t0 = time.perf_counter()
            pg.optimize(n_iterations=30)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            builds = SC.segment_plan_builds - builds
            assert pg.last_strategy == strategy, pg.last_strategy
            # a solve sorts once: H and b (dense) or [ei, ej] (PCG); an LM
            # retry is a solve of its own
            per = 2 if strategy == "dense" else 1
            assert (builds == per if "+" not in pg.last_strategy
                    else builds % per == 0), (builds, pg.last_strategy)
            nodes[strategy] = np.stack(pg.nodes)
            out[f"{strategy}_{n}"] = ms
            out[f"{strategy}_{n}_iterations"] = pg.last_iterations
            out[f"{strategy}_{n}_plan_builds"] = builds
            log(f"pose graph {n} nodes, {strategy}: optimize {ms:.1f} ms "
                f"({pg.last_iterations} GN iterations of 30 max, "
                f"{builds} segment plans built), chi2 "
                f"{pg.total_error():.4g} on {card}")
        gap = float(np.abs(nodes["dense"][:, :2] - nodes["cg"][:, :2]).max())
        log(f"pose graph {n} nodes: max |dense - cg| position {gap:.3g} m")
    return out


def profile_counts(fn, n):
    """{launches, h2d, d2h, kernels, graph_launches} per call of fn() over
    n calls: the host's kernel launch calls, host-to-device /
    device-to-host copies, the kernels the card ran (copies and fills left
    out, as the benchmark's trace reducer leaves them) and the host's
    graph launches, from torch.profiler's CUDA runtime, memcpy and kernel
    events; None for a count the profiler did not record."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = [(e.name(), e.device_type() == cuda)
              for e in prof.profiler.kineto_results.events()]
    names = [nm for nm, _ in events]
    launches = sum(nm.startswith(("cudaLaunchKernel", "cuLaunchKernel"))
                   for nm in names)
    copies = any(nm.startswith("cudaMemcpy") for nm in names)
    h2d = sum("HtoD" in nm for nm in names)
    d2h = sum("DtoH" in nm for nm in names)
    kernels = sum(on_card and not nm.startswith(("Memcpy", "Memset"))
                  and "memcpy" not in nm.lower() for nm, on_card in events)
    graphs = sum(nm.startswith("cudaGraphLaunch") for nm in names)
    return {"launches": launches / n if launches else None,
            "h2d": h2d / n if (h2d or copies) else None,
            "d2h": d2h / n if (d2h or copies) else None,
            "kernels": kernels / n, "graph_launches": graphs / n}


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


PATROL_LAP = 240           # scans a lap of the patrol (0.26 m a scan)


def make_patrol(dev, laps=2):
    """Config #5 at bench_scaled.py's 1,200-scan closure settings
    (``pipeline_kwargs(1200, 100000)``: closures from 120 scans apart) and
    ``laps`` laps of a patrol round an 11 x 8.8 m ellipse in config #5's
    world, each lap's points drawn from a generator of its own."""
    from icp_tpu_torch.bench import scaled as BS
    from icp_tpu_torch.parallel.scaled import ScaledPipeline
    from icp_tpu_torch.utils.synth import LargeScanStream, make_dense_world

    kw = BS.pipeline_kwargs(1200, 100_000, env={})
    world = make_dense_world(np.random.default_rng(3), extent=100.0)
    scans = [scan for lap in range(laps) for scan, _ in LargeScanStream(
        PATROL_LAP, n_points=100_000, extent=20.0, max_range=35.0,
        noise=0.02, seed=3 + lap, world_points=world)]
    return ScaledPipeline(dev, **kw), scans


def make_scaled(dev, n_scans=SCALED_SCANS, n_points=100_000):
    """The scaled pipeline at benchmarks/bench_scaled.py's configuration
    (``bench.scaled.pipeline_kwargs`` at its defaults), every capacity
    unchanged, and its scan stream as the bench makes it."""
    from icp_tpu_torch.bench import scaled as BS
    from icp_tpu_torch.parallel.scaled import ScaledPipeline

    kw = BS.pipeline_kwargs(n_scans, n_points, env={})
    assert kw["kf_capacity"] == KF_CAP, kw["kf_capacity"]
    return ScaledPipeline(dev, **kw), BS.scan_stream(n_scans, n_points)


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


def scaled_phase(dev, card, td) -> dict:
    """Phase 12: the scaled pipeline at full width, 400 scans, through
    ``bench.scaled`` (its kernel guard, protocol and line; the graph dump
    into ``td``)."""
    from icp_tpu_torch.bench import scaled as BS

    # the state right after the first bundle adjustment (the first
    # closure's), for the second run to be held to
    first = {}

    def probe(k, p):
        if not first and p.stats.ba_runs >= 1:
            first.update(k=k, closures=p.stats.loop_closures,
                         traj=np.stack(p.trajectory),
                         lo=p.log_odds.cpu().clone())

    dump = os.path.join(td, "scaled_graph.npz")
    t0 = time.perf_counter()
    line, pipe, gt = BS.run(dev, env={"BENCH_SCALED_SCANS": str(SCALED_SCANS),
                                      "BENCH_SCALED_DEVICES": "1",
                                      "BENCH_SCALED_DUMP_GRAPH": dump},
                            probe=probe)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(json.dumps(line), flush=True)
    missing = BENCH_SCALED_KEYS - set(line)
    assert not missing, f"bench.scaled's line lacks {sorted(missing)}"
    # the timed region's launches (scans 3-399 and finish; the guard's
    # comparisons are outside it)
    launches = {k: line["kernel_launches"][name]
                for k, name in KERNEL_NAMES.items()}
    traj = np.stack(pipe.trajectory)
    sps, ate_stream, ate_ba = line["value"], line["ate_stream_m"], line["ate_m"]
    st = pipe.stats
    peak = torch.cuda.max_memory_allocated(dev)
    checks = max(st.lc_checked, 1)
    log(f"scaled pipeline: {len(traj)} poses, {sps:.2f} scans/s after 3 warm "
        f"scans (host scan generation inside, as bench_scaled.py: "
        f"{line['stream_ms_per_scan']:.2f} ms a scan, culled), "
        f"{wall:.1f} s for the phase, on {card}")
    log(f"  ATE {ate_stream:.4f} m streaming -> {ate_ba:.4f} m after the "
        f"terminal BA (bound {SCALED_ATE_BOUND_M} m); loop_closures="
        f"{st.loop_closures} lc_checked={st.lc_checked} lc_candidates="
        f"{st.lc_candidates} ba_runs={st.ba_runs} gate_fallbacks="
        f"{st.gate_fallbacks} reg_dropped_points={st.reg_dropped_points} "
        f"replayed_keyframes={st.replayed_keyframes} icp_iters={st.icp_iters} "
        f"LM retries {line['lm_retries']} rejected {line['rejected_solves']}")
    log(f"  wall: registration {st.wall_registration:.2f} s, lc "
        f"{st.wall_lc:.2f} s, ba {st.wall_ba:.2f} s, replay "
        f"{st.wall_replay:.2f} s (fill {st.wall_replay_fill:.2f} s); "
        f"launches in the timed region {launches}, per loop-closure check nn "
        f"{launches['nn'] / checks:.1f} nn_min {launches['nn_min'] / checks:.1f}; "
        f"peak device memory {peak / 2**30:.2f} GiB; grid {pipe.ny}x{pipe.nx}; "
        f"GN step {line['gn_step_ms']:.2f} ms ({line['gn_step_strategy']})")
    lo = pipe.log_odds
    assert line["n_scans"] == len(traj) == SCALED_SCANS, f"{len(traj)} poses"
    assert np.isfinite(traj).all(), "non-finite pose (scaled)"
    assert bool(torch.isfinite(lo).all()), "non-finite map (scaled)"
    assert int((lo != 0).sum()) > 0, "empty map (scaled)"
    assert st.loop_closures >= 1, "no loop closure accepted (scaled)"
    assert st.ba_runs >= 1, "no bundle adjustment (scaled)"
    assert not pipe._map_dirty, "map still dirty after optimize (scaled)"
    assert all_launched(launches), launches
    assert np.isfinite(line["gn_step_ms"]) and line["gn_step_ms"] > 0, line
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
            "map_shape": tuple(lo.shape), "dump": dump,
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
        f"lc_groups={s.lc_groups}; ATE {ate_e:.4f} m (bound "
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


def bench_phase(dev, card, td, seq) -> dict:
    """Phase 17: the bench layer (icp_tpu_torch/bench). One headline pass in
    BENCH_ENGINE_ONLY form (its kernel guard first), the scan2scan and
    teapot_batch rows, and gt_init_ba on the 50k-node loop graph, each
    line printed. Returns the kernels' launches per run."""
    from icp_tpu_torch.bench import gt_init_ba, headline, suite

    t_phase = time.perf_counter()
    line = headline.run(dev, passes=1, engine_only=True, data_dir=td)
    print(json.dumps(line), flush=True)
    head = {k: line["kernel_launches"][name] for k, name in KERNEL_NAMES.items()}
    assert line["ate_m"] <= ATE_BOUND_M, f"headline ATE {line['ate_m']:.4f} m"
    assert line["poses_kept"] >= MIN_POSES, f"headline kept {line['poses_kept']} poses"
    assert head["nn"] > 0 and head["nn_min"] > 0, head

    for name, fn in (("scan2scan", lambda: suite.bench_scan2scan(dev, seq)),
                     ("teapot_batch", lambda: suite.bench_teapot_batch(dev, reps=2))):
        row = fn()
        print(json.dumps({**row, "config": name, "card": card}), flush=True)
        assert np.isfinite(row["value"]) and row["value"] > 0, (name, row["value"])
    assert np.isfinite(row["mean_error"]), row

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), GT_INIT_GRAPH)
    graph = np.load(path)
    ba = gt_init_ba.run(dev, graph)
    print(json.dumps(ba), flush=True)
    assert ba["strategy_streamed"] == ba["strategy_gt"] == "cg", ba
    rel = {k: ba[k] / GT_INIT_CPU[k] - 1
           for k in ("chi2_streamed_post", "chi2_gt_init_post")}
    drop = ((ba["chi2_streamed_pre"] - ba["chi2_streamed_post"])
            / (GT_INIT_CPU["chi2_streamed_pre"] - GT_INIT_CPU["chi2_streamed_post"]))
    # the control: the GT-init solve cut to one GN step
    pg = gt_init_ba.gt_init_graph(graph, dev)
    gt_init_ba.timed_solve(pg, GT_INIT_CONTROL_ITERS, dev)
    rel_control = pg.total_error() / GT_INIT_CPU["chi2_gt_init_post"] - 1
    log(f"gt_init_ba: chi2 after each solve relative to icp_tpu's CPU figure "
        f"{rel} (GT init limit {GT_INIT_GT_RTOL}; a {GT_INIT_CONTROL_ITERS}-step "
        f"control {rel_control:+.4g}); streamed chi2 drop {drop:.4g} x icp_tpu's "
        f"(range {GT_INIT_DROP_RANGE}); ATE streamed {ba['ate_streamed_init_m']:.4f} m "
        f"(icp_tpu {GT_INIT_CPU['ate_streamed_init_m']}), GT init "
        f"{ba['ate_gt_init_m']:.4f} m; plan builds "
        f"{ba['span_ms_streamed'].get('scatter.segment_plan', 0.0):.3f} / "
        f"{ba['span_ms_gt'].get('scatter.segment_plan', 0.0):.3f} ms a solve")
    assert abs(rel["chi2_streamed_post"]) <= GT_INIT_CHI2_RTOL, rel
    assert GT_INIT_DROP_RANGE[0] <= drop <= GT_INIT_DROP_RANGE[1], ("drop", drop)
    assert ba["chi2_streamed_post"] <= ba["chi2_streamed_pre"] * 1.001, ba
    gap = abs(ba["ate_streamed_init_m"] - GT_INIT_CPU["ate_streamed_init_m"])
    assert gap <= GT_INIT_ATE_TOL_M, ("ate_streamed_init_m", ba["ate_streamed_init_m"])
    assert abs(rel["chi2_gt_init_post"]) <= GT_INIT_GT_RTOL, rel
    assert abs(rel_control) > GT_INIT_GT_RTOL, ("control inside the limit", rel_control)
    assert ba["chi2_gt_init_post"] < ba["chi2_at_gt"], ba
    assert ba["ate_gt_init_m"] < ba["ate_streamed_init_m"], ba
    log(f"bench layer phase: {time.perf_counter() - t_phase:.1f} s on {card}")
    # each solve's launches, counted from 0 just before it, read just after
    solves = {k: sum(ba[f"kernel_launches_{tag}"][name] for tag in ("streamed", "gt"))
              for k, name in KERNEL_NAMES.items()}
    return {"bench_headline": head, "gt_init_ba": solves}


def chi2_floor(d) -> float:
    """The chi2 a pose-graph dump ``d`` cannot resolve in float32: each
    residual component is a difference of coordinates, each rounded by up
    to half an ulp of the largest, 2^-24 max |x|; weighted by every edge's
    information, sum_e tr(Omega_e) (2^-24 max |x|)^2. Phase 12's graph,
    converged online, sits below it (chi2 9.85e-7 against 2.8e-6), so its
    terminal solve moves chi2 by rounding alone."""
    lim = 2.0 ** -24 * float(np.abs(d["nodes"][:, :2]).max())
    return float(np.trace(d["om"], axis1=1, axis2=2).astype(np.float64).sum()
                 * lim * lim)


def bench_mesh_phase(dev, card, dump) -> dict:
    """Phase 18: the rest of the bench layer. ``bench.distributed`` at its
    50,000 nodes on 2 virtual shards of the card (meshes 1 and 2: the
    2-shard CG step's nodes held to the 1-shard step's), ``bench.scaling``
    on 2 virtual shards at 40 scans (two lines, the meshes' positions held
    to each other), and ``bench.gt_init_ba`` on phase 12's graph dump.
    Returns the kernels' launches in each timed region."""
    from icp_tpu_torch.bench import distributed, gt_init_ba, scaling

    t_phase = time.perf_counter()
    line, outs, _ = distributed.main(["--virtual-devices", "2"], env={})
    steps = list(line["step_ms"].values()) + [line["schur_exact_step_ms"]]
    gap = float(np.abs(outs[2] - outs[1]).max())
    log(f"bench.distributed: {line['n_nodes']} nodes, CG step {line['step_ms']} "
        f"ms by mesh, plans {line['plan_build_ms']} ms, Schur "
        f"{line['schur_exact_step_ms']:.2f} ms ({line['schur_separators']} "
        f"separators); max |2 shards - 1 shard| {gap:.3g} on {card}")
    assert sorted(outs) == [1, 2] and line["virtual_devices"] == 2, line
    assert np.allclose(outs[2], outs[1], rtol=DIST_RTOL, atol=DIST_ATOL), gap
    assert all(np.isfinite(t) and t > 0 for t in steps), steps
    assert line["kernel_launches"]["icp_segment_add"] > 0, line["kernel_launches"]

    runs = scaling.main(["--virtual-devices", "2"], env={
        "BENCH_SCALING_SCANS": str(SCALING_SCANS), "BENCH_SCALING_MESHES": "1,2"})
    (l1, p1), (l2, p2) = runs
    t1, t2 = np.stack(p1.trajectory), np.stack(p2.trajectory)
    gap_s = float(np.linalg.norm(t1[:, :2, 2] - t2[:, :2, 2], axis=1).max())
    log(f"bench.scaling: {l1['value']:.2f} / {l2['value']:.2f} scans/s on 1 / "
        f"2 virtual shards (efficiency {l2['efficiency_vs_smallest']:.3f}, "
        f"not scaling), GN {l1['gn_step_ms']:.2f} / {l2['gn_step_ms']:.2f} ms; "
        f"max |2 - 1| position {1e3 * gap_s:.3f} mm (bound "
        f"{1e3 * SCALING_GAP_M:.0f} mm)")
    assert [l1["n_devices"], l2["n_devices"]] == [1, 2], (l1, l2)
    assert "efficiency_vs_smallest" not in l1 and "efficiency_vs_smallest" in l2
    assert len(t1) == len(t2) == SCALING_SCANS and np.isfinite(t1).all()
    assert gap_s <= SCALING_GAP_M, f"scaling meshes {gap_s:.5f} m apart"

    graph = np.load(dump)
    floor = chi2_floor(graph)
    ba = gt_init_ba.run(dev, graph)
    print(json.dumps(ba), flush=True)
    log(f"gt_init_ba on phase 12's dump: {ba['n_nodes']} nodes, chi2 "
        f"{ba['chi2_streamed_pre']:.6g} -> {ba['chi2_streamed_post']:.6g} "
        f"(streamed init, {ba['strategy_streamed']}; f32 floor {floor:.3g}), "
        f"ATE {ba['ate_streamed_init_m']:.4f} m; GT init "
        f"{ba['ate_gt_init_m']:.4f} m")
    assert ba["n_nodes"] == SCALED_SCANS, ba["n_nodes"]
    assert (ba["chi2_streamed_post"]
            <= ba["chi2_streamed_pre"] * DUMP_CHI2_RAISE + floor), (ba, floor)
    log(f"rest of the bench layer: {time.perf_counter() - t_phase:.1f} s on {card}")

    def named(counts):
        return {k: counts[name] for k, name in KERNEL_NAMES.items()}

    return {"bench_distributed": named(line["kernel_launches"]),
            "bench_scaling": {k: l1["kernel_launches"][n] + l2["kernel_launches"][n]
                              for k, n in KERNEL_NAMES.items()},
            "gt_init_ba_scaled_dump": {
                k: sum(ba[f"kernel_launches_{tag}"][n] for tag in ("streamed", "gt"))
                for k, n in KERNEL_NAMES.items()}}


def resume_phase(dev, card, td, base, n_points=100_000) -> dict:
    """Phase 19: phase 12's run cut at RESUME_CUT by ``save_checkpoint``
    and resumed twice from the one file, each time by ``load_checkpoint``
    into a fresh ``ScaledPipeline`` with the scan stream resumed from its
    saved generator state. ``base`` is phase 12's result. Returns the
    resumed timed region's launches and the summary's figures."""
    from icp_tpu_torch.bench import scaled as BS
    from icp_tpu_torch.parallel.mesh import make_mesh
    from icp_tpu_torch.parallel.scaled import ScaledPipeline
    from icp_tpu_torch.utils.metrics import ate

    t_phase = time.perf_counter()
    kw = BS.pipeline_kwargs(SCALED_SCANS, n_points, env={})
    mesh = make_mesh(1, device=dev)        # as phase 12's bench.scaled run
    path = os.path.join(td, "resume.npz")
    pipe = ScaledPipeline(mesh, **kw)
    pipe.warm_replay()
    stream = BS.scan_stream(SCALED_SCANS, n_points)
    for _ in range(RESUME_CUT):
        pipe.step(next(stream)[0])
    t0 = time.perf_counter()
    pipe.save_checkpoint(path)
    save_s = time.perf_counter() - t0
    ckpt_mb = os.path.getsize(path) / 2**20
    state, gt = stream.state, stream.gt
    del pipe
    log(f"resume phase: scans 0-{RESUME_CUT - 1}, checkpoint {ckpt_mb:.2f} "
        f"MiB written in {save_s:.3f} s")
    st0, want = base["stats"], base["traj"][:, :2, 2]
    runs = []
    for n in (1, 2):
        pipe = ScaledPipeline(mesh, **kw)
        t0 = time.perf_counter()
        pipe.load_checkpoint(path)
        load_s = time.perf_counter() - t0
        assert len(pipe.trajectory) == pipe.stats.scans == RESUME_CUT
        pipe.warm_replay()
        pipe.log_odds[:1, :1].cpu()
        reset_counts()
        t0 = time.perf_counter()
        for scan, _ in BS.scan_stream(SCALED_SCANS, n_points,
                                      start=RESUME_CUT, rng_state=state):
            pipe.step(scan)
        pipe.finish()
        pipe.log_odds[:1, :1].cpu()
        wall = time.perf_counter() - t0
        launches = read_counts()
        ate_stream = ate(np.stack(pipe.trajectory)[:, :2, 2], gt,
                         gt_offset=0)
        pipe.optimize(n_iterations=15)
        traj = np.stack(pipe.trajectory)
        ate_ba = ate(traj[:, :2, 2], gt, gt_offset=0)
        st = pipe.stats
        got = {"loop_closures": st.loop_closures, "lc_checked": st.lc_checked,
               "ba_runs": st.ba_runs}
        gap = (float(np.sqrt(np.mean(np.sum((traj[:, :2, 2] - want) ** 2,
                                             axis=1))))
               if traj.shape == base["traj"].shape else float("inf"))
        log(f"  resume {n}: scans {RESUME_CUT}-{SCALED_SCANS - 1} in a fresh "
            f"pipeline, checkpoint loaded in {load_s:.3f} s; {got} (phase "
            f"12: closures {st0['loop_closures']}, checks "
            f"{st0['lc_checked']}, BA runs {st0['ba_runs']}); trajectory "
            f"{1e3 * gap:.3f} mm RMS from phase 12's (bound "
            f"{1e3 * RESUME_GAP_M:.0f} mm); ATE {ate_stream:.4f} -> "
            f"{ate_ba:.4f} m; {(SCALED_SCANS - RESUME_CUT) / wall:.2f} "
            f"scans/s (no warm scan); launches in the resumed region "
            f"{launches}; LM retries {pipe.pose_graph.lm_retries}")
        assert len(traj) == SCALED_SCANS, len(traj)
        assert np.isfinite(traj).all(), "non-finite pose (resumed)"
        assert not pipe._map_dirty, "map still dirty after optimize (resumed)"
        assert got == {"loop_closures": st0["loop_closures"],
                       "lc_checked": st0["lc_checked"],
                       "ba_runs": st0["ba_runs"]}, (got, st0)
        assert gap <= RESUME_GAP_M, f"resumed run {gap:.5f} m RMS from phase 12"
        assert ate_ba <= SCALED_ATE_BOUND_M, ate_ba
        assert all_launched(launches), launches
        runs.append({"traj": traj, "lo": pipe.log_odds.cpu(), "gap": gap,
                     "load_s": load_s, "ate": ate_ba, "launches": launches})
        del pipe
    r1, r2 = runs
    same = (np.array_equal(r1["traj"], r2["traj"])
            and torch.equal(r1["lo"], r2["lo"]))
    log(f"  the two resumes bit-equal (trajectory and log-odds map): {same}; "
        f"phase {time.perf_counter() - t_phase:.1f} s on {card}")
    assert same, "two resumes of one checkpoint differ"
    return {"launches": r1["launches"],
            "summary": {"cut": RESUME_CUT, "ckpt_mb": ckpt_mb,
                        "ckpt_save_s": save_s,
                        "ckpt_load_s": [r["load_s"] for r in runs],
                        "gap_rms_m": [r["gap"] for r in runs],
                        "ate_m": [r["ate"] for r in runs],
                        "resumes_bit_equal": same}}


def _program_site() -> str:
    """The innermost line of icp_tpu_torch on the stack."""
    import traceback
    for f in reversed(traceback.extract_stack()):
        if os.sep + "icp_tpu_torch" + os.sep in f.filename:
            rel = f.filename.split(os.sep + "icp_tpu_torch" + os.sep)[-1]
            return f"icp_tpu_torch/{rel}:{f.lineno}"
    return "outside icp_tpu_torch"


def counted_syncs(dev, fn):
    """``fn()`` under a live spans record with torch's sync debug mode on;
    returns (the record's totals, torch's sync warnings by program site)."""
    import collections
    import warnings

    from icp_tpu_torch.utils import spans

    sites = collections.Counter()

    def show(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" in str(message):
            site = _program_site()
            if site == "outside icp_tpu_torch":
                import traceback
                site += ": " + " < ".join(
                    f"{os.path.basename(f.filename)}:{f.lineno} {f.name}"
                    for f in reversed(traceback.extract_stack()[-12:-1]))
            sites[site] += 1

    torch.cuda.synchronize(dev)
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        with spans.record(dev) as spent:
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
    return spent.record, sites


# syncs that torch's debug mode does not flag: an event's wait, a device
# synchronize (the replay's, held on the patrol slice)
UNFLAGGED_SYNCS = ("sync.scaled.drain_wait", "sync.scaled.sync_devices")


def sync_phase(dev, card, lc_cfg, imu, scans, rels) -> dict:
    """Phase 20: the sync counters against torch's sync warnings on both
    cells' paths, and the spans' and counters' cost when off."""
    from icp_tpu_torch.engine import SlamEngine
    from icp_tpu_torch.utils import spans

    out = {}
    eng = None

    def engine_log():
        eng.process_scan(scans[0], rels[0])
        for k in range(1, len(scans), BATCH):
            eng.process_scans_batched(scans[k:k + BATCH], rels[k:k + BATCH])
        eng.finish()

    # one unrecorded log for the scan's host time, then the recorded one
    walls = []
    for _ in range(2):
        eng = SlamEngine(lc_cfg, imu=imu, verbose=False, device=dev)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        engine_log()
        torch.cuda.synchronize(dev)
        walls.append(time.perf_counter() - t0)
    eng = SlamEngine(lc_cfg, imu=imu, verbose=False, device=dev)
    rec_e, sites_e = counted_syncs(dev, engine_log)
    closures = eng.stats.loop_closures

    pipe, stream = make_scaled(dev)
    steps = [scan for _, (scan, _g) in zip(range(64), stream)]

    def scaled_steps():
        for scan in steps:
            pipe.step(scan)
        pipe.finish()

    rec_s, sites_s = counted_syncs(dev, scaled_steps)

    # the closure path: a patrol's first lap and a few scans unrecorded,
    # then, recorded, the steps from the first closure check with
    # candidates, the map read every 16 steps, until a read replays
    # keyframes (BAs move few keyframes past the replay's tolerance)
    pipe, patrol = make_patrol(dev, laps=3)
    first = PATROL_LAP - 8
    for scan in patrol[:first]:
        pipe.step(scan)
    st = pipe.stats
    before = (st.lc_checked, st.ba_runs, st.replayed_keyframes)
    n_patrol = [0]

    def patrol_steps():
        for k in range(first, len(patrol)):
            pipe.step(patrol[k])
            n_patrol[0] += 1
            if (k + 1) % 16 == 0:
                pipe.sync_map()
                if st.replayed_keyframes > before[2]:
                    break
        pipe.finish()

    rec_p, sites_p = counted_syncs(dev, patrol_steps)
    c = rec_p.totals()["counts"]
    log(f"patrol slice: {n_patrol[0]} steps from scan {first}: "
        f"{pipe.stats.lc_checked - before[0]} checks with candidates, "
        f"{pipe.stats.ba_runs - before[1]} BAs, "
        f"{c.get('scaled.replay_keyframes', 0)} keyframes replayed; counters "
        f"{ {k: v for k, v in c.items() if k.startswith('scaled.')} }")
    assert pipe.stats.lc_checked > before[0] and c.get("scaled.lc_checks")
    assert pipe.stats.ba_runs > before[1] and c.get("scaled.ba_nodes")
    assert c.get("scaled.replay_keyframes"), "the patrol slice replayed none"
    for path, rec, sites, n in (("engine", rec_e, sites_e, len(scans)),
                                ("scaled", rec_s, sites_s, len(steps)),
                                ("patrol", rec_p, sites_p, n_patrol[0])):
        counts = {k: v for k, v in rec.totals()["counts"].items()
                  if k.startswith("sync.")}
        flagged = sum(v for k, v in counts.items()
                      if k not in UNFLAGGED_SYNCS)
        warned = sum(sites.values())
        log(f"syncs, {path} path ({n} scans): sync.* counters {counts} "
            f"(sum {sum(counts.values())}, {flagged} of them torch flags); "
            f"torch's sync warnings by site {dict(sorted(sites.items()))} "
            f"(sum {warned}); {flagged / n:.2f} flagged syncs a scan")
        out[path] = {"counted": sum(counts.values()), "flagged": flagged,
                     "warned": warned, "per_scan": sum(counts.values()) / n}
    assert closures >= 1, "the recorded engine log closed no loop"
    for path in ("engine", "scaled", "patrol"):
        assert out[path]["flagged"] == out[path]["warned"], (path, out[path])

    # the cost when off: spans and counts a scan (the recorded log's),
    # each at its off-path time, against the unrecorded log's scan
    n_span = sum(s["calls"] for s in rec_e.totals()["spans"].values())
    n_count = rec_e.adds
    reps = 200_000
    sp = spans.span("smoke.off")
    t0 = time.perf_counter()
    for _ in range(reps):
        with sp:
            pass
    span_us = 1e6 * (time.perf_counter() - t0) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        spans.count("smoke.off")
    count_us = 1e6 * (time.perf_counter() - t0) / reps
    scan_us = 1e6 * min(walls) / len(scans)
    off_us = (n_span * span_us + n_count * count_us) / len(scans)
    log(f"spans off: {span_us:.3f} us a span, {count_us:.3f} us a count; "
        f"{n_span / len(scans):.1f} spans and {n_count / len(scans):.1f} "
        f"counts a scan, so {off_us:.2f} us of a {scan_us:.0f} us scan "
        f"({100 * off_us / scan_us:.4f} %) on {card}")
    # and on: a live record's span (two CUDA events) and count
    reps = 20_000
    with spans.record(dev):
        t0 = time.perf_counter()
        for _ in range(reps):
            with sp:
                pass
        on_span_us = 1e6 * (time.perf_counter() - t0) / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            spans.count("smoke.on")
        on_count_us = 1e6 * (time.perf_counter() - t0) / reps
    log(f"spans on: {on_span_us:.3f} us a span, {on_count_us:.3f} us a "
        f"count on {card}")
    assert off_us < 1e-3 * scan_us, (off_us, scan_us)
    out["off_pct"] = 100 * off_us / scan_us
    return out


def graph_phase(dev, card, lc_cfg, imu, scans, rels) -> dict:
    """Phase 21: icp_core's graph replays against its Python loop on
    phase 6's path, bit for bit, with every capture in the warm-up."""
    import importlib

    from icp_tpu_torch.engine import SlamEngine
    from icp_tpu_torch.utils import spans

    icp_mod = importlib.import_module("icp_tpu_torch.models.icp")
    replays_graphs = icp_mod._replays_graphs
    n_steps = len(scans) - 1

    def warm_engine():
        eng = SlamEngine(lc_cfg, imu=imu, verbose=False, device=dev)
        eng.process_scan(scans[0], rels[0])
        eng.warmup()
        return eng

    def batches(eng):
        for k in range(1, len(scans), BATCH):
            eng.process_scans_batched(scans[k:k + BATCH], rels[k:k + BATCH])
        eng.finish()
        eng.sync_map()
        torch.cuda.synchronize(dev)

    runs = {}
    for name, graphs in (("graph", True), ("eager", False)):
        icp_mod._replays_graphs = replays_graphs if graphs else (
            lambda *a: False)
        try:
            icp_mod._graphs.clear()
            with spans.record(dev) as warm:
                eng = warm_engine()
            reset_counts()
            t0 = time.perf_counter()
            with spans.record(dev) as timed:
                batches(eng)
            wall = time.perf_counter() - t0
            launches = read_counts()
            again = warm_engine()
            traced = {k: v / n_steps if v is not None else None for k, v in
                      profile_counts(lambda: batches(again), 1).items()}
        finally:
            icp_mod._replays_graphs = replays_graphs
        runs[name] = {
            "eng": eng, "wall": wall, "launches": launches,
            "warm": warm.record.totals()["counts"],
            "counts": timed.record.totals()["counts"],
            "traced": traced}
        c = runs[name]["counts"]
        log(f"icp_core, {name} chunks, phase 6's path: {n_steps / wall:.2f} "
            f"scans/s with a live record ({wall:.2f} s) on {card}; warm-up "
            f"captures {runs[name]['warm'].get('icp.graph_captures', 0)}; "
            f"timed: graph replays {c.get('icp.graph_replays', 0)}, eager "
            f"chunks {c.get('icp.eager_chunks', 0)}, captures "
            f"{c.get('icp.graph_captures', 0)}; launches {launches}; traced "
            f"a scan: {runs[name]['traced']}")
    g, e = runs["graph"], runs["eager"]
    tg, te = (np.stack(r["eng"].pose_trajectory) for r in (g, e))
    same = (tg.shape == te.shape and np.array_equal(tg, te)
            and torch.equal(g["eng"].mapper.log_odds, e["eng"].mapper.log_odds)
            and g["eng"].stats.loop_closures == e["eng"].stats.loop_closures
            >= 1)
    log(f"graph replays against the Python loop: trajectory, map and "
        f"{g['eng'].stats.loop_closures} closures bit-equal: {same}")
    assert same, "the graph replays' run differs from the Python loop's"
    gc, ec = g["counts"], e["counts"]
    assert g["warm"].get("icp.graph_captures", 0) > 0, g["warm"]
    assert "icp.graph_captures" not in gc, "a capture in the timed run"
    assert "icp.eager_chunks" not in gc and gc["icp.graph_replays"] > 0, gc
    assert not [k for k in ec if k.startswith("icp.graph_")], ec
    assert gc["icp.graph_replays"] == ec["icp.eager_chunks"], (gc, ec)
    assert g["launches"] == e["launches"], (g["launches"], e["launches"])
    for k in ("nn.pairs_computed", "nn.pairs_valid", "sync.icp.stop"):
        assert gc[k] == ec[k], (k, gc[k], ec[k])
    syncs = {r: sum(v for k, v in c.items() if k.startswith("sync."))
             for r, c in (("graph", gc), ("eager", ec))}
    assert syncs["graph"] == syncs["eager"] - ec["sync.icp.consts"], syncs
    assert "sync.icp.consts" not in gc, gc
    log(f"syncs a scan: graph {syncs['graph'] / n_steps:.2f}, eager "
        f"{syncs['eager'] / n_steps:.2f}; kernels the card ran a scan: "
        f"graph {g['traced']['kernels']:.1f}, eager "
        f"{e['traced']['kernels']:.1f} (the profiler sees the graphs' "
        f"kernels: {g['traced']['kernels'] > 0.9 * e['traced']['kernels']})")
    return {r: {"scans_per_s": n_steps / runs[r]["wall"],
                "traced_per_scan": runs[r]["traced"],
                "syncs_per_scan": syncs[r] / n_steps} for r in runs}


def main():
    mesh_only = sys.argv[1:] == ["--mesh"]
    syncs_only = sys.argv[1:] == ["--syncs"]
    graphs_only = sys.argv[1:] == ["--graphs"]
    if sys.argv[1:] and not (mesh_only or syncs_only or graphs_only):
        sys.exit("usage: python3 chip_smoke.py [--mesh | --syncs | --graphs]")
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "smoke test needs a CUDA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    with tempfile.TemporaryDirectory() as td:
        run(td, mesh_only, syncs_only, graphs_only)


def lc_config(n_scans):
    """Phase 6's configuration: the bench's with loop closure."""
    from icp_tpu_torch.utils.config import SlamConfig

    lc_cfg = SlamConfig.from_dict(dict(BENCH_CFG, loop_closure=LC_SECTION))
    lc_cfg.num_scans = n_scans      # as bench_suite sets it
    return lc_cfg


def run(td, mesh_only=False, syncs_only=False, graphs_only=False):
    """Every phase, or with ``mesh_only`` phase 16 and the phases it is
    held against (4-6 without the kernel timings, 12), or with
    ``syncs_only`` phase 20, or with ``graphs_only`` phase 21; ``td`` holds
    the bench CSVs and what phase 13 writes."""
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
    if syncs_only:
        syncs = sync_phase(dev, card, lc_config(len(scans)), imu, scans,
                           rels)
        print(json.dumps({"ok": True, "syncs": syncs, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return
    if graphs_only:
        graphs = graph_phase(dev, card, lc_config(len(scans)), imu, scans,
                             rels)
        print(json.dumps({"ok": True, "graphs": graphs, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return
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
    lc_cfg = lc_config(len(scans))
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
    scaled = scaled_phase(dev, card, td)
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

    # ── 17. the bench layer ──────────────────────────────────────────────
    launches_bench = bench_phase(dev, card, td, (gt, scans, rels, imu))
    # ── 18. the rest of the bench layer ──────────────────────────────────
    launches_bench.update(bench_mesh_phase(dev, card, scaled["dump"]))
    # ── 19. the checkpoint path: phase 12 cut and resumed ────────────────
    resumed = resume_phase(dev, card, td, scaled)
    launches_bench["bench_scaled_resumed"] = resumed["launches"]
    # ── 20. the sync counters against torch's sync warnings ─────────────
    sync_phase(dev, card, lc_cfg, imu, scans, rels)
    # ── 21. icp_core's graph replays against its Python loop ───────────
    graph_phase(dev, card, lc_cfg, imu, scans, rels)

    # ── 14. the native CSV parser; 15. 3-D ICP and entry() ───────────────
    parser_phase(os.path.join(td, "bench_lidar.csv"))
    align3d, computed3d = icp3d_phase(dev, card, td)

    # ── 8-10. the features path, "both" with loop closure, modular ───────
    launches_feat = features_phases(SlamConfig, ate, dev, card, gt, scans,
                                    rels, imu, ate_m)
    launches_feat["bench_scaled"] = scaled["launches"]
    launches_feat["mesh_engine"] = mesh["engine"]
    launches_feat["mesh_scaled"] = mesh["scaled"]
    launches_feat.update(launches_bench)

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
    print(json.dumps({"kernels": kernels, "resume": resumed["summary"]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
