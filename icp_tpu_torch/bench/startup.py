"""The benchmarks' kernel guard, run before any timing (bench.py's on-chip
equality check, ``bench.py:90-111``): each hand kernel of the main path
against its plain version on the benchmark's device, at its inputs.

* ``nn_cuda`` on bench.py's own inputs (rng 3: 512 targets plus 256 of
  them again, so every row has a tie; 768 rows, targets masked from 700):
  indices and squared distances bit-equal to ``nn_plain``;
* ``nn_min_cuda`` at the main path's sweep shapes, one launch a call,
  bit-equal to ``nn_min_plain``;
* ``icp_segment_add`` on a segment plan (rows left out) and on a sorted
  index, f32 and f64, one launch a call, bit-equal to CPU ``index_add_``.

``check`` raises AssertionError on a mismatch. On the CPU the wrappers are
their plain versions, so it compares them with themselves.

The case generators are also ``chip_smoke.py``'s phase-3 cases.
"""
from __future__ import annotations

import numpy as np
import torch


def _cloud(rng, n, lo=-20.0, hi=20.0):
    return rng.uniform(lo, hi, (n, 2)).astype(np.float32)


def bench_tie_case(rng):
    """bench.py's guard inputs, drawn as bench.py draws them from rng 3:
    (label, src, tgt, tgt mask)."""
    base = rng.uniform(-5, 5, (512, 2)).astype(np.float32)
    return ("bench tie", rng.uniform(-5, 5, (768, 2)).astype(np.float32),
            np.concatenate([base, base[:256]]), np.arange(768) < 700)


def nn_cases(rng):
    """(label, src, tgt, mask) cases for nn_cuda: the main path's shapes,
    ties that straddle the kernel's target slices, and the edges of its
    launch geometry (M below one slice, M = 0, N = 1, every cluster size,
    a target that is not 16-byte aligned)."""
    cases = [
        # the tie case of bench.py (duplicate targets), random data at both
        # main-path shapes, and a ragged shape
        bench_tie_case(rng),
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


def main_sweep_shapes(cfg, first_scan, dev) -> dict:
    """{label: (rows, targets)} of nn_min_cuda's calls on the IMU main path:
    the submap sweep's coarse and fine passes, at the sweep capacities an
    engine sizes from the first scan."""
    from icp_tpu_torch.engine import SlamEngine

    probe = SlamEngine(cfg, verbose=False, device=dev)
    probe._resolve_sweep_caps(first_scan)
    src_cap, tgt_cap = probe._sweep_caps
    coarse, fine = imu_sweep_rows(cfg, src_cap)
    return {"main coarse": (coarse, tgt_cap), "main fine": (fine, tgt_cap)}


def segment_cases(rng):
    """(label, out, index, keep, src) cases for icp_segment_add on the CPU:
    a plan of 30,720 rows into 4,096 slots with a tenth of the rows left
    out (values +-0 there, as a pose graph's padded edges), f32 width 3
    and f64 width 1, and the voxel means' sorted index (keep None)."""
    n, slots = 30720, 4096
    index = torch.as_tensor(rng.integers(0, slots, n))
    keep = torch.as_tensor(rng.random(n) < 0.9)
    cases = []
    for dtype, width in ((torch.float32, 3), (torch.float64, 1)):
        src = torch.as_tensor(rng.normal(size=(n, width))).to(dtype)
        src[~keep] = 0.0
        cases.append((f"plan {str(dtype).split('.')[-1]} width {width}",
                      torch.zeros((slots, width), dtype=dtype), index, keep,
                      src))
    cases.append(("sorted index f32 width 3",
                  torch.zeros((slots, 3), dtype=torch.float32),
                  torch.sort(index).values, None,
                  torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32))))
    return cases


def check(dev, sweep_shapes: dict) -> dict:
    """The guard: raises AssertionError where a kernel differs from its
    plain version. ``sweep_shapes``: {label: (rows, targets)} of the
    nn_min_cuda calls to check. Returns the max absolute error per kernel
    key (``common.read_counts``'s keys)."""
    from icp_tpu_torch.ops import scatter as SC
    from icp_tpu_torch.ops.hopper import nn_kernel as K

    on_card = dev.type == "cuda"

    def t(a):
        return torch.as_tensor(a, device=dev)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    err = {}
    _, src, tgt, msk = bench_tie_case(np.random.default_rng(3))
    d_k, i_k = K.nn_cuda(t(src), t(tgt), t(msk))
    d_p, i_p = K.nn_plain(t(src), t(tgt), t(msk))
    sync()
    assert torch.equal(i_k, i_p), "nn_cuda indices != plain on bench.py's inputs"
    assert torch.equal(d_k, d_p), "nn_cuda d2 not bit-equal to plain on bench.py's inputs"
    err["nn"] = float((d_k - d_p).abs().max())

    rng = np.random.default_rng(11)
    err["nn_min"] = 0.0
    for label, (r, m) in sweep_shapes.items():
        rows, tg, mk = t(_cloud(rng, r)), t(_cloud(rng, m)), t(rng.random(m) < 0.9)
        before = K.nn_min_launches
        d_k = K.nn_min_cuda(rows, tg, mk)
        d_p = K.nn_min_plain(rows, tg, mk)
        sync()
        assert K.nn_min_launches == before + on_card, f"nn_min_cuda launches: {label}"
        assert torch.equal(d_k, d_p), f"nn_min_cuda not bit-equal to plain: {label} {r}x{m}"
        err["nn_min"] = max(err["nn_min"], float((d_k - d_p).abs().max()))

    err["segment_add"] = 0.0
    for label, out, index, keep, src in segment_cases(np.random.default_rng(5)):
        if keep is None:
            want = out.clone().index_add_(0, index, src)
            arg, srt = t(index), True
        else:
            want = out.clone().index_add_(0, index[keep], src[keep])
            arg, srt = SC.segment_plan(t(index), out.shape[0], keep=t(keep)), False
        before = SC.segment_add_launches
        got = SC.ordered_index_add_(t(out), arg, t(src), sorted_index=srt)
        sync()
        assert SC.segment_add_launches == before + on_card, f"icp_segment_add launches: {label}"
        assert torch.equal(got.cpu(), want), f"icp_segment_add not bit-equal to CPU index_add_: {label}"
        err["segment_add"] = max(err["segment_add"],
                                 float((got.cpu() - want).abs().max()))
    return err
