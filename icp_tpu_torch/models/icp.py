"""Iterative Closest Point on masked clouds (counterpart of
icp_tpu.models.icp: ``ICPResult``, ``icp_core``, ``icp``, ``identity_init``,
``icp_large``).

Each iteration is {NN query, correspondence gate, closed-form solve,
accumulate, convergence check} on device tensors. icp_tpu runs the loop as
one ``lax.while_loop``; here the iteration count depends on the data, and
reading the stop flag after every iteration would cost one host sync per
iteration. So the loop runs in chunks of ``_CHUNK`` iterations and reads
the flag once per chunk: once ``stop`` is set (or the iteration budget is
spent) every later iteration of the chunk leaves the state untouched, so the
result is exactly the while-loop's, at the cost of at most ``_CHUNK - 1``
wasted iterations.

``icp_core`` drives one iteration body (``_iteration``) in one of two ways.
On a card, in 2-D with the NN kernel, a chunk is a CUDA graph captured once
per shape (``_Graphs``) and replayed: the same kernels in the same order,
launched by one call instead of a few hundred from Python. Elsewhere (the
CPU, 3-D, whose SVD may synchronize, and the plain "xla" query) the chunk
is the Python loop (``_eager_chunks``).

Convergence as in icp_tpu (reference icp.py:215-218): stop when
|prev_error - error| < max(error_threshold, 32 ulp of error), where error
is the mean squared point-to-point NN residual over the valid sources.
"""
from __future__ import annotations

import threading
from typing import NamedTuple

import torch

from icp_tpu_torch.ops.eig2 import estimate_normals
from icp_tpu_torch.ops.hopper import nn_kernel
from icp_tpu_torch.ops.hopper.nn_kernel import nn_cuda
from icp_tpu_torch.ops.nn import nn_query
from icp_tpu_torch.ops.rigid import p2l_solve_2d, p2p_solve_2d, p2p_solve_3d
from icp_tpu_torch.ops.voxel import voxel_downsample
from icp_tpu_torch.utils import spans
from icp_tpu_torch.utils.masking import masked_mean

_F32_EPS = 1.1920929e-07
_CHUNK = 8          # ICP iterations between two reads of the stop flag
_GRAPH_KEYS = 32    # captured shapes a device keeps; later ones run eagerly


class ICPResult(NamedTuple):
    R: torch.Tensor          # (D, D) accumulated rotation
    t: torch.Tensor          # (D,) accumulated translation
    error: torch.Tensor      # scalar mean squared NN residual
    iters: torch.Tensor      # iterations executed (int32)
    n_inliers: torch.Tensor  # inlier count at the last executed iteration
    # points outside static capacities (icp_large: targets over `cap` or
    # the grid extent, plus the last binning's queries over qcells/qcap);
    # 0 for the brute-force ICPs
    dropped: torch.Tensor | int = 0


def _iteration(state, consts, use_gate, use_p2l, use_kernel, out=None):
    """One ICP iteration. ``state`` is (transformed, r_total, t_total,
    error, stop, n_in, it), ``consts`` (target, src_mask, tgt_mask,
    target_normals, min_inliers, max_corr_sq, err_thresh); returns the next
    state, written into the tensors of ``out`` where given."""
    transformed, r_total, t_total, error, stop, n_in, it = state
    target, src_mask, tgt_mask, target_normals, min_inliers, max_corr_sq, \
        err_thresh = consts
    o = out if out is not None else (None,) * 7
    dim = transformed.shape[1]
    live = ~stop        # it < max_iterations holds: the host counts
    if use_kernel:
        d2, nn_idx = nn_cuda(transformed, target, tgt_mask)
        nn_dists = torch.sqrt(d2)
        nn_idx = nn_idx.long()
    else:
        nn_dists, nn_idx = nn_query(transformed, target, tgt_mask, src_mask)
    nearest = target[nn_idx]
    if use_gate:
        inlier = (nn_dists * nn_dists < max_corr_sq) & src_mask
    else:
        inlier = src_mask
    w = inlier.to(torch.float32)
    n_in_new = w.sum()
    abort = n_in_new < min_inliers     # reference icp.py:186-187

    if use_p2l:
        r, t = p2l_solve_2d(transformed, nearest, target_normals[nn_idx], w)
    elif dim == 2:
        r, t = p2p_solve_2d(transformed, nearest, w)
    else:
        r, t = p2p_solve_3d(transformed, nearest, w)

    new_transformed = transformed @ r.T + t
    sq = ((nearest - new_transformed) ** 2).sum(-1)
    new_error = masked_mean(sq, src_mask)
    delta = torch.abs(error - new_error)
    eff_thresh = torch.maximum(err_thresh, 32.0 * _F32_EPS * new_error)
    converged = delta < eff_thresh

    # on abort keep the state (the reference breaks before applying the
    # solve); after stop, keep everything. Each select reads only what no
    # earlier one has written, so ``out`` may be ``state`` itself.
    apply = live & ~abort
    transformed = torch.where(apply, new_transformed, transformed, out=o[0])
    r_total = torch.where(apply, r @ r_total, r_total, out=o[1])
    t_total = torch.where(apply, t_total @ r.T + t, t_total, out=o[2])
    error = torch.where(apply, new_error, error, out=o[3])
    n_in = torch.where(live, n_in_new, n_in, out=o[5])
    it = torch.add(it, live.to(torch.int32), out=o[6])
    stop = torch.bitwise_or(stop | abort, converged, out=o[4])
    return transformed, r_total, t_total, error, stop, n_in, it


def _eager_chunks(state, consts, flags, max_iterations):
    """The Python loop: chunks of ``_CHUNK`` iterations, one stop read
    each. Returns (state, iterations run)."""
    done = 0
    while done < max_iterations:
        k = min(_CHUNK, max_iterations - done)
        for _ in range(k):
            state = _iteration(state, consts, *flags)
        done += k
        spans.count("icp.eager_chunks")
        spans.count("sync.icp.stop")
        if bool(state[4]):      # one host sync per chunk
            break
    return state, done


def _replays_graphs(is_cuda: bool, dim: int, nn_impl: str) -> bool:
    """Whether icp_core replays captured chunks: on a card, in 2-D, with
    the NN kernel. 3-D ICP's SVD may synchronize, and the "xla" query and
    the CPU keep the Python loop."""
    return is_cuda and dim == 2 and nn_impl != "xla"


def _chunk_lengths(max_iterations: int) -> list[int]:
    """The chunk lengths a run of ``max_iterations`` takes."""
    full, rest = divmod(max_iterations, _CHUNK)
    return [_CHUNK] * bool(full) + [rest] * bool(rest)


class _Graphs:
    """The captured chunks of one (device, N, M, point-to-line, gated) key
    over static buffers: ``run`` copies a call's tensors in, replays chunks
    with one stop read each, and clones the results out, so a later call
    leaves a returned ICPResult alone."""

    def __init__(self, dev, n, m, use_p2l, use_gate):
        f32 = torch.float32

        def buf(*shape, dtype=f32):
            return torch.empty(shape, dtype=dtype, device=dev)

        self.dev = dev
        self.flags = (use_gate, use_p2l, True)
        self.state = (buf(n, 2), buf(2, 2), buf(2), buf(),
                      buf(dtype=torch.bool), buf(), buf(dtype=torch.int32))
        self.consts = (buf(m, 2), buf(n, dtype=torch.bool),
                       buf(m, dtype=torch.bool),
                       buf(m, 2) if use_p2l else None, buf(), buf(), buf())
        self.values = None      # the host (max_corr_dist, error_threshold)
        self.chunks = {}        # length -> (graph, nn_cuda launches in it)
        self.pool = torch.cuda.graph_pool_handle()
        self.lock = threading.Lock()
        self.stream = None      # the stream of the last call

    def _capture(self, k):
        """Capture ``k`` iterations over the buffers, after one eager
        iteration on the capture stream (its cuBLAS workspace); launch
        counters keep only what runs."""
        cur = torch.cuda.current_stream(self.dev)
        side = _capture_stream(self.dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            _iteration(self.state, self.consts, *self.flags)
            n1 = nn_kernel.nn_launches
            g = torch.cuda.CUDAGraph()
            g.capture_begin(pool=self.pool, capture_error_mode="thread_local")
            try:
                s = self.state
                for i in range(k):
                    s = _iteration(s, self.consts, *self.flags,
                                   out=self.state if i == k - 1 else None)
            finally:
                g.capture_end()
        cur.wait_stream(side)
        self.chunks[k] = (g, nn_kernel.nn_launches - n1)
        nn_kernel.nn_launches = n1      # the eager iteration ran, not these
        spans.count("icp.graph_captures")

    def run(self, source, src_mask, target, tgt_mask, R_init, t_init,
            target_normals, n_valid, max_corr_dist, error_threshold,
            max_iterations):
        cur = torch.cuda.current_stream(self.dev)
        if self.stream is not None and self.stream != cur:
            cur.wait_stream(self.stream)
        self.stream = cur
        transformed, r, t, error, stop, n_in, it = self.state
        tgt, smask, tmask, normals, min_inliers, corr_sq, thresh = self.consts
        tgt.copy_(target)
        smask.copy_(src_mask)
        tmask.copy_(tgt_mask)
        if normals is not None:
            normals.copy_(target_normals)
        torch.clamp(torch.floor(n_valid / 10.0), min=3.0, out=min_inliers)
        # host constants are filled on the card, never copied to it, and
        # only when they change
        values = (max_corr_dist, error_threshold)
        if values != self.values:
            corr_sq.fill_(max_corr_dist).pow_(2)
            thresh.fill_(error_threshold)
            self.values = values
        transformed.copy_(source @ R_init.T + t_init)
        r.copy_(R_init)
        t.copy_(t_init)
        error.fill_(float("inf"))
        stop.zero_()
        n_in.zero_()
        it.zero_()
        for k in _chunk_lengths(max_iterations):
            if k not in self.chunks:
                self._capture(k)
        done = 0
        while done < max_iterations:
            k = min(_CHUNK, max_iterations - done)
            g, launches = self.chunks[k]
            g.replay()
            nn_kernel.nn_launches += launches
            done += k
            spans.count("icp.graph_replays")
            spans.count("sync.icp.stop")
            if bool(stop):          # one host sync per chunk
                break
        return (r.clone(), t.clone(), error.clone(), it.clone(),
                n_in.to(torch.int32)), done


_graphs: dict = {}          # (device, N, M, point-to-line, gated) -> _Graphs
_capture_streams: dict = {}


def _capture_stream(dev):
    s = _capture_streams.get(dev)
    if s is None:
        s = _capture_streams[dev] = torch.cuda.Stream(dev)
    return s


def _graphs_for(dev, n, m, use_p2l, use_gate):
    """The key's captured chunks, made at its first call; None once the
    device holds ``_GRAPH_KEYS`` keys."""
    key = (dev, n, m, use_p2l, use_gate)
    g = _graphs.get(key)
    if g is None:
        if sum(k[0] == dev for k in _graphs) >= _GRAPH_KEYS:
            return None
        g = _graphs.setdefault(key, _Graphs(dev, n, m, use_p2l, use_gate))
    return g


@spans.spanned("icp.core")
def icp_core(
    source, src_mask, target, tgt_mask, R_init, t_init,
    *,
    method: str = "point_to_point",
    max_iterations: int = 100,
    normal_k: int = 10,
    error_threshold=1e-7,
    max_corr_dist=0.0,
    use_gate: bool = False,
    nn_impl: str = "auto",
):
    """ICP on already-downsampled masked clouds, D in {2, 3}.

    source/target (N, D)/(M, D) with masks; R_init (D, D), t_init (D,).
    ``nn_impl``, for D = 2: "xla" uses the plain torch distance-matrix
    query (ops/nn.nn_query); any other value uses the NN kernel wrapper
    ``nn_cuda``, which launches the CUDA kernel on CUDA tensors and runs
    its plain version on CPU tensors. Both break ties toward the lower
    index. For D = 3 the query is always ``nn_query`` and the solve the
    point-to-point SVD, whatever ``nn_impl`` and ``method`` say: icp_tpu
    has no 3-D kernel and estimates no 3-D normals. On a card in 2-D with
    the kernel, each chunk replays a CUDA graph captured at the shape's
    first call (the module's docstring); the result is the same.
    """
    dim = source.shape[1]
    if dim not in (2, 3):
        raise ValueError(f"icp_core takes (N, 2) or (N, 3) clouds, got "
                         f"{tuple(source.shape)}")
    dev = source.device
    f32 = torch.float32
    use_p2l = method == "point_to_line" and dim == 2
    use_kernel = nn_impl != "xla" and dim == 2

    n_valid = src_mask.to(f32).sum()
    target_normals = (estimate_normals(target, tgt_mask, k=normal_k)
                      if use_p2l else None)
    graphs = (_graphs_for(dev, source.shape[0], target.shape[0], use_p2l,
                          use_gate)
              if max_iterations > 0 and _replays_graphs(
                  source.is_cuda, dim, nn_impl) else None)
    if graphs is not None:
        with graphs.lock, torch.cuda.device(dev):
            (r_total, t_total, error, it, n_in), done = graphs.run(
                source, src_mask, target, tgt_mask, R_init, t_init,
                target_normals, n_valid, max_corr_dist, error_threshold,
                max_iterations)
    else:
        min_inliers = torch.clamp(torch.floor(n_valid / 10.0), min=3.0)
        spans.count("sync.icp.consts", 3)   # the three host scalars below
        max_corr_sq = torch.tensor(max_corr_dist, dtype=f32, device=dev) ** 2
        err_thresh = torch.tensor(error_threshold, dtype=f32, device=dev)
        state = (source @ R_init.T + t_init, R_init, t_init,
                 torch.tensor(float("inf"), dtype=f32, device=dev),
                 torch.zeros((), dtype=torch.bool, device=dev),
                 torch.zeros((), dtype=f32, device=dev),
                 torch.zeros((), dtype=torch.int32, device=dev))
        consts = (target, src_mask, tgt_mask, target_normals, min_inliers,
                  max_corr_sq, err_thresh)
        state, done = _eager_chunks(state, consts,
                                    (use_gate, use_p2l, use_kernel),
                                    max_iterations)
        _, r_total, t_total, error, _, n_in, it = state
        n_in = n_in.to(torch.int32)
    if use_kernel and spans.live():
        # the NN kernel's pairs: each launch's padded rows x targets, and
        # the valid ones of the live iterations (summed when read)
        spans.count("nn.pairs_computed",
                    done * source.shape[0] * target.shape[0])
        spans.count("nn.pairs_valid", (n_valid, tgt_mask.sum(), it))
    return ICPResult(r_total, t_total, error, it, n_in)


def icp(
    source, src_mask, target, tgt_mask, R_init, t_init,
    *,
    voxel_size,
    method: str = "point_to_point",
    max_iterations: int = 100,
    normal_k: int = 10,
    error_threshold=1e-7,
    max_corr_dist=0.0,
    use_gate: bool = False,
    nn_impl: str = "auto",
):
    """Full ICP entry: voxel-downsample both clouds, then run icp_core."""
    src_d, src_dm = voxel_downsample(source, src_mask, voxel_size)
    tgt_d, tgt_dm = voxel_downsample(target, tgt_mask, voxel_size)
    return icp_core(
        src_d, src_dm, tgt_d, tgt_dm, R_init, t_init,
        method=method, max_iterations=max_iterations, normal_k=normal_k,
        error_threshold=error_threshold, max_corr_dist=max_corr_dist,
        use_gate=use_gate, nn_impl=nn_impl,
    )


def identity_init(dim: int = 2, device="cuda"):
    """Identity (R, t) pair for the 'no initial guess' case."""
    return (torch.eye(dim, dtype=torch.float32, device=device),
            torch.zeros(dim, dtype=torch.float32, device=device))


def _row_bound(occupied: int, qcells: int) -> int:
    """compact_nn's row bound for one icp_large call: the occupied compact
    rows of the first binning with headroom for re-binning, in steps of 64
    so the buffers' shapes repeat across calls."""
    want = occupied + max(64, occupied // 4)
    return min(qcells, -(-want // 64) * 64)


@spans.spanned("icp.large")
def icp_large(
    source, src_mask, target, tgt_mask, R_init, t_init,
    *,
    max_corr_dist,
    max_iterations: int = 50,
    error_threshold=1e-7,
    grid_shape: tuple = (256, 256),
    cap: int = 16,
    qcap: int = 16,
    qcells: int = 4096,
    cell_size=None,
    method: str = "point_to_point",
):
    """Gated ICP for large clouds (10^5+ points) on a dense cell grid.

    Correspondences come from ``ops.densegrid``: the target is binned once
    with cell size >= max_corr_dist (1.5x by default), which is exact for
    every pair the gate keeps. The source lives in compact cell-binned
    planes that each iteration transforms in place; it is re-binned when
    the accumulated movement exceeds the margin cell_size - max_corr_dist.
    ``method="point_to_line"`` takes per-cell target normals
    (``cell_normals``), looked up at each binning, with the residual
    direction where a cell's neighbourhood is degenerate, and centres the
    solve on the weighted source centroid (f32 at 100 m coordinates).

    icp_tpu runs the loop as one ``lax.while_loop`` with a ``lax.cond``
    re-bin. Here, as in ``icp_core``, it runs in chunks of ``_CHUNK``
    iterations with one host read each, and every iteration after ``stop``
    leaves the state untouched. The re-binned planes are computed every
    iteration and selected where the drift exceeds the margin, so the
    host never reads the drift. ``compact_nn`` compares only the first
    ``rows`` compact rows, a bound set from the first binning; the read at
    the end of a chunk also says whether a re-bin in it occupied more rows,
    and then the chunk runs again over all ``qcells`` rows. The result is
    the while-loop's.
    """
    from icp_tpu_torch.ops.densegrid import (
        CompactQueries, bin_queries, build_dense_grid, cell_normals,
        compact_nn, grid_origin)

    dev = source.device
    f32 = torch.float32
    use_p2l = method == "point_to_line"
    spans.count("sync.icp.consts", sum(
        x is not None and not isinstance(x, torch.Tensor)
        for x in (max_corr_dist, error_threshold, cell_size)))
    max_corr = torch.as_tensor(max_corr_dist, dtype=f32, device=dev)
    cell = (1.5 * max_corr if cell_size is None
            else torch.as_tensor(cell_size, dtype=f32, device=dev))
    margin = cell - max_corr
    origin = grid_origin(target, tgt_mask, cell)
    grid = build_dense_grid(target, tgt_mask, cell, origin,
                            grid_shape=grid_shape, cap=cap)
    if use_p2l:
        nrm = cell_normals(grid)
    n_valid = src_mask.to(f32).sum()
    min_inliers = torch.clamp(torch.floor(n_valid / 10.0), min=3.0)
    err_thresh = torch.as_tensor(error_threshold, dtype=f32, device=dev)
    max_corr_sq = max_corr * max_corr
    Cx = grid_shape[1]

    def rebin(r_total, t_total):
        pts = source @ r_total.T + t_total
        cq = bin_queries(pts, src_mask, origin, cell, grid_shape=grid_shape,
                         qcells=qcells, qcap=qcap)
        if not use_p2l:
            return cq, ()
        rows_ = cq.cell_yx[:, 0].to(torch.int64) * Cx + cq.cell_yx[:, 1]
        return cq, tuple(p[rows_] for p in nrm)

    def step(s, rows):
        it, cq, nq, r_total, t_total, error, stop, n_in, drift, need = s
        live = ~stop
        d2, _, bx, by = compact_nn(cq, grid, rows)
        inlier = (d2 < max_corr_sq) & cq.mask
        w = inlier.to(f32)
        n_in_new = w.sum()
        abort = n_in_new < min_inliers

        a = torch.stack([cq.x.reshape(-1), cq.y.reshape(-1)], dim=1)
        b = torch.stack([bx.reshape(-1), by.reshape(-1)], dim=1)
        wf = w.reshape(-1)
        if use_p2l:
            nqx, nqy, nok = nq
            # residual-direction fallback for degenerate cells
            d_s = torch.sqrt(torch.clamp(d2, min=1e-12))
            fbx = (bx - cq.x) / d_s
            fby = (by - cq.y) / d_s
            nrm_ = torch.stack(
                [torch.where(nok[:, None], nqx[:, None], fbx).reshape(-1),
                 torch.where(nok[:, None], nqy[:, None], fby).reshape(-1)],
                dim=1)
            cw = (a * wf[:, None]).sum(0) / torch.clamp(n_in_new, min=1.0)
            r, t1 = p2l_solve_2d(a - cw, b - cw, nrm_, wf)
            t = t1 + cw - r @ cw
        else:
            r, t = p2p_solve_2d(a, b, wf)

        # transform the compact planes in place (rigid, elementwise)
        mx = r[0, 0] * cq.x + r[0, 1] * cq.y + t[0]
        my = r[1, 0] * cq.x + r[1, 1] * cq.y + t[1]
        sq = (bx - mx) ** 2 + (by - my) ** 2
        new_error = masked_mean(sq, inlier)
        delta = torch.abs(error - new_error)
        eff = torch.maximum(err_thresh, 32.0 * _F32_EPS * new_error)
        converged = delta < eff

        keep = ~abort
        kf = keep.to(f32)
        mx = kf * mx + (1.0 - kf) * cq.x
        my = kf * my + (1.0 - kf) * cq.y
        apply = live & keep
        r_total = torch.where(apply, r @ r_total, r_total)
        t_total = torch.where(apply, t_total @ r.T + t, t_total)

        # conservative drift bound: the largest per-point displacement
        move_sq = torch.where(cq.mask, (mx - cq.x) ** 2 + (my - cq.y) ** 2,
                              0.0).amax()
        drift_new = drift + torch.sqrt(move_sq)
        rb = live & (drift_new > margin)
        cq_rb, nq_rb = rebin(r_total, t_total)
        moved = cq._replace(x=torch.where(live, mx, cq.x),
                            y=torch.where(live, my, cq.y))
        cq = CompactQueries(*(torch.where(rb, u, v)
                              for u, v in zip(cq_rb, moved)))
        nq = tuple(torch.where(rb, u, v) for u, v in zip(nq_rb, nq))
        need = torch.maximum(need, cq.cell_mask.sum())
        return (it + live.to(torch.int32), cq, nq, r_total, t_total,
                torch.where(apply, new_error, error), stop | abort | converged,
                torch.where(live, n_in_new, n_in),
                torch.where(live, torch.where(rb, 0.0, drift_new), drift),
                need)

    cq, nq = rebin(R_init, t_init)
    occupied = cq.cell_mask.sum()
    spans.count("sync.icp.rows")
    rows = _row_bound(int(occupied), qcells)
    zero = torch.zeros((), dtype=f32, device=dev)
    s = (torch.zeros((), dtype=torch.int32, device=dev), cq, nq, R_init,
         t_init, torch.full((), float("inf"), dtype=f32, device=dev),
         torch.zeros((), dtype=torch.bool, device=dev), zero, zero, occupied)
    done = 0
    while done < max_iterations:
        k = min(_CHUNK, max_iterations - done)
        out = s
        for _ in range(k):
            out = step(out, rows)
        spans.count("sync.icp.stop")
        stop, need = torch.stack([out[6].to(torch.int64), out[9]]).tolist()
        if need > rows:         # a re-bin outgrew the bound: redo on all rows
            rows = qcells
            out = s
            for _ in range(k):
                out = step(out, rows)
            spans.count("sync.icp.stop")
            stop = bool(out[6])
        s = out
        done += k
        if stop:
            break
    it, cq, _, r_total, t_total, error, _, n_in, _, _ = s
    return ICPResult(r_total, t_total, error, it, n_in.to(torch.int32),
                     grid.overflow + cq.overflow)
