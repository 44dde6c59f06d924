// Brute-force 2-D nearest-neighbour kernels for Hopper (sm_90a).
//
// Replace the two Pallas TPU kernels of icp_tpu/ops/pallas/nn_kernel.py:
//   icp_nn     <- _nn_kernel     (via nn_pallas):     (min d2, argmin) per row
//   icp_nn_min <- _nn_min_kernel (via nn_min_pallas): min d2 per row
//
// Semantics, held bit for bit against the plain torch versions
// (ops/hopper/nn_kernel.py nn_plain / nn_min_plain):
//   * d2 = dx*dx + dy*dy with every operation rounded on its own
//     (__fsub_rn/__fmul_rn/__fadd_rn). nvcc would otherwise contract the
//     sum into an FMA, torch does not, and a one-ulp difference can flip
//     the argmin of two near-equal targets.
//   * masked targets count as BIG = 1e30; a row with no valid target gets
//     (BIG, 0), as the TPU kernel's initial scratch gives.
//   * ties go to the lowest target index.
//   * any N and M: ragged edges are cut inside the kernels, callers pad
//     nothing.
//
// icp_nn: the ICP correspondence query, at 768 x 768 (scan-to-scan) and
// 768 x 4096 (submap) on the main path, called ~26 times per scan.
//
//   The old design gave one thread one row and walked all M targets in one
//   serial chain (shared-memory load, sub, mul, add, compare, select: ~70
//   cycles a target). 768 rows at 256 threads a block made 3 blocks on 132
//   SMs, so 4096 targets took ~155 us for ~3 M pairs of work.
//
//   The answer is the lexicographic minimum of (d2, j) over all targets j,
//   with (BIG, 0) as the start. That min is associative and commutative,
//   so the targets can be cut into slices, each reduced on its own, and
//   the partial pairs combined in any order with the same bits every time,
//   as long as every comparison across threads and blocks is
//   "d < bd || (d == bd && j < bj)". Inside one thread the targets are
//   visited in index order, so a strict "<" is enough there.
//
//   Design. A thread-block cluster of C <= 8 blocks shares one group of
//   32 source rows; block rank r of the cluster takes one contiguous slice
//   of the targets (whole 64-target chunks; the host picks the slice so
//   that 8 slices cover M, then C = the number of non-empty slices, and
//   one block when M = 0). Each block stages its slice in shared memory
//   with 16-byte loads of the interleaved (M, 2) array and byte loads of
//   the mask (scalar loads where the target is not 16-byte aligned); a
//   masked target is staged as NaN, which no comparison accepts, so the
//   inner loop has no mask test and the (BIG, 0) start stands for it
//   exactly as the plain version's BIG does. Each warp owns 4 rows held in
//   registers (4 independent compare chains per shared-memory load), its
//   32 lanes stride over the slice two targets at a time, and a 5-step
//   butterfly of warp shuffles reduces the lanes. Each block then stores
//   its 32 partial (d2, idx) pairs into rank 0's shared memory through
//   distributed shared memory (map_shared_rank), one cluster.sync() makes
//   them visible, and rank 0 combines them and writes the outputs. The
//   stores need every block of the cluster to have started: the arrive of
//   a split cluster barrier at the top of the kernel and its wait before
//   the stores show that at almost no cost. (Rank 0 loading its peers'
//   pairs instead needs a second full barrier to keep the peers' shared
//   memory alive: ~0.5 us more a call, measured below.)
//   768 x 4096 makes 24 clusters of 8 (192 blocks), 768 x 768 24 clusters
//   of 6 (144 blocks).
//
//   One launch per call, no memset, no second pass, no scratch buffer:
//   the main path is bound by the host's launch rate (~2,500 launches per
//   scan), so a design that needs an initialised output (a packed 64-bit
//   atomicMin) or a second reduction pass would cost more launches than
//   it saves. What bounds the new design is latency, not work. On an H100
//   SXM at 700 W, in device-only time: an empty 192-block launch takes
//   ~1.0 us; the kernel takes ~3.5 us at 768 x 768 and ~4.7 us at
//   768 x 4096 (~4.1 and ~5.2 us with rank 0 loading from its peers
//   behind two full barriers). Between the launch and the outputs lie one
//   global-load round trip to stage the slice, a few hundred cycles of
//   compute per lane, the shuffles and one cluster barrier.
//
// icp_nn_min: the rotation sweep's scorer, at 20 x 768 rows x ~1800
// targets. One thread owns one row and keeps its running minimum in
// registers; the block stages tiles of the target as three shared-memory
// planes (x, y, valid) and every thread walks the whole tile (a
// shared-memory broadcast). 15360 rows fill 60 blocks. Later work: fuse
// the sweep's rotation/placement and per-angle masked mean into it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr float kBig = 1e30f;

__device__ __forceinline__ float sqdist(float sx, float sy, float tx, float ty) {
  const float dx = __fsub_rn(sx, tx);
  const float dy = __fsub_rn(sy, ty);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// ── icp_nn ────────────────────────────────────────────────────────────────

constexpr int kRowsPerWarp = 4;                          // rows in registers
constexpr int kNnWarps = 8;
constexpr int kNnThreads = 32 * kNnWarps;                 // 256
constexpr int kNnRows = kRowsPerWarp * kNnWarps;          // 32 rows a cluster
constexpr int kChunk = 64;          // targets per lane step (a float4 a lane)
constexpr int kNnTile = 2 * kNnThreads;  // 512 targets staged per pass
constexpr int kMaxCluster = 8;      // the portable maximum cluster size

__device__ __forceinline__ bool lex_less(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

__global__ void __launch_bounds__(kNnThreads)
nn_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
          const unsigned char* __restrict__ mask, int n, int m, int slice,
          bool vec, float* __restrict__ out_d, int* __restrict__ out_i) {
  __shared__ float4 tile[kNnTile / 2];   // (x0, y0, x1, y1): two targets
  // rank 0's copy collects every rank's (d2, idx bits) per row
  __shared__ float2 part[kMaxCluster][kNnRows];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int row0 = static_cast<int>(blockIdx.x / csize) * kNnRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float nan = __int_as_float(0x7fffffff);
  // first half of a split cluster barrier: its wait, before the stores
  // into rank 0's shared memory, only has to show that every block of the
  // cluster has started, so the work in between hides it
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // this block's slice of the targets: [lo, hi)
  const int lo = static_cast<int>(min(static_cast<long long>(m),
                                      static_cast<long long>(rank) * slice));
  const int hi = static_cast<int>(min(static_cast<long long>(m),
                                      static_cast<long long>(lo) + slice));

  float sx[kRowsPerWarp], sy[kRowsPerWarp], bd[kRowsPerWarp];
  int bi[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + warp * kRowsPerWarp + r;
    sx[r] = row < n ? src[2 * static_cast<size_t>(row)] : 0.0f;
    sy[r] = row < n ? src[2 * static_cast<size_t>(row) + 1] : 0.0f;
    bd[r] = kBig;
    bi[r] = 0;
  }

  for (int base = lo; base < hi; base += kNnTile) {
    const int end = min(hi, base + kNnTile);
    const int steps = (end - base + kChunk - 1) / kChunk;
    __syncthreads();  // previous tile fully consumed
    // stage pairs q: targets base + 2q and base + 2q + 1 (base is even);
    // masked targets and the pad up to a whole chunk are NaN
    for (int q = threadIdx.x; q < steps * 32; q += kNnThreads) {
      const int j = base + 2 * q;
      const size_t e = 2 * static_cast<size_t>(j);
      float4 v = make_float4(nan, nan, nan, nan);
      if (j + 1 < end) {
        v = vec ? __ldg(reinterpret_cast<const float4*>(tgt + e))
                : make_float4(tgt[e], tgt[e + 1], tgt[e + 2], tgt[e + 3]);
        if (!mask[j]) v.x = v.y = nan;
        if (!mask[j + 1]) v.z = v.w = nan;
      } else if (j < end && mask[j]) {
        v.x = tgt[e];
        v.y = tgt[e + 1];
      }
      tile[q] = v;
    }
    __syncthreads();
    for (int k = 0; k < steps; ++k) {
      const int q = lane + 32 * k;
      const float4 t = tile[q];
      const int j = base + 2 * q;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float d0 = sqdist(sx[r], sy[r], t.x, t.y);
        if (d0 < bd[r]) {
          bd[r] = d0;
          bi[r] = j;
        }
        const float d1 = sqdist(sx[r], sy[r], t.z, t.w);
        if (d1 < bd[r]) {
          bd[r] = d1;
          bi[r] = j + 1;
        }
      }
    }
  }

  // lanes -> one pair per row (every lane ends with the warp's minimum)
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd[r], off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi[r], off);
      if (lex_less(od, oi, bd[r], bi[r])) {
        bd[r] = od;
        bi[r] = oi;
      }
    }
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (lane == 0) {   // this warp's rows into rank 0 (distributed shared memory)
    float2* dst = cluster.map_shared_rank(&part[rank][0], 0);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
      dst[warp * kRowsPerWarp + r] = make_float2(bd[r], __int_as_float(bi[r]));
  }
  cluster.sync();  // release/acquire: every rank's pairs visible to rank 0
  if (rank == 0 && threadIdx.x < kNnRows) {
    const int t = threadIdx.x;
    float d = part[0][t].x;
    int i = __float_as_int(part[0][t].y);
    for (int c = 1; c < csize; ++c) {
      if (lex_less(part[c][t].x, __float_as_int(part[c][t].y), d, i)) {
        d = part[c][t].x;
        i = __float_as_int(part[c][t].y);
      }
    }
    const int row = row0 + t;
    if (row < n) {
      out_d[row] = d;
      out_i[row] = i;
    }
  }
}

// ── icp_nn_min ────────────────────────────────────────────────────────────

constexpr int kThreads = 256;   // source rows per block
constexpr int kTile = 1024;     // targets staged in shared memory per pass

// Stage target[base : base + cnt] into the shared planes.
__device__ __forceinline__ void stage_tile(const float* __restrict__ tgt,
                                           const unsigned char* __restrict__ mask,
                                           int base, int cnt, float* tx, float* ty,
                                           unsigned char* tv) {
  for (int j = threadIdx.x; j < cnt; j += blockDim.x) {
    tx[j] = tgt[2 * (base + j)];
    ty[j] = tgt[2 * (base + j) + 1];
    tv[j] = mask[base + j];
  }
}

__global__ void __launch_bounds__(kThreads)
nn_min_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
              const unsigned char* __restrict__ mask, int n, int m,
              float* __restrict__ out_d) {
  __shared__ float tx[kTile];
  __shared__ float ty[kTile];
  __shared__ unsigned char tv[kTile];

  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = row < n;
  const float sx = live ? src[2 * row] : 0.0f;
  const float sy = live ? src[2 * row + 1] : 0.0f;
  float best_d = kBig;

  for (int base = 0; base < m; base += kTile) {
    const int cnt = min(kTile, m - base);
    __syncthreads();
    stage_tile(tgt, mask, base, cnt, tx, ty, tv);
    __syncthreads();
    if (live) {
      for (int j = 0; j < cnt; ++j) {
        const float d = tv[j] ? sqdist(sx, sy, tx[j], ty[j]) : kBig;
        best_d = fminf(best_d, d);
      }
    }
  }
  if (live) out_d[row] = best_d;
}

}  // namespace

// Plain C interface (loaded with ctypes). Pointers are device pointers of
// contiguous tensors: src (n, 2) f32, tgt (m, 2) f32, mask (m,) bool (one
// byte each), out_d (n,) f32, out_i (n,) int32. The launch goes on
// `stream`; the return value is the launch's error, else
// cudaGetLastError() after it.
extern "C" int icp_nn(const void* src, const void* tgt, const void* mask,
                      int n, int m, void* out_d, void* out_i, void* stream) {
  if (n <= 0) return 0;
  // whole 64-target chunks per slice, at most kMaxCluster slices; the
  // cluster has one block per non-empty slice (one block when m == 0)
  const long long chunks = (static_cast<long long>(m) + kChunk - 1) / kChunk;
  const long long per_block =
      chunks > 0 ? (chunks + kMaxCluster - 1) / kMaxCluster : 1;
  const int csize =
      chunks > 0 ? static_cast<int>((chunks + per_block - 1) / per_block) : 1;
  const int slice = static_cast<int>(per_block * kChunk);
  const int row_groups = (n + kNnRows - 1) / kNnRows;
  const bool vec = reinterpret_cast<uintptr_t>(tgt) % 16 == 0;

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(row_groups * csize);
  cfg.blockDim = dim3(kNnThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, nn_kernel, static_cast<const float*>(src),
      static_cast<const float*>(tgt), static_cast<const unsigned char*>(mask),
      n, m, slice, vec, static_cast<float*>(out_d), static_cast<int*>(out_i));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int icp_nn_min(const void* src, const void* tgt, const void* mask,
                          int n, int m, void* out_d, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  nn_min_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const float*>(tgt),
      static_cast<const unsigned char*>(mask), n, m,
      static_cast<float*>(out_d));
  return static_cast<int>(cudaGetLastError());
}
