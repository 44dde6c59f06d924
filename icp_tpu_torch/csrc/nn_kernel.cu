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
// icp_nn_min: the rotation sweep's scorer (replaces _nn_min_kernel, via
// nn_min_pallas). Rows are angles x 768 placed points, targets the 1792
// (submap) or 768 (scan) sweep voxels: 9,984 and 15,360 x 1792 on the IMU
// main path, 115,968 and 24,576 x 1792 without IMU, 184,320 and 23,040 x
// 768 in loop-closure verification.
//
//   Bound. A pair costs 6 FP32 instructions (2 subtracts, 2 multiplies,
//   1 add, 1 min): bit-equality with the plain version forbids FMA, so
//   none fuses, and the H100's 67 TFLOP/s (an FMA counted as two) is 33.5
//   T instructions a second at 1.98 GHz: 37.2 us at 115,968 x 1792
//   (chip_smoke.py's kernel_bound; icp_nn's argmin adds a compare and a
//   select, 7 a pair). The bytes are negligible (1.41 MB there, 0.42 us
//   at 3.35 TB/s): every shape is bound by operations.
//   No tensor cores: ||s||^2 + ||t||^2 - 2 s.t gives other bits, and in
//   f32 it cancels catastrophically at map coordinates of tens of metres
//   (||s||^2 ~ 1e3 m^2 against the ~1e-4 m^2 being ranked); TF32 is worse.
//
//   The old design gave one thread one row and walked tiles of x, y and
//   mask planes: 3 shared-memory loads and a select for each pair (the
//   load/store pipe, not the FP32 pipe, set the rate), one serial fminf
//   chain a thread, and ceil(R / 256) blocks (39 and 60 on 132 SMs at the
//   main path's shapes). On an H100 80GB HBM3 at 700 W, device-only:
//   55.8 us at 15,360 x 1792, 110.0 us at 115,968 x 1792 (16.9 % of the
//   bound), 67.5 us at 184,320 x 768.
//
//   Design. A lane holds K = 4 or 8 rows in registers, so one staged
//   target feeds K independent min chains; the 8 warps of a block share
//   its 32 K rows and split its slice of the targets, and the csize <= 8
//   blocks of a cluster split the targets into slices. A block stages its
//   slice (2048 targets a pass; the scaled pipeline's 8192-target slices
//   take 2-4 passes) as float4 pairs,
//   a masked target as NaN: fminf(x, NaN) = x, so the inner loop has no
//   mask test and costs one broadcast LDS.128 per 2 targets per K rows,
//   5 FP32 instructions and 1 FMNMX per pair; the next float4 is loaded a
//   step ahead. The minimum of d2 >= 0 (never -0, NaN dropped) is exact
//   and order-free, so the warps' partial minima meet in shared memory
//   and the cluster's in rank 0's (distributed shared memory, as icp_nn)
//   with the same bits in any order: one launch, no atomics, no output to
//   initialise. A row starts at +inf and takes BIG only where its slices
//   hold a masked target (or M = 0), which is the plain version's
//   where(mask, d2, BIG).amin even for d2 above BIG. The host picks
//   (K, csize, slice) from (R, M) (ops/hopper/nn_kernel.py
//   nn_min_geometry) so that every sweep shape puts a block on each SM.
//
//   Times on an H100 80GB HBM3 at 700 W, device-only (CUDA-graph replays,
//   chip_smoke.py): 7.65 / 9.46 / 12.78 / 45.87 us at 9,984 / 15,360 /
//   24,576 / 115,968 x 1792 and 7.14 / 33.60 us at 23,040 / 184,320 x
//   768: 81 % and 75 % of the bound at the two large shapes. Past the
//   fixed cost the issue rate reached is ~0.89 of one instruction a cycle
//   at 115,968 rows and ~0.72 at 15,360 (tools/nn_min_sweep.py --detail). At the main path's shapes ~2 us are
//   fixed (the launch and one global round trip) and the rest is the
//   busiest SM's share of pairs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
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

constexpr int kMinWarps = 8;                  // split one block's targets
constexpr int kMinThreads = 32 * kMinWarps;   // 256
constexpr int kMinTile = 2048;   // targets staged in shared memory per pass

// K rows per lane; a block holds 32 * K rows, which all 8 warps share.
template <int K>
__global__ void __launch_bounds__(kMinThreads)
nn_min_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
              const unsigned char* __restrict__ mask, int n, int m, int csize,
              int slice, bool vec, float* __restrict__ out_d) {
  constexpr int kRows = 32 * K;
  extern __shared__ float4 tile[];             // (x0, y0, x1, y1): two targets
  __shared__ float part[kMinWarps][kRows];     // each warp's minima
  __shared__ float cpart[kMaxCluster][kRows];  // rank 0's copy: each rank's

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // a 1-D cluster of csize blocks: rank = blockIdx.x % csize
  const int rank = static_cast<int>(blockIdx.x % csize);
  const size_t row0 = static_cast<size_t>(blockIdx.x / csize) * kRows;
  const float nan = __int_as_float(0x7fffffff);
  if (csize > 1)   // as in nn_kernel: its wait comes before the pushes
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // this block's slice of the targets: [lo, hi)
  const int lo = static_cast<int>(min(static_cast<long long>(m),
                                      static_cast<long long>(rank) * slice));
  const int hi = static_cast<int>(min(static_cast<long long>(m),
                                      static_cast<long long>(lo) + slice));

  // lane owns rows row0 + lane + 32 r: coalesced loads and stores
  float sx[K], sy[K], best[K];
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const size_t row = row0 + lane + 32 * r;
    sx[r] = row < static_cast<size_t>(n) ? src[2 * row] : 0.0f;
    sy[r] = row < static_cast<size_t>(n) ? src[2 * row + 1] : 0.0f;
    best[r] = __int_as_float(0x7f800000);   // +inf
  }
  // the plain version counts a masked target as BIG and returns BIG for
  // M = 0; any other target enters as its own d2
  int masked = m == 0;

  for (int base = lo; base < hi; base += kMinTile) {
    const int end = min(hi, base + kMinTile);
    const int pairs = (end - base + 1) / 2;
    __syncthreads();  // previous tile fully consumed
    // stage pairs q: targets base + 2q and base + 2q + 1 (base is even);
    // masked targets, and the pad of an odd count, are NaN
    int any = 0;
    for (int q = tid; q < pairs; q += kMinThreads) {
      const int j = base + 2 * q;
      const size_t e = 2 * static_cast<size_t>(j);
      float4 v = make_float4(nan, nan, nan, nan);
      if (j + 1 < end) {
        v = vec ? __ldg(reinterpret_cast<const float4*>(tgt + e))
                : make_float4(tgt[e], tgt[e + 1], tgt[e + 2], tgt[e + 3]);
        if (!mask[j]) { v.x = v.y = nan; any = 1; }
        if (!mask[j + 1]) { v.z = v.w = nan; any = 1; }
      } else if (mask[j]) {
        v.x = tgt[e];
        v.y = tgt[e + 1];
      } else {
        any = 1;
      }
      tile[q] = v;
    }
    masked |= __syncthreads_or(any);
    // warp w walks its own contiguous run of pairs [q0, q1); all lanes
    // read the same float4 (a broadcast), and the next one is loaded before
    // this one is used, so the load's latency hides behind 12 K operations
    // (the tile has a spare float4 past its pairs for the last look-ahead).
    // fminf(x, NaN) = x drops the masked targets.
    const int per = (pairs + kMinWarps - 1) / kMinWarps;
    const int q0 = min(pairs, warp * per);
    const int q1 = min(pairs, q0 + per);
    float4 t = tile[q0];
#pragma unroll 2
    for (int q = q0; q < q1; ++q) {
      const float4 next = tile[q + 1];
#pragma unroll
      for (int r = 0; r < K; ++r)
        best[r] = fminf(best[r], fminf(sqdist(sx[r], sy[r], t.x, t.y),
                                       sqdist(sx[r], sy[r], t.z, t.w)));
      t = next;
    }
  }

  // warps -> one minimum per row; thread tid < kRows owns row row0 + tid
#pragma unroll
  for (int r = 0; r < K; ++r) part[warp][lane + 32 * r] = best[r];
  __syncthreads();
  const bool has_row = tid < kRows;
  const size_t row = row0 + tid;
  float v = masked ? kBig : __int_as_float(0x7f800000);
  if (has_row) {
#pragma unroll
    for (int w = 0; w < kMinWarps; ++w) v = fminf(v, part[w][tid]);
  }
  if (csize == 1) {
    if (has_row && row < static_cast<size_t>(n)) out_d[row] = v;
    return;
  }
  // ranks -> rank 0 (distributed shared memory), as in nn_kernel
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  if (has_row) cluster.map_shared_rank(&cpart[rank][0], 0)[tid] = v;
  cluster.sync();
  if (rank == 0 && has_row && row < static_cast<size_t>(n)) {
    float d = cpart[0][tid];
    for (int c = 1; c < csize; ++c) d = fminf(d, cpart[c][tid]);
    out_d[row] = d;
  }
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

// The launch geometry comes from the caller (ops/hopper/nn_kernel.py
// nn_min_geometry): k rows per lane (4 or 8), csize blocks to a cluster,
// each taking `slice` targets (even). Every target must lie in exactly one
// non-empty slice; anything else returns cudaErrorInvalidValue unlaunched.
extern "C" int icp_nn_min(const void* src, const void* tgt, const void* mask,
                          int n, int m, int k, int csize, int slice,
                          void* out_d, void* stream) {
  if (n <= 0) return 0;
  const long long cs = csize, sl = slice;
  if ((k != 4 && k != 8) || cs < 1 || cs > kMaxCluster || sl < 2 || sl % 2 ||
      cs * sl < m || (m > 0 && (cs - 1) * sl >= m) || (m == 0 && cs != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = 32LL * k;
  const bool vec = reinterpret_cast<uintptr_t>(tgt) % 16 == 0;

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((n + rows - 1) / rows * cs));
  cfg.blockDim = dim3(kMinThreads);
  cfg.dynamicSmemBytes = sizeof(float4) * ((std::min(slice, kMinTile) + 1) / 2 + 1);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = csize > 1 ? 1 : 0;
  auto kernel = k == 8 ? &nn_min_kernel<8> : &nn_min_kernel<4>;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const float*>(src), static_cast<const float*>(tgt),
      static_cast<const unsigned char*>(mask), n, m, csize, slice, vec,
      static_cast<float*>(out_d));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
