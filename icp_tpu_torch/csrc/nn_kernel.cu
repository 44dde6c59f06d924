// Brute-force 2-D nearest-neighbour kernels for Hopper (sm_90a).
//
// Replace the two Pallas TPU kernels of icp_tpu/ops/pallas/nn_kernel.py:
//   icp_nn     <- _nn_kernel     (via nn_pallas):     (min d2, argmin) per row
//   icp_nn_min <- _nn_min_kernel (via nn_min_pallas): min d2 per row
//
// Design. One thread owns one source row and keeps a running (best_d,
// best_i) in registers. The block stages tiles of the target as three
// shared-memory planes (x, y, valid) and every thread walks the whole tile
// (all threads read the same element: a shared-memory broadcast). The loop
// over tiles inside the block takes the place of the TPU kernel's
// sequential "j" grid axis and its VMEM scratch accumulator. Ragged N and M
// are handled here: rows past N do no work, the last tile is cut to M, so
// callers pad nothing.
//
// Semantics, held bit for bit against the plain torch version
// (ops/hopper/nn_kernel.py nn_plain / nn_min_plain):
//   * d2 = dx*dx + dy*dy with every operation rounded on its own
//     (__fsub_rn/__fmul_rn/__fadd_rn). nvcc would otherwise contract the
//     sum into an FMA, torch does not, and a one-ulp difference can flip
//     the argmin of two near-equal targets.
//   * masked targets count as BIG = 1e30; a row with no valid target gets
//     (BIG, 0), as the TPU kernel's initial scratch gives.
//   * ties go to the lowest target index: targets are visited in index
//     order and the running minimum is replaced only on strict "<".
//
// What bounds it. At the submap-ICP shape (768 sources x 4096 targets) the
// work is ~3 M pairs at ~5 flops each: far too little for the card, so it
// is latency- and occupancy-bound — 768 rows at 256 threads per block are
// 3 blocks on 132 SMs, and each thread runs a serial loop over all M
// targets. The sweep shape (up to 20 x 768 rows x 4096) fills 60 blocks.
// Later work: split M across blocks and finish with a second (min, argmin)
// pass, fuse the sweep's rotation/placement and per-angle masked mean into
// the min kernel, or capture the ICP iteration loop in a CUDA graph.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // source rows per block
constexpr int kTile = 1024;     // targets staged in shared memory per pass
constexpr float kBig = 1e30f;

__device__ __forceinline__ float sqdist(float sx, float sy, float tx, float ty) {
  const float dx = __fsub_rn(sx, tx);
  const float dy = __fsub_rn(sy, ty);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

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
nn_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
          const unsigned char* __restrict__ mask, int n, int m,
          float* __restrict__ out_d, int* __restrict__ out_i) {
  __shared__ float tx[kTile];
  __shared__ float ty[kTile];
  __shared__ unsigned char tv[kTile];

  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = row < n;
  const float sx = live ? src[2 * row] : 0.0f;
  const float sy = live ? src[2 * row + 1] : 0.0f;
  float best_d = kBig;
  int best_i = 0;

  for (int base = 0; base < m; base += kTile) {
    const int cnt = min(kTile, m - base);
    __syncthreads();  // previous tile fully consumed
    stage_tile(tgt, mask, base, cnt, tx, ty, tv);
    __syncthreads();
    if (live) {
      for (int j = 0; j < cnt; ++j) {
        const float d = tv[j] ? sqdist(sx, sy, tx[j], ty[j]) : kBig;
        if (d < best_d) {
          best_d = d;
          best_i = base + j;
        }
      }
    }
  }
  if (live) {
    out_d[row] = best_d;
    out_i[row] = best_i;
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
// `stream`; the return value is cudaGetLastError() after the launch.
extern "C" int icp_nn(const void* src, const void* tgt, const void* mask,
                      int n, int m, void* out_d, void* out_i, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  nn_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const float*>(tgt),
      static_cast<const unsigned char*>(mask), n, m,
      static_cast<float*>(out_d), static_cast<int*>(out_i));
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
