// Ordered scatter-sum for Hopper (sm_90a): icp_segment_add.
//
// A port-only kernel: icp_tpu has no Pallas counterpart, since XLA's
// scatter-add is deterministic. torch's CUDA index_add_ adds through float
// atomics, in an order that changes from run to run, so every voxel mean
// and every pose-graph assembly came out with other rounding on each run.
// This kernel gives what CPU out.index_add_(0, index, src) gives, bit for
// bit: each slot starts from out's value and adds its source rows one
// after another in ascending source-row order.
//
// Input. The wrapper (ops/scatter.py ordered_index_add_) hands over the
// index in non-decreasing order (a stable torch.sort, skipped where the
// caller's index is already sorted) and, where it sorted, the permutation
// that maps a sorted position to its source row. Equal slots are then
// contiguous runs, and inside a run the stable sort keeps the source rows
// in ascending order.
//
// Design. Thread t owns the pair (row t / width, column t % width) of the
// (rows, width) source, for any width (the callers use 1, 3, 4 and 9).
// Run starts are found on the device, by comparing a row's slot with the
// row before it: no host read, no second pass. The thread that owns a
// run's first row starts from out's value for its column and adds the
// run's rows in order, each add __fadd_rn / __dadd_rn, rounded on its
// own, as torch's CPU loop adds. The adds of a run are one chain on one
// thread; what costs is the memory round trip before a group of rows can
// be added:
//   * short runs (the points of a voxel): the owner loads 4 rows' slots
//     and values at once and adds them while the slot still matches;
//   * longer runs (a pose graph's padded edges all sit at node 0: ~1,900
//     rows a slot of b and ~3,800 of H at 1,024 nodes) of one column go
//     on with the whole warp: for each of its lanes with a run left, in
//     turn, the 32 lanes load the next 32 rows (then 256, 8 a lane) of
//     that run at once, a ballot counts the rows still in the run (the
//     index never decreases, so they are a prefix), and the owner takes
//     their values by shuffles, in row order, into its chain. A round
//     trip then brings 256 rows, not 4;
//   * longer runs of several columns (the PCG step's per-node b and 3 x 3
//     blocks): the owners of a row's columns sit side by side in a warp,
//     so each goes on alone, 32 rows a step while the step's last row is
//     in the run, then 4 a step.
// An unsorted index comes with the sort's permutation, read before each
// value; the kernel is built once with and once without it.
//
// Bound. Bytes: each index and source value read once, each touched slot
// read and written once (chip_smoke.py counts it that way). The adds are
// few (one a source value) and the work has no reuse, so every shape is
// bytes-bound; at the main path's 30,720-row submap merge the bound is
// well under a microsecond and a call is a launch's latency. Ordered
// sums cost this: a run of L rows is L dependent adds (and, past its
// first 4 rows, L shuffles) on one thread.
//
// One launch a call, no memset, no atomics, no scratch. A slot outside
// [0, n_slots) is skipped (torch's index_add_ raises); callers build their
// indices in range.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kShort = 4;     // rows the owner loads itself
constexpr int kLong = 32;     // rows an owner loads a step (width > 1)
constexpr int kPer = 8;       // rows a lane a warp step, past the first
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T, bool kPerm>
__device__ __forceinline__ T load_row(const T* __restrict__ src,
                                      const int64_t* __restrict__ perm,
                                      int64_t r, int width, int col) {
  const int64_t from = kPerm ? perm[r] : r;
  return src[from * width + col];
}

template <typename T, bool kPerm>
__global__ void __launch_bounds__(kThreads)
segment_add_kernel(T* __restrict__ out, const T* __restrict__ src,
                   const int64_t* __restrict__ idx,
                   const int64_t* __restrict__ perm, int64_t n_rows,
                   int width, int64_t n_slots) {
  // every lane stays to the end: the warp steps below need all 32
  const int lane = threadIdx.x & 31;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool valid = t < n_rows * width;
  const int64_t row = valid ? t / width : 0;
  const int col = valid ? static_cast<int>(t - row * width) : 0;
  const int64_t slot = valid ? idx[row] : -1;
  const bool owner = valid && slot >= 0 && slot < n_slots &&
                     (row == 0 || idx[row - 1] != slot);

  // the owner's first kShort rows
  T acc = T(0);
  bool more = false;
  if (owner) {
    acc = out[slot * width + col];
    int64_t s[kShort];
    T v[kShort];
#pragma unroll
    for (int u = 0; u < kShort; ++u) {
      const int64_t r = row + u;
      s[u] = r < n_rows ? idx[r] : -1;
      v[u] = r < n_rows ? load_row<T, kPerm>(src, perm, r, width, col) : T(0);
    }
    more = true;
#pragma unroll
    for (int u = 0; u < kShort; ++u) {
      more = more && s[u] == slot;
      if (more) acc = add_rn(acc, v[u]);
    }
    if (more && width > 1) {
      // rows of several columns: each owner goes on alone, kLong rows a
      // step while the step's last row is still in the run (the index
      // never decreases), then kShort rows a step
      int64_t j = row + kShort;
      for (;;) {
        const int64_t last = j + kLong - 1;
        if (last >= n_rows) break;
        T w[kLong];
#pragma unroll
        for (int u = 0; u < kLong; ++u)
          w[u] = load_row<T, kPerm>(src, perm, j + u, width, col);
        if (idx[last] != slot) break;
#pragma unroll
        for (int u = 0; u < kLong; ++u) acc = add_rn(acc, w[u]);
        j += kLong;
      }
      for (bool go = true; go; j += kShort) {
#pragma unroll
        for (int u = 0; u < kShort; ++u) {
          const int64_t r = j + u;
          s[u] = r < n_rows ? idx[r] : -1;
          v[u] = r < n_rows ? load_row<T, kPerm>(src, perm, r, width, col)
                            : T(0);
        }
#pragma unroll
        for (int u = 0; u < kShort; ++u) {
          go = go && s[u] == slot;
          if (go) acc = add_rn(acc, v[u]);
        }
      }
      more = false;
    }
    if (!more) out[slot * width + col] = acc;
  }

  // one column: the rest of each longer run, the warp together, one run
  // at a time
  int64_t next = row + kShort;               // the owner's next row
  int per = 1;                               // rows a lane this step
  unsigned pending = __ballot_sync(kAll, more);
  while (pending) {
    const int leader = __ffs(pending) - 1;
    const int64_t j = __shfl_sync(kAll, next, leader);
    const int64_t ls = __shfl_sync(kAll, slot, leader);
    const int lc = __shfl_sync(kAll, col, leader);
    const int lper = __shfl_sync(kAll, per, leader);
    T v[kPer];
    int in_run = 0;                          // rows of this step in the run
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      // slots and values loaded together; only the run's prefix is added
      const int64_t r = j + u * 32 + lane;
      const bool ok = u < lper && r < n_rows;
      const int64_t sr = ok ? idx[r] : -1;
      v[u] = ok ? load_row<T, kPerm>(src, perm, r, width, lc) : T(0);
      in_run += __popc(__ballot_sync(kAll, sr == ls));
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      if (u * 32 >= in_run) break;           // uniform across the warp
      for (int l = 0; l < 32 && u * 32 + l < in_run; ++l) {
        const T x = __shfl_sync(kAll, v[u], l);
        if (lane == leader) acc = add_rn(acc, x);
      }
    }
    if (in_run == lper * 32) {               // the run may go on
      if (lane == leader) {
        next = j + lper * 32;
        per = kPer;
      }
    } else {
      if (lane == leader) out[ls * width + lc] = acc;
      pending &= ~(1u << leader);
    }
  }
}

template <typename T>
void launch(T* out, const T* src, const int64_t* idx, const int64_t* perm,
            long long n_rows, int width, long long n_slots, unsigned blocks,
            cudaStream_t s) {
  if (perm)
    segment_add_kernel<T, true><<<blocks, kThreads, 0, s>>>(
        out, src, idx, perm, n_rows, width, n_slots);
  else
    segment_add_kernel<T, false><<<blocks, kThreads, 0, s>>>(
        out, src, idx, perm, n_rows, width, n_slots);
}

}  // namespace

// out (n_slots, width) and src (n_rows, width) contiguous, of float32
// (dtype 0) or float64 (dtype 1); idx (n_rows,) int64, non-decreasing;
// perm (n_rows,) int64 or null (sorted position -> source row). Returns a
// cudaError_t (0 on success), from the launch itself.
extern "C" int icp_segment_add(void* out, const void* src, const void* idx,
                               const void* perm, long long n_rows, int width,
                               long long n_slots, int dtype, void* stream) {
  if (n_rows <= 0 || width <= 0) return 0;
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long threads = n_rows * static_cast<long long>(width);
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* i = static_cast<const int64_t*>(idx);
  const auto* p = static_cast<const int64_t*>(perm);
  const auto nb = static_cast<unsigned>(blocks);
  if (dtype == 0)
    launch(static_cast<float*>(out), static_cast<const float*>(src), i, p,
           n_rows, width, n_slots, nb, s);
  else
    launch(static_cast<double*>(out), static_cast<const double*>(src), i, p,
           n_rows, width, n_slots, nb, s);
  return static_cast<int>(cudaGetLastError());
}
