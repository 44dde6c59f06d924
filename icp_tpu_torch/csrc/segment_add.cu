// Ordered scatter-sum for Hopper (sm_90a): icp_segment_add.
//
// A port-only kernel: icp_tpu has no Pallas counterpart, since XLA's
// scatter-add is deterministic. torch's CUDA index_add_ adds through float
// atomics, in an order that changes from run to run, so every voxel mean
// and every pose-graph assembly came out with other rounding on each run.
// This kernel gives what CPU out.index_add_(0, index, src) gives, bit for
// bit: each slot starts from out's value and adds its source rows one
// after another in ascending source-row order, each add __fadd_rn /
// __dadd_rn, rounded on its own, as torch's CPU loop adds.
//
// Input: a segment plan (ops/scatter.py segment_plan). The slots come in
// non-decreasing order: a stable torch.sort, built once for every call
// that shares the index (a pose-graph solve sorts its H and b indices
// once, not once a Gauss-Newton iteration), or the caller's own order
// (sorted_index=True, the voxel means). Where the plan sorted, perm maps a
// sorted position to its source row (int32), and the kernel reads the
// values through it. Rows the caller leaves out (a pose graph's padded
// edges, whose values are all +-0) carry the slot n_slots: they sort to
// the end and are never walked. Equal slots are contiguous runs, and
// inside a run the stable sort keeps the source rows in ascending order.
//
// Bound. Bytes: each kept row's slot, permutation entry and values read
// once, each touched slot read and written once (chip_smoke.py counts it
// that way). The adds are few (one a source value) and the work has no
// reuse, so every shape is bytes-bound; at the paths' shapes that bound
// is well under a microsecond, and a call costs a launch and the latency
// of its dependent loads. Ordered sums cost this on top: a run of L rows
// is L dependent adds on one thread.
//
// Design. Block b owns the rows [b T, b T + T), T = 256 / width, and
// thread p of it the pair (row p / width, column p % width). Whole rows
// are staged in shared memory, a warp's loads on neighbouring addresses
// (no perm: one contiguous stretch; with perm: a row's columns side by
// side):
//   1. the block loads the slots of its T rows and of a halo of up to 64
//      rows past them, and the values' source rows through perm (without
//      perm, the values themselves); each thread its pair's slot, the one
//      before it and, with perm, the next four. Every load is in flight
//      before any is waited on;
//   2. uniform exits: a block whose first slot is n_slots (only left-out
//      rows from there on) or whose rows all continue a run that started
//      before it ends here, before it reads a value through perm;
//   3. the thread of a run's first row (its slot differs from the row
//      before: the run's owner) loads the slot's value in out as soon as
//      it has the two slots, and the values go to shared memory (through
//      perm: a second round trip, beside out's);
//   4. each owner finds its run's last staged row (in the next four slots
//      it loaded, else in the staged slots: the next four at once, then a
//      binary search) and adds the rows up to it in row order, with no
//      compare between two adds, then stores the slot. A run that ends
//      inside the halo never leaves the block's staged rows;
//   5. at most one run of a block reaches past them (the run of its last
//      staged row, when it holds the tile's last row; every thread reads
//      that from the staged slots, so no vote). Its owners (one a column)
//      keep their sums in registers while the whole block stages the
//      run's next 512 values (512 rows of width 1) at a time; they add a
//      stage that lies wholly in the run, and the stage where the run ends
//      up to the end that a search finds. No owner waits on another run,
//      and no row goes through a shuffle.
// Launch and grid are static, from n_rows: blocks past the plan's kept
// rows exit at step 2. One launch a call, no memset, no atomics, no
// scratch. A slot outside [0, n_slots) is skipped (torch's index_add_
// raises); callers build their indices in range.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 2;                  // values a thread stages at once
constexpr int kStage = kThreads * kPer;  // values staged at once (512)
constexpr int kSlotsPer = kPer + 1;      // slots a thread stages at once
constexpr int kHalo = 64;                // rows staged past a block's tile
constexpr int kMaxWidth = kThreads;      // a block owns at least one row

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// past the last row: above every slot, so the staged slots stay sorted
template <typename Idx>
__device__ __forceinline__ Idx past_end() {
  return static_cast<Idx>((1ull << (sizeof(Idx) * 8 - 1)) - 1);
}

// Stages rows [j, j + n) of the sorted order into shared memory: the
// slots of rows j - 1 .. j + n into s_slot[0 .. n + 1] (-1 before row 0,
// past_end() after the last row) and the values into s_val[0 .. n width).
// load() starts every global load at once into registers: each value's
// source row through perm (kPerm) or else the value itself, then the
// slots; a warp's loads fall on neighbouring addresses, and no load waits
// on another. slots() stores the slots; values() the values (kPerm: loads
// them now, through perm).
template <typename T, typename Idx, bool kPerm>
struct Stage {
  Idx sl[kSlotsPer];
  int32_t from[kPer];
  T v[kPer];

  __device__ __forceinline__ void load(const T* __restrict__ src,
                                       const Idx* __restrict__ idx,
                                       const int32_t* __restrict__ perm,
                                       int64_t j, int n, int64_t n_rows,
                                       int width) {
    const int nv = n * width;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int q = threadIdx.x + u * kThreads;
      if (q < nv) {
        if (kPerm) from[u] = perm[j + q / width];
        else v[u] = src[j * width + q];
      }
    }
#pragma unroll
    for (int u = 0; u < kSlotsPer; ++u) {
      const int64_t r = j - 1 + threadIdx.x + u * kThreads;
      sl[u] = r < 0 ? Idx(-1) : past_end<Idx>();
      if (r >= 0 && r < n_rows && r <= j + n) sl[u] = idx[r];
    }
  }

  __device__ __forceinline__ void slots(Idx* s_slot, int n) const {
#pragma unroll
    for (int u = 0; u < kSlotsPer; ++u) {
      const int k = threadIdx.x + u * kThreads;
      if (k < n + 2) s_slot[k] = sl[u];
    }
  }

  __device__ __forceinline__ void values(T* s_val, const T* __restrict__ src,
                                         int n, int width) {
    const int nv = n * width;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int q = threadIdx.x + u * kThreads;
      if (q < nv) {
        if (kPerm)
          s_val[q] = src[static_cast<int64_t>(from[u]) * width + q % width];
        else
          s_val[q] = v[u];
      }
    }
  }
};

// The first staged row in [lo, hi) whose slot is not `slot`, hi if none:
// the rows before lo hold `slot`, and the staged slots never decrease.
// The next four rows are read at once (most runs end there), the rest is
// a binary search.
template <typename Idx>
__device__ __forceinline__ int run_end(const Idx* s_slot, int lo, int hi,
                                       Idx slot) {
  Idx ahead[4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
    ahead[u] = lo + u < hi ? s_slot[lo + u + 1] : past_end<Idx>();
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (ahead[u] != slot) return lo + u < hi ? lo + u : hi;
  lo += 4;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_slot[mid + 1] == slot) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// acc plus the staged rows [k, e) of column c, one add after another
template <typename T>
__device__ __forceinline__ T add_rows(T acc, const T* s_val, int k, int e,
                                      int width, int c) {
#pragma unroll 4
  for (; k < e; ++k) acc = add_rn(acc, s_val[k * width + c]);
  return acc;
}

template <typename T, typename Idx, bool kPerm>
__global__ void __launch_bounds__(kThreads)
segment_add_kernel(T* __restrict__ out, const T* __restrict__ src,
                   const Idx* __restrict__ idx,
                   const int32_t* __restrict__ perm, int64_t n_rows,
                   int width, int64_t n_slots) {
  __shared__ T s_val[kStage];
  __shared__ Idx s_slot[kStage + 2];        // s_slot[k]: row j - 1 + k

  const int tile = kThreads / width;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * tile;
  const int64_t left = n_rows - r0;
  const int nt = static_cast<int>(left < tile ? left : tile);
  int halo = (kStage - tile * width) / width;
  halo = halo < kHalo ? halo : kHalo;
  const int ns = static_cast<int>(left < tile + halo ? left : tile + halo);

  // 1. every global load of the first round trip: perm or the values, the
  //    staged slots, and this thread's pair's slot, the slot before it and
  //    (with perm) the next four
  Stage<T, Idx, kPerm> st;
  st.load(src, idx, perm, r0, ns, n_rows, width);
  const int i = threadIdx.x / width;
  const int c = threadIdx.x - i * width;
  Idx slot = -1, prev = -1, ahead[4];
  if (i < nt) {
    slot = idx[r0 + i];
    if (r0 + i > 0) prev = idx[r0 + i - 1];
  }
  // with perm (a plan's runs: a few rows each), the next four rows' slots
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int64_t r = r0 + i + 1 + u;
    ahead[u] = past_end<Idx>();
    if (kPerm && i < nt && r < n_rows) ahead[u] = idx[r];
  }
  // 3. (loaded now) the slot's value in out, for the run's owner
  const bool owner = slot >= 0 && slot < n_slots && slot != prev;
  T acc = T(0);
  if (owner) acc = out[static_cast<int64_t>(slot) * width + c];
  // the run's end if it ends in the next four rows and within the staged
  // ones, else -1 (found in the staged slots below)
  int e = -1;
#pragma unroll
  for (int u = 3; u >= 0; --u)
    if (kPerm && ahead[u] != slot) e = i + 1 + u;
  if (e > ns) e = -1;
  st.slots(s_slot, ns);
  if (!kPerm) st.values(s_val, src, ns, width);
  __syncthreads();
  // 2. uniform exits: only left-out rows from here on (the slots never
  //    decrease), or every row continues a run that started before
  if (s_slot[1] >= n_slots) return;
  if (r0 > 0 && s_slot[nt] == s_slot[0]) return;
  if (kPerm) {                              // 3. the values, through perm
    st.values(s_val, src, ns, width);
    __syncthreads();
  }

  // 4. each owner finds its run's last staged row and adds up to it
  bool going = false;
  if (owner) {
    if (e < 0) e = run_end(s_slot, kPerm ? i + 5 : i + 1, ns, slot);
    acc = add_rows(acc, s_val, i, e, width, c);
    going = e == ns && s_slot[ns + 1] == slot;
    if (!going) out[static_cast<int64_t>(slot) * width + c] = acc;
  }

  // 5. the run of the last staged row goes on past them (uniform: it
  //    started in the tile, since the block did not exit, if it holds the
  //    tile's last row): the block stages it kStage values at a time, its
  //    owners (those with going set) add
  const Idx run = s_slot[ns];
  bool on = run >= 0 && run < n_slots && s_slot[ns + 1] == run &&
            s_slot[nt] == run;
  const int chunk = kStage / width;
  int64_t j = r0 + ns;
  while (on) {
    __syncthreads();                        // the last stage is read
    const int64_t rest = n_rows - j;
    const int n = static_cast<int>(rest < chunk ? rest : chunk);
    st.load(src, idx, perm, j, n, n_rows, width);
    st.slots(s_slot, n);
    st.values(s_val, src, n, width);
    __syncthreads();
    // uniform: the whole stage lies in the run, and so does the next row
    const bool whole = s_slot[n] == run;
    on = whole && s_slot[n + 1] == run;
    if (going) {
      acc = add_rows(acc, s_val, 0, whole ? n : run_end(s_slot, 1, n, run),
                     width, c);
      if (!on) out[static_cast<int64_t>(slot) * width + c] = acc;
    }
    j += n;
  }
}

// an empty kernel at a call's grid: the floor one launch cannot go under
__global__ void __launch_bounds__(kThreads) empty_kernel() {}

unsigned grid_of(long long n_rows, int width) {
  const long long tile = kThreads / width;
  return static_cast<unsigned>((n_rows + tile - 1) / tile);
}

template <typename T, typename Idx>
void launch(T* out, const T* src, const Idx* idx, const int32_t* perm,
            long long n_rows, int width, long long n_slots, cudaStream_t s) {
  const unsigned blocks = grid_of(n_rows, width);
  if (perm)
    segment_add_kernel<T, Idx, true><<<blocks, kThreads, 0, s>>>(
        out, src, idx, perm, n_rows, width, n_slots);
  else
    segment_add_kernel<T, Idx, false><<<blocks, kThreads, 0, s>>>(
        out, src, idx, perm, n_rows, width, n_slots);
}

template <typename T>
void launch_t(void* out, const void* src, const void* idx, const void* perm,
              long long n_rows, int width, long long n_slots, int idx64,
              cudaStream_t s) {
  const auto* p = static_cast<const int32_t*>(perm);
  if (idx64)
    launch(static_cast<T*>(out), static_cast<const T*>(src),
           static_cast<const int64_t*>(idx), p, n_rows, width, n_slots, s);
  else
    launch(static_cast<T*>(out), static_cast<const T*>(src),
           static_cast<const int32_t*>(idx), p, n_rows, width, n_slots, s);
}

// rows past int32 (perm's type) or wider than a block cannot launch
bool bad_shape(long long n_rows, int width) {
  return width > kMaxWidth || n_rows >= 0x7fffffffLL;
}

}  // namespace

// out (n_slots, width) and src (n_rows, width) contiguous, of float32
// (dtype 0) or float64 (dtype 1), width <= 256; idx (n_rows,) non-decreasing,
// int64 (idx64 1) or int32 (idx64 0); perm (n_rows,) int32 or null (sorted
// position -> source row). Returns a cudaError_t (0 on success), from the
// launch itself.
extern "C" int icp_segment_add(void* out, const void* src, const void* idx,
                               const void* perm, long long n_rows, int width,
                               long long n_slots, int dtype, int idx64,
                               void* stream) {
  if (n_rows <= 0 || width <= 0) return 0;
  if ((dtype != 0 && dtype != 1) || bad_shape(n_rows, width))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_t<float>(out, src, idx, perm, n_rows, width, n_slots, idx64, s);
  else
    launch_t<double>(out, src, idx, perm, n_rows, width, n_slots, idx64, s);
  return static_cast<int>(cudaGetLastError());
}

// The empty kernel at the grid icp_segment_add launches for (n_rows,
// width): what one launch costs with no work.
extern "C" int icp_segment_add_empty(long long n_rows, int width,
                                     void* stream) {
  if (n_rows <= 0 || width <= 0) return 0;
  if (bad_shape(n_rows, width)) return static_cast<int>(cudaErrorInvalidValue);
  empty_kernel<<<grid_of(n_rows, width), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
