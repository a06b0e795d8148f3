// Per-slot moment sums for C value columns: count[s] = Σ m,
// s1[c, s] = Σ m·y_c, s2[c, s] = Σ (m·y_c)·y_c over the tuples of slot s.
//
// Replaces the TPU kernel `edge_reduce_pallas` (body `_reduce_kernel`, rows
// `_moment_rows`) of src/repro/kernels/edge_reduce/edge_reduce.py, which
// contracts the stacked rows against a one-hot slot matrix on the MXU.
//
// Bound on an H100: memory.  Each tuple reads 4 + 1 + 4·C bytes (13 bytes
// at C = 2) and the (1 + 2C)·S sums are written once, a few microseconds
// at the memory rate for the 1.2 M-tuple Geohash-6 window — about one
// launch.  What shapes the design is determinism and skew, not bandwidth:
//
//  * The sums must be the same bits on every run (sessions and checkpoint
//    replay compare results bit for bit), so there is no float atomicAdd.
//    The wrapper sorts tuple indices by slot (a stable sort, as glue), so
//    each slot owns a contiguous run of the permutation.
//  * Real windows are skewed: a downtown Geohash-6 cell holds tens of
//    thousands of tuples while most hold a handful.  Each run is cut into
//    chunks of `chunk` tuples; one warp reduces one chunk (lane-strided,
//    then a fixed shuffle tree) into a partial row, and a second kernel
//    adds each slot's partial rows in chunk order.  No warp ever walks more
//    than `chunk` tuples, whatever the skew.
//  * Sums accumulate in double and are rounded to float once.  A run of
//    50 k f32 terms summed in f32 drifts by ~sqrt(L) ulps in an order-
//    dependent way; in double the result is the correctly rounded f32 sum
//    to within an ulp in any fixed order, and the memory-bound kernel pays
//    nothing for it.  The per-tuple products m·y and (m·y)·y are formed in
//    float with _rn intrinsics, exactly as the row layout defines them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;

__device__ __forceinline__ double warp_sum(double v) {
  // fixed butterfly: lane 0 ends with a total added in the same order on
  // every run (the caller reads lane 0 only)
  for (int off = kWarp / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// chunk_off[s] .. chunk_off[s+1] are slot s's work items; find the slot of
// item `item` by binary search (chunk_off is non-decreasing, S+1 entries).
__device__ __forceinline__ int slot_of(const int32_t* chunk_off, int s, int item) {
  int lo = 0, hi = s;  // invariant: chunk_off[lo] <= item < chunk_off[hi]
  while (hi - lo > 1) {
    int mid = (lo + hi) >> 1;
    if (chunk_off[mid] <= item) lo = mid; else hi = mid;
  }
  return lo;
}

// One warp per work item: partial[item, r] for r = 0 .. 2C (count, s1_c, s2_c).
__global__ void edge_reduce_partial_kernel(const int32_t* __restrict__ perm,
                                           const int32_t* __restrict__ offsets,
                                           const int32_t* __restrict__ chunk_off,
                                           const float* __restrict__ values,
                                           const uint8_t* __restrict__ mask, int64_t n,
                                           int c, int s, int chunk, int max_items,
                                           double* __restrict__ partial) {
  const int warps_per_block = blockDim.x / kWarp;
  const int item = blockIdx.x * warps_per_block + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (item >= max_items || item >= chunk_off[s]) return;  // warp-uniform exit
  const int slot = slot_of(chunk_off, s, item);
  const int64_t begin = (int64_t)offsets[slot] + (int64_t)(item - chunk_off[slot]) * chunk;
  int64_t end = begin + chunk;
  if (end > offsets[slot + 1]) end = offsets[slot + 1];
  const int rows = 1 + 2 * c;
  double* out = partial + (int64_t)item * rows;

  double cnt = 0.0;
  for (int64_t i = begin + lane; i < end; i += kWarp) cnt += mask[perm[i]] ? 1.0 : 0.0;
  cnt = warp_sum(cnt);
  if (lane == 0) out[0] = cnt;
  for (int col = 0; col < c; ++col) {
    const float* y = values + (int64_t)col * n;
    double a1 = 0.0, a2 = 0.0;
    for (int64_t i = begin + lane; i < end; i += kWarp) {
      int32_t p = perm[i];
      float m = mask[p] ? 1.0f : 0.0f;
      float my = __fmul_rn(m, y[p]);
      a1 += (double)my;
      a2 += (double)__fmul_rn(my, y[p]);
    }
    a1 = warp_sum(a1);
    a2 = warp_sum(a2);
    if (lane == 0) {
      out[1 + col] = a1;
      out[1 + c + col] = a2;
    }
  }
}

// One thread per slot: add the slot's partial rows in chunk order, round once.
__global__ void edge_reduce_finish_kernel(const int32_t* __restrict__ chunk_off,
                                          const double* __restrict__ partial, int c, int s,
                                          float* __restrict__ count, float* __restrict__ s1,
                                          float* __restrict__ s2) {
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= s) return;
  const int rows = 1 + 2 * c;
  const int first = chunk_off[slot], last = chunk_off[slot + 1];
  double acc = 0.0;
  for (int it = first; it < last; ++it) acc += partial[(int64_t)it * rows];
  count[slot] = (float)acc;
  for (int col = 0; col < c; ++col) {
    double a1 = 0.0, a2 = 0.0;
    for (int it = first; it < last; ++it) {
      a1 += partial[(int64_t)it * rows + 1 + col];
      a2 += partial[(int64_t)it * rows + 1 + c + col];
    }
    s1[(int64_t)col * s + slot] = (float)a1;
    s2[(int64_t)col * s + slot] = (float)a2;
  }
}

}  // namespace

extern "C" int edge_reduce_launch(const int32_t* perm, const int32_t* offsets,
                                  const int32_t* chunk_off, const float* values,
                                  const uint8_t* mask, int64_t n, int c, int s, int chunk,
                                  int max_items, double* partial, float* count, float* s1,
                                  float* s2, int threads, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (max_items > 0) {
    const int warps_per_block = threads / kWarp;
    const int blocks = (max_items + warps_per_block - 1) / warps_per_block;
    edge_reduce_partial_kernel<<<blocks, threads, 0, st>>>(
        perm, offsets, chunk_off, values, mask, n, c, s, chunk, max_items, partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (s > 0) {
    edge_reduce_finish_kernel<<<(s + threads - 1) / threads, threads, 0, st>>>(
        chunk_off, partial, c, s, count, s1, s2);
  }
  return (int)cudaGetLastError();
}
