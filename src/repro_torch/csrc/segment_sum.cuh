// Deterministic per-segment moment sums over a stable sort, shared by
// edge_reduce.cu and stratified_stats.cu.
//
// The caller (the Python wrapper, as glue) stable-sorts tuple ids by
// segment, so segment g owns the contiguous run perm[offsets[g] ..
// offsets[g+1]).  Each run is cut into chunks of `chunk` entries numbered
// chunk_off[g] onwards; one warp reduces one chunk (lane-strided, then a
// fixed shuffle tree) into a partial row, and a second kernel adds each
// segment's partial rows in chunk order and rounds once.  So:
//
//  * the sums are the same bits on every run: no float atomicAdd, and every
//    addition happens in an order fixed by the sort;
//  * no warp walks more than `chunk` entries, however skewed the segments
//    (a downtown Geohash-6 cell holds tens of thousands of tuples);
//  * sums accumulate in double and round to float once, so in any fixed
//    order the result is the correctly rounded f32 sum to within an ulp.
//
// A source `Src` supplies, for perm entry p of segment g, the tuple's weight
// w in {0, 1} and its value y in column c; the rows are, per column,
// s1 = sum of w*y and s2 = sum of (w*y)*y (products in float with _rn
// intrinsics, exactly as the reference's row layout defines them), preceded
// by a count row sum of w when `with_count` is set.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace segsum {

constexpr int kWarp = 32;

__device__ __forceinline__ double warp_sum(double v) {
  // fixed butterfly: lane 0 ends with a total added in the same order on
  // every run (the caller reads lane 0 only)
  for (int off = kWarp / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// chunk_off[g] .. chunk_off[g+1] are segment g's work items; find the
// segment of item `item` by binary search (non-decreasing, segs+1 entries).
__device__ __forceinline__ int segment_of(const int32_t* chunk_off, int segs, int item) {
  int lo = 0, hi = segs;  // invariant: chunk_off[lo] <= item < chunk_off[hi]
  while (hi - lo > 1) {
    int mid = (lo + hi) >> 1;
    if (chunk_off[mid] <= item) lo = mid; else hi = mid;
  }
  return lo;
}

// One warp per work item: partial[item, r] for the rows described above.
template <class Src>
__global__ void partial_kernel(const int32_t* __restrict__ perm,
                               const int32_t* __restrict__ offsets,
                               const int32_t* __restrict__ chunk_off, int segs, int chunk,
                               int max_items, int with_count, Src src,
                               double* __restrict__ partial) {
  const int warps_per_block = blockDim.x / kWarp;
  const int item = blockIdx.x * warps_per_block + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (item >= max_items || item >= chunk_off[segs]) return;  // warp-uniform exit
  const int seg = segment_of(chunk_off, segs, item);
  const int64_t begin = (int64_t)offsets[seg] + (int64_t)(item - chunk_off[seg]) * chunk;
  int64_t end = begin + chunk;
  if (end > offsets[seg + 1]) end = offsets[seg + 1];
  const int c = src.cols;
  double* out = partial + (int64_t)item * (with_count + 2 * c);

  if (with_count) {
    double cnt = 0.0;
    for (int64_t i = begin + lane; i < end; i += kWarp) cnt += (double)src.weight(seg, perm[i]);
    cnt = warp_sum(cnt);
    if (lane == 0) out[0] = cnt;
  }
  for (int col = 0; col < c; ++col) {
    double a1 = 0.0, a2 = 0.0;
    for (int64_t i = begin + lane; i < end; i += kWarp) {
      const int32_t p = perm[i];
      const float y = src.value(seg, p, col);
      const float wy = __fmul_rn(src.weight(seg, p), y);
      a1 += (double)wy;
      a2 += (double)__fmul_rn(wy, y);
    }
    a1 = warp_sum(a1);
    a2 = warp_sum(a2);
    if (lane == 0) {
      out[with_count + col] = a1;
      out[with_count + c + col] = a2;
    }
  }
}

// One thread per segment: add the segment's partial rows in chunk order,
// round once, hand row r's total to `store(seg, r, value)`.
template <class Store>
__global__ void finish_kernel(const int32_t* __restrict__ chunk_off,
                              const double* __restrict__ partial, int segs, int rows,
                              Store store) {
  const int seg = blockIdx.x * blockDim.x + threadIdx.x;
  if (seg >= segs) return;
  const int first = chunk_off[seg], last = chunk_off[seg + 1];
  for (int r = 0; r < rows; ++r) {
    double acc = 0.0;
    for (int it = first; it < last; ++it) acc += partial[(int64_t)it * rows + r];
    store(seg, r, (float)acc);
  }
}

// Both passes on `stream`; returns the first CUDA error code (0 if none).
template <class Src, class Store>
int launch(const int32_t* perm, const int32_t* offsets, const int32_t* chunk_off, int segs,
           int chunk, int max_items, int with_count, Src src, double* partial, Store store,
           int threads, cudaStream_t stream) {
  if (max_items > 0) {
    const int warps_per_block = threads / kWarp;
    const int blocks = (max_items + warps_per_block - 1) / warps_per_block;
    partial_kernel<<<blocks, threads, 0, stream>>>(perm, offsets, chunk_off, segs, chunk,
                                                   max_items, with_count, src, partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (segs > 0) {
    finish_kernel<<<(segs + threads - 1) / threads, threads, 0, stream>>>(
        chunk_off, partial, segs, with_count + 2 * src.cols, store);
  }
  return (int)cudaGetLastError();
}

}  // namespace segsum
