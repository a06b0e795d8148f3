// Per-slot moments of one masked column: count[s] = Σ m, s1[s] = Σ m·y,
// s2[s] = Σ (m·y)·y over the tuples of slot s, with m the mask read as a
// float (bool or float weights) and y the value read as f32 (f32 or bf16).
// Indices outside [0, num_slots), the -1 padding included, contribute
// nothing.
//
// Replaces the TPU kernel `stratified_stats_pallas` (body `_stats_kernel`)
// of src/repro/kernels/stratified_stats/stratified_stats.py, which
// contracts the rows [m, m·y, m·y·y] against one-hot slot tiles on the MXU.
//
// Bound on an H100: memory.  Each tuple reads its index (4 bytes, 8 as
// int64), its value (4, or 2 in bf16) and its mask (1 as bool, 4 as float),
// and the 3·S sums are written once: at N = 1.2 M, S = 6558 about 11 MB,
// 3 us at 3.35 TB/s.  It is the single-column case of edge_reduce's design
// (tile_moments.cuh): no sort of the whole window, but each block sorts a
// tile by slot in shared memory; an out-of-range index takes the "none" key
// inside the tile kernel, which sorts last and is never summed, so the
// indices are read once, in their own dtype.  No float atomics: two runs
// give the same bits.

#include "tile_moments.cuh"

namespace {

template <class Idx, class V>
int by_mask(const void* sidx, const void* values, const void* mask, int mask_float, int64_t n,
            int s, int tiles, int per, int32_t* marker, double* sums, float* out,
            cudaStream_t st) {
  return mask_float
      ? launch_moments<Idx, V, float>(sidx, values, mask, n, 1, s, tiles, per, marker, sums, out, st)
      : launch_moments<Idx, V, uint8_t>(sidx, values, mask, n, 1, s, tiles, per, marker, sums, out,
                                        st);
}

template <class Idx>
int by_value(const void* sidx, const void* values, const void* mask, int value_bf16,
             int mask_float, int64_t n, int s, int tiles, int per, int32_t* marker, double* sums,
             float* out, cudaStream_t st) {
  return value_bf16 ? by_mask<Idx, __nv_bfloat16>(sidx, values, mask, mask_float, n, s, tiles,
                                                  per, marker, sums, out, st)
                    : by_mask<Idx, float>(sidx, values, mask, mask_float, n, s, tiles, per,
                                          marker, sums, out, st);
}

}  // namespace

// index_64: stratum_idx is int64 (else int32); value_bf16: values are bf16
// (else f32); mask_float: mask is f32 (else bool).  out is (3, S): count,
// s1, s2.
extern "C" int stratified_stats_launch(const void* sidx, const void* values, const void* mask,
                                       int index_64, int value_bf16, int mask_float, int64_t n,
                                       int s, int tiles, int per, int32_t* marker, double* sums,
                                       float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return index_64 ? by_value<int64_t>(sidx, values, mask, value_bf16, mask_float, n, s, tiles,
                                      per, marker, sums, out, st)
                  : by_value<int32_t>(sidx, values, mask, value_bf16, mask_float, n, s, tiles,
                                      per, marker, sums, out, st);
}
