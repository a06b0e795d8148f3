// Per-slot moments of one masked column: count[s] = Σ m, s1[s] = Σ m·y,
// s2[s] = Σ (m·y)·y over the tuples of slot s, with m the mask read as a
// float (bool or float weights) and y the value read as f32 (f32 or bf16).
//
// Replaces the TPU kernel `stratified_stats_pallas` (body `_stats_kernel`)
// of src/repro/kernels/stratified_stats/stratified_stats.py, which
// contracts the rows [m, m·y, m·y·y] against one-hot slot tiles on the MXU.
// Here it is the single-column case of edge_reduce's deterministic design:
// the wrapper stable-sorts tuple indices by slot (glue), and
// segment_sum.cuh reduces each slot's run in fixed-order chunks in double
// and rounds once.  No float atomics: two runs give the same bits.
// Indices outside [0, num_slots) (the -1 padding included) are mapped by
// the wrapper to segment num_slots, which lies past the last run and is
// never summed.
//
// Bound on an H100: memory.  Each tuple reads its index (4 bytes), its
// value (4, or 2 in bf16) and its mask (1 as bool, 4 as float), and the
// 3·S sums are written once: at N = 1.2 M, S = 6558 about 11 MB, 3 µs at
// 3.35 TB/s.  The sort glue dominates, as it does in edge_reduce.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "segment_sum.cuh"

namespace {

__device__ __forceinline__ float as_float(float x) { return x; }
__device__ __forceinline__ float as_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float as_float(uint8_t x) { return x ? 1.0f : 0.0f; }

// weight m = mask[p] as a float, value y = values[p] as a float
template <class V, class M>
struct MaskedColumn {
  const V* values;
  const M* mask;
  int cols;  // always 1
  __device__ __forceinline__ float weight(int, int32_t p) const { return as_float(mask[p]); }
  __device__ __forceinline__ float value(int, int32_t p, int) const { return as_float(values[p]); }
};

// row 0 -> count[slot], row 1 -> s1[slot], row 2 -> s2[slot]
struct StoreMoments {
  float* count;
  float* s1;
  float* s2;
  __device__ __forceinline__ void operator()(int slot, int r, float v) const {
    (r == 0 ? count : r == 1 ? s1 : s2)[slot] = v;
  }
};

template <class V, class M>
int run(const int32_t* perm, const int32_t* offsets, const int32_t* chunk_off, const void* values,
        const void* mask, int s, int chunk, int max_items, double* partial, float* count,
        float* s1, float* s2, int threads, cudaStream_t stream) {
  return segsum::launch(perm, offsets, chunk_off, s, chunk, max_items, /*with_count=*/1,
                        MaskedColumn<V, M>{(const V*)values, (const M*)mask, 1}, partial,
                        StoreMoments{count, s1, s2}, threads, stream);
}

}  // namespace

// value_bf16: values are bf16 (else f32); mask_float: mask is f32 (else bool)
extern "C" int stratified_stats_launch(const int32_t* perm, const int32_t* offsets,
                                       const int32_t* chunk_off, const void* values,
                                       const void* mask, int value_bf16, int mask_float, int s,
                                       int chunk, int max_items, double* partial, float* count,
                                       float* s1, float* s2, int threads, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (value_bf16) {
    return mask_float
        ? run<__nv_bfloat16, float>(perm, offsets, chunk_off, values, mask, s, chunk, max_items,
                                    partial, count, s1, s2, threads, st)
        : run<__nv_bfloat16, uint8_t>(perm, offsets, chunk_off, values, mask, s, chunk,
                                      max_items, partial, count, s1, s2, threads, st);
  }
  return mask_float
      ? run<float, float>(perm, offsets, chunk_off, values, mask, s, chunk, max_items, partial,
                          count, s1, s2, threads, st)
      : run<float, uint8_t>(perm, offsets, chunk_off, values, mask, s, chunk, max_items, partial,
                            count, s1, s2, threads, st);
}
