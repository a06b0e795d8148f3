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
// the sums must be the same bits on every run (sessions and checkpoint
// replay compare results bit for bit), and real windows are skewed.  The
// wrapper stable-sorts tuple indices by slot (glue); segment_sum.cuh, shared
// with the edge megakernel, reduces each slot's run in fixed-order chunks in
// double and rounds once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "segment_sum.cuh"

namespace {

// weight m = mask[p], value y = values[col, p]
struct MaskedColumns {
  const float* values;
  const uint8_t* mask;
  int64_t n;
  int cols;
  __device__ __forceinline__ float weight(int, int32_t p) const { return mask[p] ? 1.0f : 0.0f; }
  __device__ __forceinline__ float value(int, int32_t p, int col) const {
    return values[(int64_t)col * n + p];
  }
};

// row 0 -> count[slot], rows 1..C -> s1[c, slot], rows C+1..2C -> s2[c, slot]
struct StoreRows {
  float* count;
  float* s1;
  float* s2;
  int c, s;
  __device__ __forceinline__ void operator()(int slot, int r, float v) const {
    if (r == 0) count[slot] = v;
    else if (r <= c) s1[(int64_t)(r - 1) * s + slot] = v;
    else s2[(int64_t)(r - 1 - c) * s + slot] = v;
  }
};

}  // namespace

extern "C" int edge_reduce_launch(const int32_t* perm, const int32_t* offsets,
                                  const int32_t* chunk_off, const float* values,
                                  const uint8_t* mask, int64_t n, int c, int s, int chunk,
                                  int max_items, double* partial, float* count, float* s1,
                                  float* s2, int threads, void* stream) {
  return segsum::launch(perm, offsets, chunk_off, s, chunk, max_items, /*with_count=*/1,
                        MaskedColumns{values, mask, n, c}, partial,
                        StoreRows{count, s1, s2, c, s}, threads, (cudaStream_t)stream);
}
