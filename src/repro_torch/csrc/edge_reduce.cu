// Per-slot moment sums for C value columns: count[s] = Σ m,
// s1[c, s] = Σ m·y_c, s2[c, s] = Σ (m·y_c)·y_c over the tuples of slot s.
//
// Replaces the TPU kernel `edge_reduce_pallas` (body `_reduce_kernel`, rows
// `_moment_rows`) of src/repro/kernels/edge_reduce/edge_reduce.py, which
// contracts the stacked rows against a one-hot slot matrix on the MXU.
//
// Bound on an H100: memory.  Each tuple reads 4 + 1 + 4·C bytes (13 bytes
// at C = 2) and the (1 + 2C)·S sums are written once: 15.7 MB, 4.7 us at
// 3.35 TB/s for the 1.2 M-tuple Geohash-6 window.  What shapes the design
// is determinism and skew: the sums must be the same bits on every run
// (sessions and checkpoint replay compare results bit for bit), and real
// windows are skewed (the busiest Geohash-6 cells hold ~20 000 tuples).
// A sort of the whole window by slot would order the sums, at the cost of
// a global radix sort and scattered gathers; instead each block sorts one
// tile of the window by slot in shared memory and writes a record per
// (tile, slot), and a finish pass adds the records over the tiles in order
// (tile_moments.cuh, over the edge megakernel's tile_runs.cuh).  The 13-bit
// keys of a tile sort in four radix passes in shared memory, and every
// global access but the finish's record reads is coalesced.

#include "tile_moments.cuh"

// values (C, N) f32, mask (N,) bool, stratum_idx (N,) int32
extern "C" int edge_reduce_launch(const int32_t* sidx, const float* values, const uint8_t* mask,
                                  int64_t n, int c, int s, int tiles, int per, int32_t* marker,
                                  double* sums, float* out, void* stream) {
  return launch_moments<int32_t, float, uint8_t>(sidx, values, mask, n, c, s, tiles, per, marker,
                                                 sums, out, (cudaStream_t)stream);
}
