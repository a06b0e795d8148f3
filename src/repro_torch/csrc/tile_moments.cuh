// Per-slot moment sums over sorted tiles of the window, shared by
// edge_reduce.cu and stratified_stats.cu:
//
//   count[s]    = Σ m
//   s1[c, s]    = Σ m·y_c
//   s2[c, s]    = Σ (m·y_c)·y_c
//
// over the tuples whose index is s, with m the tuple's weight (a bool mask
// read as 0 or 1, or a float mask) and y_c its value in column c (f32, or
// bf16 widened to f32 before any product).  The products are f32 with _rn
// intrinsics, the row layout of the reference kernels; the sums are double,
// rounded to f32 once.  An index outside [0, S), the -1 padding included,
// contributes nothing.
//
// Design: a zero-fill of the record markers and two kernels, no float
// atomics, no global sort (tile_runs.cuh, the edge megakernel's scheme).
//
//  * tile_kernel: one block per tile of at most TILE consecutive tuples; the
//    wrapper spreads the window evenly over whole waves of tiles.  The block
//    loads its indices and weights striped (coalesced).  An index in [0, S)
//    is the tuple's key; any other index gets the "none" key S, which sorts
//    last, is never summed and never addresses memory.  A stable block
//    radix sort of the keys puts each slot's tuples in one run of sorted
//    positions, in load order.  Three kinds of segmented reduction over the
//    runs write one record per (tile, slot present): the run's tuple count
//    (an int, the record's presence marker) and Σ m in double; then, with
//    each value column staged in shared memory in turn, Σ m·y and
//    Σ (m·y)·y in double.  Every tuple of a run is folded, masked or not,
//    as the plain version sums every row.
//  * finish_kernel: one warp per slot adds the slot's present records over
//    the tiles in tile order (lanes strided, then a fixed butterfly) and
//    rounds each sum to f32 once.
//
// Scratch: tiles x S x (4 + 8 (1 + 2C)) bytes of records, of which only the
// markers (tiles x S x 4 bytes) are zeroed; a record is written and read
// only where its marker is set.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_runs.cuh"

namespace {

using tile_runs::ITEMS;
using tile_runs::TILE;
using tile_runs::TILE_THREADS;
using tile_runs::TileSmem;

constexpr int FINISH_THREADS = 256;

__device__ __forceinline__ float as_float(float x) { return x; }
__device__ __forceinline__ float as_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float as_float(uint8_t x) { return x ? 1.0f : 0.0f; }

template <class Idx, class V, class M>
struct MomentArgs {
  const Idx* sidx;   // (N,)
  const V* vals;     // (C, N)
  const M* mask;     // (N,)
  int64_t n;
  int c, s, tiles, per;  // per: tuples of a tile (<= TILE)
  int key_bits;
  int32_t* marker;   // (S, tiles): tuples of the tile's run of the slot, 0 where none
  double* sums;      // (1 + 2C, S, tiles): Σm, then Σm·y per column, then Σ(m·y)·y
  float* out;        // (1 + 2C, S): count, s1 (C, S), s2 (C, S)
};

// partial records of a slot's run
struct Weighed {
  int n = 0;
  double w = 0.0;
  __device__ __forceinline__ void merge(const Weighed& o) {
    n += o.n;
    w += o.w;
  }
};

struct Moments {
  double a1 = 0.0, a2 = 0.0;
  __device__ __forceinline__ void merge(const Moments& o) {
    a1 += o.a1;
    a2 += o.a2;
  }
};

template <class Idx, class V, class M>
__global__ void __launch_bounds__(TILE_THREADS, 1) tile_kernel(MomentArgs<Idx, V, M> a) {
  // dynamic: the tile's weights, one staged value column, then the sort's
  // scratch, later the sorted keys and positions
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) unsigned char heads_raw[sizeof(Moments) * TILE_THREADS];
  __shared__ bool has_start[TILE_THREADS];
  float* const weight = reinterpret_cast<float*>(smem);
  float* const column = weight + TILE;
  TileSmem& sh = *reinterpret_cast<TileSmem*>(smem + 2 * sizeof(float) * TILE);
  const int tile = blockIdx.x;
  const int64_t i0 = (int64_t)tile * a.per;
  const int count = (int)max((int64_t)0, min((int64_t)a.per, a.n - i0));  // this tile's tuples
  const uint32_t none = (uint32_t)a.s;  // sorts after every slot

  uint32_t keys[ITEMS];
  uint16_t pos[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int local = j * TILE_THREADS + threadIdx.x;
    pos[j] = (uint16_t)local;
    keys[j] = none;
    if (local < count) {
      const Idx v = a.sidx[i0 + local];
      if (v >= 0 && v < (Idx)a.s) keys[j] = (uint32_t)v;
      weight[local] = as_float(a.mask[i0 + local]);
    }
  }
  tile_runs::sort_tile(sh, keys, pos, a.key_bits);

  const uint32_t* key = sh.run.key;
  const uint16_t* at = sh.run.pos;
  const auto key_slot = [](uint32_t k) { return k; };
  tile_runs::reduce_runs(
      key, key_slot, none, reinterpret_cast<Weighed*>(heads_raw), has_start,
      [&](Weighed& acc, int p) {
        acc.n += 1;
        acc.w += (double)weight[at[p]];
      },
      [&](uint32_t s, const Weighed& acc) {
        a.marker[tile_runs::record(0, s, tile, a.s, a.tiles)] = acc.n;
        a.sums[tile_runs::record(0, s, tile, a.s, a.tiles)] = acc.w;
      });

  // each value column in turn, staged in shared memory (coalesced)
  for (int col = 0; col < a.c; ++col) {
    const V* v = a.vals + (int64_t)col * a.n + i0;
    for (int j = threadIdx.x; j < count; j += TILE_THREADS) column[j] = as_float(v[j]);
    __syncthreads();
    tile_runs::reduce_runs(
        key, key_slot, none, reinterpret_cast<Moments*>(heads_raw), has_start,
        [&](Moments& acc, int p) {
          const int q = at[p];
          const float y = column[q];
          const float wy = __fmul_rn(weight[q], y);
          acc.a1 += (double)wy;
          acc.a2 += (double)__fmul_rn(wy, y);
        },
        [&](uint32_t s, const Moments& acc) {
          a.sums[tile_runs::record(1 + col, s, tile, a.s, a.tiles)] = acc.a1;
          a.sums[tile_runs::record(1 + a.c + col, s, tile, a.s, a.tiles)] = acc.a2;
        });
  }
}

// one warp per slot: its present records over the tiles in tile order
__global__ void __launch_bounds__(FINISH_THREADS) finish_kernel(const int32_t* __restrict__ marker,
                                                                const double* __restrict__ sums,
                                                                float* __restrict__ out, int rows,
                                                                int s, int tiles) {
  const int lane = threadIdx.x & 31;
  const int slot = blockIdx.x * (FINISH_THREADS / 32) + (threadIdx.x >> 5);
  if (slot >= s) return;  // warp-uniform
  const int32_t* present = marker + tile_runs::record(0, slot, 0, s, tiles);
  for (int r = 0; r < rows; ++r) {
    const double* row = sums + tile_runs::record(r, slot, 0, s, tiles);
    double acc = 0.0;
    for (int t = lane; t < tiles; t += 32)
      if (present[t] != 0) acc += row[t];
    acc = tile_runs::warp_sum(acc);
    if (lane == 0) out[(int64_t)r * s + slot] = (float)acc;
  }
}

// Every pass on `stream`: `tiles` tiles of `per` <= TILE tuples cover the
// window; marker and sums are scratch of tiles x S and (1 + 2C) x tiles x S
// entries.  Returns the first CUDA error code (0 if none).
template <class Idx, class V, class M>
int launch_moments(const void* sidx, const void* vals, const void* mask, int64_t n, int c, int s,
                   int tiles, int per, int32_t* marker, double* sums, float* out,
                   cudaStream_t stream) {
  if (tiles < 0 || per < 0 || per > TILE || (int64_t)tiles * per < n || s < 1 || c < 0)
    return (int)cudaErrorInvalidValue;
  int key_bits = 1;
  while (key_bits < 32 && (1ll << key_bits) <= s) ++key_bits;  // s fits: the "none" key
  const MomentArgs<Idx, V, M> a{static_cast<const Idx*>(sidx), static_cast<const V*>(vals),
                                static_cast<const M*>(mask), n, c, s, tiles, per, key_bits,
                                marker, sums, out};
  if (tiles > 0) {
    cudaError_t err = cudaMemsetAsync(marker, 0, sizeof(int32_t) * (size_t)s * tiles, stream);
    if (err != cudaSuccess) return (int)err;
    const size_t smem = 2 * sizeof(float) * TILE + sizeof(TileSmem);
    err = cudaFuncSetAttribute(tile_kernel<Idx, V, M>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    tile_kernel<Idx, V, M><<<(unsigned)tiles, TILE_THREADS, smem, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int per_block = FINISH_THREADS / 32;
  finish_kernel<<<(unsigned)((s + per_block - 1) / per_block), FINISH_THREADS, 0, stream>>>(
      marker, sums, out, 1 + 2 * c, s, tiles);
  return (int)cudaGetLastError();
}

}  // namespace
