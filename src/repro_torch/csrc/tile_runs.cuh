// Tile-local slot runs, shared by the edge megakernel, edge_reduce and
// stratified_stats.
//
// A block takes a tile of at most TILE consecutive tuples of the window,
// gives each tuple a 32-bit key whose high part is its slot (key_slot maps a
// key to it), and sorts the keys with CUB's block radix sort in shared
// memory, carrying each tuple's position in the tile.  The sort is stable,
// so a slot's tuples form one run of sorted positions in load order.
// reduce_runs then folds every run in a fixed order into one record per
// (tile, slot); a finish pass adds a slot's records over the tiles in tile
// order.  Every sum is thus added in an order fixed by the data: two runs
// give the same bits, with no float atomics and no sort of the whole window.
//
// Records are laid out tile fastest (`record`), so the warp that finishes a
// slot reads consecutive words.

#pragma once

#include <cub/block/block_radix_sort.cuh>
#include <stdint.h>

namespace tile_runs {

constexpr int TILE_THREADS = 1024;
constexpr int ITEMS = 8;                     // tuples a thread sorts
constexpr int TILE = TILE_THREADS * ITEMS;   // tuples a block sorts, at most

using Sort = cub::BlockRadixSort<uint32_t, TILE_THREADS, ITEMS, uint16_t>;

// the tile's sorted keys and tuple positions, over the sort's scratch
union TileSmem {
  typename Sort::TempStorage sort;
  struct {
    uint32_t key[TILE];
    uint16_t pos[TILE];
  } run;
};

// fixed butterflies: every lane ends with the same bits on every run
__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// position of the record of (row block, slot, tile) among `s` slots and
// `tiles` tiles
__device__ __forceinline__ int64_t record(int64_t block, int slot, int tile, int s, int tiles) {
  return (block * s + slot) * tiles + tile;
}

// Sorts the block's keys and positions (ITEMS each, blocked) on their low
// `key_bits` bits and leaves them in `sh.run`, every thread's view synced.
__device__ __forceinline__ void sort_tile(TileSmem& sh, uint32_t (&keys)[ITEMS],
                                          uint16_t (&pos)[ITEMS], int key_bits) {
  Sort(sh.sort).Sort(keys, pos, 0, key_bits);
  __syncthreads();  // the sort's scratch becomes the run arrays
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    sh.run.key[threadIdx.x * ITEMS + j] = keys[j];
    sh.run.pos[threadIdx.x * ITEMS + j] = pos[j];
  }
  __syncthreads();
}

// Segmented reduction of the sorted tile by slot, in a fixed order.  Thread
// t folds its ITEMS consecutive sorted positions with add(acc, p); a run
// that starts and ends inside them is emitted at once, the part before the
// thread's first run start is published as its head, and the owner of a run
// that leaves its range adds the heads of the threads it covers, in order.
// Runs of `none_slot` are never emitted.
template <class Acc, class SlotOf, class Add, class Emit>
__device__ __forceinline__ void reduce_runs(const uint32_t* key, SlotOf key_slot,
                                            uint32_t none_slot, Acc* heads, bool* has_start,
                                            Add add, Emit emit) {
  const int t = threadIdx.x, p0 = t * ITEMS;
  Acc head, cur;
  bool started = false;
  uint32_t slot = key_slot(key[p0]);
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int p = p0 + j;
    const uint32_t sp = key_slot(key[p]);
    if (p == 0 || sp != key_slot(key[p - 1])) {
      if (started) {
        if (slot != none_slot) emit(slot, cur);
      } else {
        head = cur;
      }
      started = true;
      cur = Acc();
      slot = sp;
    }
    add(cur, p);
  }
  if (!started) head = cur;
  heads[t] = head;
  has_start[t] = started;
  __syncthreads();
  if (started && slot != none_slot) {
    for (int u = t + 1; u < TILE_THREADS && key_slot(key[u * ITEMS]) == slot; ++u) {
      cur.merge(heads[u]);
      if (has_start[u]) break;
    }
    emit(slot, cur);
  }
  __syncthreads();  // heads are reused by the next reduction
}

}  // namespace tile_runs
