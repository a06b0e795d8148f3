// Edge megakernel: one pass over a window that resolves each tuple's
// stratum slot, samples it, and emits every per-slot stat row the fused
// backend needs, for M members at once:
//
//   slot    = sidx[m, i]                        (sidx mode), or
//             code table position of morton(lat_i, lon_i), none if absent
//   keep    = ok[m, i] && slot exists && score[m, i] < thr[m, slot]
//   pop     += ok;  keep += keep                 (per member and slot)
//   s1, s2  += keep·y_c, (keep·y_c)·y_c          (every value column)
//   mins, maxs over kept y_e                     (extrema columns)
//   bins    += keep at the 513-bin log index     (sketch columns)
//
// Replaces the TPU kernel `edge_megakernel_pallas` (bodies
// `_mega_kernel_latlon`, `_mega_kernel_sidx`, `_fused_body`,
// `_threshold_keep`) of src/repro/kernels/edge_megakernel/edge_megakernel.py.
// That kernel walks a (member x strata-block x points-block) grid and turns
// every gather and scatter into one-hot MXU contractions because the TPU
// lacks both; here each thread gathers its threshold directly.
//
// Bound on an H100: memory.  At the main path's shape (1.2 M tuples,
// 6558 slots, two f32 columns, one extrema and one sketch column, one
// member) the pass reads about 21 bytes a tuple in latlon mode (lat, lon,
// two values, ok, score) and writes the rows, 13.5 MB of them sketch bins:
// about 11.6 us at 3.35 TB/s.  The integer work per tuple (an encode, a
// 13-step binary search, a log) is far below the card's rate.
//
// Design: two kernels, no float atomics, no global sort.
//
//  * tile_kernel: one block per (tile of at most TILE consecutive tuples,
//    member); the wrapper spreads the window evenly over whole waves of
//    tiles.  The block resolves its tuples (threshold row and code table in
//    shared memory, read from global memory when they do not fit), then
//    sorts the tile in shared memory by the key 2 slot + (not kept) with a
//    block radix sort (stable: a key's tuples keep their load order); tuples
//    that are not ok or have no slot sort last and drop out.  Each slot's
//    tuples are now one run of sorted positions.  A segmented reduction
//    writes one record per (tile, slot): thread t folds its ITEMS
//    consecutive positions in order, a run that ends inside them is stored
//    at once, and the thread that starts a run crossing into later threads
//    adds their partial heads in thread order.  Records hold the ok and kept
//    counts, each column's kept s1 and s2 in double, and the extrema as
//    order-preserving integer images.  The value columns are staged in
//    shared memory one at a time (coalesced, over the table the resolve no
//    longer needs).  Sketch bins are counted with integer atomics, one per
//    distinct (slot, bin) among a warp's lanes at each step
//    (__match_any_sync): sorted, a hot slot fills whole warps.  The tile's
//    sort and segmented reduction are tile_runs.cuh's, shared with
//    edge_reduce.cu and stratified_stats.cu.
//  * finish_kernel: one warp per (member, slot) adds the slot's records over
//    the tiles in tile order (lanes strided, then a fixed shuffle tree),
//    rounds the sums to f32 once, decodes the extrema, and converts the
//    slot's sketch bins to f32 in place.
//
// Why this shape: every sum is added in an order fixed by the data, so two
// runs give the same bits, with no float atomics.  No global atomic counts
// pop, keep or the extrema per tuple: in a skewed window (the Shenzhen
// window's busiest Geohash-6 cells hold ~20 000 tuples each) the atomics of
// a hot slot serialise.  And no sort of the whole window orders the sums:
// the key of a tile's sort needs 14 bits (2 S + 1 values at Geohash-6), and
// the tiles' order fixes the rest.
//
// Scratch: the records take M x S x tiles x (8 + 8 E + 16 C) bytes, read
// once by the finish.  Counts are exact below 2^24.  Values may arrive as
// bf16 (staged); they are widened to f32 before any product, compare or bin
// index.  No fast-math: the sketch bin index uses IEEE division and logf, as
// the plain version does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "geohash.cuh"
#include "tile_runs.cuh"

namespace {

using tile_runs::ITEMS;
using tile_runs::TILE;
using tile_runs::TILE_THREADS;
using tile_runs::TileSmem;
using tile_runs::warp_sum;

constexpr int FINISH_THREADS = 256;

// sketch bin layout: the constants of estimators.py
constexpr int kBinsPerSide = 256;
constexpr int kNumBins = 2 * kBinsPerSide + 1;
constexpr float kMinMag = 1e-4f;
constexpr float kLogGamma = 0.08f;

constexpr int32_t kOrderedPosInf = 0x7F800000;   // ordered images of +inf, -inf
constexpr int32_t kOrderedNegInf = -0x7F800001;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// order-preserving float <-> int32 map (its own inverse)
__device__ __forceinline__ int32_t ordered(int32_t bits) {
  return bits >= 0 ? bits : bits ^ 0x7FFFFFFF;
}

__device__ __forceinline__ int sketch_bin(float v) {
  // floor(log(max(|v|, MIN_MAG) / MIN_MAG) / LOG_GAMMA), clipped, signed
  const float mag = fabsf(v);
  float k = floorf(__fdiv_rn(logf(__fdiv_rn(fmaxf(mag, kMinMag), kMinMag)), kLogGamma));
  k = fminf(fmaxf(k, 0.0f), (float)(kBinsPerSide - 1));
  const int ki = (int)k;
  if (v > kMinMag) return kBinsPerSide + 1 + ki;
  if (v < -kMinMag) return kBinsPerSide - 1 - ki;
  return kBinsPerSide;
}

// fixed butterflies, like tile_runs::warp_sum
__device__ __forceinline__ int32_t warp_min(int32_t v) {
  for (int off = 16; off > 0; off >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ int32_t warp_max(int32_t v) {
  for (int off = 16; off > 0; off >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <typename T>
struct Args {
  const T* vals;                 // (C, N)
  const uint8_t* ok;             // member m at ok + m * ok_ms
  const float* scores;           // member m at scores + m * sc_ms
  const float* thr;              // (M, S)
  const int32_t* sidx;           // sidx mode (else null); member m at sidx + m * sidx_ms
  const float* lat;              // latlon mode
  const float* lon;
  const int32_t* codes;          // sorted, num_codes entries
  int64_t ok_ms, sc_ms, sidx_ms;
  int64_t n;
  int c, s, num_codes, m;
  geohash_dev::Params geo;
  uint32_t ext_mask, sk_mask;    // value columns with extrema / sketch rows
  int e, k;                      // popcounts of the masks
  int use_smem, key_bits, tiles, per;  // per: tuples of a tile (<= TILE)
  int front_bytes;               // dynamic shared memory before the sort's scratch
  // records of the (member, slot, tile) runs, tile fastest; written where
  // the tile holds an ok tuple of the slot (popc > 0), popc zero elsewhere
  int32_t* popc;                 // (M, S, tiles)
  int32_t* keepc;                // (M, S, tiles)
  int32_t* ext;                  // (M, E, 2, S, tiles) ordered min, max
  double* sums;                  // (M, 2C, S, tiles) s1 per column, then s2
  int32_t* bins;                 // (M, K, S, 513) integer counts, then f32 in place
  // outputs
  float* pop;                    // (M, S)
  float* keep;                   // (M, S)
  float* s1;                     // (M, C, S)
  float* s2;
  float* mins;                   // (M, E, S)
  float* maxs;
};

template <typename T>
__device__ __forceinline__ int64_t rec(const Args<T>& a, int m, int row, int rows, int slot,
                                       int tile) {
  return tile_runs::record((int64_t)m * rows + row, slot, tile, a.s, a.tiles);
}

// one (tile, slot) record: column col's sums, and its extrema as extrema
// row ext (-1: the column has none)
template <typename T>
__device__ __forceinline__ void store_column(const Args<T>& a, int m, int tile, uint32_t slot,
                                             int col, double a1, double a2, int ext, int32_t lo,
                                             int32_t hi) {
  a.sums[rec(a, m, col, 2 * a.c, slot, tile)] = a1;
  a.sums[rec(a, m, a.c + col, 2 * a.c, slot, tile)] = a2;
  if (ext >= 0) {
    a.ext[rec(a, m, 2 * ext, 2 * a.e, slot, tile)] = lo;
    a.ext[rec(a, m, 2 * ext + 1, 2 * a.e, slot, tile)] = hi;
  }
}

template <typename T>
__device__ __forceinline__ void store_counts(const Args<T>& a, int m, int tile, uint32_t slot,
                                             int n_ok, int n_kept) {
  a.keepc[rec(a, m, 0, 1, slot, tile)] = n_kept;
  a.popc[rec(a, m, 0, 1, slot, tile)] = n_ok;
}

// Partial records of a slot's run: ok and kept counts, or one column's
// kept sums (in double) and extrema (ordered images).
struct Counts {
  int ok = 0, kept = 0;
  __device__ __forceinline__ void merge(const Counts& o) {
    ok += o.ok;
    kept += o.kept;
  }
};

struct Moments {
  double a1 = 0.0, a2 = 0.0;
  int32_t lo = kOrderedPosInf, hi = kOrderedNegInf;
  __device__ __forceinline__ void merge(const Moments& o) {
    a1 += o.a1;
    a2 += o.a2;
    lo = min(lo, o.lo);
    hi = max(hi, o.hi);
  }
};

template <typename T>
__global__ void __launch_bounds__(TILE_THREADS, 1) tile_kernel(Args<T> a) {
  // dynamic: [threshold row | code table], later one staged value column,
  // then the sort's scratch, later the sorted keys and positions
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) unsigned char heads_raw[sizeof(Moments) * TILE_THREADS];
  __shared__ bool has_start[TILE_THREADS];
  Moments* const heads = reinterpret_cast<Moments*>(heads_raw);
  const int m = blockIdx.y, tile = blockIdx.x;
  const int64_t i0 = (int64_t)tile * a.per;
  const int count = (int)max((int64_t)0, min((int64_t)a.per, a.n - i0));  // this tile's tuples
  const float* thr = a.thr + (int64_t)m * a.s;
  const int32_t* codes = a.codes;
  if (a.use_smem) {
    float* thr_sh = reinterpret_cast<float*>(smem);
    for (int j = threadIdx.x; j < a.s; j += TILE_THREADS) thr_sh[j] = thr[j];
    thr = thr_sh;
    if (codes != nullptr) {
      int32_t* codes_sh = reinterpret_cast<int32_t*>(smem + sizeof(float) * a.s);
      for (int j = threadIdx.x; j < a.num_codes; j += TILE_THREADS) codes_sh[j] = a.codes[j];
      codes = codes_sh;
    }
    __syncthreads();
  }
  float* const column = reinterpret_cast<float*>(smem);  // after the sort
  TileSmem& sh = *reinterpret_cast<TileSmem*>(smem + a.front_bytes);

  // resolve, threshold, key.  Tuples load striped (coalesced), and a key's
  // tuples keep that order through the stable sort.  The code table search
  // runs a fixed number of steps for all of a thread's tuples at once.
  const uint32_t none = 2u * (uint32_t)a.s;  // sorts after every slot's keys
  uint32_t keys[ITEMS];
  uint16_t pos[ITEMS];
  int slot[ITEMS];
  float score[ITEMS];
  uint32_t ok_bits = 0u;
  // every load first (independent, so they overlap), then the arithmetic
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int local = j * TILE_THREADS + threadIdx.x;
    const int64_t i = min(i0 + local, a.n - 1);  // past the tile: any tuple, not used
    pos[j] = (uint16_t)local;
    if (local < count && a.ok[m * a.ok_ms + i] != 0) ok_bits |= 1u << j;
    score[j] = a.scores[m * a.sc_ms + i];
    if (a.sidx != nullptr) {
      const int32_t v = a.sidx[m * a.sidx_ms + i];
      slot[j] = v < 0 ? 0 : (v > a.s ? a.s : v);
    }
  }
  if (a.sidx == nullptr) {
    int32_t code[ITEMS];
    int lo[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int64_t i = min(i0 + (int64_t)pos[j], a.n - 1);
      code[j] = geohash_dev::encode(a.lat[i], a.lon[i], a.geo);
      lo[j] = 0;
    }
    int step = 1;
    while (step * 2 <= a.num_codes) step *= 2;
    for (; step > 0; step >>= 1) {  // lo: the entries below code, its lower bound
#pragma unroll
      for (int j = 0; j < ITEMS; ++j)
        if (lo[j] + step <= a.num_codes && codes[lo[j] + step - 1] < code[j]) lo[j] += step;
    }
#pragma unroll
    for (int j = 0; j < ITEMS; ++j)
      slot[j] = (lo[j] < a.num_codes && codes[lo[j]] == code[j]) ? lo[j] : a.s;
  }
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    keys[j] = none;
    if (((ok_bits >> j) & 1u) != 0u && slot[j] < a.s)
      keys[j] = 2u * (uint32_t)slot[j] + (score[j] < thr[slot[j]] ? 0u : 1u);
  }
  tile_runs::sort_tile(sh, keys, pos, a.key_bits);

  const uint32_t* key = sh.run.key;
  const uint32_t none_slot = (uint32_t)a.s;
  const auto key_slot = [](uint32_t k) { return k >> 1; };  // key: 2 slot + not kept
  tile_runs::reduce_runs(
      key, key_slot, none_slot, reinterpret_cast<Counts*>(heads), has_start,
      [&](Counts& acc, int p) {
        acc.ok += 1;
        acc.kept += (key[p] & 1u) == 0u;
      },
      [&](uint32_t s, const Counts& acc) { store_counts(a, m, tile, s, acc.ok, acc.kept); });

  // each value column in turn, staged in shared memory (coalesced), over
  // the table that resolve no longer needs
  const int lane = threadIdx.x & 31;
  int ei = 0, ki = 0;
  for (int col = 0; col < a.c; ++col) {
    const uint32_t bit = 1u << col;
    const bool has_ext = (a.ext_mask & bit) != 0u, has_sk = (a.sk_mask & bit) != 0u;
    const T* v = a.vals + (int64_t)col * a.n + i0;
    for (int j = threadIdx.x; j < count; j += TILE_THREADS) column[j] = widen(v[j]);
    __syncthreads();
    if (has_sk) {
      // kept tuples' bins, one atomic per distinct (slot, bin) among the
      // warp's lanes at each step (a warp's positions are mostly one slot)
      int32_t* bins = a.bins + ((int64_t)m * a.k + ki) * a.s * kNumBins;
#pragma unroll 4
      for (int j = 0; j < ITEMS; ++j) {
        const int p = threadIdx.x * ITEMS + j;
        const bool kept = key[p] < none && (key[p] & 1u) == 0u;
        const uint32_t active = __ballot_sync(0xffffffffu, kept);
        if (kept) {
          const int64_t at = (int64_t)(key[p] >> 1) * kNumBins + sketch_bin(column[sh.run.pos[p]]);
          const uint32_t peers = __match_any_sync(active, at);
          if (lane == __ffs(peers) - 1) atomicAdd(&bins[at], __popc(peers));
        }
      }
    }
    tile_runs::reduce_runs(
        key, key_slot, none_slot, heads, has_start,
        [&](Moments& acc, int p) {
          if ((key[p] & 1u) != 0u) return;  // not kept
          const float y = column[sh.run.pos[p]];
          acc.a1 += (double)y;
          acc.a2 += (double)__fmul_rn(y, y);
          const int32_t o = ordered(__float_as_int(y));
          acc.lo = min(acc.lo, o);
          acc.hi = max(acc.hi, o);
        },
        [&](uint32_t s, const Moments& acc) {
          store_column(a, m, tile, s, col, acc.a1, acc.a2, has_ext ? ei : -1, acc.lo, acc.hi);
        });
    ei += has_ext;
    ki += has_sk;
  }
}

// one warp per (member, slot): the records over the tiles in tile order
template <typename T>
__global__ void __launch_bounds__(FINISH_THREADS) finish_kernel(Args<T> a) {
  const int lane = threadIdx.x & 31;
  const int64_t w = (int64_t)blockIdx.x * (FINISH_THREADS / 32) + (threadIdx.x >> 5);
  if (w >= (int64_t)a.m * a.s) return;  // warp-uniform
  const int m = (int)(w / a.s), slot = (int)(w % a.s);
  const int rows = 2 * a.c;
  const int32_t* popc = a.popc + rec(a, m, 0, 1, slot, 0);
  int n_ok = 0, n_kept = 0;
  for (int t = lane; t < a.tiles; t += 32) {
    if (popc[t] != 0) {
      n_ok += popc[t];
      n_kept += a.keepc[rec(a, m, 0, 1, slot, t)];
    }
  }
  n_ok = warp_sum(n_ok);
  n_kept = warp_sum(n_kept);
  for (int r = 0; r < rows; ++r) {
    double acc = 0.0;
    const double* sums = a.sums + rec(a, m, r, rows, slot, 0);
    for (int t = lane; t < a.tiles; t += 32)
      if (popc[t] != 0) acc += sums[t];
    acc = warp_sum(acc);
    if (lane == 0) {
      float* out = r < a.c ? a.s1 : a.s2;
      out[((int64_t)m * a.c + (r % a.c)) * a.s + slot] = (float)acc;
    }
  }
  for (int e = 0; e < a.e; ++e) {
    int32_t lo = kOrderedPosInf, hi = kOrderedNegInf;
    const int32_t* elo = a.ext + rec(a, m, 2 * e, 2 * a.e, slot, 0);
    const int32_t* ehi = a.ext + rec(a, m, 2 * e + 1, 2 * a.e, slot, 0);
    for (int t = lane; t < a.tiles; t += 32) {
      if (popc[t] != 0) {
        lo = min(lo, elo[t]);
        hi = max(hi, ehi[t]);
      }
    }
    lo = warp_min(lo);
    hi = warp_max(hi);
    if (lane == 0) {
      a.mins[((int64_t)m * a.e + e) * a.s + slot] = __int_as_float(ordered(lo));
      a.maxs[((int64_t)m * a.e + e) * a.s + slot] = __int_as_float(ordered(hi));
    }
  }
  if (lane == 0) {
    a.pop[(int64_t)m * a.s + slot] = (float)n_ok;
    a.keep[(int64_t)m * a.s + slot] = (float)n_kept;
  }
  for (int kk = 0; kk < a.k; ++kk) {
    int32_t* row = a.bins + (((int64_t)m * a.k + kk) * a.s + slot) * kNumBins;
    for (int b = lane; b < kNumBins; b += 32) row[b] = __float_as_int((float)row[b]);
  }
}

template <typename T>
int launch(Args<T> a, cudaStream_t stream) {
  const size_t table =
      sizeof(float) * a.s + (a.codes != nullptr ? sizeof(int32_t) * a.num_codes : 0);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t column = sizeof(float) * TILE;
  const size_t with_table = ((table > column ? table : column) + 15) & ~(size_t)15;
  a.use_smem = with_table + sizeof(TileSmem) <= (size_t)optin;
  a.front_bytes = (int)(a.use_smem ? with_table : column);
  const size_t smem = a.front_bytes + sizeof(TileSmem);
  if (a.tiles > 0) {
    cudaError_t err = cudaFuncSetAttribute(tile_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    tile_kernel<T><<<dim3((unsigned)a.tiles, (unsigned)a.m), TILE_THREADS, smem, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t warps = (int64_t)a.m * a.s;
  const int per_block = FINISH_THREADS / 32;
  finish_kernel<T><<<(unsigned)((warps + per_block - 1) / per_block), FINISH_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Both kernels on `stream`: `tiles` tiles of `per` <= TILE tuples cover the
// window (the wrapper spreads them over whole waves of the SMs); popc and
// bins zeroed by the caller; keepc, ext, sums and the outputs need no
// initial value.
extern "C" int edge_megakernel_launch(
    const void* vals, int vals_bf16, int c, int64_t n, int m, const uint8_t* ok, int64_t ok_ms,
    const float* scores, int64_t sc_ms, const float* thr, int s, const int32_t* sidx,
    int64_t sidx_ms, const float* lat, const float* lon, const int32_t* codes, int num_codes,
    float lat_scale, float lon_scale, int lat_bits, int lon_bits, int lon_high,
    int ext_mask, int sk_mask, int e, int k, int tiles, int per, int32_t* popc, int32_t* keepc,
    int32_t* ext, double* sums, int32_t* bins, float* pop, float* keep, float* s1, float* s2,
    float* mins, float* maxs, void* stream) {
  if (tiles < 0 || per < 0 || per > TILE || (int64_t)tiles * per < n || s < 1 || m < 1)
    return (int)cudaErrorInvalidValue;
  int key_bits = 1;
  while (key_bits < 32 && (1ll << key_bits) <= 2ll * s) ++key_bits;  // 2 s fits: the "none" key
  const geohash_dev::Params geo{lat_scale, lon_scale, lat_bits, lon_bits, lon_high};
  cudaStream_t st = (cudaStream_t)stream;
  if (vals_bf16) {
    Args<__nv_bfloat16> a{static_cast<const __nv_bfloat16*>(vals), ok, scores, thr, sidx, lat,
                          lon, codes, ok_ms, sc_ms, sidx_ms, n, c, s, num_codes, m, geo,
                          (uint32_t)ext_mask, (uint32_t)sk_mask, e, k, 0, key_bits, tiles, per, 0, popc,
                          keepc, ext, sums, bins, pop, keep, s1, s2, mins, maxs};
    return launch(a, st);
  }
  Args<float> a{static_cast<const float*>(vals), ok, scores, thr, sidx, lat, lon, codes, ok_ms,
                sc_ms, sidx_ms, n, c, s, num_codes, m, geo, (uint32_t)ext_mask,
                (uint32_t)sk_mask, e, k, 0, key_bits, tiles, per, 0, popc, keepc, ext, sums, bins,
                pop, keep, s1, s2, mins, maxs};
  return launch(a, st);
}

