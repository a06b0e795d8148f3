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
// lacks both; here each thread gathers its threshold and scatters its
// counts directly.
//
// Bound on an H100: memory.  At the main path's shape (1.2 M tuples,
// 6558 slots, two f32 columns, one extrema and one sketch column, one
// member) the pass reads about 21 bytes a tuple in latlon mode (lat, lon,
// two values, ok, score) and writes the rows, 13.5 MB of them sketch bins:
// about 11.6 us at 3.35 TB/s.  The integer work per tuple (an encode, a
// 13-step binary search, a log) is far below the card's rate.
//
// Design, for determinism and skew:
//
//  * Integer-valued rows (pop, keep, bins) count with int32 atomics in
//    their output memory and are converted to f32 in place at the end,
//    exact below 2^24.  Extrema use atomicMin/atomicMax on the
//    order-preserving integer image of the float; min and max do not
//    depend on order, and empty slots keep the images of +inf/-inf.
//  * The float sums s1, s2 never use float atomics: the resolve pass
//    writes each tuple's segment key (member, slot) and keep flag; the
//    wrapper stable-sorts the keys (glue, as for edge_reduce), and
//    segment_sum.cuh sums every segment's run in fixed-order chunks in
//    double and rounds once.  The same inputs give the same bits on every
//    run, and no warp walks more than one chunk however skewed the strata.
//  * The code table (sorted int32, padded nowhere: lookup is a binary
//    search over its true length) and member m's threshold row sit in
//    shared memory, 52 KB at Geohash-6; a table too large for shared
//    memory is read from global memory instead.
//  * Values may arrive as bf16 (staged); they are widened to f32 before
//    any product, compare or bin index.  No fast-math: the sketch bin
//    index uses IEEE division and logf, as the plain version does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "geohash.cuh"
#include "segment_sum.cuh"

namespace {

// sketch bin layout: the constants of estimators.py
constexpr int kBinsPerSide = 256;
constexpr int kNumBins = 2 * kBinsPerSide + 1;
constexpr float kMinMag = 1e-4f;
constexpr float kLogGamma = 0.08f;

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

template <typename T>
struct ResolveArgs {
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
  int c, s, num_codes;
  geohash_dev::Params geo;
  uint32_t ext_mask, sk_mask;    // value columns with extrema / sketch rows
  int e, k;                      // popcounts of the masks
  int use_smem;
  int32_t* pop;                  // (M, S)
  int32_t* keep;                 // (M, S)
  int32_t* bins;                 // (M, K, S, 513)
  int32_t* mins;                 // (M, E, S) ordered images
  int32_t* maxs;
  int32_t* key;                  // (M * N) segment m * (S + 1) + slot
  uint8_t* kept;                 // (M * N)
};

template <typename T>
__global__ void resolve_kernel(ResolveArgs<T> a) {
  extern __shared__ int32_t smem[];
  const int m = blockIdx.y;
  const float* thr = a.thr + (int64_t)m * a.s;
  const int32_t* codes = a.codes;
  if (a.use_smem) {
    float* thr_sh = reinterpret_cast<float*>(smem);
    for (int j = threadIdx.x; j < a.s; j += blockDim.x) thr_sh[j] = thr[j];
    thr = thr_sh;
    if (codes != nullptr) {
      int32_t* codes_sh = smem + a.s;
      for (int j = threadIdx.x; j < a.num_codes; j += blockDim.x) codes_sh[j] = a.codes[j];
      codes = codes_sh;
    }
    __syncthreads();
  }
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < a.n; i += stride) {
    int slot;
    if (a.sidx != nullptr) {
      const int32_t v = a.sidx[m * a.sidx_ms + i];
      slot = v < 0 ? 0 : (v > a.s ? a.s : v);
    } else {
      const int32_t code = geohash_dev::encode(a.lat[i], a.lon[i], a.geo);
      int lo = 0, hi = a.num_codes;  // lower bound
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (codes[mid] < code) lo = mid + 1; else hi = mid;
      }
      slot = (lo < a.num_codes && codes[lo] == code) ? lo : a.s;
    }
    const bool ok = a.ok[m * a.ok_ms + i] != 0;
    const bool keep = ok && slot < a.s && a.scores[m * a.sc_ms + i] < thr[slot];
    const int64_t t = (int64_t)m * a.n + i;
    a.key[t] = m * (a.s + 1) + slot;
    a.kept[t] = keep ? 1 : 0;
    if (slot >= a.s) continue;
    const int64_t ms = (int64_t)m * a.s + slot;
    if (ok) atomicAdd(&a.pop[ms], 1);
    if (!keep) continue;
    atomicAdd(&a.keep[ms], 1);
    int e = 0, k = 0;
    for (int col = 0; col < a.c; ++col) {
      const uint32_t bit = 1u << col;
      if (!((a.ext_mask | a.sk_mask) & bit)) continue;
      const float y = widen(a.vals[(int64_t)col * a.n + i]);
      if (a.ext_mask & bit) {
        const int64_t at = ((int64_t)m * a.e + e) * a.s + slot;
        const int32_t o = ordered(__float_as_int(y));
        atomicMin(&a.mins[at], o);
        atomicMax(&a.maxs[at], o);
        ++e;
      }
      if (a.sk_mask & bit) {
        atomicAdd(&a.bins[(((int64_t)m * a.k + k) * a.s + slot) * kNumBins + sketch_bin(y)], 1);
        ++k;
      }
    }
  }
}

template <typename T>
int launch_resolve(ResolveArgs<T> a, int m, int threads, int max_blocks, cudaStream_t stream) {
  const size_t bytes = sizeof(int32_t) * ((size_t)a.s + (a.codes != nullptr ? a.num_codes : 0));
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  a.use_smem = bytes <= (size_t)optin;
  const size_t smem = a.use_smem ? bytes : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(resolve_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int64_t blocks = (a.n + threads - 1) / threads;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  resolve_kernel<T><<<dim3((unsigned)blocks, (unsigned)m), threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// s1/s2 source: weight kept[p], value vals[col, p - m * N] for segment
// m * (S + 1) + slot
template <typename T>
struct KeptColumns {
  const T* vals;
  const uint8_t* kept;
  int64_t n;
  int s1_slots;  // S + 1
  int cols;
  __device__ __forceinline__ float weight(int, int32_t p) const { return kept[p] ? 1.0f : 0.0f; }
  __device__ __forceinline__ float value(int seg, int32_t p, int col) const {
    const int64_t member = seg / s1_slots;
    return widen(vals[(int64_t)col * n + (p - member * n)]);
  }
};

// rows 0..C-1 -> s1[m, c, slot], rows C..2C-1 -> s2[m, c, slot]; the
// no-slot segment of each member is dropped
struct StoreMoments {
  float* s1;
  float* s2;
  int c, s;
  __device__ __forceinline__ void operator()(int seg, int r, float v) const {
    const int m = seg / (s + 1), slot = seg % (s + 1);
    if (slot == s) return;
    if (r < c) s1[((int64_t)m * c + r) * s + slot] = v;
    else s2[((int64_t)m * c + (r - c)) * s + slot] = v;
  }
};

// integer counts -> f32 and ordered extrema images -> f32, in place
__global__ void to_float_kernel(int32_t* __restrict__ counts, int64_t n_counts,
                                int32_t* __restrict__ ext, int64_t n_ext) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_counts + n_ext;
       i += stride) {
    if (i < n_counts) {
      counts[i] = __float_as_int((float)counts[i]);
    } else {
      ext[i - n_counts] = ordered(ext[i - n_counts]);
    }
  }
}

}  // namespace

extern "C" int edge_megakernel_resolve_launch(
    const void* vals, int vals_bf16, int c, int64_t n, int m, const uint8_t* ok, int64_t ok_ms,
    const float* scores, int64_t sc_ms, const float* thr, int s, const int32_t* sidx,
    int64_t sidx_ms, const float* lat, const float* lon, const int32_t* codes, int num_codes,
    float lat_scale, float lon_scale, int lat_bits, int lon_bits, int lon_high,
    int ext_mask, int sk_mask, int e, int k, int32_t* counts, int32_t* ext, int32_t* key,
    uint8_t* kept, int threads, int max_blocks, void* stream) {
  const int64_t ms = (int64_t)m * s;
  const geohash_dev::Params geo{lat_scale, lon_scale, lat_bits, lon_bits, lon_high};
  cudaStream_t st = (cudaStream_t)stream;
  if (vals_bf16) {
    ResolveArgs<__nv_bfloat16> a{
        static_cast<const __nv_bfloat16*>(vals), ok, scores, thr, sidx, lat, lon, codes,
        ok_ms, sc_ms, sidx_ms, n, c, s, num_codes, geo, (uint32_t)ext_mask, (uint32_t)sk_mask,
        e, k, 0, counts, counts + ms, counts + 2 * ms, ext, ext + ms * e, key, kept};
    return launch_resolve(a, m, threads, max_blocks, st);
  }
  ResolveArgs<float> a{
      static_cast<const float*>(vals), ok, scores, thr, sidx, lat, lon, codes,
      ok_ms, sc_ms, sidx_ms, n, c, s, num_codes, geo, (uint32_t)ext_mask, (uint32_t)sk_mask,
      e, k, 0, counts, counts + ms, counts + 2 * ms, ext, ext + ms * e, key, kept};
  return launch_resolve(a, m, threads, max_blocks, st);
}

extern "C" int edge_megakernel_reduce_launch(
    const int32_t* perm, const int32_t* offsets, const int32_t* chunk_off, int chunk,
    int max_items, const void* vals, int vals_bf16, int c, int64_t n, int m, int s,
    const uint8_t* kept, double* partial, float* s1, float* s2, int32_t* counts,
    int64_t n_counts, int32_t* ext, int64_t n_ext, int threads, int max_blocks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int segs = m * (s + 1);
  const StoreMoments store{s1, s2, c, s};
  int err;
  if (vals_bf16) {
    const KeptColumns<__nv_bfloat16> src{static_cast<const __nv_bfloat16*>(vals), kept, n, s + 1, c};
    err = segsum::launch(perm, offsets, chunk_off, segs, chunk, max_items, 0, src, partial,
                         store, threads, st);
  } else {
    const KeptColumns<float> src{static_cast<const float*>(vals), kept, n, s + 1, c};
    err = segsum::launch(perm, offsets, chunk_off, segs, chunk, max_items, 0, src, partial,
                         store, threads, st);
  }
  if (err != 0) return err;
  const int64_t total = n_counts + n_ext;
  if (total > 0) {
    int64_t blocks = (total + threads - 1) / threads;
    if (blocks > max_blocks) blocks = max_blocks;
    to_float_kernel<<<(unsigned)blocks, threads, 0, st>>>(counts, n_counts, ext, n_ext);
  }
  return (int)cudaGetLastError();
}
