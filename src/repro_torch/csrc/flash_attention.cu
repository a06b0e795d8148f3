// Causal attention forward with an online softmax (flash attention):
// o[b, s, h] = softmax_t(q[b, s, h] . k[b, t, h / G] * scale, t <= s) . v[b, t, h / G]
// for q (B, S, H, DH) and k, v (B, S, K, DH), H = K * G, f32 or bf16 in and
// out, every sum in f32.
//
// Replaces the TPU kernel `flash_attention_pallas` (body `_flash_kernel`) of
// src/repro/kernels/flash_attention/flash_attention.py, which walks a
// sequential (B*H, q block, kv block) grid of 256 x 256 MXU blocks with the
// running max, normalizer and accumulator in VMEM scratch, and whose wrapper
// pads head_dim to 128 and S to 256 and transposes to (B*H, S, DH).
//
// Bound on an H100: at the serving shape (B 4, S 1024, 16 heads, DH 64,
// bf16) q, k, v and o are 34 MB, 10 us at the memory rate, and the causal
// products 8.6 GFLOP, 8.7 us at the bf16 tensor-core rate.
//
// bf16 path (Hopper only: wgmma, TMA, warp specialisation).  A block is one
// consumer warpgroup (4 warps x 16 query rows) and one producer warp.  The
// producer's elected lane loads the query tile once and the key and value
// tiles into a ring of two stages with TMA (cp.async.bulk.tensor through
// tensor maps the host encodes per call), each stage guarded by a "full"
// and an "empty" mbarrier; the consumers compute S = Q . K^T with wgmma from
// shared memory, keep the online softmax of their rows in registers, and add
// P . V with wgmma taking P from registers.  Overlap comes from the three or
// four blocks an SM holds; two consumer warpgroups sharing a key tile, a
// third stage, and issuing the next tile's S during this tile's softmax
// were each slower at the serving shape.  Tiles land in shared memory in
// the hardware's swizzled layout (128-byte rows of 64 head-dim values; 32-
// and 64-byte rows for head dims 16 and 32; head dims above 64 in boxes of
// 64 columns, so 112 reads a zero-filled 128), which the wgmma descriptors
// name.  P is rounded to bf16 once before P . V, as the plain version
// (models.layers.chunked_causal_attention) and SDPA round it: one P . V
// product per tile, within the reference kernel test's 2e-2 of the plain
// version.
//
// f32 path (unchanged): the CUDA cores in full f32 (no TF32; wgmma has no
// f32 mode), 4 x 4 scores per thread from shared-memory tiles.
//
// Design, both paths:
//  * one block per (query tile of 64 rows, b * h), the tiles with the most
//    keys launched first; key tiles wholly above the diagonal are skipped;
//  * q, k, v are read in place through their strides (the (B, S, H, DH)
//    layout, no transposes), and query head h reads key/value head h / G
//    directly (no repetition); on bf16 the tensor maps need 16-byte aligned
//    data and strides that are multiples of 8 elements (the wrapper checks);
//  * S need not be a multiple of the tile: rows and keys past S load as 0
//    (on bf16 TMA fills them), keys past S are masked and rows past S are
//    not written;
//  * DH is a template parameter: 64 and 128 (qwen1.5, internlm2), 112
//    (zamba2) and the smoke configs' 16 and 32;
//  * the running (max, normalizer) and the output rows live in registers,
//    masked logits are -1e30 and the normalizer is clamped at 1e-30, as in
//    the TPU kernel;
//  * no atomics: every sum has a fixed order, so two runs are bitwise equal.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per shared-memory tile
constexpr int THREADS = 256;    // f32 path: 16 row groups x 16 column lanes
constexpr int RPT = BQ / 16;    // f32 path: query rows per thread
constexpr int CPT = BK / 16;    // f32 path: key columns per thread
constexpr int WG = 128;         // bf16 path: one consumer warpgroup, 4 warps x 16 rows
constexpr int TMA_THREADS = WG + 32;  // bf16 path: and one producer warp
constexpr int STAGES = 2;       // bf16 path: key/value stages in the ring
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int s, h, g, bh, nq;
  int64_t qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;  // element strides
  float scale;
};

// f32 path ----------------------------------------------------------------
//
// Shared-memory layout; the padded row strides keep the column reads of a
// warp on distinct banks.
template <int DH>
struct Smem {
  static constexpr int QS = DH + 1;  // sQ  [BQ][QS]  query tile
  static constexpr int KS = BK + 1;  // sKt [DH][KS]  key tile, transposed
  static constexpr int PS = BK + 1;  // sP  [BQ][PS]  the tile's softmax weights
  static constexpr int bytes = (BQ * QS + DH * KS + BK * DH + BQ * PS) * (int)sizeof(float);
};

template <int DH>
__global__ void __launch_bounds__(THREADS) flash_fwd_f32(Params a) {
  using T = float;
  using L = Smem<DH>;
  constexpr int DPT = DH / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sKt = sQ + BQ * L::QS;
  float* sV = sKt + DH * L::KS;  // [BK][DH]
  float* sP = sV + BK * DH;

  const int qt = a.nq - 1 - (int)(blockIdx.x / (unsigned)a.bh);
  const int bh = (int)(blockIdx.x % (unsigned)a.bh);
  const int b = bh / a.h, h = bh % a.h, kh = h / a.g;
  const int q0 = qt * BQ;
  const T* qp = static_cast<const T*>(a.q) + b * a.qsb + h * a.qsh;
  const T* kp = static_cast<const T*>(a.k) + b * a.ksb + kh * a.ksh;
  const T* vp = static_cast<const T*>(a.v) + b * a.vsb + kh * a.vsh;
  const int64_t orow = (int64_t)a.h * DH;  // o is (B, S, H, DH), contiguous
  T* op = static_cast<T*>(a.o) + (int64_t)b * a.s * orow + (int64_t)h * DH;

  const int tid = threadIdx.x;
  const int lane = tid & 15;  // key / output columns lane + 16 j
  const int grp = tid >> 4;   // query rows grp * RPT + r

  for (int i = tid; i < BQ * DH; i += THREADS) {
    const int r = i / DH, d = i - r * DH, s = q0 + r;
    sQ[r * L::QS + d] = s < a.s ? qp[s * a.qss + d] : 0.0f;
  }

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.0f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[r][j] = 0.0f;
  }

  const int last_row = min(q0 + BQ, a.s) - 1;
  const int n_tiles = last_row / BK + 1;  // key tiles at or left of the diagonal
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile (and sQ's load) is done
    for (int i = tid; i < BK * DH; i += THREADS) {
      const int c = i / DH, d = i - c * DH, s = k0 + c;
      const bool in = s < a.s;
      sKt[d * L::KS + c] = in ? kp[s * a.kss + d] : 0.0f;
      sV[c * DH + d] = in ? vp[s * a.vss + d] : 0.0f;
    }
    __syncthreads();

    // logits of this thread's RPT x CPT (row, key) pairs
    float sc[RPT][CPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) sc[r][c] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) qv[r] = sQ[(grp * RPT + r) * L::QS + d];
#pragma unroll
      for (int c = 0; c < CPT; ++c) kv[c] = sKt[d * L::KS + lane + 16 * c];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) sc[r][c] = fmaf(qv[r], kv[c], sc[r][c]);
    }

    // online softmax; a row's 64 keys are spread over the 16 lanes of its
    // half-warp, reduced with xor shuffles inside the half
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int qpos = q0 + grp * RPT + r;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int kpos = k0 + lane + 16 * c;
        float s = sc[r][c] * a.scale;
        if (kpos > qpos || kpos >= a.s) s = NEG_INF;
        sc[r][c] = s;
        mx = fmaxf(mx, s);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float p = expf(sc[r][c] - m_new);
        sP[(grp * RPT + r) * L::PS + lane + 16 * c] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[r] = alpha * l[r] + rs;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[r][j] *= alpha;
      m[r] = m_new;
    }
    __syncthreads();

    // acc += P . V over the tile's keys (masked keys carry p = 0)
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) pv[r] = sP[(grp * RPT + r) * L::PS + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const float vv = sV[c * DH + lane + 16 * j];
#pragma unroll
        for (int r = 0; r < RPT; ++r) acc[r][j] = fmaf(pv[r], vv, acc[r][j]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int s = q0 + grp * RPT + r;
    if (s < a.s) {
      const float norm = fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int j = 0; j < DPT; ++j) op[s * orow + lane + 16 * j] = acc[r][j] / norm;
    }
  }
}


// bf16 path ---------------------------------------------------------------
//
// Shared memory: the query tile, then STAGES x (key tile, value tile), each
// 64 rows (queries or keys) of ATOMS boxes of COLS head-dim columns; a box is
// 64 rows of ROW_BYTES, swizzled by TMA in groups of 8 rows.  In the wgmma
// fragments lane (g = lane / 4, t = lane % 4) of warp w holds rows 16 w + g
// and + 8, columns 8 j + 2 t and + 1 of every 8-column block j.

template <int DH>
struct TmaTile {
  static constexpr int COLS = DH < 64 ? DH : 64;          // head-dim columns of a box
  static constexpr int ROW_BYTES = COLS * 2;              // 32, 64 or 128: the swizzle span
  static constexpr int ATOMS = (DH + COLS - 1) / COLS;    // boxes across the head dim
  static constexpr int SWIZZLE = ROW_BYTES == 128 ? 1 : (ROW_BYTES == 64 ? 2 : 3);
  static constexpr int GROUP_BYTES = 8 * ROW_BYTES;       // one 8-row swizzle group
  static constexpr int ATOM_BYTES = 64 * ROW_BYTES;       // one box of 64 rows
  static constexpr int TILE_BYTES = ATOMS * ATOM_BYTES;   // a 64-row tile
  static constexpr int STEPS_PER_ATOM = ROW_BYTES / 32;   // k-steps of 16 values in a box
  // + 1 KB to align the tiles to the 128-byte swizzle's 1 KB period
  static constexpr int bytes = 1024 + (1 + 2 * STAGES) * TILE_BYTES;
};

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}

template <int DH>
__global__ void __launch_bounds__(TMA_THREADS) flash_fwd_bf16(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, Params a) {
  using L = TmaTile<DH>;
  using hopper::desc;
  using hopper::smem_addr;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];  // q_full, full[], empty[]
  unsigned char* const base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* const q_full = bars;
  uint64_t* const full = bars + 1;
  uint64_t* const empty = bars + 1 + STAGES;

  const int qt = a.nq - 1 - (int)(blockIdx.x / (unsigned)a.bh);
  const int bh = (int)(blockIdx.x % (unsigned)a.bh);
  const int b = bh / a.h, h = bh % a.h, kh = h / a.g;
  const int q0 = qt * BQ;
  const int n_tiles = (min(q0 + BQ, a.s) - 1) / BK + 1;  // key tiles at or left of the diagonal
  const int tid = threadIdx.x;

  if (tid == 0) {
    hopper::mbar_init(q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      hopper::mbar_init(&full[st], 1);
      hopper::mbar_init(&empty[st], WG);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= WG) {
    // producer warp: one lane issues every load, up to STAGES tiles ahead
    if (tid == WG) {
      hopper::mbar_expect_tx(q_full, L::TILE_BYTES);
      for (int at = 0; at < L::ATOMS; ++at)
        hopper::tma_load_4d(base + at * L::ATOM_BYTES, &qmap, q_full, at * L::COLS, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % STAGES;
        if (j >= STAGES) hopper::mbar_wait(&empty[st], ((j / STAGES) - 1) & 1);
        unsigned char* const sk = base + (1 + 2 * st) * L::TILE_BYTES;
        unsigned char* const sv = sk + L::TILE_BYTES;
        hopper::mbar_expect_tx(&full[st], 2 * L::TILE_BYTES);
        for (int at = 0; at < L::ATOMS; ++at) {
          hopper::tma_load_4d(sk + at * L::ATOM_BYTES, &kmap, &full[st], at * L::COLS, kh,
                              j * BK, b);
          hopper::tma_load_4d(sv + at * L::ATOM_BYTES, &vmap, &full[st], at * L::COLS, kh,
                              j * BK, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup: per key tile, S = Q . K^T (wgmma, both operands
  // in shared memory), the online softmax in registers, O += P . V (wgmma,
  // P from registers), then the stage goes back to the producer
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;  // this thread's query rows
  const float sl2 = a.scale * 1.4426950408889634f;      // logits in the log2 domain
  const uint32_t q_addr = smem_addr(base);

  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.0f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.0f, l1 = 0.0f;

  hopper::mbar_wait(q_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % STAGES;
    const int k0 = j * BK;
    const uint32_t k_addr = q_addr + (1 + 2 * st) * L::TILE_BYTES;
    const uint32_t v_addr = k_addr + L::TILE_BYTES;
    hopper::mbar_wait(&full[st], (j / STAGES) & 1);

    // S = Q . K^T over the head dim, 16 values a step (both operands K-major)
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
    hopper::fence_regs(sc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < DH / 16; ++kd) {
      const uint32_t off =
          (kd / L::STEPS_PER_ATOM) * L::ATOM_BYTES + (kd % L::STEPS_PER_ATOM) * 32;
      hopper::wgmma_ss_n64(sc, desc(q_addr + off, 16, L::GROUP_BYTES, L::SWIZZLE),
                           desc(k_addr + off, 16, L::GROUP_BYTES, L::SWIZZLE), kd > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);

    // mask and online softmax; a row's 64 keys lie with the 4 lanes of its quad
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? row0 : row1, col = k0 + nt * 8 + 2 * t + (e & 1);
        float s = sc[4 * nt + e] * sl2;
        if (col > row || col >= a.s) s = NEG_INF;
        sc[4 * nt + e] = s;
      }
      mx0 = fmaxf(mx0, fmaxf(sc[4 * nt], sc[4 * nt + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * nt + 2], sc[4 * nt + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f(m0 - n0), alpha1 = exp2f(m1 - n1);
    float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      sc[4 * nt] = exp2f(sc[4 * nt] - n0);
      sc[4 * nt + 1] = exp2f(sc[4 * nt + 1] - n0);
      sc[4 * nt + 2] = exp2f(sc[4 * nt + 2] - n1);
      sc[4 * nt + 3] = exp2f(sc[4 * nt + 3] - n1);
      rs0 += sc[4 * nt] + sc[4 * nt + 1];
      rs1 += sc[4 * nt + 2] + sc[4 * nt + 3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, off);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, off);
    }
    l0 = alpha0 * l0 + rs0;
    l1 = alpha1 * l1 + rs1;
    m0 = n0;
    m1 = n1;
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) {
      o[4 * nd] *= alpha0;
      o[4 * nd + 1] *= alpha0;
      o[4 * nd + 2] *= alpha1;
      o[4 * nd + 3] *= alpha1;
    }

    // O += P . V: keys 16 kk .. + 15 are the score blocks 2 kk and 2 kk + 1,
    // which are exactly the A fragment of that k-step; V is MN-major
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = pack_f32(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_f32(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_f32(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_f32(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
    hopper::fence_regs(o);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      hopper::wgmma_rs<DH>(o, pa[kk], desc(v_addr + kk * 16 * L::ROW_BYTES, L::ATOM_BYTES,
                                            L::GROUP_BYTES, L::SWIZZLE));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    hopper::mbar_arrive(&empty[st]);  // this stage may be loaded again
  }

  const int64_t orow = (int64_t)a.h * DH;  // o is (B, S, H, DH), contiguous
  __nv_bfloat16* op =
      static_cast<__nv_bfloat16*>(a.o) + (int64_t)b * a.s * orow + (int64_t)h * DH;
  const float norm0 = fmaxf(l0, 1e-30f), norm1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int nd = 0; nd < DH / 8; ++nd) {
    const int col = nd * 8 + 2 * t;
    if (row0 < a.s)
      *reinterpret_cast<uint32_t*>(op + row0 * orow + col) =
          pack_f32(o[4 * nd] / norm0, o[4 * nd + 1] / norm0);
    if (row1 < a.s)
      *reinterpret_cast<uint32_t*>(op + row1 * orow + col) =
          pack_f32(o[4 * nd + 2] / norm1, o[4 * nd + 3] / norm1);
  }
}

// cuTensorMapEncodeTiled, a driver function, through the runtime's entry
// point query, so that the library links no driver library
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// the tensor map of a (B, S, heads, DH) bf16 tensor read through its element
// strides, in boxes of 64 rows of one head and COLS head-dim columns
template <int DH>
bool encode(CUtensorMap* map, const void* ptr, int b, int s, int heads, int64_t sb, int64_t ss,
            int64_t sh) {
  using L = TmaTile<DH>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)DH, (cuuint64_t)heads, (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)L::COLS, 1, (cuuint32_t)BQ, 1};  // BQ == BK rows
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = L::SWIZZLE == 1   ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : L::SWIZZLE == 2 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                   : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
int launch_bf16(const Params& a, int b, int kv_heads, int blocks, cudaStream_t stream) {
  CUtensorMap maps[3];
  if (!encode<DH>(&maps[0], a.q, b, a.s, a.h, a.qsb, a.qss, a.qsh) ||
      !encode<DH>(&maps[1], a.k, b, a.s, kv_heads, a.ksb, a.kss, a.ksh) ||
      !encode<DH>(&maps[2], a.v, b, a.s, kv_heads, a.vsb, a.vss, a.vsh))
    return (int)cudaErrorInvalidValue;
  const int smem = TmaTile<DH>::bytes;
  static bool sized = false;  // the attribute is set once for the process
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(flash_fwd_bf16<DH>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  flash_fwd_bf16<DH><<<blocks, TMA_THREADS, smem, stream>>>(maps[0], maps[1], maps[2], a);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_dh(bool bf16, const Params& a, int b, int kv_heads, int blocks, cudaStream_t stream) {
  if (bf16) return launch_bf16<DH>(a, b, kv_heads, blocks, stream);
  const int smem = Smem<DH>::bytes;
  const cudaError_t e = cudaFuncSetAttribute(flash_fwd_f32<DH>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  flash_fwd_f32<DH><<<blocks, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int dispatch(int dh, bool bf16, const Params& a, int b, int kv_heads, int blocks,
             cudaStream_t stream) {
  switch (dh) {
    case 16: return launch_dh<16>(bf16, a, b, kv_heads, blocks, stream);
    case 32: return launch_dh<32>(bf16, a, b, kv_heads, blocks, stream);
    case 64: return launch_dh<64>(bf16, a, b, kv_heads, blocks, stream);
    case 112: return launch_dh<112>(bf16, a, b, kv_heads, blocks, stream);
    case 128: return launch_dh<128>(bf16, a, b, kv_heads, blocks, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v in their (B, S, heads, DH) layouts through element strides (the
// last dimension contiguous; on bf16 the data 16-byte aligned and the
// strides multiples of 8); o (B, S, H, DH) contiguous, in q's type.
// q_block and kv_block must equal the compiled tile (the wrapper passes its
// launch table, so the two cannot drift apart).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int b,
                                      int s, int h, int kv_heads, int dh, int64_t qsb,
                                      int64_t qss, int64_t qsh, int64_t ksb, int64_t kss,
                                      int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh,
                                      int bf16, float scale, int q_block, int kv_block,
                                      void* stream) {
  if (q_block != BQ || kv_block != BK || kv_heads <= 0 || h % kv_heads)
    return (int)cudaErrorInvalidValue;
  const int nq = (s + BQ - 1) / BQ;
  const long long blocks = (long long)nq * b * h;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Params a{q, k, v, o, s, h, h / kv_heads, b * h, nq, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
           scale};
  return dispatch(dh, bf16 != 0, a, b, kv_heads, (int)blocks, (cudaStream_t)stream);
}
