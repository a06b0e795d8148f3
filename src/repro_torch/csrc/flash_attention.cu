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
// products 8.6 GFLOP, 8.7 us at the bf16 tensor-core rate.  bf16 inputs take
// the tensor cores through mma.sync (m16n8k16, f32 accumulate); P . V runs
// as two products, P's bf16 high part and its bf16 remainder, so P keeps
// about 16 bits where the TPU kernel keeps it in f32.  f32 inputs stay on
// the CUDA cores in full f32 (no TF32), 4 x 4 scores per thread from
// shared-memory tiles.  wgmma, TMA and warp specialisation are later work.
//
// Design, both paths:
//  * one block per (query tile of 64 rows, b * h), the tiles with the most
//    keys launched first; key tiles wholly above the diagonal are skipped;
//  * q, k, v are read in place through their strides (the (B, S, H, DH)
//    layout, no transposes), and query head h reads key/value head h / G
//    directly (no repetition); on bf16, k and v are copied in 16-byte
//    pieces, so their strides are multiples of 8 and their data 16-byte
//    aligned (the wrapper checks);
//  * S need not be a multiple of the tile: rows and keys past S load as 0,
//    keys past S are masked and rows past S are not written;
//  * DH is a template parameter, unpadded: 64 and 128 (qwen1.5, internlm2),
//    112 (zamba2) and the smoke configs' 16 and 32;
//  * the running (max, normalizer) and the output rows live in registers,
//    masked logits are -1e30 and the normalizer is clamped at 1e-30, as in
//    the TPU kernel;
//  * no atomics: every sum has a fixed order, so two runs are bitwise equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per shared-memory tile
constexpr int THREADS = 256;    // f32 path: 16 row groups x 16 column lanes
constexpr int RPT = BQ / 16;    // f32 path: query rows per thread
constexpr int CPT = BK / 16;    // f32 path: key columns per thread
constexpr int MMA_THREADS = 128;  // bf16 path: 4 warps of 16 query rows
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
// Warp w owns query rows q0 + 16 w .. + 15; in the m16n8k16 fragments lane
// (g = lane / 4, t = lane % 4) holds rows g and g + 8 and columns 2t, 2t + 1
// (+ 8).  Q stays in registers as A fragments.  The key and value tiles are
// copied row for row (row = key) into shared memory with 16-byte cp.async,
// double-buffered: the next tile's copy runs while this tile is computed.
// Rows are padded by 8 elements so that the fragment loads of a warp hit
// distinct banks; V's B fragments come transposed out of shared memory
// through ldmatrix.  The scores' C fragments become P . V's A fragments in
// place.

template <int DH>
struct MmaSmem {
  static constexpr int RS = DH + 8;                 // row stride of a tile
  static constexpr int TILE = BK * RS;              // elements of one tile
  // two buffers, each a key tile then a value tile
  static constexpr int bytes = 2 * 2 * TILE * (int)sizeof(__nv_bfloat16);
};

// 16 bytes from global to shared memory, asynchronously; zeros when !in
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(addr), "l"(src), "r"(in ? 16 : 0));
}

// start copying key tile k0 into sK and value tile k0 into sV
template <int DH>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* sK, __nv_bfloat16* sV,
                                           const __nv_bfloat16* kp, const __nv_bfloat16* vp,
                                           const Params& a, int k0, int tid) {
  constexpr int VPR = DH / 8;  // 16-byte vectors per row
  constexpr int RS = MmaSmem<DH>::RS;
#pragma unroll
  for (int i = tid; i < BK * VPR; i += MMA_THREADS) {
    const int c = i / VPR, d = (i - c * VPR) * 8, s = k0 + c;
    const bool in = s < a.s;
    const int row = in ? s : 0;  // a valid address even when nothing is read
    cp_async16(sK + c * RS + d, kp + row * a.kss + d, in);
    cp_async16(sV + c * RS + d, vp + row * a.vss + d, in);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// b0, b1 of P . V's B fragment (keys 16 kk + 2t .. (+ 8), head-dim column g
// of an n-tile) from the row-major value tile: two 8 x 8 matrices, their row
// addresses from lanes 0-15
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& b0, uint32_t& b1, const void* row) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two values as one bf16x2 register, the first in the low half
__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t smem_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// q[row][col], q[row][col + 1] of a row below s, else zeros
__device__ __forceinline__ uint32_t q_pair(const __nv_bfloat16* qp, int64_t qss, int row, int col,
                                           int s) {
  if (row >= s) return 0u;
  const __nv_bfloat16* p = qp + row * qss + col;
  return pack(p[0], p[1]);
}

// split an f32 pair into bf16 high parts and bf16 remainders
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat16 hx = __float2bfloat16(x), hy = __float2bfloat16(y);
  hi = pack(hx, hy);
  lo = pack(__float2bfloat16(x - __bfloat162float(hx)), __float2bfloat16(y - __bfloat162float(hy)));
}

template <int DH>
__global__ void __launch_bounds__(MMA_THREADS) flash_fwd_bf16(Params a) {
  using L = MmaSmem<DH>;
  using T = __nv_bfloat16;
  constexpr int NT = BK / 8;   // key n-tiles of a tile's scores
  constexpr int KD = DH / 16;  // head-dim k-steps of Q . K^T
  constexpr int ND = DH / 8;   // head-dim n-tiles of the output
  constexpr int KK = BK / 16;  // key k-steps of P . V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);

  const int qt = a.nq - 1 - (int)(blockIdx.x / (unsigned)a.bh);
  const int bh = (int)(blockIdx.x % (unsigned)a.bh);
  const int b = bh / a.h, h = bh % a.h, kh = h / a.g;
  const int q0 = qt * BQ;
  const T* qp = static_cast<const T*>(a.q) + b * a.qsb + h * a.qsh;
  const T* kp = static_cast<const T*>(a.k) + b * a.ksb + kh * a.ksh;
  const T* vp = static_cast<const T*>(a.v) + b * a.vsb + kh * a.vsh;
  const int64_t orow = (int64_t)a.h * DH;
  T* op = static_cast<T*>(a.o) + (int64_t)b * a.s * orow + (int64_t)h * DH;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;  // this thread's query rows

  uint32_t qf[KD][4];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    const int col = kd * 16 + 2 * t;
    qf[kd][0] = q_pair(qp, a.qss, row0, col, a.s);
    qf[kd][1] = q_pair(qp, a.qss, row1, col, a.s);
    qf[kd][2] = q_pair(qp, a.qss, row0, col + 8, a.s);
    qf[kd][3] = q_pair(qp, a.qss, row1, col + 8, a.s);
  }

  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.0f, l1 = 0.0f;
  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.0f;

  const int last_row = min(q0 + BQ, a.s) - 1;
  const int n_tiles = last_row / BK + 1;
  stage_tile<DH>(smem, smem + L::TILE, kp, vp, a, 0, tid);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    const T* sK = smem + (tile & 1) * 2 * L::TILE;
    const T* sV = sK + L::TILE;
    if (tile + 1 < n_tiles) {
      // the other buffer was consumed by every warp before the barrier
      // that ended the previous iteration
      T* next = smem + ((tile + 1) & 1) * 2 * L::TILE;
      stage_tile<DH>(next, next + L::TILE, kp, vp, a, k0 + BK, tid);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // this tile has landed for every thread

    // scores of rows (row0, row1) x keys k0 + 8 nt + 2t (+1)
    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.0f;
      const T* kr = sK + (nt * 8 + g) * L::RS + 2 * t;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        mma_bf16(sc[nt], qf[kd], smem_pair(kr + kd * 16), smem_pair(kr + kd * 16 + 8));
    }

    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? row0 : row1, col = k0 + nt * 8 + 2 * t + (e & 1);
        float s = sc[nt][e] * a.scale;
        if (col > row || col >= a.s) s = NEG_INF;
        sc[nt][e] = s;
      }
      mx0 = fmaxf(mx0, fmaxf(sc[nt][0], sc[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[nt][2], sc[nt][3]));
    }
    // a row's 64 keys lie with the 4 lanes of its quad
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    const float alpha0 = expf(m0 - n0), alpha1 = expf(m1 - n1);
    float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      sc[nt][0] = expf(sc[nt][0] - n0);
      sc[nt][1] = expf(sc[nt][1] - n0);
      sc[nt][2] = expf(sc[nt][2] - n1);
      sc[nt][3] = expf(sc[nt][3] - n1);
      rs0 += sc[nt][0] + sc[nt][1];
      rs1 += sc[nt][2] + sc[nt][3];
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
    for (int nd = 0; nd < ND; ++nd) {
      acc[nd][0] *= alpha0;
      acc[nd][1] *= alpha0;
      acc[nd][2] *= alpha1;
      acc[nd][3] *= alpha1;
    }

    // acc += P . V: keys 16 kk .. + 15 are n-tiles 2 kk and 2 kk + 1 of
    // the scores, which are exactly the A fragment of that k-step
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      uint32_t ph[4], pl[4];
      split_pair(sc[2 * kk][0], sc[2 * kk][1], ph[0], pl[0]);
      split_pair(sc[2 * kk][2], sc[2 * kk][3], ph[1], pl[1]);
      split_pair(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ph[2], pl[2]);
      split_pair(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ph[3], pl[3]);
      const T* vrow = sV + (kk * 16 + (lane & 15)) * L::RS;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, vrow + nd * 8);
        mma_bf16(acc[nd], ph, b0, b1);
        mma_bf16(acc[nd], pl, b0, b1);
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }

  const float norm0 = fmaxf(l0, 1e-30f), norm1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int col = nd * 8 + 2 * t;
    if (row0 < a.s) {
      op[row0 * orow + col] = __float2bfloat16(acc[nd][0] / norm0);
      op[row0 * orow + col + 1] = __float2bfloat16(acc[nd][1] / norm0);
    }
    if (row1 < a.s) {
      op[row1 * orow + col] = __float2bfloat16(acc[nd][2] / norm1);
      op[row1 * orow + col + 1] = __float2bfloat16(acc[nd][3] / norm1);
    }
  }
}

template <typename Kernel>
int launch(Kernel kernel, int threads, int smem, const Params& a, int blocks,
           cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<blocks, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_dh(bool bf16, const Params& a, int blocks, cudaStream_t stream) {
  if (bf16) return launch(flash_fwd_bf16<DH>, MMA_THREADS, MmaSmem<DH>::bytes, a, blocks, stream);
  return launch(flash_fwd_f32<DH>, THREADS, Smem<DH>::bytes, a, blocks, stream);
}

int dispatch(int dh, bool bf16, const Params& a, int blocks, cudaStream_t stream) {
  switch (dh) {
    case 16: return launch_dh<16>(bf16, a, blocks, stream);
    case 32: return launch_dh<32>(bf16, a, blocks, stream);
    case 64: return launch_dh<64>(bf16, a, blocks, stream);
    case 112: return launch_dh<112>(bf16, a, blocks, stream);
    case 128: return launch_dh<128>(bf16, a, blocks, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v in their (B, S, heads, DH) layouts through element strides (the
// last dimension contiguous); o (B, S, H, DH) contiguous, in q's type.
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
  return dispatch(dh, bf16 != 0, a, (int)blocks, (cudaStream_t)stream);
}
