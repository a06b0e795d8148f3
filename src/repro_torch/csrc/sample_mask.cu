// EdgeSOS Bernoulli selection: keep = u < f[sidx], w = keep ? 1/max(f, 1e-9) : 0.
//
// Replaces the TPU kernel `sample_mask_pallas` (body `_select_kernel`) of
// src/repro/kernels/sample_mask/sample_mask.py.  The TPU version gathers
// f[sidx] as a one-hot matrix product accumulated over strata blocks,
// because the TPU has no fast dynamic gather; Hopper gathers directly.
//
// Bound on an H100: memory.  Each tuple reads 8 bytes (sidx, u) and writes
// 5 (mask, weight); the S per-stratum fractions (26 KB at Geohash-6) are
// read once per block.  Design: each block copies f into shared memory
// once, then walks the tuples in a grid-stride loop, so the random gather
// hits shared memory and the tuple streams stay coalesced.  The grid is a
// few blocks per SM, so the copies of f cost little against the stream.
//
// The division is IEEE (no fast-math), so the weight equals the plain
// version's bit for bit.  A stratum index outside [0, S) gathers f = 0 and
// is never kept.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void sample_mask_kernel(const int32_t* __restrict__ sidx,
                                   const float* __restrict__ u,
                                   const float* __restrict__ frac, int64_t n, int s,
                                   uint8_t* __restrict__ mask, float* __restrict__ weight) {
  extern __shared__ float f_s[];
  for (int k = threadIdx.x; k < s; k += blockDim.x) f_s[k] = frac[k];
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    int32_t k = sidx[i];
    float f = (k >= 0 && k < s) ? f_s[k] : 0.0f;
    bool keep = u[i] < f;
    mask[i] = keep ? 1 : 0;
    weight[i] = keep ? __fdiv_rn(1.0f, fmaxf(f, 1e-9f)) : 0.0f;
  }
}

}  // namespace

extern "C" int sample_mask_launch(const int32_t* sidx, const float* u, const float* frac,
                                  int64_t n, int s, uint8_t* mask, float* weight,
                                  int threads, int max_blocks, void* stream) {
  size_t smem = (size_t)s * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sample_mask_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (n > 0) {
    int64_t blocks = (n + threads - 1) / threads;
    if (blocks > max_blocks) blocks = max_blocks;
    sample_mask_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
        sidx, u, frac, n, s, mask, weight);
  }
  return (int)cudaGetLastError();
}
