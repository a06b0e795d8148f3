// Geohash encode: f32 lat/lon -> quantized cell indices -> Morton code.
//
// Replaces the TPU kernel `encode_pallas` (body `_encode_kernel`) of
// src/repro/kernels/geohash/geohash.py.
//
// Bound on an H100: memory.  Each point reads 8 bytes and writes 4, and
// costs about 20 integer operations, far below the card's operation rate,
// so the kernel can at best stream 12 bytes per point at the memory rate.
// Design: one thread per point in a grid-stride loop, coalesced 4-byte
// loads and stores; no shared memory is needed.
//
// The arithmetic must equal the plain version bit for bit.  The quantize is
// a float32 subtract and a float32 multiply by a scale computed on the host
// (an exact f32 value), written with the _rn intrinsics so the compiler can
// neither contract them into an FMA nor promote them to double (a double
// literal such as -90.0 would move points that sit on a cell edge).  The
// truncation is toward zero, as a float->int32 cast is on the host.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t part1by1(uint32_t x) {
  x &= 0x0000FFFFu;
  x = (x | (x << 8)) & 0x00FF00FFu;
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  x = (x | (x << 2)) & 0x33333333u;
  x = (x | (x << 1)) & 0x55555555u;
  return x;
}

__device__ __forceinline__ int32_t cell_index(float deg, float offset, float scale, int bits) {
  // (deg - offset) * scale in float32, truncated, clipped to [0, 2^bits - 1]
  float q = __fmul_rn(__fsub_rn(deg, offset), scale);
  int32_t i = __float2int_rz(q);
  int32_t hi = (1 << bits) - 1;
  return i < 0 ? 0 : (i > hi ? hi : i);
}

__global__ void geohash_encode_kernel(const float* __restrict__ lat,
                                      const float* __restrict__ lon,
                                      int32_t* __restrict__ out, int64_t n,
                                      float lat_scale, float lon_scale,
                                      int lat_bits, int lon_bits, int lon_high) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    uint32_t la = (uint32_t)cell_index(lat[i], -90.0f, lat_scale, lat_bits);
    uint32_t lo = (uint32_t)cell_index(lon[i], -180.0f, lon_scale, lon_bits);
    // even total width: lon on the odd positions (MSB); odd: lat there
    uint32_t code = lon_high ? ((part1by1(lo) << 1) | part1by1(la))
                             : (part1by1(lo) | (part1by1(la) << 1));
    out[i] = (int32_t)code;
  }
}

}  // namespace

extern "C" int geohash_encode_launch(const float* lat, const float* lon, int32_t* out,
                                     int64_t n, float lat_scale, float lon_scale,
                                     int lat_bits, int lon_bits, int lon_high,
                                     int threads, int max_blocks, void* stream) {
  if (n > 0) {
    int64_t blocks = (n + threads - 1) / threads;
    if (blocks > max_blocks) blocks = max_blocks;
    geohash_encode_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        lat, lon, out, n, lat_scale, lon_scale, lat_bits, lon_bits, lon_high);
  }
  return (int)cudaGetLastError();
}
