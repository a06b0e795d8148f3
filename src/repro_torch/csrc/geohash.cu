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
// The arithmetic (geohash.cuh, shared with the edge megakernel) must equal
// the plain version bit for bit; see the header for how.

#include <cuda_runtime.h>
#include <stdint.h>

#include "geohash.cuh"

namespace {

__global__ void geohash_encode_kernel(const float* __restrict__ lat,
                                      const float* __restrict__ lon,
                                      int32_t* __restrict__ out, int64_t n,
                                      geohash_dev::Params p) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    out[i] = geohash_dev::encode(lat[i], lon[i], p);
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
    const geohash_dev::Params p{lat_scale, lon_scale, lat_bits, lon_bits, lon_high};
    geohash_encode_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        lat, lon, out, n, p);
  }
  return (int)cudaGetLastError();
}
