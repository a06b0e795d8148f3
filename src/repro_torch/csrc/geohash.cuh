// Geohash encode arithmetic shared by geohash.cu and edge_megakernel.cu, so
// the megakernel's in-kernel encode gives the geohash kernel's codes bit
// for bit.
//
// The quantize is a float32 subtract and a float32 multiply by a scale
// computed on the host (an exact f32 value), written with the _rn
// intrinsics so the compiler can neither contract them into an FMA nor
// promote them to double (a double literal such as -90.0 would move points
// that sit on a cell edge).  The truncation is toward zero, as a
// float->int32 cast is on the host.

#pragma once

#include <stdint.h>

namespace geohash_dev {

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

// Per-precision constants of the encode, computed on the host.
struct Params {
  float lat_scale, lon_scale;
  int lat_bits, lon_bits;
  int lon_high;  // even total width: lon on the odd positions (MSB)
};

__device__ __forceinline__ int32_t encode(float lat, float lon, const Params& p) {
  uint32_t la = (uint32_t)cell_index(lat, -90.0f, p.lat_scale, p.lat_bits);
  uint32_t lo = (uint32_t)cell_index(lon, -180.0f, p.lon_scale, p.lon_bits);
  uint32_t code = p.lon_high ? ((part1by1(lo) << 1) | part1by1(la))
                             : (part1by1(lo) | (part1by1(la) << 1));
  return (int32_t)code;
}

}  // namespace geohash_dev
