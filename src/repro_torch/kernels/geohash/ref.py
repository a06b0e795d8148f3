"""Oracle: self-contained numpy Morton geohash encoder.

Numpy-only by contract (edgelint EDG006), an independent implementation of
the encoder: single-multiply f32 quantize (f32 subtract, f32 precomputed
scale, truncating int32 cast, clip) and the uint32 bit-spread chain.
Codes come back as int32 (30 bits at most, so never negative).
"""

from __future__ import annotations

import numpy as np

LAT_MIN, LAT_MAX = -90.0, 90.0
LON_MIN, LON_MAX = -180.0, 180.0


def _part1by1(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32) & np.uint32(0x0000FFFF)
    x = (x | (x << np.uint32(8))) & np.uint32(0x00FF00FF)
    x = (x | (x << np.uint32(4))) & np.uint32(0x0F0F0F0F)
    x = (x | (x << np.uint32(2))) & np.uint32(0x33333333)
    x = (x | (x << np.uint32(1))) & np.uint32(0x55555555)
    return x


def geohash_encode_ref(lat, lon, precision: int):
    """lat/lon -> int32 geohash codes (numpy, vectorized)."""
    if not 1 <= precision <= 6:
        raise ValueError(f"precision must be in [1, 6], got {precision}")
    lat = np.asarray(lat, dtype=np.float32)
    lon = np.asarray(lon, dtype=np.float32)
    total = 5 * precision
    lon_bits, lat_bits = (total + 1) // 2, total // 2
    lat_scale = np.float32((1 << lat_bits) / (LAT_MAX - LAT_MIN))
    lon_scale = np.float32((1 << lon_bits) / (LON_MAX - LON_MIN))
    lat_i = np.clip(((lat - np.float32(LAT_MIN)) * lat_scale).astype(np.int32), 0, (1 << lat_bits) - 1)
    lon_i = np.clip(((lon - np.float32(LON_MIN)) * lon_scale).astype(np.int32), 0, (1 << lon_bits) - 1)
    if total % 2 == 0:
        code = (_part1by1(lon_i) << np.uint32(1)) | _part1by1(lat_i)
    else:
        code = _part1by1(lon_i) | (_part1by1(lat_i) << np.uint32(1))
    return code.astype(np.int32)
