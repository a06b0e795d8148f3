"""Geohash encode: the CUDA kernel's wrapper and its plain PyTorch version.

``geohash_encode`` launches ``csrc/geohash.cu`` on a CUDA tensor and takes
the plain version on a CPU tensor; the two are bit-identical.  Stratum
lookup stays outside the kernel (``StratumTable.lookup``).
"""

from __future__ import annotations

import torch

from ...core import geohash
from .. import build
from ..tiling import BLOCKS_PER_SM, THREADS


def geohash_encode_plain(lat: torch.Tensor, lon: torch.Tensor, precision: int) -> torch.Tensor:
    """lat/lon (N,) f32 -> int32 geohash codes, in plain tensor ops."""
    return geohash.encode(lat, lon, precision)


def geohash_encode(lat: torch.Tensor, lon: torch.Tensor, precision: int) -> torch.Tensor:
    """lat/lon (N,) f32 -> int32 geohash codes (the CUDA kernel on CUDA)."""
    geohash.check_precision(precision)
    if lat.device.type == "cpu" and lon.device.type == "cpu":
        return geohash_encode_plain(lat, lon, precision)
    for name, t in (("lat", lat), ("lon", lon)):
        if t.device.type != "cuda" or t.dtype != torch.float32 or t.dim() != 1:
            raise ValueError(f"{name} must be a 1-D float32 CUDA tensor; got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if lat.shape != lon.shape or lat.device != lon.device:
        raise ValueError("lat and lon must have one shape and one device")
    n = lat.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=lat.device)
    if n == 0:
        return out  # nothing to launch
    lon_bits, lat_bits = geohash.split_bits(precision)
    lat_scale, lon_scale = geohash.axis_scales(precision)
    err = build.kernel("geohash")(
        lat.data_ptr(), lon.data_ptr(), out.data_ptr(), n, lat_scale, lon_scale,
        lat_bits, lon_bits, int((5 * precision) % 2 == 0),
        THREADS["geohash"], BLOCKS_PER_SM["geohash"] * build.num_sms(lat.device),
        build.stream_handle(lat.device),
    )
    build.check(err, "geohash")
    build.LAUNCHES["geohash"] += 1
    return out
