"""Geohash encoding/decoding as integer tensor ops.

A geohash is kept as its raw Morton code: the quantized per-axis cell
indices with their bits interleaved, starting with longitude at the MSB.
``5 * precision`` bits; for odd widths longitude gets the extra bit.

Codes are ``int32`` (precision <= 6 needs 30 bits, so every code is
non-negative and sorts like its unsigned form); ``-1`` is free as a
sentinel that no real code matches.

String conversion (base32) is host-side numpy for interop and tests.
"""

from __future__ import annotations

import numpy as np
import torch

LAT_MIN, LAT_MAX = -90.0, 90.0
LON_MIN, LON_MAX = -180.0, 180.0

BASE32 = "0123456789bcdefghjkmnpqrstuvwxyz"
_BASE32_INV = {c: i for i, c in enumerate(BASE32)}

MAX_PRECISION = 6  # 30 bits: int32 codes stay non-negative


def split_bits(precision: int) -> tuple[int, int]:
    """(lon_bits, lat_bits) for a geohash of ``precision`` characters."""
    total = 5 * precision
    return (total + 1) // 2, total // 2


def axis_scales(precision: int) -> tuple[float, float]:
    """(lat_scale, lon_scale): the single f32 multiplier per axis that maps
    an offset in degrees to a cell index.  Both values are exact f32 numbers,
    so a Python float carries them to torch and to the CUDA kernel unchanged."""
    lon_bits, lat_bits = split_bits(precision)
    lat_scale = np.float32((1 << lat_bits) / (LAT_MAX - LAT_MIN))
    lon_scale = np.float32((1 << lon_bits) / (LON_MAX - LON_MIN))
    return float(lat_scale), float(lon_scale)


def _part1by1(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 16 bits of ``x`` to even bit positions (Morton)."""
    x = x.to(torch.int32) & 0x0000FFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def _compact1by1(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_part1by1` (gather even bit positions)."""
    x = x.to(torch.int32) & 0x55555555
    x = (x | (x >> 1)) & 0x33333333
    x = (x | (x >> 2)) & 0x0F0F0F0F
    x = (x | (x >> 4)) & 0x00FF00FF
    x = (x | (x >> 8)) & 0x0000FFFF
    return x


def quantize(
    lat: torch.Tensor, lon: torch.Tensor, precision: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize lat/lon to their per-axis cell indices -> (lon_idx, lat_idx).

    Single-multiply form in float32: ``(lat - LAT_MIN) * lat_scale`` with
    the f32 scale of :func:`axis_scales`, truncated toward zero and
    clipped.  Points within one f32 ulp of a cell edge land where this
    arithmetic puts them, identically on every backend.
    """
    lon_bits, lat_bits = split_bits(precision)
    lat_scale, lon_scale = axis_scales(precision)
    lat = lat.to(torch.float32)
    lon = lon.to(torch.float32)
    lat_i = ((lat - LAT_MIN) * lat_scale).to(torch.int32).clamp(0, (1 << lat_bits) - 1)
    lon_i = ((lon - LON_MIN) * lon_scale).to(torch.int32).clamp(0, (1 << lon_bits) - 1)
    return lon_i, lat_i


def interleave(lon_idx: torch.Tensor, lat_idx: torch.Tensor, precision: int) -> torch.Tensor:
    """Morton-interleave per-axis cell indices into a geohash code."""
    if (5 * precision) % 2 == 0:
        # MSB (odd positions) = lon, even positions = lat.
        return (_part1by1(lon_idx) << 1) | _part1by1(lat_idx)
    # odd width: lon on even positions (incl. MSB), lat on odd.
    return _part1by1(lon_idx) | (_part1by1(lat_idx) << 1)


def deinterleave(code: torch.Tensor, precision: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`interleave` -> (lon_idx, lat_idx)."""
    if (5 * precision) % 2 == 0:
        return _compact1by1(code >> 1), _compact1by1(code)
    return _compact1by1(code), _compact1by1(code >> 1)


def check_precision(precision: int) -> None:
    if not 1 <= precision <= MAX_PRECISION:
        raise ValueError(f"precision must be in [1, {MAX_PRECISION}], got {precision}")


def encode(lat: torch.Tensor, lon: torch.Tensor, precision: int) -> torch.Tensor:
    """Encode coordinates to int32 geohash codes (plain tensor ops)."""
    check_precision(precision)
    lon_i, lat_i = quantize(lat, lon, precision)
    return interleave(lon_i, lat_i, precision)


def decode(code: torch.Tensor, precision: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode codes to (lat, lon) cell centers."""
    lon_bits, lat_bits = split_bits(precision)
    lon_i, lat_i = deinterleave(code, precision)
    lat = LAT_MIN + (lat_i.to(torch.float32) + 0.5) * ((LAT_MAX - LAT_MIN) / (1 << lat_bits))
    lon = LON_MIN + (lon_i.to(torch.float32) + 0.5) * ((LON_MAX - LON_MIN) / (1 << lon_bits))
    return lat, lon


def cell_size_deg(precision: int) -> tuple[float, float]:
    """(lat_extent, lon_extent) in degrees of one cell at ``precision``."""
    lon_bits, lat_bits = split_bits(precision)
    return (LAT_MAX - LAT_MIN) / (1 << lat_bits), (LON_MAX - LON_MIN) / (1 << lon_bits)


def parent(code: torch.Tensor, precision: int, parent_precision: int) -> torch.Tensor:
    """Truncate a geohash code to a coarser precision (prefix property):
    a right shift by ``5 * (precision - parent_precision)`` bits."""
    if parent_precision > precision:
        raise ValueError("parent_precision must be <= precision")
    return code >> (5 * (precision - parent_precision))


# ---------------------------------------------------------------------------
# Host-side string interop (numpy; not for the hot path).
# ---------------------------------------------------------------------------


def to_strings(codes, precision: int) -> list[str]:
    codes = np.asarray(codes, dtype=np.int64)
    out = []
    for c in codes.reshape(-1):
        c = int(c)
        out.append(
            "".join(BASE32[(c >> (5 * (precision - 1 - i))) & 0x1F] for i in range(precision))
        )
    return out


def from_strings(strings) -> np.ndarray:
    out = np.zeros(len(strings), dtype=np.int64)
    for j, s in enumerate(strings):
        c = 0
        for ch in s:
            c = (c << 5) | _BASE32_INV[ch]
        out[j] = c
    return out


def encode_host(lat: float, lon: float, precision: int) -> str:
    """Reference host-side encoder (bisection, textbook algorithm)."""
    lat_lo, lat_hi = LAT_MIN, LAT_MAX
    lon_lo, lon_hi = LON_MIN, LON_MAX
    code = 0
    for i in range(5 * precision):
        if i % 2 == 0:  # longitude first
            mid = (lon_lo + lon_hi) / 2
            bit = lon >= mid
            lon_lo, lon_hi = (mid, lon_hi) if bit else (lon_lo, mid)
        else:
            mid = (lat_lo + lat_hi) / 2
            bit = lat >= mid
            lat_lo, lat_hi = (mid, lat_hi) if bit else (lat_lo, mid)
        code = (code << 1) | int(bit)
    return to_strings([code], precision)[0]
