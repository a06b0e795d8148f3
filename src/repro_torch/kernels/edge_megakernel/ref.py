"""Oracle: self-contained numpy single-traversal fused edge pass.

Jax-free by contract (edgelint EDG006) — an independent port of the
megakernel's semantics, not a delegation: its own Morton encoder (the
same bit-exact uint32 mask chain / single-multiply f32 quantize as the
geohash oracle), its own sketch bin index, and input-order f32
``np.add.at`` accumulation.

Returns a plain 7-tuple mirroring the kernel's ``MegaResult`` field
order: ``(pop, keep, s1, s2, mins, maxs, bins)`` with shapes
``(M, S)``, ``(M, S)``, ``(M, C, S)``, ``(M, C, S)``, ``(M, E, S)``,
``(M, E, S)``, ``(M, K, S, 513)``.

Contract mirrored from ops.py: unified threshold-compare sampling;
latlon-mode tuples with codes outside the table land in NO slot (the
caller owns overflow residuals); sidx mode covers all slots exactly;
empty-stratum extrema are the +/-inf identities.
"""

from __future__ import annotations

import numpy as np

LAT_MIN, LAT_MAX = -90.0, 90.0
LON_MIN, LON_MAX = -180.0, 180.0
MAX_PRECISION = 6  # 30 bits; uint32 codes

BINS_PER_SIDE = 256
LOG_GAMMA = 0.08
MIN_MAG = 1e-4
NUM_BINS = 2 * BINS_PER_SIDE + 1


def _part1by1(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32) & np.uint32(0x0000FFFF)
    x = (x | (x << np.uint32(8))) & np.uint32(0x00FF00FF)
    x = (x | (x << np.uint32(4))) & np.uint32(0x0F0F0F0F)
    x = (x | (x << np.uint32(2))) & np.uint32(0x33333333)
    x = (x | (x << np.uint32(1))) & np.uint32(0x55555555)
    return x


def _encode(lat, lon, precision: int) -> np.ndarray:
    """uint32 Morton geohash codes (bit-exact with the device encoder)."""
    if not 1 <= precision <= MAX_PRECISION:
        raise ValueError(f"precision must be in [1, {MAX_PRECISION}], got {precision}")
    lat = np.asarray(lat, dtype=np.float32)
    lon = np.asarray(lon, dtype=np.float32)
    total = 5 * precision
    lon_bits, lat_bits = (total + 1) // 2, total // 2
    lat_scale = np.float32((1 << lat_bits) / (LAT_MAX - LAT_MIN))
    lon_scale = np.float32((1 << lon_bits) / (LON_MAX - LON_MIN))
    lat_i = np.clip(
        ((lat - np.float32(LAT_MIN)) * lat_scale).astype(np.int32), 0, (1 << lat_bits) - 1
    ).astype(np.uint32)
    lon_i = np.clip(
        ((lon - np.float32(LON_MIN)) * lon_scale).astype(np.int32), 0, (1 << lon_bits) - 1
    ).astype(np.uint32)
    if total % 2 == 0:
        return (_part1by1(lon_i) << np.uint32(1)) | _part1by1(lat_i)
    return _part1by1(lon_i) | (_part1by1(lat_i) << np.uint32(1))


def _bin_index(v: np.ndarray) -> np.ndarray:
    """Value -> sketch bin index, the fixed 513-bin log layout."""
    v = v.astype(np.float32)
    mag = np.abs(v)
    k = np.floor(
        np.log(np.maximum(mag, np.float32(MIN_MAG)) / np.float32(MIN_MAG))
        / np.float32(LOG_GAMMA)
    )
    k = np.clip(k, 0, BINS_PER_SIDE - 1).astype(np.int32)
    zero = BINS_PER_SIDE
    return np.where(
        v > np.float32(MIN_MAG), zero + 1 + k,
        np.where(v < -np.float32(MIN_MAG), zero - 1 - k, zero),
    ).astype(np.int32)


def edge_megakernel_ref(
    vals,
    ok,
    scores,
    thresholds,
    num_slots: int,
    *,
    sidx=None,
    lat=None,
    lon=None,
    codes=None,
    precision=None,
    ext_idx=(),
    sk_idx=(),
):
    """Numpy oracle for the fused pass (see module docstring for layout)."""
    vals = np.asarray(vals, dtype=np.float32)
    ok = np.asarray(ok, dtype=np.float32)
    scores = np.asarray(scores, dtype=np.float32)
    thresholds = np.asarray(thresholds, dtype=np.float32)
    c, n = vals.shape
    m = ok.shape[0]
    ext_idx, sk_idx = tuple(ext_idx), tuple(sk_idx)

    if sidx is None:
        if lat is None or lon is None or codes is None or precision is None:
            raise ValueError("latlon mode needs lat, lon, codes and precision")
        codes = np.asarray(codes, dtype=np.uint32)
        code = _encode(lat, lon, precision)
        pos = np.clip(np.searchsorted(codes, code), 0, len(codes) - 1)
        found = codes[pos] == code
        # unmatched codes land in a dump slot that is sliced off
        sidx_m = np.where(found, pos.astype(np.int64), num_slots)
        sidx_all = np.broadcast_to(sidx_m[None, :], (m, n))
    else:
        sidx_all = np.clip(np.asarray(sidx, dtype=np.int64), 0, num_slots)

    pop = np.zeros((m, num_slots), np.float32)
    keep_ct = np.zeros((m, num_slots), np.float32)
    s1 = np.zeros((m, c, num_slots), np.float32)
    s2 = np.zeros((m, c, num_slots), np.float32)
    e = len(ext_idx)
    mins = np.full((m, e, num_slots), np.inf, np.float32)
    maxs = np.full((m, e, num_slots), -np.inf, np.float32)
    bins = np.zeros((m, len(sk_idx), num_slots, NUM_BINS), np.float32)

    thr_ext = np.concatenate([thresholds, np.zeros((m, 1), np.float32)], axis=1)
    for j in range(m):
        s = sidx_all[j]
        in_range = s < num_slots
        t = thr_ext[j, s]
        keep = ok[j] * (scores[j] < t).astype(np.float32)
        sl = s[in_range]
        np.add.at(pop[j], sl, ok[j][in_range])
        np.add.at(keep_ct[j], sl, keep[in_range])
        for ci in range(c):
            np.add.at(s1[j, ci], sl, (keep * vals[ci])[in_range])
            np.add.at(s2[j, ci], sl, (keep * vals[ci] * vals[ci])[in_range])
        kept = in_range & (keep > 0.0)
        for ei, col in enumerate(ext_idx):
            np.minimum.at(mins[j, ei], s[kept], vals[col][kept])
            np.maximum.at(maxs[j, ei], s[kept], vals[col][kept])
        for ki, col in enumerate(sk_idx):
            b = _bin_index(vals[col])
            flat = s[in_range] * NUM_BINS + b[in_range]
            np.add.at(bins[j, ki].reshape(-1), flat, keep[in_range])
    return pop, keep_ct, s1, s2, mins, maxs, bins
