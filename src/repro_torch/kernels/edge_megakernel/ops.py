"""Single-traversal fused edge pass: the CUDA kernel's wrapper and its plain
PyTorch version.

Contract shared by the kernel (``csrc/edge_megakernel.cu``), the plain
version and the numpy oracle (``ref.py``):

* sampling is the unified threshold compare ``keep = ok & (score <
  thr[slot])`` (Bernoulli: uniforms against fractions; SRS: ranks against
  ``n_k``; keep-all: zeros against ones);
* ``latlon`` mode resolves membership against the sorted code table; tuples
  whose code is absent (the overflow stratum) land in NO slot: their stat
  rows stay zero (+inf/-inf for extrema) and the caller rebuilds overflow
  *counts* as residuals, which is sound because the query layer zeroes
  overflow stats before estimating;
* ``sidx`` mode covers every slot, overflow included, exactly (indices are
  clipped to ``[0, num_slots]``; ``num_slots`` itself is no slot).

Both implementations count integer rows exactly and sum ``s1``/``s2`` in
double, rounding to f32 once: the plain version with ``index_add_``, the
kernel deterministically, over tiles of the window that each sort their
tuples by slot in shared memory, then over the tiles in order.  Counts,
extrema and sketch bins agree exactly; sums to within an ulp.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...core import geohash
from ...core.estimators import SKETCH_NUM_BINS, sketch_bin_index
from .. import build
from ..tiling import BLOCKS_PER_SM, plan_tiles

class MegaResult(NamedTuple):
    """Per-member per-stratum sufficient stats from one fused traversal.

    ``pop``/``keep`` are ok-tuple and kept-tuple counts per slot; ``s1``/
    ``s2`` kept-tuple power sums per value column; ``mins``/``maxs`` the
    extrema columns (±inf where no tuple was kept); ``bins`` the sketch
    columns' kept-count log-histograms.
    """

    pop: torch.Tensor  # (M, S) f32
    keep: torch.Tensor  # (M, S) f32
    s1: torch.Tensor  # (M, C, S) f32
    s2: torch.Tensor  # (M, C, S) f32
    mins: torch.Tensor  # (M, E, S) f32
    maxs: torch.Tensor  # (M, E, S) f32
    bins: torch.Tensor  # (M, K, S, SKETCH_NUM_BINS) f32


def _latlon_args(lat, lon, codes, precision):
    if lat is None or lon is None or codes is None or precision is None:
        raise ValueError("latlon mode needs lat, lon, codes and precision")


def edge_megakernel_plain(vals, ok, scores, thresholds, num_slots: int, *, sidx=None, lat=None,
                          lon=None, codes=None, precision=None, ext_idx=(), sk_idx=()):
    """The fused pass in plain tensor ops -> :class:`MegaResult`.

    A stacked ``index_add_`` over ``(member, slot)`` segments with one
    trailing no-slot segment per member, sliced off."""
    ext_idx, sk_idx = tuple(ext_idx), tuple(sk_idx)
    c, n = vals.shape
    m = ok.shape[0]
    s = int(num_slots)
    dev = vals.device
    v = vals.to(torch.float32)
    if sidx is None:
        _latlon_args(lat, lon, codes, precision)
        code = geohash.encode(lat.to(torch.float32), lon.to(torch.float32), precision)
        pos = torch.searchsorted(codes, code, out_int32=True).clamp(0, max(codes.shape[0] - 1, 0))
        found = (codes[pos] == code) if codes.shape[0] else torch.zeros_like(code, dtype=torch.bool)
        slot = torch.where(found, pos, s).to(torch.int64).expand(m, n)
    else:
        slot = sidx.to(torch.int64).clamp(0, s).expand(m, n)
    okb = ok.to(torch.bool).expand(m, n)
    thr_ext = torch.cat([thresholds.to(torch.float32),
                         torch.zeros((m, 1), dtype=torch.float32, device=dev)], 1)
    keep = okb & (scores.to(torch.float32).expand(m, n) < torch.gather(thr_ext, 1, slot))
    seg = (slot + (s + 1) * torch.arange(m, device=dev)[:, None]).reshape(-1)
    keepf = keep.to(torch.float32)
    kv = keepf[:, None, :] * v[None]  # (M, C, N)
    rows = torch.cat([okb.to(torch.float32)[:, None], keepf[:, None], kv, kv * v[None]], 1)
    sums = torch.zeros((m * (s + 1), rows.shape[1]), dtype=torch.float64, device=dev)
    sums.index_add_(0, seg, rows.transpose(1, 2).reshape(m * n, rows.shape[1]).to(torch.float64))
    sums = sums.to(torch.float32).reshape(m, s + 1, -1)[:, :s]  # (M, S, R)
    pop, kept_ct = sums[..., 0], sums[..., 1]
    s1 = sums[..., 2 : 2 + c].transpose(1, 2)
    s2 = sums[..., 2 + c :].transpose(1, 2)

    mins, maxs = [], []
    for e in ext_idx:
        y = v[e].expand(m, n)
        lo = torch.full((m * (s + 1),), torch.inf, device=dev)
        hi = torch.full((m * (s + 1),), -torch.inf, device=dev)
        lo.scatter_reduce_(0, seg, torch.where(keep, y, torch.inf).reshape(-1), reduce="amin")
        hi.scatter_reduce_(0, seg, torch.where(keep, y, -torch.inf).reshape(-1), reduce="amax")
        mins.append(lo.reshape(m, s + 1)[:, :s])
        maxs.append(hi.reshape(m, s + 1)[:, :s])
    bins = []
    for k in sk_idx:
        flat = seg * SKETCH_NUM_BINS + sketch_bin_index(v[k]).to(torch.int64).expand(m, n).reshape(-1)
        b = torch.zeros(m * (s + 1) * SKETCH_NUM_BINS, dtype=torch.float32, device=dev)
        # 0/1 counts: f32 sums stay exact integers below 2**24 in any order
        b.index_add_(0, flat, keepf.reshape(-1))
        bins.append(b.reshape(m, s + 1, SKETCH_NUM_BINS)[:, :s])
    empty = torch.zeros((m, 0, s), dtype=torch.float32, device=dev)
    return MegaResult(
        pop=pop.contiguous(), keep=kept_ct.contiguous(),
        s1=s1.contiguous(), s2=s2.contiguous(),
        mins=torch.stack(mins, 1) if mins else empty,
        maxs=torch.stack(maxs, 1) if maxs else empty.clone(),
        bins=torch.stack(bins, 1) if bins else torch.zeros((m, 0, s, SKETCH_NUM_BINS), device=dev),
    )


def _member_stride(name: str, t: torch.Tensor, m: int, n: int, dtype) -> int:
    """A (M, N) operand's member stride: N, or 0 for one row expanded."""
    if t.dtype != dtype or t.dim() != 2 or t.shape != (m, n):
        raise ValueError(f"{name} must be a ({m}, {n}) {dtype} tensor; got {t.dtype} {tuple(t.shape)}")
    if n > 0 and t.stride(1) != 1:
        raise ValueError(f"{name} must be contiguous along the tuple axis")
    if m > 1 and t.stride(0) not in (0, n):
        raise ValueError(f"{name} must be contiguous or one row expanded over members")
    return t.stride(0) if m > 1 else n


def _column_mask(idx: tuple, c: int, what: str) -> int:
    if list(idx) != sorted(set(idx)) or any(not 0 <= i < c for i in idx) or c > 31:
        raise ValueError(f"{what} must be increasing column positions below C = {c} (C <= 31); got {idx}")
    return sum(1 << i for i in idx)


def edge_megakernel(vals, ok, scores, thresholds, num_slots: int, *, sidx=None, lat=None,
                    lon=None, codes=None, precision=None, ext_idx=(), sk_idx=()) -> MegaResult:
    """Single-traversal fused edge pass -> :class:`MegaResult`.

    ``vals`` (C, N) value columns (f32, or bf16 when staged; accumulation is
    f32), ``ok`` (M, N) bool per-member validity & ROI, ``scores`` (M, N)
    non-negative f32 sampling scores, ``thresholds`` (M, num_slots) f32
    per-slot keep thresholds.  Membership comes from ``sidx`` (M, N) int32
    or from ``lat``/``lon`` (N,) f32 with the sorted int32 ``codes`` table
    and ``precision``.  ``ext_idx``/``sk_idx`` select the value columns that
    also get extrema / sketch rows.  ``ok``, ``scores`` and ``sidx`` may be
    one (N,) row expanded over members.

    The CUDA kernel on CUDA tensors (bitwise reproducible); the plain
    version when every tensor lies on the CPU.
    """
    ext_idx, sk_idx = tuple(ext_idx), tuple(sk_idx)
    tensors = [t for t in (vals, ok, scores, thresholds, sidx, lat, lon, codes) if t is not None]
    if all(t.device.type == "cpu" for t in tensors):
        return edge_megakernel_plain(vals, ok, scores, thresholds, num_slots, sidx=sidx, lat=lat,
                                     lon=lon, codes=codes, precision=precision,
                                     ext_idx=ext_idx, sk_idx=sk_idx)
    dev = vals.device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"every operand must be a CUDA tensor on {dev}; got one on {t.device}")
    if vals.dim() != 2 or vals.dtype not in (torch.float32, torch.bfloat16) or not vals.is_contiguous():
        raise ValueError(f"vals must be a contiguous (C, N) f32 or bf16 tensor; got {vals.dtype} {tuple(vals.shape)}")
    c, n = vals.shape
    m, s = ok.shape[0], int(num_slots)
    if m < 1 or s < 1:
        raise ValueError("the megakernel needs at least one member and one slot")
    ok_ms = _member_stride("ok", ok, m, n, torch.bool)
    sc_ms = _member_stride("scores", scores, m, n, torch.float32)
    if thresholds.shape != (m, s) or thresholds.dtype != torch.float32 or not thresholds.is_contiguous():
        raise ValueError(f"thresholds must be a contiguous ({m}, {s}) f32 tensor")
    ext_mask = _column_mask(ext_idx, c, "ext_idx")
    sk_mask = _column_mask(sk_idx, c, "sk_idx")
    e, k = len(ext_idx), len(sk_idx)
    geo = (0.0, 0.0, 0, 0, 0)
    if sidx is None:
        _latlon_args(lat, lon, codes, precision)
        for name, t in (("lat", lat), ("lon", lon)):
            if t.shape != (n,) or t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(f"{name} must be a contiguous ({n},) f32 tensor")
        if codes.dim() != 1 or codes.dtype != torch.int32 or not codes.is_contiguous():
            raise ValueError("codes must be a contiguous 1-D int32 tensor (sorted)")
        geohash.check_precision(precision)
        lon_bits, lat_bits = geohash.split_bits(precision)
        lat_scale, lon_scale = geohash.axis_scales(precision)
        geo = (lat_scale, lon_scale, lat_bits, lon_bits, int((5 * precision) % 2 == 0))
        sidx_ms, num_codes = 0, codes.shape[0]
    else:
        sidx_ms, num_codes = _member_stride("sidx", sidx, m, n, torch.int32), 0
        lat = lon = codes = None  # sidx mode reads no coordinates

    # scratch: per-(member, slot, tile) records of the tile pass, read by the
    # finish pass; popc (a record's presence) and the sketch bins start at
    # zero, in one fill.  The bins count as int32 and become f32 in place.
    ms = m * s
    tiles, per = plan_tiles(n, BLOCKS_PER_SM["edge_megakernel"] * build.num_sms(dev))
    n_bins = ms * k * SKETCH_NUM_BINS
    counts = torch.zeros(n_bins + ms * tiles, dtype=torch.int32, device=dev)
    keepc = torch.empty(ms * tiles, dtype=torch.int32, device=dev)
    ext_rec = torch.empty(2 * e * ms * tiles, dtype=torch.int32, device=dev)
    sums = torch.empty(2 * c * ms * tiles, dtype=torch.float64, device=dev)
    out = torch.empty(2 * ms * (1 + c + e), dtype=torch.float32, device=dev)
    pop, keep, s1, s2, mins, maxs = out.split([ms, ms, ms * c, ms * c, ms * e, ms * e])
    bf16 = int(vals.dtype == torch.bfloat16)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = build.kernel("edge_megakernel")(
        vals.data_ptr(), bf16, c, n, m, ok.data_ptr(), ok_ms, scores.data_ptr(), sc_ms,
        thresholds.data_ptr(), s, ptr(sidx), sidx_ms, ptr(lat), ptr(lon), ptr(codes), num_codes,
        *geo, ext_mask, sk_mask, e, k, tiles, per, counts[n_bins:].data_ptr(), keepc.data_ptr(),
        ext_rec.data_ptr(), sums.data_ptr(), counts.data_ptr(), pop.data_ptr(), keep.data_ptr(),
        s1.data_ptr(), s2.data_ptr(), mins.data_ptr(), maxs.data_ptr(), build.stream_handle(dev),
    )
    build.check(err, "edge_megakernel")
    build.LAUNCHES["edge_megakernel"] += 1
    return MegaResult(
        pop=pop.view(m, s),
        keep=keep.view(m, s),
        s1=s1.view(m, c, s),
        s2=s2.view(m, c, s),
        mins=mins.view(m, e, s),
        maxs=maxs.view(m, e, s),
        bins=counts[:n_bins].view(torch.float32).view(m, k, s, SKETCH_NUM_BINS),
    )
