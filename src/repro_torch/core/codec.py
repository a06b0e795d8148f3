"""Uplink wire-format codecs: sparse + quantized sufficient statistics.

The paper's bandwidth argument is that the edge ships *sufficient
statistics*, not tuples — yet the dense preagg payload still ships every
``(S+1)``-float row of every accumulator kind, including all
``SKETCH_NUM_BINS`` sketch bins per column per stratum, even when a pane
touched three strata out of thousands.  This module is the wire-format
layer between edge partial-aggregation and cloud consolidation: it
flattens the registry's ``{column: {kind: state}}`` pytrees into a
canonical row list (via each kind's ``payload_flatten`` hook), packs the
rows into buffers + a tiny header, and measures the bytes that would
actually cross the uplink — the *measured truth* the session and runtime
byte accounting now report, with :func:`~.query.preagg_bytes` demoted to
the analytic dense *model*.

Codecs (composable through :func:`resolve_codec` specs):

* :class:`SparseCodec` (``"sparse"``) — lossless.  Per row, a packed
  stratum-occupancy bitmap (an entry whose f32 *bit pattern* differs from
  the row's merge identity marks its stratum occupied) gates a
  gather-compaction of the occupied rows; wide sketch rows additionally
  compact their bin columns through a second bitmap.  Decode scatters
  back into identity-filled arrays — bit-exact, down to the sign of zero
  and NaN payloads (occupancy compares bits, not float equality, which
  would drop a stored ``-0.0`` as identity ``0.0``).
* :class:`TopKSketchCodec` (``"topk<k>"``) — lossy, totals-exact.  Sketch
  bin rows keep their top-k bins verbatim and spread the (integer)
  residual count uniformly over the remaining bins of the occupied
  ``[lo, hi]`` index range, so per-stratum totals are preserved *exactly*
  — Horvitz-Thompson expansion and quantile inversion stay sound, only
  within-range bin placement blurs.  Every non-sketch row rides the
  sparse path unchanged.
* :class:`QuantizeCodec` (``"quantize16"`` / ``"quantize8"``) — lossy,
  counts-exact.  Rows whose kind declared ``quantize_ok`` (value moments,
  extrema) quantize to int16/int8 against a per-row scale shipped on the
  wire; ``n`` / ``total`` / sketch-bin rows stay exact f32 — they drive
  fpc and every error bound.  The declared per-row error bound is
  ``scale / 2`` (round-to-nearest); ±inf/NaN ride dedicated sentinels.
* :class:`DeltaCodec` (``"delta"``) — lossless, stateful.  Cross-pane
  DPCM: each pane ships the XOR of its rows' f32 bit patterns against the
  previous pane's reconstruction, sparse-coded (unchanged strata XOR to
  zero and cost a bitmap bit).  XOR — not arithmetic ``cur - prev`` — is
  deliberate: the f32 difference of two f32 values is generally not
  representable in f32, so arithmetic DPCM could not honor the bit-exact
  contract; XOR residuals always invert exactly.  The inner coder's
  bitwise occupancy matters doubly here: an exact sign flip of a value
  XORs to the ``-0.0`` bit pattern, which a float occupancy test would
  silently drop, desynchronizing both ends of the stream.  A keyframe
  (plain sparse frame) opens every stream and follows any schema change
  (membership churn, restore).

Byte accounting: ``EncodedPayload.nbytes`` counts the packed buffers plus
a small per-row control word and frame preamble.  The row *schema*
(column/kind/name/shape/identity) is a static property of the registered
plan — negotiated once at registration like the stratum table itself —
and is not charged per pane.

Everything here is host-side numpy by design: encoded shapes are
data-dependent (that is the whole point), so this layer is the
serialization boundary where device states become wire bytes, the one
place in the pane loop where a device sync is the semantics, not an
accident.  :func:`roundtrip` moves a frame's states to the host in one
copy (one sync) and the decoded rows back to the states' device in one
copy, through the registry's ``payload_flatten``/``payload_unflatten``.
"""

from __future__ import annotations

import re
from typing import NamedTuple

import numpy as np
import torch

from . import estimators
from .transfer import to_device

# accounting model: 8-byte frame preamble (codec id + frame kind + row
# count), one 4-byte control word per row (tag + buffer count)
_PREAMBLE_BYTES = 8
_ROW_CONTROL_BYTES = 4


class Row(NamedTuple):
    """One wire row of a flattened payload (see ``payload_flatten``)."""

    column: str
    kind: str
    name: str
    array: np.ndarray  # (S+1,) or (S+1, K) float32, stratum axis leading
    quantize_ok: bool
    identity: float


class SchemaRow(NamedTuple):
    """Static per-row metadata (negotiated at registration, not charged)."""

    column: str
    kind: str
    name: str
    shape: tuple
    quantize_ok: bool
    identity: float


class EncodedPayload(NamedTuple):
    """One pane's packed uplink frame: buffers + header.

    ``entries`` holds one ``(tag, meta, nbuf)`` control tuple per schema
    row; ``buffers`` is the flat buffer sequence the rows consume in
    order.  ``frame`` distinguishes delta frames from keyframes.
    """

    codec: str
    frame: str  # "raw" | "key" | "delta"
    schema: tuple  # tuple[SchemaRow, ...] — static, uncharged
    entries: tuple  # tuple[(tag, meta, nbuf), ...]
    buffers: tuple  # tuple[np.ndarray, ...]

    @property
    def nbytes(self) -> int:
        """Measured wire bytes of this frame (buffers + control words)."""
        return (
            _PREAMBLE_BYTES
            + _ROW_CONTROL_BYTES * len(self.entries)
            + sum(int(b.nbytes) for b in self.buffers)
        )


def flatten_stats(stats: dict) -> list[Row]:
    """Canonical wire rows of a ``{column: {kind: state}}`` registry tree
    (column/kind insertion order, each kind's ``payload_flatten`` order), as
    host f32 arrays: every row crosses to the host in one copy."""
    entries = []
    for col, kinds in stats.items():
        for kind, state in kinds.items():
            acc = estimators.accumulator(kind)
            for name, arr, q_ok, ident in acc.payload_flatten(state):
                entries.append((col, kind, name, torch.as_tensor(arr), q_ok, ident))
    if not entries:
        return []
    flat = torch.cat([e[3].to(torch.float32).reshape(-1) for e in entries]).cpu().numpy()
    rows: list[Row] = []
    pos = 0
    for col, kind, name, arr, q_ok, ident in entries:
        size = arr.numel()
        rows.append(
            Row(
                column=col,
                kind=kind,
                name=name,
                array=flat[pos : pos + size].reshape(tuple(arr.shape)),
                quantize_ok=bool(q_ok),
                identity=float(ident),
            )
        )
        pos += size
    return rows


def unflatten_stats(rows: list[Row], device=None) -> dict:
    """Inverse of :func:`flatten_stats`: decoded rows back to the registry
    ``{column: {kind: state}}`` tree (each kind's ``payload_unflatten``) on
    ``device`` (the CPU when None), in one host-to-device copy."""
    if not rows:
        return {}
    flat = to_device(np.concatenate([np.asarray(r.array, np.float32).reshape(-1) for r in rows]),
                     torch.float32, device or "cpu")
    grouped: dict[tuple, dict] = {}
    pos = 0
    for r in rows:
        size = int(np.asarray(r.array).size)
        grouped.setdefault((r.column, r.kind), {})[r.name] = flat[pos : pos + size].reshape(
            np.asarray(r.array).shape
        )
        pos += size
    stats: dict = {}
    for (col, kind), named in grouped.items():
        stats.setdefault(col, {})[kind] = estimators.accumulator(kind).payload_unflatten(named)
    return stats


def _device_of(stats: dict):
    for kinds in stats.values():
        for state in kinds.values():
            return next(iter(state)).device
    return None


def roundtrip(codec: "UplinkCodec", stats: dict) -> tuple[dict, int]:
    """Ship a registry tree through ``codec`` and back: the uplink
    boundary.  Returns ``(decoded_stats, measured_wire_bytes)``: the
    decoded tree, on the states' device, is what the cloud tier
    consolidates (bit-identical to ``stats`` for lossless codecs), the byte
    count is the frame's :attr:`EncodedPayload.nbytes`."""
    payload = codec.encode(flatten_stats(stats))
    return unflatten_stats(codec.decode(payload), _device_of(stats)), payload.nbytes


def _bits(a) -> np.ndarray:
    """The f32 bit patterns of ``a`` (shape-preserving uint32 view)."""
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _occupied(flat: np.ndarray, identity: float) -> np.ndarray:
    """Boolean occupancy along axis 0, compared on f32 *bit patterns*: an
    entry is occupied iff its bits differ from the identity's.  Bitwise —
    not float — equality is load-bearing three ways: NaN payloads register
    occupied, a ``-0.0`` entry differs from a ``+0.0`` identity (lossless
    codecs round-trip the sign of zero), and a delta frame's
    ``0x80000000`` XOR residual — an exact sign flip of the underlying
    value, e.g. ``wsum`` crossing ``x`` to ``-x`` or ``min`` going
    ``+inf`` to ``-inf`` — ships instead of being dropped as
    ``-0.0 == 0.0``, which would silently desynchronize the DPCM stream."""
    return np.any(_bits(flat) != _bits(np.float32(identity)), axis=1)


class UplinkCodec:
    """Protocol of one wire codec.  Stateless unless noted; a stateful
    codec (delta) returns a fresh instance from :meth:`for_stream` so
    every (fusion group, member) stream carries its own DPCM state."""

    name: str = "?"
    lossless: bool = True

    def fingerprint(self) -> str:
        """Stable config identity (checkpoint-validated across restarts)."""
        return self.name

    def for_stream(self) -> "UplinkCodec":
        """A codec instance for one independent uplink stream."""
        return self

    def reset(self) -> None:
        """Drop any cross-pane state (next frame is a keyframe)."""

    def encode(self, rows: list[Row]) -> EncodedPayload:
        raise NotImplementedError

    def decode(self, payload: EncodedPayload) -> list[Row]:
        raise NotImplementedError


class SparseCodec(UplinkCodec):
    """Empty-stratum / empty-bin skipping: bitmap + gather-compaction."""

    name = "sparse"
    lossless = True

    def encode(self, rows: list[Row]) -> EncodedPayload:
        schema = []
        entries = []
        buffers: list[np.ndarray] = []
        for row in rows:
            schema.append(
                SchemaRow(
                    row.column, row.kind, row.name, tuple(row.array.shape),
                    row.quantize_ok, row.identity,
                )
            )
            tag, meta, bufs = self._encode_row(row)
            entries.append((tag, meta, len(bufs)))
            buffers.extend(bufs)
        return EncodedPayload(
            codec=self.name,
            frame="raw",
            schema=tuple(schema),
            entries=tuple(entries),
            buffers=tuple(buffers),
        )

    def decode(self, payload: EncodedPayload) -> list[Row]:
        rows: list[Row] = []
        pos = 0
        for srow, (tag, meta, nbuf) in zip(payload.schema, payload.entries):
            bufs = payload.buffers[pos : pos + nbuf]
            pos += nbuf
            arr = self._decode_row(srow, tag, meta, iter(bufs))
            rows.append(
                Row(
                    column=srow.column, kind=srow.kind, name=srow.name,
                    array=arr, quantize_ok=srow.quantize_ok,
                    identity=srow.identity,
                )
            )
        return rows

    # -- per-row packing (subclass hook points) ------------------------------

    def _encode_row(self, row: Row):
        flat = row.array.reshape(row.array.shape[0], -1)
        occ = _occupied(flat, row.identity)
        if not occ.any():
            return "empty", None, []
        bufs = [np.packbits(occ)]
        sub = flat[occ]
        if sub.shape[1] > 1:
            colocc = _occupied(np.ascontiguousarray(sub.T), row.identity)
            bufs.append(np.packbits(colocc))
            sub = np.ascontiguousarray(sub[:, colocc])
            tag = "grid"
        else:
            tag = "vec"
        meta = self._encode_values(row, sub, bufs)
        return tag, meta, bufs

    def _decode_row(self, srow: SchemaRow, tag: str, meta, bufs) -> np.ndarray:
        shape = srow.shape
        width = int(np.prod(shape[1:], dtype=np.int64)) if len(shape) > 1 else 1
        flat = np.full((shape[0], width), np.float32(srow.identity), np.float32)
        if tag == "empty":
            return flat.reshape(shape)
        occ = np.unpackbits(next(bufs), count=shape[0]).astype(bool)
        n_occ = int(occ.sum())
        if tag == "grid":
            colocc = np.unpackbits(next(bufs), count=width).astype(bool)
            sub = self._decode_values(srow, meta, bufs, (n_occ, int(colocc.sum())))
            block = np.full((n_occ, width), np.float32(srow.identity), np.float32)
            block[:, colocc] = sub
            flat[occ] = block
        else:
            flat[occ] = self._decode_values(srow, meta, bufs, (n_occ, 1))
        return flat.reshape(shape)

    def _encode_values(self, row: Row, sub: np.ndarray, bufs: list):
        bufs.append(np.ascontiguousarray(sub, np.float32).reshape(-1))
        return None

    def _decode_values(self, srow: SchemaRow, meta, bufs, shape) -> np.ndarray:
        return np.asarray(next(bufs), np.float32).reshape(shape)


class TopKSketchCodec(SparseCodec):
    """Top-k + uniform residual spread for sketch bin rows (totals exact).

    Residuals distribute as *integers* (``base`` per bin, the remainder
    spread one-each from the range start): bin counts are integer-valued
    f32, so per-stratum totals — the masses HT expansion and quantile
    inversion read — survive the lossy pass with zero float drift.
    """

    lossless = False

    def __init__(self, k: int = 16):
        if k < 1:
            raise ValueError(f"topk codec needs k >= 1; got {k}")
        self.k = int(k)
        self.name = f"topk{self.k}"

    def _encode_row(self, row: Row):
        wide = row.array.ndim == 2 and row.array.shape[1] > 1
        if not (row.kind == "sketch" and row.name == "bins" and wide):
            return super()._encode_row(row)
        arr = row.array
        # float — not bitwise — occupancy on purpose: this path is lossy
        # and indexes bins via flatnonzero (which reads -0.0 as empty), so
        # a row of zero-mass bins must count as unoccupied here
        with np.errstate(invalid="ignore"):
            occ = np.any(arr != 0.0, axis=1)
        if not occ.any():
            return "empty", None, []
        ranges, idx_parts, val_parts, residuals = [], [], [], []
        for v in arr[occ]:
            nz = np.flatnonzero(v)
            lo, hi = int(nz[0]), int(nz[-1])
            k_use = min(self.k, len(nz))
            by_mass = nz[np.argsort(-v[nz], kind="stable")]
            top = np.sort(by_mass[:k_use])
            topv = v[top]
            residual = float(
                np.sum(v[nz], dtype=np.float64) - np.sum(topv, dtype=np.float64)
            )
            ranges.append((lo, hi, k_use))
            idx_parts.append(top.astype(np.int16))
            val_parts.append(topv.astype(np.float32))
            residuals.append(residual)
        bufs = [
            np.packbits(occ),
            np.asarray(ranges, np.uint16).reshape(-1),
            np.concatenate(idx_parts),
            np.concatenate(val_parts),
            np.asarray(residuals, np.float32),
        ]
        return "topk", None, bufs

    def _decode_row(self, srow: SchemaRow, tag: str, meta, bufs) -> np.ndarray:
        if tag != "topk":
            return super()._decode_row(srow, tag, meta, bufs)
        shape = srow.shape
        out = np.zeros(shape, np.float32)
        occ = np.unpackbits(next(bufs), count=shape[0]).astype(bool)
        n_occ = int(occ.sum())
        ranges = np.asarray(next(bufs), np.uint16).reshape(n_occ, 3)
        idx = np.asarray(next(bufs), np.int16)
        vals = np.asarray(next(bufs), np.float32)
        residuals = np.asarray(next(bufs), np.float32)
        rows = np.flatnonzero(occ)
        pos = 0
        for r, (lo, hi, k_use), residual in zip(rows, ranges, residuals):
            lo, hi, k_use = int(lo), int(hi), int(k_use)
            top = idx[pos : pos + k_use].astype(np.int64)
            out[r, top] = vals[pos : pos + k_use]
            pos += k_use
            rest = np.ones(hi - lo + 1, bool)
            rest[top - lo] = False
            rest_idx = lo + np.flatnonzero(rest)
            m = len(rest_idx)
            if m:
                base, rem = divmod(int(round(float(residual))), m)
                spread = np.full(m, base, np.float32)
                spread[:rem] += 1.0
                out[r, rest_idx] = spread
        return out


# quantization grids: symmetric integer range + dedicated sentinels for
# the non-finite lattice values extrema rows legitimately carry
_QUANT = {
    16: {"dtype": np.int16, "qmax": 32764, "pos_inf": 32767, "neg_inf": -32768, "nan": -32767},
    8: {"dtype": np.int8, "qmax": 124, "pos_inf": 127, "neg_inf": -128, "nan": -127},
}


class QuantizeCodec(SparseCodec):
    """Per-row scaled int16/int8 quantization of value rows; count rows
    (``quantize_ok=False``) ride the sparse f32 path exactly."""

    lossless = False

    def __init__(self, bits: int = 16):
        if bits not in _QUANT:
            raise ValueError(f"quantize codec supports bits in {sorted(_QUANT)}; got {bits}")
        self.bits = int(bits)
        self.name = f"quantize{self.bits}"

    def _encode_values(self, row: Row, sub: np.ndarray, bufs: list):
        if not row.quantize_ok:
            return super()._encode_values(row, sub, bufs)
        g = _QUANT[self.bits]
        finite = np.isfinite(sub)
        amax = float(np.max(np.abs(sub[finite]))) if finite.any() else 0.0
        # quantize against the exact f32 value the decoder will read off
        # the wire, or the declared half-step bound would not survive the
        # f64 -> f32 scale rounding; qmax sits below the dtype max with
        # enough headroom that the f32 rounding cannot push rint past it.
        # Floored at the smallest normal f32: a subnormal amax can
        # underflow amax/qmax to 0 in f32 (divide-by-zero, everything
        # clips to qmax and decodes to 0, the declared bound scale/2 = 0)
        # or leave it subnormal; the floor keeps the division normal,
        # rint(sub/scale) inside the clip range, and the half-step bound
        # intact — with scale = tiny, |sub| <= amax <= qmax*tiny
        tiny = float(np.finfo(np.float32).tiny)
        scale = max(float(np.float32(amax / g["qmax"])), tiny) if amax > 0 else 1.0
        with np.errstate(invalid="ignore"):
            q = np.clip(np.rint(sub / scale), -g["qmax"], g["qmax"])
        q = np.where(np.isnan(q), 0, q).astype(g["dtype"])
        q[sub == np.inf] = g["pos_inf"]
        q[sub == -np.inf] = g["neg_inf"]
        q[np.isnan(sub)] = g["nan"]
        bufs.append(np.ascontiguousarray(q).reshape(-1))
        # the per-row scale crosses the wire (one f32), so it is charged
        bufs.append(np.asarray([scale], np.float32))
        # declared reconstruction bound: round-to-nearest half-step
        return ("quant", self.bits, 0.5 * scale)

    def _decode_values(self, srow: SchemaRow, meta, bufs, shape) -> np.ndarray:
        if not (isinstance(meta, tuple) and meta and meta[0] == "quant"):
            return super()._decode_values(srow, meta, bufs, shape)
        g = _QUANT[self.bits]
        q = np.asarray(next(bufs), g["dtype"]).reshape(shape)
        scale = float(np.asarray(next(bufs), np.float32)[0])
        # f64 product, single f32 rounding at the end: reconstruction
        # error stays within the declared half-step plus one result ulp
        out = (q.astype(np.float64) * scale).astype(np.float32)
        out[q == g["pos_inf"]] = np.inf
        out[q == g["neg_inf"]] = -np.inf
        out[q == g["nan"]] = np.nan
        return out


class DeltaCodec(UplinkCodec):
    """Cross-pane XOR DPCM over a sparse inner coder (lossless, stateful).

    The encoder tracks the decoder's reconstruction (identical here: the
    inner path is lossless), so both ends advance in lockstep; the first
    frame of a stream — and the first after any schema change — is a
    keyframe.  Encode and decode keep *separate* previous-frame mirrors,
    so one instance can serve both ends of a loopback uplink without the
    encoder's state update corrupting the decoder's reference frame.
    """

    name = "delta:sparse"
    lossless = True

    def __init__(self):
        self._inner = SparseCodec()
        self._enc_prev: list[np.ndarray] | None = None
        self._dec_prev: list[np.ndarray] | None = None

    def for_stream(self) -> "DeltaCodec":
        return DeltaCodec()

    def reset(self) -> None:
        self._enc_prev = None
        self._dec_prev = None

    @staticmethod
    def _matches(prev: list[np.ndarray], rows: list[Row]) -> bool:
        return len(prev) == len(rows) and all(
            p.shape == r.array.shape for p, r in zip(prev, rows)
        )

    def encode(self, rows: list[Row]) -> EncodedPayload:
        cur = [np.ascontiguousarray(r.array, np.float32) for r in rows]
        prev = self._enc_prev
        if prev is None or not self._matches(prev, rows):
            payload = self._inner.encode(rows)._replace(codec=self.name, frame="key")
        else:
            xrows = [
                r._replace(
                    array=(_bits(c) ^ _bits(p)).view(np.float32),
                    quantize_ok=False,
                    identity=0.0,
                )
                for r, c, p in zip(rows, cur, prev)
            ]
            payload = self._inner.encode(xrows)._replace(
                codec=self.name, frame="delta"
            )
        self._enc_prev = cur
        return payload

    def decode(self, payload: EncodedPayload) -> list[Row]:
        rows = self._inner.decode(payload)
        if payload.frame == "delta":
            if self._dec_prev is None or not self._matches(self._dec_prev, rows):
                raise ValueError(
                    "delta frame received with no matching reference frame; "
                    "the stream must open (and reopen after any schema "
                    "change) with a keyframe"
                )
            rows = [
                r._replace(array=(_bits(r.array) ^ _bits(p)).view(np.float32))
                for r, p in zip(rows, self._dec_prev)
            ]
        self._dec_prev = [np.ascontiguousarray(r.array, np.float32) for r in rows]
        return rows


_SPEC_HELP = (
    "'sparse', 'topk<k>' (e.g. 'topk16'), 'quantize16', 'quantize8', "
    "'delta' (alias 'delta:sparse'), or an UplinkCodec instance"
)


def resolve_codec(spec) -> UplinkCodec | None:
    """Resolve a ``PipelineConfig.uplink_codec`` spec to a codec.

    ``None`` keeps the dense analytic uplink (codec off).  String specs
    keep the frozen config hashable; see ``_SPEC_HELP`` for the grammar.
    """
    if spec is None:
        return None
    if isinstance(spec, UplinkCodec):
        return spec
    if isinstance(spec, str):
        s = spec.strip().lower()
        if s == "sparse":
            return SparseCodec()
        if s in ("delta", "delta:sparse"):
            return DeltaCodec()
        m = re.fullmatch(r"topk(\d+)", s)
        if m:
            return TopKSketchCodec(int(m.group(1)))
        m = re.fullmatch(r"quantize(8|16)", s)
        if m:
            return QuantizeCodec(int(m.group(1)))
    raise ValueError(f"unknown uplink codec spec {spec!r}; expected {_SPEC_HELP}")
