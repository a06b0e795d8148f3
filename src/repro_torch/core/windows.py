"""Window semantics for the streaming pipeline (paper §3.4, §5.2.4).

The paper processes continuous queries over *tumbling* windows and observes
(design implication #2) that count-triggered windows keep per-batch compute
constant under bursty traffic.  Both triggers are provided; windows are
host-side iterators yielding fixed-shape arrays (count windows) or padded
arrays with a validity mask (time windows), so every device step is a single
compiled program.

Sliding and hopping windows are *pane-based* (the classic panes / stream
"slicing" decomposition): the stream is cut into stride-sized sub-windows
("panes"), each pane is reduced once to mergeable per-stratum accumulators,
and a window's answer is the merge of its panes — no tuple is ever touched
twice.  :class:`WindowSpec` declares the shape of a registered continuous
query's window in pane units; the pane *content* is whatever the tumbling
iterators below yield (see :func:`pane_windows`), and the merge lives in
``session.StreamSession`` / ``estimators.merge_column_stats_panes``.

Windows carry *multiple named value columns* for the query layer: stream
chunks may include any number of extra numeric keys beyond the canonical
``sensor_id/timestamp/lat/lon/value`` (e.g. mobility speed + occupancy, air
quality PM2.5 + temperature).  Extra keys ride in ``WindowBatch.extra`` and
are addressable from ``Query`` aggregates via ``WindowBatch.columns``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

CANONICAL_KEYS = ("sensor_id", "timestamp", "lat", "lon", "value")

WINDOW_KINDS = ("tumbling", "sliding", "hopping")


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    """Pane-based window shape of a registered continuous query.

    ``size`` and ``stride`` are measured in *panes* — the unit batches a
    :class:`~.session.StreamSession` consumes (one ``WindowBatch`` per
    ``step``).  A query's window covers the last ``size`` panes and a result
    is emitted every ``stride`` panes:

      tumbling  stride == size (consecutive disjoint windows; the default,
                ``WindowSpec()`` is the classic one-pane tumbling window)
      sliding   stride == 1 (a result after every pane, windows overlap)
      hopping   1 <= stride <= size (general overlapping hop)

    ``stride`` may be omitted: it defaults to ``size`` for tumbling and to
    ``1`` for sliding; hopping requires it explicitly.
    """

    kind: str = "tumbling"
    size: int = 1
    stride: int | None = None

    def __post_init__(self):
        if self.kind not in WINDOW_KINDS:
            raise ValueError(f"window kind must be one of {WINDOW_KINDS}; got {self.kind!r}")
        if int(self.size) < 1:
            raise ValueError(f"window size must be >= 1 pane; got {self.size}")
        object.__setattr__(self, "size", int(self.size))
        stride = self.stride
        if stride is None:
            if self.kind == "hopping":
                raise ValueError("hopping WindowSpec requires an explicit stride")
            stride = self.size if self.kind == "tumbling" else 1
        stride = int(stride)
        if self.kind == "tumbling" and stride != self.size:
            raise ValueError(f"tumbling windows need stride == size; got {stride} != {self.size}")
        if self.kind == "sliding" and stride != 1:
            raise ValueError(f"sliding windows need stride == 1; got {stride}")
        if not 1 <= stride <= self.size:
            raise ValueError(
                f"stride must be in [1, size={self.size}] (stride > size would skip panes); got {stride}"
            )
        object.__setattr__(self, "stride", stride)


@dataclasses.dataclass(frozen=True)
class WindowBatch:
    """One window (or pane) of tuples, fixed shape (N,) + validity mask.

    ``n_dropped`` counts tuples that arrived for this window but were shed
    before it reached the device; ``drop_causes`` breaks that count down by
    *why* (cause -> tuples).  Producers tag their own cause:

      ``late``        bounded-buffer capacity overflow in :func:`time_windows`
      ``queue_full``  ingest-queue backpressure (:mod:`.qdisc` policies)
      ``shed``        load-shedding decimation under queue saturation

    Count-triggered windows report an explicit ``n_dropped=0`` / empty
    ``drop_causes`` (never "missing"), so downstream accounting can always
    sum across sources and causes.
    """

    sensor_id: np.ndarray
    timestamp: np.ndarray
    lat: np.ndarray
    lon: np.ndarray
    value: np.ndarray
    valid: np.ndarray
    extra: dict = dataclasses.field(default_factory=dict)
    n_dropped: int = 0
    drop_causes: dict = dataclasses.field(default_factory=dict)

    @property
    def size(self) -> int:
        return int(self.valid.sum())

    @property
    def capacity(self) -> int:
        return int(self.valid.shape[0])

    @property
    def columns(self) -> dict:
        """All named value columns: the primary ``value`` plus extras."""
        return {"value": self.value, **self.extra}


def _pad(arr: np.ndarray, capacity: int) -> np.ndarray:
    out = np.zeros((capacity,) + arr.shape[1:], dtype=arr.dtype)
    out[: len(arr)] = arr
    return out


def _make_batch(
    cat: dict,
    valid: np.ndarray,
    pad_to: int | None = None,
    n_dropped: int = 0,
    cause: str = "late",
) -> WindowBatch:
    def col(k):
        a = cat[k]
        return _pad(a, pad_to) if pad_to is not None else a

    extra = {k: col(k) for k in cat if k not in CANONICAL_KEYS}
    return WindowBatch(
        sensor_id=col("sensor_id"),
        timestamp=col("timestamp"),
        lat=col("lat"),
        lon=col("lon"),
        value=col("value"),
        valid=valid,
        extra=extra,
        n_dropped=n_dropped,
        drop_causes={cause: n_dropped} if n_dropped else {},
    )


def _check_keys(buf: dict, chunk: dict) -> None:
    """Every chunk must carry the same column set as the first one; a drift
    would otherwise silently drop (new key) or crash on (missing key) data."""
    if buf.keys() != chunk.keys():
        raise ValueError(
            f"stream chunk keys {sorted(chunk)} differ from the first "
            f"chunk's {sorted(buf)}; columns must be consistent across chunks"
        )


def count_windows(stream: Iterator[dict], window_size: int) -> Iterator[WindowBatch]:
    """Count-triggered tumbling windows: exactly ``window_size`` tuples each.

    ``stream`` yields dict chunks with keys sensor_id/timestamp/lat/lon/value
    plus any number of extra value columns (carried into ``extra``); the key
    set must be identical across chunks.
    """
    buf: dict[str, list[np.ndarray]] | None = None
    have = 0
    for chunk in stream:
        if buf is None:
            buf = {k: [] for k in chunk}
        _check_keys(buf, chunk)
        n = len(chunk["lat"])
        for k in buf:
            buf[k].append(np.asarray(chunk[k]))
        have += n
        while have >= window_size:
            cat = {k: np.concatenate(v) for k, v in buf.items()}
            head = {k: v[:window_size] for k, v in cat.items()}
            rest = {k: v[window_size:] for k, v in cat.items()}
            for k in buf:
                buf[k] = [rest[k]]
            have -= window_size
            # count windows never shed: report an explicit zero (not a
            # missing field) so drop accounting sums cleanly across sources
            yield _make_batch(head, np.ones(window_size, dtype=bool), n_dropped=0)


def time_windows(
    stream: Iterator[dict], window_seconds: float, capacity: int
) -> Iterator[WindowBatch]:
    """Time-triggered tumbling windows padded to a static ``capacity``.

    Tuples beyond capacity are dropped (bounded-buffer semantics, like the
    paper's Kafka producer under burst) and counted: each emitted batch's
    ``n_dropped`` is the number its window shed, so downstream diagnostics
    (e.g. ``StreamSession`` step reports) can account for the loss.
    """
    buf: dict[str, list] | None = None
    t_edge: float | None = None
    for chunk in stream:
        if buf is None:
            buf = {k: [] for k in chunk}
        _check_keys(buf, chunk)
        ts = np.asarray(chunk["timestamp"], dtype=np.float64)
        if t_edge is None and len(ts):
            t_edge = float(ts[0]) + window_seconds
        lo = 0
        while t_edge is not None and len(ts) and ts[-1] >= t_edge:
            cut = int(np.searchsorted(ts, t_edge, side="left"))
            for k in buf:
                buf[k].append(np.asarray(chunk[k])[lo:cut])
            cat = {k: np.concatenate(v) if v else np.zeros(0) for k, v in buf.items()}
            size = min(len(cat["lat"]), capacity)
            head = {k: v[:size] for k, v in cat.items()}
            yield _make_batch(
                head, np.arange(capacity) < size, pad_to=capacity,
                n_dropped=len(cat["lat"]) - size,
            )
            for k in buf:
                buf[k] = []
            lo = cut
            t_edge += window_seconds
        for k in buf:
            arr = np.asarray(chunk[k])[lo:]
            if len(arr):
                buf[k].append(arr)
    if buf is not None and any(len(v) for v in buf.values()):
        cat = {k: (np.concatenate(v) if v else np.zeros(0)) for k, v in buf.items()}
        size = min(len(cat["lat"]), capacity)
        if size:
            head = {k: v[:size] for k, v in cat.items()}
            yield _make_batch(
                head, np.arange(capacity) < size, pad_to=capacity,
                n_dropped=len(cat["lat"]) - size,
            )


def pane_windows(
    stream: Iterator[dict],
    pane_tuples: int | None = None,
    pane_seconds: float | None = None,
    capacity: int | None = None,
) -> Iterator[WindowBatch]:
    """Cut a stream into panes — the arrival unit of a ``StreamSession``.

    A pane is just a tumbling window of one *stride* worth of data: pass
    either ``pane_tuples`` (count trigger, fixed-shape panes) or
    ``pane_seconds`` + ``capacity`` (time trigger, padded panes).  Feed the
    resulting iterator to ``StreamSession.run``; registered queries with
    sliding/hopping :class:`WindowSpec` assemble their windows by merging
    pane accumulators, never re-reading these tuples.
    """
    if (pane_tuples is None) == (pane_seconds is None):
        raise ValueError("pass exactly one of pane_tuples / pane_seconds")
    if pane_tuples is not None:
        return count_windows(stream, pane_tuples)
    if capacity is None:
        raise ValueError("time-triggered panes need a static capacity")
    return time_windows(stream, pane_seconds, capacity)
