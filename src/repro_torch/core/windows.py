"""Window semantics for the streaming pipeline (paper §3.4, §5.2.4).

The paper processes continuous queries over tumbling windows and observes
that count-triggered windows keep per-batch compute constant under bursty
traffic.  Windows are host-side numpy batches of fixed shape with a
validity mask; ``EdgeCloudPipeline.execute`` moves one onto the device.

Windows carry multiple named value columns: stream chunks may include any
number of extra numeric keys beyond the canonical
``sensor_id/timestamp/lat/lon/value``; extra keys ride in
``WindowBatch.extra`` and are addressable via ``WindowBatch.columns``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

CANONICAL_KEYS = ("sensor_id", "timestamp", "lat", "lon", "value")


@dataclasses.dataclass(frozen=True)
class WindowBatch:
    """One window of tuples, fixed shape (N,) + validity mask.

    ``n_dropped`` counts tuples that arrived for this window but were shed
    before it reached the device; ``drop_causes`` breaks that count down by
    cause.  Count-triggered windows report an explicit ``n_dropped=0``.
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


def _make_batch(cat: dict, valid: np.ndarray) -> WindowBatch:
    return WindowBatch(
        sensor_id=cat["sensor_id"],
        timestamp=cat["timestamp"],
        lat=cat["lat"],
        lon=cat["lon"],
        value=cat["value"],
        valid=valid,
        extra={k: cat[k] for k in cat if k not in CANONICAL_KEYS},
        n_dropped=0,
    )


def _check_keys(buf: dict, chunk: dict) -> None:
    """Every chunk must carry the same column set as the first one."""
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
        for k in buf:
            buf[k].append(np.asarray(chunk[k]))
        have += len(chunk["lat"])
        while have >= window_size:
            cat = {k: np.concatenate(v) for k, v in buf.items()}
            head = {k: v[:window_size] for k, v in cat.items()}
            for k in buf:
                buf[k] = [cat[k][window_size:]]
            have -= window_size
            yield _make_batch(head, np.ones(window_size, dtype=bool))
