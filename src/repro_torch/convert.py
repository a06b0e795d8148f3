"""Carry state across from numpy: stratum tables and accumulator states.

Another implementation of the engine (or a file) can hand over a stratum
table or per-column accumulator states as plain numpy arrays; these
functions rebuild this package's objects from them, so the same states can
be finalized here and there.
"""

from __future__ import annotations

import numpy as np
import torch

from .core import estimators
from .core.stratify import StratumTable, resolve_device

_STATE_TYPES = {
    "moments": estimators.StratumStats,
    "extrema": estimators.Extrema,
    "sketch": estimators.QuantileSketch,
}


def table_from_numpy(codes, neighborhood, precision: int, neighborhood_precision: int,
                     num_neighborhoods: int, device=None) -> StratumTable:
    """A :class:`StratumTable` from sorted codes (S,) and neighborhood ids (S+1,)."""
    dev = resolve_device(device)
    codes = np.asarray(codes)
    if codes.size and int(codes.max()) >= 2**31:
        raise ValueError("geohash codes must fit in int32 (precision <= 6)")
    return StratumTable(
        codes=torch.as_tensor(codes.astype(np.int32), device=dev),
        neighborhood=torch.as_tensor(np.asarray(neighborhood).astype(np.int32), device=dev),
        precision=int(precision),
        neighborhood_precision=int(neighborhood_precision),
        num_neighborhoods=int(num_neighborhoods),
    )


def accs_from_numpy(stats: dict, device=None) -> dict:
    """``{column: {kind: {field: ndarray}}}`` -> ``{column: {kind: state}}``
    with f32 tensors on ``device``."""
    dev = resolve_device(device)
    out = {}
    for column, kinds in stats.items():
        out[column] = {}
        for kind, fields in kinds.items():
            cls = _STATE_TYPES[kind]
            out[column][kind] = cls(
                **{
                    f: torch.as_tensor(np.array(fields[f], dtype=np.float32), device=dev)
                    for f in cls._fields
                }
            )
    return out
