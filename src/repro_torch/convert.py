"""Carry state across from numpy: stratum tables, accumulator states and
model parameters.

Another implementation of the engine (or a file) can hand over a stratum
table, per-column accumulator states or a model's parameter tree as plain
numpy arrays; these functions rebuild this package's objects from them, so
the same states can be finalized, and the same weights served, here and
there.
"""

from __future__ import annotations

import numpy as np
import torch

from .core import estimators
from .core.stratify import StratumTable, resolve_device
from .models import DenseTransformer, ModelConfig
from .models.base import map_leaves

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


def model_from_numpy(params: dict, cfg: ModelConfig, device=None) -> DenseTransformer:
    """A model from a parameter tree in the JAX package's layout, as nested
    dicts of numpy arrays: ``embedding/tok`` (and ``embedding/unembed`` when
    the embeddings are untied), ``final_norm``, and the ``layers/*`` leaves
    stacked over the layers, ``(L, ...)``, which the model takes apart into
    its per-layer modules.  Arrays are copied as they are (the reference
    keeps its parameters in f32)."""
    dev = resolve_device(device)
    tree = {k: params[k] for k in ("embedding", "final_norm", "layers")}
    return DenseTransformer(cfg, map_leaves(lambda a: torch.as_tensor(np.array(a), device=dev), tree))
