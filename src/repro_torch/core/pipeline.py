"""EdgeApproxGeo query engine (paper Algorithm 2), preagg mode.

A query is lowered (``query.lower``) into the two halves of the edge-cloud
split:

Edge tier  = stratify + EdgeSOS-sample the local window, then reduce every
             column the query references to its plan-declared mergeable
             per-stratum accumulator states.  The moment reductions run on
             ``PipelineConfig.backend``:

               * ``"segment"`` — per-column ``index_add_`` reductions (the
                 portable path and the parity oracle);
               * ``"pallas"``  — one multi-column pass through the
                 edge_reduce kernel, with geohash encode and Bernoulli
                 selection through their kernels too (the CUDA kernels on a
                 CUDA device, their plain versions on the CPU).  The name is
                 the reference package's, so one config selects the
                 kernel path in both.
Cloud tier = finalize each aggregate into an ``AggEstimate`` with error
             bounds, optionally grouped by stratum / neighborhood.

Randomness: one ``(N,)`` uniform vector decides the whole sample (the SRS
rank draw and the Bernoulli draw read the same vector, as in the reference
package, where both read ``jax.random.uniform`` from one key).
``execute`` draws it with ``torch.rand`` from the caller's generator, or
takes it from ``uniforms=``.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from . import estimators, sampling
from . import query as aqp
from .query import Plan, Query, QueryResult
from .sampling import SampleResult
from .stratify import StratumTable, resolve_device
from .windows import WindowBatch

BACKENDS = ("segment", "pallas")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Deployment-level defaults; per-query settings live on ``Query``.

    ``backend`` selects the edge reduction implementation: ``"segment"``
    (per-column reductions) or ``"pallas"`` (the kernel path).  The
    reference's ``"fused"`` megakernel backend, raw mode and uplink codecs
    are not part of this package yet and raise ``NotImplementedError``.
    """

    method: str = "srs"  # srs | bernoulli | neyman
    mode: str = "preagg"
    confidence: float = 0.95
    backend: str = "segment"
    uplink_codec: str | None = None

    def __post_init__(self):
        if self.backend == "fused":
            raise NotImplementedError(
                "backend='fused' (the edge megakernel) arrives with slice 2 of the port"
            )
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}; got {self.backend!r}")
        if self.mode == "raw":
            raise NotImplementedError("mode='raw' arrives with the raw-mode slice of the port")
        if self.mode != "preagg":
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.uplink_codec is not None:
            raise NotImplementedError("uplink codecs arrive with the codec slice of the port")


def edge_sample(
    u: torch.Tensor,
    table: StratumTable,
    lat: torch.Tensor,
    lon: torch.Tensor,
    valid: torch.Tensor,
    fraction,
    method: str,
    stddev: torch.Tensor | None = None,
    backend: str = "segment",
) -> tuple[torch.Tensor, SampleResult]:
    """Edge-local half of Algorithm 2: stratify + EdgeSOS sample."""
    sidx = table.assign(lat, lon, backend=backend)
    sidx = torch.where(valid, sidx, table.num_strata)  # padding -> overflow
    result = sampling.edgesos(
        u, sidx, table.num_slots, fraction, method=method, stddev=stddev, backend=backend
    )
    mask = result.mask & valid
    weight = torch.where(valid, result.weight, 0.0)
    # population counts must also exclude padding
    counts = sampling.segment_count(sidx, valid, table.num_slots)
    n_k = sampling.segment_count(sidx, mask, table.num_slots)
    return sidx, SampleResult(mask=mask, weight=weight, n_k=n_k, counts=counts)


def _accumulate_columns(
    plan: Plan,
    cfg: PipelineConfig,
    cols: Mapping[str, torch.Tensor],
    sidx: torch.Tensor,
    mask: torch.Tensor,
    num_slots: int,
    counts: torch.Tensor,
) -> dict:
    """Reduce every referenced column to its plan-declared registry states.

    With ``backend="pallas"`` the moment states of all columns come from one
    edge_reduce pass; on ``"segment"`` from per-column reductions.  Other
    kinds (extrema, sketches) accumulate through their registry entries."""
    kinds_map = plan.column_kind_map
    stats: dict = {c: {} for c in plan.columns}
    if cfg.backend == "pallas":
        from ..kernels.edge_reduce import edge_reduce

        stacked = torch.stack([cols[c] for c in plan.columns])
        cnt, s1, s2 = edge_reduce(sidx, stacked, mask, num_slots)
        for i, c in enumerate(plan.columns):
            stats[c]["moments"] = estimators.MOMENTS.from_kernel_rows(cnt, s1[i], s2[i], counts)
    else:
        for c in plan.columns:
            stats[c]["moments"] = estimators.MOMENTS.accumulate(
                cols[c], sidx, mask, num_slots, counts=counts
            )
    for c in plan.columns:
        for kind in kinds_map[c]:
            if kind not in stats[c]:
                stats[c][kind] = estimators.accumulator(kind).accumulate(
                    cols[c], sidx, mask, num_slots, counts=counts
                )
    return stats


def _edge_program(plan: Plan, table: StratumTable, cfg: PipelineConfig, u, lat, lon, cols,
                  valid, fraction):
    """The lowered edge half of a preagg plan on one edge node.

    Returns ``(stats, n_sampled, n_valid, n_overflow, n_truncated,
    comm_bytes)`` where ``stats`` maps column -> ``{kind: state}``."""
    ok = valid & aqp.roi_mask(plan, table, lat, lon)
    sidx, sample = edge_sample(
        u, table, lat, lon, ok, fraction, plan.query.method, backend=cfg.backend
    )
    stats, n_sampled, n_valid, n_overflow = _member_reduce(
        plan, table, cfg, cols, sidx, sample.mask, ok, valid, sample.counts
    )
    comm = torch.tensor(aqp.preagg_bytes(plan, table.num_slots), dtype=torch.int32)
    n_truncated = torch.zeros((), dtype=torch.int32, device=lat.device)
    return stats, n_sampled, n_valid, n_overflow, n_truncated, comm.to(lat.device)


def _member_reduce(plan: Plan, table: StratumTable, cfg: PipelineConfig, cols, sidx, mask, ok,
                   valid, counts):
    """One plan's preagg reduce + consolidate + counters for a given sample."""
    stats = _accumulate_columns(plan, cfg, cols, sidx, mask, table.num_slots, counts)
    n_sampled = torch.sum(mask, dtype=torch.int32)
    return _consolidate(stats, n_sampled, ok, valid, counts)


def _consolidate(stats, n_sampled, ok, valid, counts):
    """Shared tail of every preagg path: the sample/validity/overflow
    counters (one edge node, so there is no collective to run)."""
    n_valid = torch.sum(ok, dtype=torch.int32)
    n_overflow = counts[-1] + torch.sum(valid & ~ok, dtype=torch.int32)
    return stats, n_sampled, n_valid, n_overflow


class EdgeCloudPipeline:
    """Single-node query engine on one device (CUDA unless named)."""

    def __init__(self, table: StratumTable, config: PipelineConfig = PipelineConfig(),
                 device=None):
        self.device = resolve_device(device)
        self.table = table.to(self.device)
        self.config = config
        self._plans: dict[Query, Plan] = {}

    def plan(self, query: Query) -> Plan:
        """Lower (and cache) a query against this pipeline's stratum table."""
        p = self._plans.get(query)
        if p is None:
            if query.mode != "preagg":
                raise NotImplementedError(
                    "mode='raw' arrives with the raw-mode slice of the port"
                )
            p = aqp.lower(query, self.table)
            self._plans[query] = p
        return p

    def _window_arrays(self, window, plan: Plan):
        """Host-side: split a WindowBatch / mapping into device tensors."""
        if isinstance(window, WindowBatch):
            cols = window.columns
            lat, lon, valid = window.lat, window.lon, window.valid
        else:
            cols = {k: v for k, v in window.items() if k not in ("lat", "lon", "valid")}
            lat, lon = window["lat"], window["lon"]
            valid = window.get("valid")
        missing = [c for c in plan.columns if c not in cols]
        if missing:
            raise KeyError(f"window has no column(s) {missing}; available: {sorted(cols)}")
        lat = self._tensor(lat, torch.float32)
        lon = self._tensor(lon, torch.float32)
        if valid is None:
            valid = torch.ones(lat.shape, dtype=torch.bool, device=self.device)
        else:
            valid = self._tensor(valid, torch.bool)
        cols = {c: self._tensor(cols[c], torch.float32) for c in plan.columns}
        return lat, lon, cols, valid

    def _tensor(self, x, dtype) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=dtype).contiguous()
        # np.array copies, so read-only host buffers convert without a warning
        return torch.as_tensor(np.array(x), device=self.device).to(dtype).contiguous()

    def execute(self, query: Query, generator: torch.Generator | None, window, fraction=1.0,
                *, uniforms=None) -> QueryResult:
        """Evaluate a declarative query over one window on one edge node.

        ``window`` is a :class:`WindowBatch` or a mapping with ``lat``,
        ``lon``, optional ``valid``, and one array per referenced column.
        The window's ``(N,)`` uniforms come from ``torch.rand`` with
        ``generator`` (a generator on the pipeline's device, or None for the
        default one) unless ``uniforms`` supplies them.
        """
        plan = self.plan(query)
        lat, lon, cols, valid = self._window_arrays(window, plan)
        n = lat.shape[0]
        if uniforms is None:
            u = torch.rand(n, generator=generator, device=self.device)
        else:
            u = self._tensor(uniforms, torch.float32)
            if u.shape != (n,):
                raise ValueError(f"uniforms must have shape ({n},); got {tuple(u.shape)}")
        stats, n_sampled, n_valid, n_overflow, n_truncated, comm = _edge_program(
            plan, self.table, self.config, u, lat, lon, cols, valid, fraction
        )
        return QueryResult(
            estimates=aqp.finalize(plan, self.table, stats),
            stats=stats,
            n_sampled=n_sampled,
            n_valid=n_valid,
            n_overflow=n_overflow,
            n_truncated=n_truncated,
            comm_bytes=comm,
            n_dropped=int(getattr(window, "n_dropped", 0)),
        )
