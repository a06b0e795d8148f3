"""EdgeApproxGeo query engine (paper Algorithm 2).

A query is lowered (``query.lower``) into the two halves of the edge-cloud
split:

Edge tier  = stratify + EdgeSOS-sample the local window, then reduce every
             column the query references to its plan-declared mergeable
             per-stratum accumulator states.  The moment reductions run on
             ``PipelineConfig.backend``:

               * ``"segment"`` — per-column segment sums in a fixed order
                 (``estimators.segment_sum``; the portable path and the
                 parity oracle);
               * ``"pallas"``  — one multi-column pass through the
                 edge_reduce kernel, with geohash encode and Bernoulli
                 selection through their kernels too;
               * ``"fused"``   — the edge megakernel: membership, threshold
                 sampling and every moment / extrema / sketch row in one
                 pass (SRS keeps its rank sort outside the kernel).
             The CUDA kernels run on a CUDA device, their plain versions on
             the CPU.  The names are the reference package's, so one config
             selects the kernel path in both.
Cloud tier = finalize each aggregate into an ``AggEstimate`` with error
             bounds, optionally grouped by stratum / neighborhood.

Two transmission modes (paper §3.6.4), chosen per query:
  * ``preagg`` — the edge ships per-stratum accumulator states, O(S ·
    columns) floats; with ``PipelineConfig.uplink_codec`` set they cross
    through that wire codec (:mod:`.codec`) and the cloud finalizes the
    decoded states;
  * ``raw`` — the edge compacts its kept tuples into a static
    ``raw_capacity`` buffer (:func:`~.sampling.compact`) and the cloud
    accumulates the buffer on the same backend; kept tuples beyond the
    buffer are counted in ``n_truncated``.

Entry points: ``execute`` (one query, one window); the edge and cloud
halves a :class:`~.session.StreamSession` composes (``_pass_fn``,
``_refined_pass_fn`` and ``finalize_fn``, cached on
the pipeline and counted in ``cache_stats``); the legacy
``process_window`` and ``run_stream`` shims.

Randomness: one ``(N,)`` uniform vector decides the whole sample (the SRS
rank draw and the Bernoulli draw read the same vector, as in the reference
package, where both read ``jax.random.uniform`` from one key).
``execute`` draws it with ``torch.rand`` from the caller's generator, or
takes it from ``uniforms=``; the bootstrap's normals follow from the same
generator (``query.bootstrap_normals``), or from ``normals=``.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple

import numpy as np
import torch

from . import codec as wirecodec
from . import estimators, feedback, sampling
from . import query as aqp
from .estimators import Estimate, StratumStats
from .query import AggSpec, Plan, Query, QueryResult
from .sampling import SampleResult
from .stratify import StratumTable, resolve_device
from .transfer import to_device
from .windows import WindowBatch

BACKENDS = ("segment", "pallas", "fused")

STAGING_DTYPES = ("float32", "bfloat16")

# registry kinds the megakernel emits stat rows for in one pass; plans
# referencing any other kind keep the per-kind accumulate path for it
_FUSED_STAT_KINDS = frozenset({"moments", "extrema", "sketch"})


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Deployment-level defaults; per-query settings live on ``Query``.

    ``backend`` selects the edge reduction implementation: ``"segment"``
    (per-column reductions), ``"pallas"`` (the edge_reduce kernel path) or
    ``"fused"`` (the edge megakernel).  ``staging_dtype`` (fused backend
    only) is the dtype value columns are staged in on their way into the
    megakernel: ``"bfloat16"`` halves their traffic; accumulation stays f32.
    ``raw_capacity`` is the static per-node tuple buffer of raw mode (the
    window size when None).  ``uplink_codec`` selects the preagg wire
    format (:mod:`.codec`): None ships the dense analytic payload;
    ``"sparse"``, ``"topk<k>"``, ``"quantize16"``, ``"quantize8"`` or
    ``"delta"`` route every preagg frame through that codec, estimates
    finalize from the decoded states, and ``comm_bytes`` reports the
    measured encoded bytes.  Raw-mode queries are untouched by the codec.
    """

    method: str = "srs"  # srs | bernoulli | neyman
    mode: str = "preagg"  # preagg | raw (legacy-API default)
    confidence: float = 0.95
    raw_capacity: int | None = None
    backend: str = "segment"
    staging_dtype: str = "float32"
    uplink_codec: str | None = None

    def __post_init__(self):
        wirecodec.resolve_codec(self.uplink_codec)  # fail fast on bad specs
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}; got {self.backend!r}")
        if self.staging_dtype not in STAGING_DTYPES:
            raise ValueError(
                f"staging_dtype must be one of {STAGING_DTYPES}; got {self.staging_dtype!r}"
            )
        if self.staging_dtype != "float32" and self.backend != "fused":
            raise ValueError(
                "staging_dtype is a fused-backend knob: reduced-precision staging "
                "requires backend='fused' (accumulation stays f32 on every backend)"
            )
        if self.mode not in ("preagg", "raw"):
            raise ValueError(f"unknown mode {self.mode!r}")


class WindowResult(NamedTuple):
    """Output of the legacy single-estimate API (``process_window``)."""

    estimate: Estimate
    stats: StratumStats
    n_sampled: torch.Tensor
    n_valid: torch.Tensor
    n_overflow: torch.Tensor  # tuples outside the region of interest
    comm_bytes: torch.Tensor  # analytic edge->cloud payload of this mode


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
    edge_reduce pass; with ``"fused"`` the given sample's moment, extrema and
    sketch rows come from one megakernel pass (sidx mode, keep == mask via
    zero scores against unit thresholds); on ``"segment"`` from per-column
    reductions.  Kinds outside those accumulate through their registry
    entries."""
    kinds_map = plan.column_kind_map
    stats: dict = {c: {} for c in plan.columns}
    if cfg.backend == "pallas":
        from ..kernels.edge_reduce import edge_reduce

        stacked = torch.stack([cols[c] for c in plan.columns])
        cnt, s1, s2 = edge_reduce(sidx, stacked, mask, num_slots)
        for i, c in enumerate(plan.columns):
            stats[c]["moments"] = estimators.MOMENTS.from_kernel_rows(cnt, s1[i], s2[i], counts)
    elif cfg.backend == "fused":
        from ..kernels.edge_megakernel import edge_megakernel

        ext_idx, sk_idx = _kernel_layout(plan.columns, kinds_map)
        dev = mask.device
        res = edge_megakernel(
            _stack_staged(cfg, plan.columns, cols),
            mask[None],
            torch.zeros((1, mask.shape[0]), dtype=torch.float32, device=dev),
            torch.ones((1, num_slots), dtype=torch.float32, device=dev),
            num_slots,
            sidx=sidx[None],
            ext_idx=ext_idx,
            sk_idx=sk_idx,
        )
        stats = _stats_from_mega(
            plan.columns, kinds_map, res, 0, res.keep[0], counts, plan.columns, ext_idx, sk_idx
        )
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


def _plan_fusable(plan: Plan) -> bool:
    """True when every referenced kind has megakernel stat rows: the
    condition for serving the plan from the single-traversal pass."""
    kinds_map = plan.column_kind_map
    return all(set(kinds_map[c]) <= _FUSED_STAT_KINDS for c in plan.columns)


def _kernel_layout(columns, kinds_map) -> tuple[tuple, tuple]:
    """Column positions that get extrema / sketch rows in the megakernel."""
    ext_idx = tuple(i for i, c in enumerate(columns) if "extrema" in kinds_map.get(c, ()))
    sk_idx = tuple(i for i, c in enumerate(columns) if "sketch" in kinds_map.get(c, ()))
    return ext_idx, sk_idx


def _stack_staged(cfg: PipelineConfig, columns, cols) -> torch.Tensor:
    """Stack value columns in the configured staging dtype (fused backend)."""
    dt = torch.bfloat16 if cfg.staging_dtype == "bfloat16" else torch.float32
    return torch.stack([cols[c] for c in columns]).to(dt).contiguous()


def _stats_from_mega(columns, kinds_map, res, m, keep, counts, union_cols, ext_idx, sk_idx) -> dict:
    """Adopt member ``m``'s megakernel stat rows into registry states.

    ``columns`` is the member's own column list; positions resolve against
    ``union_cols`` (the kernel's value-column layout, a superset for refined
    fused groups).  ``keep`` is the per-slot kept-count row to use as the
    moment count (callers patch latlon-mode overflow residuals in first)."""
    pos = {c: i for i, c in enumerate(union_cols)}
    e_pos = {i: e for e, i in enumerate(ext_idx)}
    k_pos = {i: k for k, i in enumerate(sk_idx)}
    stats: dict = {}
    for c in columns:
        i = pos[c]
        d = {"moments": estimators.MOMENTS.from_kernel_rows(keep, res.s1[m, i], res.s2[m, i], counts)}
        for kind in kinds_map.get(c, ()):
            if kind == "extrema":
                d[kind] = estimators.EXTREMA.from_kernel_rows(
                    res.mins[m, e_pos[i]], res.maxs[m, e_pos[i]]
                )
            elif kind == "sketch":
                d[kind] = estimators.SKETCH.from_kernel_rows(res.bins[m, k_pos[i]])
        stats[c] = d
    return stats


def _add_to_last(x: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """``x`` with ``delta`` added to its last (overflow) slot."""
    return torch.cat([x[:-1], (x[-1] + delta).reshape(1).to(x.dtype)])


def _edge_program(plan: Plan, table: StratumTable, cfg: PipelineConfig, u, lat, lon, cols,
                  valid, fraction):
    """The lowered edge half of a plan on one edge node.

    Returns ``(stats, n_sampled, n_valid, n_overflow, n_truncated,
    comm_bytes)`` where ``stats`` maps column -> ``{kind: state}``."""
    q = plan.query
    dev = lat.device
    ok = valid & aqp.roi_mask(plan, table, lat, lon)
    if (
        cfg.backend == "fused"
        and q.mode != "raw"
        and _plan_fusable(plan)
        and q.method in ("srs", "bernoulli")
        # latlon-mode overflow residuals need a scalar threshold; a
        # per-stratum Bernoulli fraction falls back to the two-pass path
        and (q.method == "srs" or np.ndim(fraction) == 0)
    ):
        stats, n_sampled, n_valid, n_overflow = _fused_member_program(
            plan, table, cfg, u, lat, lon, cols, ok, valid, fraction
        )
        comm = _int32(aqp.preagg_bytes(plan, table.num_slots), dev)
        return stats, n_sampled, n_valid, n_overflow, _int32(0, dev), comm
    sidx, sample = edge_sample(u, table, lat, lon, ok, fraction, q.method, backend=cfg.backend)
    if q.mode == "raw":
        n = lat.shape[0]
        cap = cfg.raw_capacity or n
        v_ok, v_sidx, *packed = sampling.compact(
            sample.mask, cap, sidx, *[cols[c] for c in plan.columns]
        )
        # kept tuples beyond the static buffer are shed by compact();
        # account for them so the result surfaces the loss
        n_sampled = torch.sum(sample.mask, dtype=torch.int32)
        n_truncated = torch.clamp_min(n_sampled - min(cap, n), 0)
        gathered = dict(zip(plan.columns, packed))
        stats = _accumulate_columns(
            plan, cfg, gathered, v_sidx, v_ok, table.num_slots, sample.counts
        )
        _, _, n_valid, n_overflow = _consolidate(stats, n_sampled, ok, valid, sample.counts)
        comm = _int32(aqp.raw_bytes(plan, cap), dev)
        return stats, n_sampled, n_valid, n_overflow, n_truncated, comm
    stats, n_sampled, n_valid, n_overflow = _member_reduce(
        plan, table, cfg, cols, sidx, sample.mask, ok, valid, sample.counts
    )
    comm = _int32(aqp.preagg_bytes(plan, table.num_slots), dev)
    return stats, n_sampled, n_valid, n_overflow, _int32(0, dev), comm


def _int32(x: int, device) -> torch.Tensor:
    return torch.full((), x, dtype=torch.int32, device=device)


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


def _fused_member_program(plan: Plan, table: StratumTable, cfg: PipelineConfig, u, lat, lon,
                          cols, ok, valid, fraction):
    """One plan's preagg reduce as a single megakernel traversal.

    The kernel's threshold compare reproduces EdgeSOS sampling decision for
    decision while it emits every fused stat row:

      * ``bernoulli``: the window's uniforms are the scores and the scalar
        fraction the per-slot threshold; membership resolves in the kernel
        from lat/lon against the code table (latlon mode).  Tuples outside
        the table land in no slot: their stat rows stay zero (the query
        layer zeroes overflow before estimating) and the overflow counts
        are rebuilt as residuals against direct sums.
      * ``srs``: exact ranks need the per-stratum sort, so stratify and
        :func:`~.sampling.srs_ranks` run outside; ranks against ``n_k`` is
        the in-kernel compare (exact in f32 below 2**24), and sidx mode
        covers every slot, overflow included.
    """
    from ..kernels.edge_megakernel import edge_megakernel

    q = plan.query
    slots = table.num_slots
    kinds_map = plan.column_kind_map
    ext_idx, sk_idx = _kernel_layout(plan.columns, kinds_map)
    vals = _stack_staged(cfg, plan.columns, cols)
    if q.method == "bernoulli":
        frac = to_device(fraction, torch.float32, u.device)
        thr = frac.expand(1, slots).contiguous()
        res = edge_megakernel(
            vals, ok[None], u[None], thr, slots,
            lat=lat, lon=lon, codes=table.codes, precision=table.precision,
            ext_idx=ext_idx, sk_idx=sk_idx,
        )
        n_sampled = torch.sum(ok & (u < frac), dtype=torch.int32)
        counts = res.pop[0].to(torch.int32)
        counts = _add_to_last(counts, torch.sum(ok, dtype=torch.int32) - torch.sum(counts))
        keep = _add_to_last(res.keep[0], n_sampled.to(torch.float32) - torch.sum(res.keep[0]))
    else:
        sidx = torch.where(ok, table.assign(lat, lon, backend=cfg.backend), table.num_strata)
        ranks, counts_all = sampling.srs_ranks(u, sidx, slots)
        n_k = sampling.allocate_proportional(counts_all, fraction)
        res = edge_megakernel(
            vals, ok[None], ranks.to(torch.float32)[None], n_k.to(torch.float32)[None], slots,
            sidx=sidx[None], ext_idx=ext_idx, sk_idx=sk_idx,
        )
        counts = res.pop[0].to(torch.int32)
        keep = res.keep[0]
        n_sampled = torch.sum(keep).to(torch.int32)
    stats = _stats_from_mega(
        plan.columns, kinds_map, res, 0, keep, counts, plan.columns, ext_idx, sk_idx
    )
    return _consolidate(stats, n_sampled, ok, valid, counts)


def _fused_edge_program(fused: aqp.FusedPlan, table: StratumTable, cfg: PipelineConfig, u, lat,
                        lon, cols: Mapping[str, torch.Tensor], valid, fractions):
    """The refined fused edge pass: per-member nested samples from one
    shared stratify and one shared uniform draw ``u`` (preagg mode).

    Each member keeps the shared sample thinned to its own fraction and,
    for Bernoulli groups, masked to its own ROI:

      * ``srs`` groups share the per-stratum random ranks: member m keeps
        ``ranks < n_k(fractions[m])``, exactly the SRS its own ``execute``
        draws from the same uniforms, nested inside the group-max sample;
        ``neyman`` is refused (its allocation needs per-stratum stddev);
      * ``bernoulli`` groups share the uniforms: member m keeps
        ``u < fractions[m]`` within its own ROI, so differing-ROI members
        fuse into this one pass.

    Returns ``(members_out, comm)`` with ``members_out[m] = (stats,
    n_sampled, n_valid, n_overflow)``.
    """
    shared = fused.shared
    q = shared.query
    if q.method not in ("srs", "bernoulli"):
        raise NotImplementedError(
            f"refined fused pass supports srs|bernoulli members, not {q.method!r}; neyman "
            "allocation needs per-stratum stddev threading"
        )
    fractions = to_device(fractions, torch.float32, u.device)
    if cfg.backend == "fused" and all(_plan_fusable(p) for p in fused.members):
        return _fused_refined_mega(fused, table, cfg, u, lat, lon, cols, valid, fractions)
    slots = table.num_slots
    sidx_raw = table.assign(lat, lon, backend=cfg.backend)
    members_out = []
    if q.method == "bernoulli":
        for m, plan_m in enumerate(fused.members):
            ok = valid & aqp.roi_mask(plan_m, table, lat, lon)
            sidx = torch.where(ok, sidx_raw, table.num_strata)
            mask = (u < fractions[m]) & ok
            counts = sampling.segment_count(sidx, ok, slots)
            members_out.append(
                _member_reduce(plan_m, table, cfg, cols, sidx, mask, ok, valid, counts)
            )
    else:
        ok = valid & aqp.roi_mask(shared, table, lat, lon)
        sidx = torch.where(ok, sidx_raw, table.num_strata)
        ranks, counts_all = sampling.srs_ranks(u, sidx, slots)
        counts = sampling.segment_count(sidx, ok, slots)
        for m, plan_m in enumerate(fused.members):
            # allocation over the raw per-slot counts, as edgesos does
            n_k = sampling.allocate_proportional(counts_all, fractions[m])
            mask = (ranks < n_k[sidx]) & ok
            members_out.append(
                _member_reduce(plan_m, table, cfg, cols, sidx, mask, ok, valid, counts)
            )
    return tuple(members_out), aqp.refined_preagg_bytes(fused, slots)


def _fused_refined_mega(fused: aqp.FusedPlan, table: StratumTable, cfg: PipelineConfig, u, lat,
                        lon, cols, valid, fractions):
    """The refined fused pass as one megakernel traversal for all members.

    The kernel's member axis carries the per-member thresholds (Bernoulli:
    each member's fraction; SRS: each member's ``n_k`` allocation) and, for
    Bernoulli groups, each member's ROI mask, so the window's value columns
    are read once for the whole group.  Sampling matches
    :func:`_fused_edge_program`'s two-pass body decision for decision;
    Bernoulli runs in latlon mode with the overflow-residual reconstruction
    of :func:`_fused_member_program`."""
    from ..kernels.edge_megakernel import edge_megakernel

    shared = fused.shared
    q = shared.query
    slots = table.num_slots
    members = fused.members
    m_count = len(members)
    n = u.shape[0]
    # union value-column layout: every member's stats slice out of one pass
    union_cols: list = []
    union_kinds: dict = {}
    for p in members:
        for c in p.columns:
            if c not in union_kinds:
                union_cols.append(c)
                union_kinds[c] = set()
            union_kinds[c] |= set(p.column_kind_map[c])
    ext_idx, sk_idx = _kernel_layout(union_cols, union_kinds)
    vals = _stack_staged(cfg, union_cols, cols)
    members_out = []
    if q.method == "bernoulli":
        ok_m = torch.stack([valid & aqp.roi_mask(p, table, lat, lon) for p in members])
        thr = fractions[:, None].expand(m_count, slots).contiguous()
        res = edge_megakernel(
            vals, ok_m, u[None].expand(m_count, n), thr, slots,
            lat=lat, lon=lon, codes=table.codes, precision=table.precision,
            ext_idx=ext_idx, sk_idx=sk_idx,
        )
        for m, plan_m in enumerate(members):
            ok = ok_m[m]
            n_sampled = torch.sum(ok & (u < fractions[m]), dtype=torch.int32)
            counts = res.pop[m].to(torch.int32)
            counts = _add_to_last(counts, torch.sum(ok, dtype=torch.int32) - torch.sum(counts))
            keep = _add_to_last(res.keep[m], n_sampled.to(torch.float32) - torch.sum(res.keep[m]))
            stats = _stats_from_mega(plan_m.columns, plan_m.column_kind_map, res, m, keep, counts,
                                     union_cols, ext_idx, sk_idx)
            members_out.append(_consolidate(stats, n_sampled, ok, valid, counts))
    else:  # srs: shared ROI + stratify + ranks, per-member n_k thresholds
        ok = valid & aqp.roi_mask(shared, table, lat, lon)
        sidx = torch.where(ok, table.assign(lat, lon, backend=cfg.backend), table.num_strata)
        ranks, counts_all = sampling.srs_ranks(u, sidx, slots)
        thr = torch.stack([
            sampling.allocate_proportional(counts_all, fractions[m]).to(torch.float32)
            for m in range(m_count)
        ])
        res = edge_megakernel(
            vals, ok[None].expand(m_count, n), ranks.to(torch.float32)[None].expand(m_count, n),
            thr, slots, sidx=sidx[None].expand(m_count, n), ext_idx=ext_idx, sk_idx=sk_idx,
        )
        for m, plan_m in enumerate(members):
            counts = res.pop[m].to(torch.int32)
            n_sampled = torch.sum(res.keep[m]).to(torch.int32)
            stats = _stats_from_mega(plan_m.columns, plan_m.column_kind_map, res, m, res.keep[m],
                                     counts, union_cols, ext_idx, sk_idx)
            members_out.append(_consolidate(stats, n_sampled, ok, valid, counts))
    return tuple(members_out), aqp.refined_preagg_bytes(fused, slots)


class EdgeCloudPipeline:
    """Single-node query engine on one device (CUDA unless named).

    Besides ``execute`` it holds the edge and cloud halves a
    :class:`~.session.StreamSession` runs per pane, as programs cached by
    plan (edge passes) and by finalize signature (emits), so sessions over
    one pipeline share them.  ``cache_stats`` counts, per family, the
    programs built (misses) and reused (hits)."""

    def __init__(self, table: StratumTable, config: PipelineConfig = PipelineConfig(),
                 device=None):
        self.device = resolve_device(device)
        self.table = table.to(self.device)
        self.config = config
        # the resolved wire codec spec (None: dense analytic payload); a
        # stateful codec (delta) hands out per-stream instances via
        # for_stream(), so this is never a live stream state
        self.codec_spec = wirecodec.resolve_codec(config.uplink_codec)
        self._plans: dict[Query, Plan] = {}
        self._passes: dict[Plan, callable] = {}
        self._refined_passes: dict[tuple, callable] = {}
        self._finalizers: dict[tuple, callable] = {}
        self.cache_stats: dict[str, dict[str, int]] = {
            f: {"hits": 0, "misses": 0}
            for f in ("plan", "pass", "refined_pass", "finalize")
        }

    def _cache_event(self, family: str, hit: bool) -> None:
        self.cache_stats[family]["hits" if hit else "misses"] += 1

    @property
    def compile_count(self) -> int:
        """Distinct programs built across the program families (``plan``
        lowerings excluded).  The churn contract: this must not move while
        tenants register and unregister queries of shapes already seen."""
        return sum(v["misses"] for f, v in self.cache_stats.items() if f != "plan")

    def cache_snapshot(self) -> dict:
        """Copy of the per-family hit/miss counters plus ``compile_count``."""
        return {
            "families": {f: dict(v) for f, v in self.cache_stats.items()},
            "compile_count": self.compile_count,
        }

    def plan(self, query: Query) -> Plan:
        """Lower (and cache) a query against this pipeline's stratum table."""
        p = self._plans.get(query)
        self._cache_event("plan", p is not None)
        if p is None:
            p = aqp.lower(query, self.table)
            self._plans[query] = p
        return p

    # -- programs (edge passes and cloud emits) -----------------------------

    def _pass_fn(self, plan: Plan):
        """The edge pass of a lowered plan: ``(u, lat, lon, cols, valid,
        fraction) -> (stats, n_sampled, n_valid, n_overflow, n_truncated,
        comm_bytes)``, stratify + EdgeSOS + accumulate without finalize.
        ``execute`` runs it before finalize; a session runs it once per
        fusion group and pane."""
        fn = self._passes.get(plan)
        self._cache_event("pass", fn is not None)
        if fn is None:
            table, cfg = self.table, self.config

            def fn(u, lat, lon, cols, valid, fraction):
                return _edge_program(plan, table, cfg, u, lat, lon, cols, valid, fraction)

            self._passes[plan] = fn
        return fn

    def _refined_pass_fn(self, fused: aqp.FusedPlan):
        """The refined fused pass of a group: ``(u, lat, lon, cols, valid,
        fractions) -> (members_out, comm)`` (see :func:`_fused_edge_program`),
        fractions a per-member vector, so drifting fractions reuse it."""
        fn = self._refined_passes.get(fused.members)
        self._cache_event("refined_pass", fn is not None)
        if fn is None:
            table, cfg = self.table, self.config

            def fn(u, lat, lon, cols, valid, fractions):
                return _fused_edge_program(fused, table, cfg, u, lat, lon, cols, valid, fractions)

            self._refined_passes[fused.members] = fn
        return fn

    def finalize_fn(self, plan: Plan, num_panes: int):
        """The cloud-side emit of one registration: ``(stats, normals) ->
        (estimates, merged)``, merging ``num_panes`` stacked pane states
        (pass-through for one pane, so a one-pane window finalizes
        ``execute``'s bits) and finalizing with the given bootstrap draws.
        Cached by finalize signature: queries that differ only in sampling
        method, mode or ROI share one program (finalize never reads those)."""
        key = (aqp.finalize_signature(plan), num_panes)
        fn = self._finalizers.get(key)
        self._cache_event("finalize", fn is not None)
        if fn is None:
            table = self.table

            def fn(stats, normals):
                if num_panes > 1:
                    stats = {c: estimators.merge_accs_panes(stats[c]) for c in plan.columns}
                return aqp.finalize(plan, table, stats, normals=normals), stats

            self._finalizers[key] = fn
        return fn

    # -- inputs --------------------------------------------------------------

    def _window_arrays(self, window, columns):
        """Host-side: split a WindowBatch / mapping into device tensors of
        ``lat``, ``lon``, ``valid`` and the named value ``columns``."""
        if isinstance(window, WindowBatch):
            cols = window.columns
            lat, lon, valid = window.lat, window.lon, window.valid
        else:
            cols = {k: v for k, v in window.items() if k not in ("lat", "lon", "valid")}
            lat, lon = window["lat"], window["lon"]
            valid = window.get("valid")
        missing = [c for c in columns if c not in cols]
        if missing:
            raise KeyError(f"window has no column(s) {missing}; available: {sorted(cols)}")
        lat = self._tensor(lat, torch.float32)
        lon = self._tensor(lon, torch.float32)
        if valid is None:
            valid = torch.ones(lat.shape, dtype=torch.bool, device=self.device)
        else:
            valid = self._tensor(valid, torch.bool)
        cols = {c: self._tensor(cols[c], torch.float32) for c in columns}
        return lat, lon, cols, valid

    def _tensor(self, x, dtype) -> torch.Tensor:
        return to_device(x, dtype, self.device).contiguous()

    def _uniforms(self, generator, n: int, uniforms) -> torch.Tensor:
        if uniforms is None:
            return torch.rand(n, generator=generator, device=self.device)
        u = self._tensor(uniforms, torch.float32)
        if u.shape != (n,):
            raise ValueError(f"uniforms must have shape ({n},); got {tuple(u.shape)}")
        return u

    # -- declarative query API -----------------------------------------------

    def execute(self, query: Query, generator: torch.Generator | None, window, fraction=1.0,
                *, uniforms=None, normals=None) -> QueryResult:
        """Evaluate a declarative query over one window on one edge node.

        ``window`` is a :class:`WindowBatch` or a mapping with ``lat``,
        ``lon``, optional ``valid``, and one array per referenced column.
        The window's ``(N,)`` uniforms come from ``torch.rand`` with
        ``generator`` (a generator on the pipeline's device, or None for the
        default one) unless ``uniforms`` supplies them; the bootstrap's
        normals then come from the same generator, in the order of
        :func:`~.query.bootstrap_normals`, unless ``normals`` supplies them.

        With an uplink codec, a preagg query's consolidated states cross
        the codec once (a fresh stream, so a delta codec sends a keyframe)
        and finalize from the decoded states with the same draws, so a
        lossless codec gives the dense estimates bit for bit;
        ``comm_bytes`` is then the frame's measured bytes (a host int).
        """
        plan = self.plan(query)
        lat, lon, cols, valid = self._window_arrays(window, plan.columns)
        u = self._uniforms(generator, lat.shape[0], uniforms)
        stats, n_sampled, n_valid, n_overflow, n_truncated, comm = self._pass_fn(plan)(
            u, lat, lon, cols, valid, fraction
        )
        if self.codec_spec is not None and query.mode == "preagg":
            stats, comm = wirecodec.roundtrip(self.codec_spec.for_stream(), stats)
        return QueryResult(
            estimates=aqp.finalize(plan, self.table, stats, generator, normals=normals),
            stats=stats,
            n_sampled=n_sampled,
            n_valid=n_valid,
            n_overflow=n_overflow,
            n_truncated=n_truncated,
            comm_bytes=comm,
            n_dropped=int(getattr(window, "n_dropped", 0)),
        )

    def refined_pass(self, fused: aqp.FusedPlan, generator: torch.Generator | None, window,
                     fractions, *, uniforms=None):
        """The refined fused edge pass of a fusion group over one window:
        ``(members_out, comm_bytes)`` with ``members_out[m] = (stats,
        n_sampled, n_valid, n_overflow)`` for member ``m`` at
        ``fractions[m]`` (see :func:`_fused_edge_program`).  Each member's
        states finalize with ``query.finalize(fused.members[m], ...)``."""
        lat, lon, cols, valid = self._window_arrays(window, fused.shared.columns)
        u = self._uniforms(generator, lat.shape[0], uniforms)
        return self._refined_pass_fn(fused)(u, lat, lon, cols, valid, fractions)

    # -- legacy single-estimate API (shim over the canonical query) ---------

    def _canonical_query(self) -> Query:
        """The fixed query the pre-query API answered: SUM/MEAN(value)."""
        return Query(
            aggs=(AggSpec("sum", "value"), AggSpec("mean", "value")),
            confidence=self.config.confidence,
            method=self.config.method,
        )

    def process_window(self, generator: torch.Generator | None, lat, lon, value, valid,
                       fraction, *, uniforms=None) -> WindowResult:
        """Legacy single-estimate API: the canonical query's edge program
        and the eq 5-10 estimate of ``value``."""
        plan = self.plan(self._canonical_query())
        window = {"lat": lat, "lon": lon, "value": value, "valid": valid}
        lat, lon, cols, valid = self._window_arrays(window, plan.columns)
        u = self._uniforms(generator, lat.shape[0], uniforms)
        stats, n_sampled, n_valid, n_overflow, _trunc, comm = self._pass_fn(plan)(
            u, lat, lon, cols, valid, fraction
        )
        base = stats["value"]["moments"]
        return WindowResult(
            estimate=estimators.estimate(estimators.zero_overflow_stats(base),
                                         self.config.confidence),
            stats=base,
            n_sampled=n_sampled,
            n_valid=n_valid,
            n_overflow=n_overflow,
            comm_bytes=comm,
        )

    def run_stream(self, windows, slo: feedback.SLO | None = None, initial_fraction: float = 0.8,
                   generator: torch.Generator | None = None, sharded: bool = False,
                   query: Query | None = None):
        """Process a stream of WindowBatch under the QoS feedback loop.

        With ``query`` set this is a thin shim over a single-query
        :class:`~.session.StreamSession` (one registered tumbling one-pane
        query, stepped with ``generator``); the controller tracks the
        query's first error-bounded aggregate.  Without it, the legacy loop
        over ``process_window`` with one host readback of the fractions at
        the end of the stream.  Returns ``(history, controller_state)``."""
        if sharded:
            raise NotImplementedError(
                "sharded streams arrive with the sharded-path slice of the port"
            )
        slo = slo or feedback.SLO()
        if query is not None:
            from .session import StreamSession  # session sits above pipeline

            sess = StreamSession(self, initial_fraction=initial_fraction)
            reg = sess.register(query, slo=slo)
            history = []
            for w in windows:
                step = sess.step(generator, w)
                history.append((step.results[reg.qid], step.fractions[reg.qid]))
            return history, sess.controller_state(reg)
        state = feedback.init_state(initial_fraction, self.device)
        history = []
        for w in windows:
            res = self.process_window(generator, w.lat, w.lon, w.value, w.valid, state.fraction)
            state = feedback.update(state, res.estimate.relative_error, res.n_valid, slo)
            history.append((res, state.fraction))
        # one host readback at the stream boundary instead of one per window
        fracs = torch.stack([f for _, f in history]).cpu().tolist() if history else []
        return [(res, f) for (res, _), f in zip(history, fracs)], state

