"""Declarative AQP query layer: specs lowered to edge/cloud plans.

A :class:`Query` is a declarative bundle of aggregates over named value
columns; :func:`lower` turns it into a :class:`Plan` with two halves:

  * an **edge partial-aggregation program** — stratify + EdgeSOS sample the
    local window, then reduce each referenced column to mergeable
    per-stratum accumulator states;
  * a **cloud finalize step** — evaluate each :class:`AggSpec` from the
    merged states into an :class:`AggEstimate`, optionally grouped by
    stratum or neighborhood.

Aggregate kinds and their error semantics:

  sum / mean   stratified estimators with eq 5-10 variance / CI / MoE;
  count        in-region population count — exact per window, MoE 0;
  var          plug-in population variance (within + between strata);
  min / max    sample extrema with one-sided order-statistic + Cantelli
               bounds;
  p<q>         quantiles from the mergeable per-stratum log-histogram
               sketch, Horvitz-Thompson-expanded per stratum (~4% value
               accuracy).

``var`` and ``p<q>`` take their confidence intervals from a stratified
bootstrap (:mod:`.bounds`) of ``Query.bootstrap_replicates`` replicates (0:
zero-width point estimates).  Its standard-normal draws come from a
``torch.Generator`` in the order :func:`bootstrap_normals` documents, or are
injected as ``finalize(..., normals=...)``.

Plans that share a sampling signature (:func:`fusion_key`) fuse into one
edge pass (:func:`fuse`).
"""

from __future__ import annotations

import dataclasses
import re
from typing import NamedTuple

import torch

from . import estimators, geohash
from .estimators import SKETCH_NUM_BINS, Groups, group_sum, z_value
from .stratify import StratumTable

KINDS = ("sum", "mean", "count", "min", "max", "var")
GROUP_KEYS = (None, "stratum", "neighborhood")
METHODS = ("srs", "bernoulli", "neyman")

# Registry accumulator kinds each aggregate kind needs on the edge.  Every
# column carries "moments" (n/total back coverage accounting and the
# Horvitz-Thompson expansion of the other kinds' finalizes).
ACCUMULATOR_KINDS: dict[str, tuple[str, ...]] = {
    "sum": ("moments",),
    "mean": ("moments",),
    "var": ("moments",),
    "count": ("moments",),
    "min": ("moments", "extrema"),
    "max": ("moments", "extrema"),
}

_QUANTILE_RE = re.compile(r"p(\d{1,2}(?:\.\d+)?)")


def quantile_of(kind: str) -> float | None:
    """The quantile in (0, 1) of a ``p<q>`` aggregate kind, else None."""
    m = _QUANTILE_RE.fullmatch(kind)
    if not m:
        return None
    q = float(m.group(1)) / 100.0
    return q if 0.0 < q < 1.0 else None


def agg_accumulator_kinds(kind: str) -> tuple[str, ...]:
    """Registry kinds an aggregate kind's edge program must accumulate."""
    if quantile_of(kind) is not None:
        return ("moments", "sketch")
    return ACCUMULATOR_KINDS[kind]


class AggSpec(NamedTuple):
    """One aggregate: ``kind`` over a named value column; ``name`` keys the
    result dict and defaults to ``"<kind>_<column>"``."""

    kind: str
    column: str = "value"
    name: str | None = None

    @property
    def key(self) -> str:
        return self.name or f"{self.kind}_{self.column}"


@dataclasses.dataclass(frozen=True)
class Query:
    """Declarative AQP query over one stream window.

    Attributes:
      aggs: the aggregates to evaluate (tuple of :class:`AggSpec`).
      group_by: ``None``, ``"stratum"`` or ``"neighborhood"``.
      roi: optional region of interest — a bbox
        ``((lat_lo, lat_hi), (lon_lo, lon_hi))`` or a geohash prefix string;
        tuples outside it land in the overflow slot (``n_overflow``).
      confidence: CI level for the stratified estimators.
      method: EdgeSOS sampling method (``srs | bernoulli | neyman``).
      mode: edge->cloud transmission mode (``preagg | raw``).
      bootstrap_replicates: replicate count of the bootstrap behind
        ``var``/``p<q>`` intervals (0: zero-width point estimates).

    Frozen and hashable, so a Query can key a plan cache.
    """

    aggs: tuple[AggSpec, ...]
    group_by: str | None = None
    roi: tuple | str | None = None
    confidence: float = 0.95
    method: str = "srs"
    mode: str = "preagg"
    bootstrap_replicates: int = 200

    def __post_init__(self):
        aggs = tuple(a if isinstance(a, AggSpec) else AggSpec(*a) for a in self.aggs)
        if not aggs:
            raise ValueError("Query needs at least one AggSpec")
        for a in aggs:
            if a.kind not in KINDS and quantile_of(a.kind) is None:
                raise ValueError(
                    f"unknown aggregate kind {a.kind!r}; choose from {KINDS} "
                    "or a quantile like 'p50'/'p99'"
                )
        keys = [a.key for a in aggs]
        if len(set(keys)) != len(keys):
            raise ValueError(f"duplicate aggregate keys: {keys}")
        object.__setattr__(self, "aggs", aggs)
        if self.group_by not in GROUP_KEYS:
            raise ValueError(f"group_by must be one of {GROUP_KEYS}")
        if self.method not in METHODS:
            raise ValueError(
                f"unknown sampling method {self.method!r}; choose from {'|'.join(METHODS)}"
            )
        if self.mode not in ("preagg", "raw"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if not isinstance(self.bootstrap_replicates, int) or self.bootstrap_replicates < 0:
            raise ValueError(
                f"bootstrap_replicates must be a non-negative int; got {self.bootstrap_replicates!r}"
            )
        if isinstance(self.roi, (list, tuple)):
            try:
                (a, b), (c, d) = self.roi
            except (TypeError, ValueError) as e:
                raise ValueError(
                    f"roi bbox must be ((lat_lo, lat_hi), (lon_lo, lon_hi)); got {self.roi!r}"
                ) from e
            object.__setattr__(self, "roi", ((float(a), float(b)), (float(c), float(d))))
        elif self.roi is not None and not isinstance(self.roi, str):
            raise ValueError(
                "roi must be None, a geohash-prefix string, or a bbox "
                f"((lat_lo, lat_hi), (lon_lo, lon_hi)); got {type(self.roi).__name__}"
            )


@dataclasses.dataclass(frozen=True)
class Plan:
    """A lowered Query: what the edge computes and how the cloud finalizes.

    Attributes:
      query: the source spec.
      columns: distinct value columns needing edge accumulators.
      accumulators: per aggregate key, the registry kinds its finalize reads.
      column_kinds: per referenced column, the union of registry kinds its
        aggregates need; the edge accumulates exactly these states.
      num_groups: result width (1 when ``group_by`` is None).
      roi_prefix_code: pre-parsed geohash code when ``roi`` is a prefix.
    """

    query: Query
    columns: tuple[str, ...]
    accumulators: tuple[tuple[str, tuple[str, ...]], ...]
    column_kinds: tuple[tuple[str, tuple[str, ...]], ...] = ()
    num_groups: int = 1
    roi_prefix_code: int | None = None

    @property
    def accumulator_map(self) -> dict[str, tuple[str, ...]]:
        return dict(self.accumulators)

    @property
    def column_kind_map(self) -> dict[str, tuple[str, ...]]:
        return dict(self.column_kinds)

    @property
    def extrema_columns(self) -> tuple[str, ...]:
        """Columns some min/max aggregate reads."""
        return tuple(c for c, kinds in self.column_kinds if "extrema" in kinds)

    @property
    def sketch_columns(self) -> tuple[str, ...]:
        """Columns some quantile aggregate reads."""
        return tuple(c for c, kinds in self.column_kinds if "sketch" in kinds)


def lower(query: Query, table: StratumTable) -> Plan:
    """Lower a declarative Query against a stratum table into a Plan."""
    columns = tuple(dict.fromkeys(a.column for a in query.aggs))
    accs = tuple((a.key, agg_accumulator_kinds(a.kind)) for a in query.aggs)
    column_kinds = tuple(
        (
            c,
            tuple(
                dict.fromkeys(
                    k for a in query.aggs if a.column == c for k in agg_accumulator_kinds(a.kind)
                )
            ),
        )
        for c in columns
    )
    if query.group_by == "stratum":
        num_groups = table.num_strata
    elif query.group_by == "neighborhood":
        num_groups = table.num_neighborhoods
    else:
        num_groups = 1
    prefix_code = None
    if isinstance(query.roi, str):
        if len(query.roi) > table.precision:
            raise ValueError(
                f"roi prefix {query.roi!r} is finer than the stratum grid "
                f"(precision {table.precision})"
            )
        prefix_code = int(geohash.from_strings([query.roi])[0])
    return Plan(
        query=query,
        columns=columns,
        accumulators=accs,
        column_kinds=column_kinds,
        num_groups=num_groups,
        roi_prefix_code=prefix_code,
    )


def fusion_key(plan: Plan) -> tuple:
    """Hashable sampling signature of a plan.

    Two plans with equal fusion keys draw identical sampling decisions from
    the same uniforms and fraction: the EdgeSOS mask depends only on the
    stratum membership of eligible tuples (method + ROI), and the uplink on
    the transmission mode.  Aggregates, columns, group-by and confidence
    only shape accumulation and finalize, which fuse freely.

    Bernoulli keep-decisions are per-tuple uniforms, independent of stratum
    membership and hence of any ROI, so differing-ROI Bernoulli preagg
    plans share one pass with per-member accumulation masks: the ROI drops
    out of their key.
    """
    q = plan.query
    if q.method == "bernoulli" and q.mode == "preagg":
        return (q.method, q.mode)
    return (q.method, q.mode, q.roi)


def finalize_signature(plan: Plan) -> tuple:
    """Hashable finalize signature of a plan: exactly the inputs
    :func:`finalize` reads (never the sampling method, mode or ROI), so
    plans with equal signatures run the same cloud-side program over
    same-shaped states."""
    q = plan.query
    return (
        q.aggs,
        q.group_by,
        q.confidence,
        q.bootstrap_replicates,
        plan.columns,
        plan.column_kinds,
        plan.num_groups,
    )


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    """A set of lowered queries served by one shared edge pass.

    ``shared`` is a carrier plan whose column / accumulator-kind sets are the
    unions over ``members``: its edge program produces every state any
    member's finalize reads."""

    members: tuple[Plan, ...]
    shared: Plan

    @property
    def columns(self) -> tuple[str, ...]:
        return self.shared.columns

    @property
    def extrema_columns(self) -> tuple[str, ...]:
        return self.shared.extrema_columns

    @property
    def mode(self) -> str:
        return self.shared.query.mode

    @property
    def cross_roi(self) -> bool:
        """True when members carry differing ROIs (Bernoulli cross-signature
        fusion): the carrier samples unfiltered and each member applies its
        own ROI as an accumulation mask in the refined edge program."""
        return len({p.query.roi for p in self.members}) > 1


def fuse(plans) -> FusedPlan:
    """Fuse lowered plans that share a sampling signature into one pass.

    Unions the referenced columns (order-preserving across members), the
    per-aggregate and the per-column accumulator kinds.  Raises
    ``ValueError`` when the fusion keys (:func:`fusion_key`) differ.
    Bernoulli preagg members may carry differing ROIs
    (:attr:`FusedPlan.cross_roi`)."""
    plans = tuple(plans)
    if not plans:
        raise ValueError("fuse needs at least one plan")
    keys = {fusion_key(p) for p in plans}
    if len(keys) != 1:
        raise ValueError(
            "cannot fuse plans with differing sampling signatures "
            f"(method, mode, roi): {sorted(keys, key=repr)}"
        )
    columns = tuple(dict.fromkeys(c for p in plans for c in p.columns))
    col_kinds: dict[str, tuple[str, ...]] = {c: () for c in columns}
    accs: dict[str, tuple[str, ...]] = {}
    for p in plans:
        for agg_key, kinds in p.accumulators:
            accs[agg_key] = tuple(dict.fromkeys(accs.get(agg_key, ()) + tuple(kinds)))
        for c, kinds in p.column_kinds:
            col_kinds[c] = tuple(dict.fromkeys(col_kinds[c] + tuple(kinds)))
    q0 = plans[0].query
    # a cross-ROI (Bernoulli) carrier samples unfiltered
    rois = {p.query.roi for p in plans}
    shared_roi, prefix_code = (
        (q0.roi, plans[0].roi_prefix_code) if len(rois) == 1 else (None, None)
    )
    carrier = Query(
        aggs=tuple(AggSpec("mean", c) for c in columns),
        roi=shared_roi,
        confidence=q0.confidence,
        method=q0.method,
        mode=q0.mode,
    )
    shared = Plan(
        query=carrier,
        columns=columns,
        accumulators=tuple(accs.items()),
        column_kinds=tuple(col_kinds.items()),
        num_groups=1,
        roi_prefix_code=prefix_code,
    )
    return FusedPlan(members=plans, shared=shared)


def roi_mask(plan: Plan, table: StratumTable, lat: torch.Tensor, lon: torch.Tensor) -> torch.Tensor:
    """Boolean in-region mask for the plan's ROI (all-True when unset)."""
    roi = plan.query.roi
    if roi is None:
        return torch.ones(lat.shape, dtype=torch.bool, device=lat.device)
    if isinstance(roi, str):
        code = geohash.encode(lat, lon, table.precision)
        return geohash.parent(code, table.precision, len(roi)) == plan.roi_prefix_code
    (lat_lo, lat_hi), (lon_lo, lon_hi) = roi
    return (lat >= lat_lo) & (lat <= lat_hi) & (lon >= lon_lo) & (lon <= lon_hi)


class AggEstimate(NamedTuple):
    """One finalized aggregate; scalars, or (num_groups,) when grouped.

    ``moe``/``ci_low``/``ci_high``/``relative_error`` are the error bounds;
    zero-width for the exact/point-estimate kinds.  ``n`` is the realized
    sample size and ``population`` the in-region window population."""

    value: torch.Tensor
    moe: torch.Tensor
    ci_low: torch.Tensor
    ci_high: torch.Tensor
    relative_error: torch.Tensor
    n: torch.Tensor
    population: torch.Tensor


class QueryResult(NamedTuple):
    """EdgeCloudPipeline.execute output: per-aggregate estimates + diagnostics."""

    estimates: dict  # agg key -> AggEstimate
    stats: dict  # column -> {kind: state} (overflow slot kept)
    n_sampled: torch.Tensor
    n_valid: torch.Tensor
    n_overflow: torch.Tensor
    n_truncated: torch.Tensor  # raw-mode kept tuples shed by the static buffer
    comm_bytes: torch.Tensor | int  # analytic payload of the plan's mode; with an
    # uplink codec the frame's measured encoded bytes (a host int)
    n_dropped: int = 0  # tuples the window shed upstream (bounded buffers)


def zero_overflow_column(accs: dict) -> dict:
    """Neutralize the overflow slot of one column's ``{kind: state}`` dict:
    additive fields -> 0, extrema -> ±inf."""
    return estimators.zero_overflow_accs(accs)


def _group_index(plan: Plan, table: StratumTable) -> Groups:
    """stratum slot -> group id; overflow maps to an extra discarded group."""
    s = table.num_strata
    if plan.query.group_by == "stratum":
        grp = torch.arange(s, dtype=torch.int32, device=table.device)
    else:
        grp = table.neighborhood[:s]
    tail = torch.full((1,), plan.num_groups, dtype=torch.int32, device=table.device)
    return estimators.groups_of(torch.cat([grp, tail]), plan.num_groups)


def _gsum(x: torch.Tensor, grp: Groups, num: int) -> torch.Tensor:
    """Strata (dim 0) -> groups, in a fixed order on every device."""
    return group_sum(x, grp, num, dim=0)


def _bounded_estimate(value, lo, hi, n_g, pop_g) -> AggEstimate:
    """Assemble an AggEstimate from a point estimate and a (lo, hi) CI.

    The interval is clamped to contain the point estimate; ``moe`` is the
    larger half-width and ``relative_error`` its ratio to |value| (0 for an
    exact zero-width interval, inf for an unbounded one or a zero value).
    A group with no sampled evidence (``n == 0``) reports an infinite
    relative error; a NaN point estimate (a quantile of an empty histogram)
    stays NaN with the interval pinned to (-inf, inf)."""
    novalue = torch.isnan(value)
    safe = torch.where(novalue, 0.0, value)
    lo = torch.minimum(torch.where(novalue, -torch.inf, lo), safe)
    hi = torch.maximum(torch.where(novalue, torch.inf, hi), safe)
    up = torch.where(hi == safe, 0.0, hi - safe)
    down = torch.where(lo == safe, 0.0, safe - lo)
    moe = torch.maximum(up, down)
    rel = torch.where(
        moe > 0,
        torch.where(
            torch.isfinite(safe) & (torch.abs(safe) > 0),
            moe / torch.clamp_min(torch.abs(safe), 1e-30),
            torch.inf,
        ),
        torch.zeros_like(moe),
    )
    rel = torch.where((n_g > 0) & ~novalue, rel, torch.inf)
    return AggEstimate(
        value=value, moe=moe, ci_low=lo, ci_high=hi, relative_error=rel, n=n_g, population=pop_g
    )


def normals_layout(plan: Plan, table: StratumTable, stats: dict[str, dict]) -> tuple:
    """The shapes of the bootstrap's standard-normal draws, in the fixed
    order :func:`finalize` consumes them: ``((agg_index, name, shape),
    ...)``.  For each aggregate in ``plan.query.aggs`` order, with ``R``
    replicates, ``S+1`` slots and ``W`` = ``(SKETCH_NUM_BINS,)``, or
    ``(num_groups, SKETCH_NUM_BINS)`` when grouped:

      * ``var``: ``"mean"`` (R, S+1), then ``"s2"`` (R, S+1), then, when the
        column's states carry a sketch, ``"sketch"`` (R, *W);
      * ``p<q>``: ``"sketch"`` (R, *W).

    Empty when ``bootstrap_replicates`` is 0.  Two plans with one layout
    take the same draws in a session step (as they take the same key in
    the reference package)."""
    q = plan.query
    r = q.bootstrap_replicates
    if r <= 0:
        return ()
    wb = (plan.num_groups, SKETCH_NUM_BINS) if q.group_by is not None else (SKETCH_NUM_BINS,)
    out = []
    for i, spec in enumerate(q.aggs):
        if spec.kind == "var":
            out += [(i, "mean", (r, table.num_slots)), (i, "s2", (r, table.num_slots))]
            if "sketch" in stats[spec.column]:
                out.append((i, "sketch", (r, *wb)))
        elif quantile_of(spec.kind) is not None:
            out.append((i, "sketch", (r, *wb)))
    return tuple(out)


def bootstrap_normals(plan: Plan, table: StratumTable, stats: dict[str, dict],
                      generator: torch.Generator | None = None) -> dict:
    """The bootstrap's standard-normal draws for every aggregate that takes
    them, as ``{agg_index: {name: tensor}}`` on the table's device: one
    ``torch.randn`` call on ``generator`` per entry of
    :func:`normals_layout`, in its order (no draws when
    ``bootstrap_replicates`` is 0)."""
    out: dict[int, dict[str, torch.Tensor]] = {}
    for i, name, shape in normals_layout(plan, table, stats):
        out.setdefault(i, {})[name] = torch.randn(shape, generator=generator, device=table.device)
    return out


def finalize(plan: Plan, table: StratumTable, stats: dict[str, dict],
             generator: torch.Generator | None = None, *, normals: dict | None = None) -> dict:
    """Cloud-side consolidation: merged accumulator states -> AggEstimates.

    ``stats`` maps each column to its ``{kind: state}`` registry dict; every
    AggSpec is evaluated, grouping strata into the plan's result groups.
    For ``group_by=None`` sum/mean evaluate :func:`estimators.estimate`.

    ``var`` and ``p<q>`` take bootstrap intervals (:mod:`.bounds`) from
    standard normals: ``normals`` as :func:`bootstrap_normals` lays them out,
    or, when None, drawn by :func:`bootstrap_normals` from ``generator``
    (None: PyTorch's default generator).  Group sums run in a fixed order,
    so the same states and draws give the same bits on every run.
    """
    q = plan.query
    grouped = q.group_by is not None
    num = plan.num_groups
    z = z_value(q.confidence, table.device)
    grp = _group_index(plan, table) if grouped else None
    replicates = q.bootstrap_replicates
    if normals is None:
        normals = bootstrap_normals(plan, table, stats, generator)

    out: dict[str, AggEstimate] = {}
    full_est: dict[str, estimators.Estimate] = {}
    zeroed = {c: zero_overflow_column(stats[c]) for c in plan.columns}
    for i, spec in enumerate(q.aggs):
        draws = {k: v.to(table.device) for k, v in normals.get(i, {}).items()}
        accs = zeroed[spec.column]
        cs = accs["moments"]
        n, N = cs.n, cs.total
        active = (n > 0) & (N > 0)
        if grouped:
            n_g = _gsum(n, grp, num)
            pop_g = _gsum(N, grp, num)
            covered_g = torch.clamp_min(_gsum(torch.where(active, N, 0.0), grp, num), 0.0)
        else:
            n_g = torch.sum(n)
            pop_g = torch.sum(N)
            covered_g = torch.sum(torch.where(active, N, 0.0))

        if spec.kind == "count":
            val = pop_g
            zero = torch.zeros_like(val)
            out[spec.key] = AggEstimate(
                value=val, moe=zero, ci_low=val, ci_high=val,
                relative_error=zero, n=n_g, population=pop_g,
            )
            continue

        qv = quantile_of(spec.kind)
        if qv is not None:
            # Horvitz-Thompson expansion: within a stratum every sampled
            # tuple carries the same weight N_k/n_k, so scaling stratum rows
            # expands the sample histogram to a population histogram
            w_k = torch.where(n > 0, N / torch.clamp_min(n, 1.0), 0.0)
            wb = w_k[:, None] * accs["sketch"].bins  # (S+1, NUM_BINS)
            wb_g = _gsum(wb, grp, num) if grouped else torch.sum(wb, 0)
            val = estimators.sketch_quantile(wb_g, qv)
            ci = estimators.accumulator("sketch").interval(
                accs["sketch"], spec.kind, cs, q=qv, confidence=q.confidence,
                normals=draws, replicates=replicates, grp=grp, num_groups=num,
            )
            if ci is None:
                ci = (val, val)
            out[spec.key] = _bounded_estimate(val, ci[0], ci[1], n_g, pop_g)
            continue

        if spec.kind in ("min", "max"):
            ext = accs["extrema"]
            field = ext.min if spec.kind == "min" else ext.max
            if grouped:
                fill = torch.inf if spec.kind == "min" else -torch.inf
                seg = torch.full((num + 1,), fill, dtype=field.dtype, device=field.device)
                red = "amin" if spec.kind == "min" else "amax"
                val = seg.scatter_reduce(0, grp.index.long(), field, reduce=red)[:num]
            else:
                val = torch.amin(field) if spec.kind == "min" else torch.amax(field)
            ci = estimators.accumulator("extrema").interval(
                ext, spec.kind, cs, confidence=q.confidence,
                replicates=replicates, grp=grp, num_groups=num,
            )
            if ci is None:
                ci = (val, val)
            out[spec.key] = _bounded_estimate(val, ci[0], ci[1], n_g, pop_g)
            continue

        if not grouped and spec.kind in ("sum", "mean"):
            est = full_est.get(spec.column)
            if est is None:
                est = estimators.estimate(cs, q.confidence)
                full_est[spec.column] = est
            if spec.kind == "sum":
                moe_s = z * torch.sqrt(torch.clamp_min(est.var_sum, 0.0))
                rel_s = torch.where(
                    torch.abs(est.sum) > 0,
                    moe_s / torch.clamp_min(torch.abs(est.sum), 1e-30),
                    torch.inf,
                )
                out[spec.key] = AggEstimate(
                    value=est.sum, moe=moe_s, ci_low=est.sum - moe_s,
                    ci_high=est.sum + moe_s, relative_error=rel_s,
                    n=est.n_total, population=est.population,
                )
            else:
                out[spec.key] = AggEstimate(
                    value=est.mean, moe=est.moe, ci_low=est.ci_low,
                    ci_high=est.ci_high, relative_error=est.relative_error,
                    n=est.n_total, population=est.population,
                )
            continue

        # grouped sum/mean/var and global var: per-stratum eq 4-7 terms,
        # segment-summed into groups (a group is a sub-population of strata)
        s2_k = torch.where(n > 1, cs.m2 / torch.clamp_min(n - 1.0, 1.0), 0.0)
        s2_eff, unident = estimators.guarded_s2(
            n, N, cs.m2, grp=grp if grouped else None, num_groups=num
        )
        fpc = torch.where(N > 0, 1.0 - n / torch.clamp_min(N, 1.0), 0.0)
        t_k = torch.where(active, N * cs.mean, 0.0)  # per-stratum sum term
        v_k = torch.where(active, N * N * fpc * s2_eff / torch.clamp_min(n, 1.0), 0.0)
        if grouped:
            sum_g = _gsum(t_k, grp, num)
            var_sum_g = _gsum(v_k, grp, num)
        else:
            sum_g = torch.sum(t_k)
            var_sum_g = torch.sum(v_k)
        var_sum_g = torch.where(unident, torch.inf, var_sum_g)
        mean_g = sum_g / torch.clamp_min(covered_g, 1.0)

        if spec.kind == "var":
            # plug-in population variance: E[y^2] - mean^2 with s2_k as the
            # within-stratum second moment around the stratum mean
            ey2_k = torch.where(active, N * (s2_k + cs.mean * cs.mean), 0.0)
            ey2_g = _gsum(ey2_k, grp, num) if grouped else torch.sum(ey2_k)
            val = torch.clamp_min(ey2_g / torch.clamp_min(covered_g, 1.0) - mean_g * mean_g, 0.0)
            # a sketch shipped for this column sharpens the CI: kurtosis-
            # widened s² spread plus a nonparametric bin-replicate channel
            ci = estimators.accumulator("moments").interval(
                cs, "var", cs, confidence=q.confidence, normals=draws,
                replicates=replicates, grp=grp, num_groups=num,
                sketch=accs.get("sketch"), center=val,
            )
            if ci is None:
                ci = (val, val)
            out[spec.key] = _bounded_estimate(val, ci[0], ci[1], n_g, pop_g)
            continue

        if spec.kind == "sum":
            val = sum_g
            moe_g = z * torch.sqrt(torch.clamp_min(var_sum_g, 0.0))
        else:  # mean
            val = mean_g
            var_mean_g = var_sum_g / torch.clamp_min(covered_g, 1.0) ** 2
            moe_g = z * torch.sqrt(torch.clamp_min(var_mean_g, 0.0))
        rel = torch.where(
            torch.abs(val) > 0, moe_g / torch.clamp_min(torch.abs(val), 1e-30), torch.inf
        )
        out[spec.key] = AggEstimate(
            value=val, moe=moe_g, ci_low=val - moe_g, ci_high=val + moe_g,
            relative_error=rel, n=n_g, population=pop_g,
        )
    return out


def preagg_bytes(plan: Plan, num_slots: int) -> int:
    """Analytic dense model of the preagg uplink: n/total are shared across
    columns; every other (S+1)-float vector is declared by the accumulator
    kinds the plan carries per column.  4-byte floats."""
    vectors = 2  # shared n/total
    for _c, kinds in plan.column_kinds:
        vectors += sum(estimators.accumulator(k).payload_vectors() for k in kinds)
    return 4 * num_slots * vectors


def refined_preagg_bytes(fused: FusedPlan, num_slots: int) -> int:
    """Analytic dense model of a refined fused pass's uplink: each member
    ships its own realized ``n`` vector plus its plan-declared per-column
    payloads; the population vector is shared by a same-ROI group and
    shipped per member when the ROIs differ."""
    per_member_totals = fused.cross_roi
    vectors = 0 if per_member_totals else 1  # shared total/counts
    for p in fused.members:
        vectors += 2 if per_member_totals else 1  # n (+ total when cross-ROI)
        for _c, kinds in p.column_kinds:
            vectors += sum(estimators.accumulator(k).payload_vectors() for k in kinds)
    return 4 * num_slots * vectors


def raw_bytes(plan: Plan, capacity: int) -> int:
    """Analytic per-node payload of raw mode: stratum id (4B) + validity
    (1B) + one f32 per referenced column, per buffer slot."""
    return capacity * (5 + 4 * len(plan.columns))


def downstream_tuple_bytes(plan: Plan) -> int:
    """Bytes one kept tuple of this plan costs any downstream consumer
    (stratum id + validity + the referenced columns: the raw-mode tuple
    layout).  Scales a member's own sample size into the session's
    downstream-volume accounting."""
    return 5 + 4 * len(plan.columns)
