"""Stratified estimators with error bounds (paper §3.5–3.6) and the
accumulator registry.

Equations (1)–(10): per-stratum sample statistics, the stratified SUM/MEAN
estimators, their variance with finite-population correction, and
normal-approximation confidence intervals / margin of error / relative
error.

The **accumulator registry** is the layer the query engine reduces windows
into.  An :class:`Accumulator` is a named kind of mergeable per-stratum
summary; the built-in citizens are

  * ``moments`` — the eq 4 sample moments (:class:`StratumStats`), exact
    Chan-et-al. merges; backs sum/mean/count/var,
  * ``extrema`` — per-stratum min/max lattices; backs min/max,
  * ``sketch``  — a mergeable fixed-size log-domain quantile histogram
    (DDSketch-style); backs the ``p50``/``p99`` quantile aggregates.

Each column a query references carries a dict of accumulator states
(``{"moments": ..., "extrema": ...}``) chosen by plan lowering.  States are
NamedTuples of tensors whose leading axis is the S+1 stratum slots.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch


class StratumStats(NamedTuple):
    """Mergeable per-stratum sample moments; shapes all (S+1,) f32.

    n: realized sample size n_k
    total: population size N_k of the window(s)
    wsum:  Σ y over sampled tuples of stratum k
    m2:    Σ (y - ȳ_k)^2 over sampled tuples (centered second moment)
    mean:  ȳ_k (carried so merges can re-center without re-reading data)
    """

    n: torch.Tensor
    total: torch.Tensor
    wsum: torch.Tensor
    m2: torch.Tensor
    mean: torch.Tensor


class ColumnStats(NamedTuple):
    """Mergeable per-stratum accumulator of one value column: the five
    moments of :class:`StratumStats` (sum/mean/count/var via the Chan et al.
    merge) plus per-stratum sample extrema (``+inf``/``-inf`` on empty
    strata, the identities of min/max), so every field merges exactly:
    additive (n/total/wsum), mean-shift (m2) or lattice (min/max)."""

    n: torch.Tensor
    total: torch.Tensor
    wsum: torch.Tensor
    m2: torch.Tensor
    mean: torch.Tensor
    min: torch.Tensor
    max: torch.Tensor

    @property
    def base(self) -> StratumStats:
        """The moment-only view (drop extrema) for the eq 5-10 estimators."""
        return StratumStats(n=self.n, total=self.total, wsum=self.wsum, m2=self.m2, mean=self.mean)


class Estimate(NamedTuple):
    """Global stratified estimate with uncertainty (eqs 5–10)."""

    sum: torch.Tensor
    mean: torch.Tensor
    var_sum: torch.Tensor
    var_mean: torch.Tensor
    moe: torch.Tensor
    relative_error: torch.Tensor
    ci_low: torch.Tensor
    ci_high: torch.Tensor
    n_total: torch.Tensor
    population: torch.Tensor


def segment_sum(x: torch.Tensor, idx: torch.Tensor, num: int) -> torch.Tensor:
    """Sum rows of ``x`` into ``num`` segments along dim 0.

    Float rows are added one after another in ascending row order within
    each segment (:func:`group_sum` over a stable sort), so the result is
    the same bits on every run and every device; integer rows, which add
    exactly in any order, go through one ``index_add_``."""
    if x.is_floating_point():
        return group_sum(x, groups_of(idx, num), num)
    out = torch.zeros((num,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    return out.index_add_(0, idx, x)


class Groups(NamedTuple):
    """A stratum -> group map with a fixed summation order.

    ``index`` (S+1,) maps each slot to its group (the overflow slot to the
    discarded group ``num_groups``); ``order`` lists slots sorted by group
    (stable, so ascending within a group) and ``lengths`` (num_groups+1,)
    the slots per group."""

    index: torch.Tensor
    order: torch.Tensor
    lengths: torch.Tensor


def groups_of(index: torch.Tensor, num_groups: int) -> Groups:
    """:class:`Groups` of a stratum -> group index (no host sync)."""
    order = torch.argsort(index, stable=True)
    lengths = torch.zeros(num_groups + 1, dtype=torch.int64, device=index.device)
    lengths.index_add_(0, index.long(), torch.ones_like(index, dtype=torch.int64))
    return Groups(index=index, order=order, lengths=lengths)


def group_index(grp) -> torch.Tensor:
    """The stratum -> group index of a :class:`Groups` or an index tensor."""
    return grp.index if isinstance(grp, Groups) else grp


def group_sum(x: torch.Tensor, grp, num_groups: int, dim: int = 0) -> torch.Tensor:
    """Sum the strata axis ``dim`` of ``x`` into ``num_groups`` groups.

    Each group's strata are added one after another in ascending slot
    order, so the result is the same bits on every run and every device
    (a float ``index_add_`` adds with atomics in a varying order on CUDA).
    ``grp`` is a :class:`Groups` or a stratum -> group index tensor."""
    g = grp if isinstance(grp, Groups) else groups_of(grp, num_groups)
    xs = x.movedim(dim, 0).index_select(0, g.order)
    out = torch.segment_reduce(xs, "sum", lengths=g.lengths, axis=0, unsafe=True)
    return out[:num_groups].movedim(0, dim)


def _mean_of(n: torch.Tensor, wsum: torch.Tensor) -> torch.Tensor:
    return torch.where(n > 0, wsum / torch.clamp_min(n, 1.0), 0.0)


def sample_stats(
    values: torch.Tensor,
    stratum_idx: torch.Tensor,
    mask: torch.Tensor,
    num_slots: int,
    counts: torch.Tensor | None = None,
) -> StratumStats:
    """Per-stratum moments of the *sampled* tuples (eq 4), two-pass centered.

    ``counts`` are the population sizes N_k; when None they are recomputed
    from ``stratum_idx`` (all tuples of the window, sampled or not)."""
    values = values.to(torch.float32)
    m = mask.to(torch.float32)
    if counts is None:
        counts = segment_sum(torch.ones_like(m), stratum_idx, num_slots)
    n = segment_sum(m, stratum_idx, num_slots)
    wsum = segment_sum(m * values, stratum_idx, num_slots)
    mean = _mean_of(n, wsum)
    centered = values - mean[stratum_idx]
    m2 = segment_sum(m * centered * centered, stratum_idx, num_slots)
    return StratumStats(n=n, total=counts.to(torch.float32), wsum=wsum, m2=m2, mean=mean)


def merge_stats(a: StratumStats, b: StratumStats) -> StratumStats:
    """Exact pairwise merge (Chan et al. parallel-variance update)."""
    n = a.n + b.n
    wsum = a.wsum + b.wsum
    delta = b.mean - a.mean
    m2 = a.m2 + b.m2 + delta * delta * torch.where(n > 0, a.n * b.n / torch.clamp_min(n, 1.0), 0.0)
    return StratumStats(n=n, total=a.total + b.total, wsum=wsum, m2=m2, mean=_mean_of(n, wsum))


def merge_all(stats: Sequence[StratumStats]) -> StratumStats:
    out = stats[0]
    for st in stats[1:]:
        out = merge_stats(out, st)
    return out


def _from_raw2(n, total, wsum, raw2) -> StratumStats:
    """Mean-shift decomposition: M2 = Σ(M2_p + n_p ȳ_p²) − n ȳ²."""
    mean = _mean_of(n, wsum)
    m2 = torch.clamp_min(raw2 - n * mean * mean, 0.0)
    return StratumStats(n=n, total=total, wsum=wsum, m2=m2, mean=mean)


def merge_stats_panes(stacked: StratumStats) -> StratumStats:
    """Vectorized multi-way moment merge over a leading pane axis (P, S+1)."""
    return _from_raw2(
        torch.sum(stacked.n, 0),
        torch.sum(stacked.total, 0),
        torch.sum(stacked.wsum, 0),
        torch.sum(stacked.m2 + stacked.n * stacked.mean * stacked.mean, 0),
    )


def _all_reduce(x: torch.Tensor, group, op=None) -> torch.Tensor:
    import torch.distributed as dist

    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM if op is None else op, group=group)
    return out


def psum_stats(stats: StratumStats, group=None) -> StratumStats:
    """Cross-process combine with additive all-reduces (mean-shift
    decomposition): collective bytes are O(S), independent of the window."""
    return _from_raw2(
        _all_reduce(stats.n, group),
        _all_reduce(stats.total, group),
        _all_reduce(stats.wsum, group),
        _all_reduce(stats.m2 + stats.n * stats.mean * stats.mean, group),
    )


def stats_from_raw_moments(
    count: torch.Tensor, s1: torch.Tensor, s2: torch.Tensor, counts: torch.Tensor
) -> StratumStats:
    """Raw per-stratum sums {n, Σy, Σy²} -> the centered StratumStats form.

    The adapter between the edge_reduce kernel (raw power sums) and the
    mean-shift moment representation the estimators consume; the centering
    ``m2 = Σy² − nȳ²`` is the one f32-cancellation step of the kernel path.
    """
    return _from_raw2(count.to(torch.float32), counts.to(torch.float32), s1, s2)


def zero_overflow_stats(stats: StratumStats) -> StratumStats:
    """Neutralize the overflow slot (additive fields -> 0) so it drops out
    of estimation."""
    return StratumStats(*(_zero_last(x, 0.0) for x in stats))


def _zero_last(x: torch.Tensor, fill: float) -> torch.Tensor:
    """``x`` with its last stratum slot (dim 0) set to ``fill``."""
    keep = torch.arange(x.shape[0], device=x.device) < (x.shape[0] - 1)
    keep = keep.reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(keep, x, fill)


def z_value(confidence: float, device=None) -> torch.Tensor:
    """Upper alpha/2 normal quantile, e.g. 1.96 for 95%, as an f32 scalar on
    ``device`` (the CPU when None), written there without a copy."""
    alpha = 1.0 - confidence
    z = torch.special.ndtri(torch.tensor(1.0 - alpha / 2.0, dtype=torch.float32))
    return torch.full((), float(z), dtype=torch.float32, device=device)


def guarded_s2(
    n: torch.Tensor,
    total: torch.Tensor,
    m2: torch.Tensor,
    grp: torch.Tensor | None = None,
    num_groups: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-stratum sample variance with the lonely-singleton guard.

    A stratum sampled at ``n_k == 1`` while under-sampled (``n_k < N_k``)
    has an unidentified variance; it borrows the mean ``s²`` of the
    identified (``n_k >= 2``) strata of its group.  Returns
    ``(s2_eff, unidentified)`` where ``unidentified`` flags groups whose
    variance no stratum identifies (their half-width is infinite)."""
    s2 = torch.where(n > 1, m2 / torch.clamp_min(n - 1.0, 1.0), 0.0)
    active = (n > 0) & (total > 0)
    known = active & (n > 1)
    lonely = active & (n < 2) & (n < total)

    if grp is not None and not isinstance(grp, Groups):
        grp = groups_of(grp, num_groups)

    def reduce(x):
        if grp is None:
            return torch.sum(x)
        return group_sum(x, grp, num_groups)

    cnt = reduce(known.to(torch.float32))
    s2_bar = reduce(torch.where(known, s2, 0.0)) / torch.clamp_min(cnt, 1.0)
    s2_bar_k = s2_bar if grp is None else s2_bar_at(s2_bar, grp.index)
    s2_eff = torch.where(lonely, s2_bar_k, s2)
    unidentified = (reduce(lonely.to(torch.float32)) > 0) & (cnt == 0)
    return s2_eff, unidentified


def s2_bar_at(s2_bar_g: torch.Tensor, grp: torch.Tensor) -> torch.Tensor:
    """Gather per-group imputed s² back to strata (overflow slot -> 0)."""
    padded = torch.cat([s2_bar_g, torch.zeros(1, dtype=s2_bar_g.dtype, device=s2_bar_g.device)])
    return padded[grp.clamp(0, s2_bar_g.shape[0])]


def estimate(stats: StratumStats, confidence: float = 0.95) -> Estimate:
    """Equations (5)–(10) from merged per-stratum statistics.

    The MEAN is normalized by the covered population Σ_{k: n_k>0} N_k (a
    ratio estimator), which equals the textbook eq 5 under full coverage.
    Under-sampled singleton strata carry the :func:`guarded_s2` adjustment;
    if no stratum identifies a variance the half-width is infinite."""
    n = stats.n
    N = stats.total
    active = (n > 0) & (N > 0)
    s2_k, unidentified = guarded_s2(n, N, stats.m2)
    sum_hat = torch.sum(torch.where(active, N * stats.mean, 0.0))  # eq 5
    population = torch.sum(N)
    covered = torch.sum(torch.where(active, N, 0.0))
    mean_hat = sum_hat / torch.clamp_min(covered, 1.0)  # eq 5 (ratio form)
    fpc = torch.where(N > 0, 1.0 - n / torch.clamp_min(N, 1.0), 0.0)
    var_sum = torch.sum(torch.where(active, N * N * fpc * s2_k / torch.clamp_min(n, 1.0), 0.0))
    var_sum = torch.where(unidentified, torch.inf, var_sum)  # eq 6
    var_mean = var_sum / torch.clamp_min(covered, 1.0) ** 2  # eq 7
    z = z_value(confidence, n.device)
    moe = z * torch.sqrt(torch.clamp_min(var_mean, 0.0))  # eq 9
    rel = torch.where(
        torch.abs(mean_hat) > 0, moe / torch.clamp_min(torch.abs(mean_hat), 1e-30), torch.inf
    )  # eq 10
    return Estimate(
        sum=sum_hat,
        mean=mean_hat,
        var_sum=var_sum,
        var_mean=var_mean,
        moe=moe,
        relative_error=rel,
        ci_low=mean_hat - moe,
        ci_high=mean_hat + moe,
        n_total=torch.sum(n),
        population=population,
    )


def substream_sums(stats_per_substream: Sequence[StratumStats]) -> torch.Tensor:
    """Equations (1)–(2): per-substream estimated sums t̂_s = Σ_k N_{s,k} ȳ_{s,k}
    (one edge node's local stats each); the global SUM is their sum."""
    return torch.stack([torch.sum(st.total * st.mean) for st in stats_per_substream])


def per_stratum_means(stats: StratumStats, confidence: float = 0.95):
    """Per-stratum mean and CI half-width (heatmaps, per-cell queries).

    A stratum is its own group, so no lonely-singleton imputation applies:
    strata with ``n_k < 2`` report an infinite half-width (fully sampled
    strata stay exact: fpc == 0)."""
    n, total = stats.n, stats.total
    s2_k = torch.where(n > 1, stats.m2 / torch.clamp_min(n - 1.0, 1.0), 0.0)
    fpc = torch.where(total > 0, 1.0 - n / torch.clamp_min(total, 1.0), 0.0)
    var_k = fpc * s2_k / torch.clamp_min(n, 1.0)
    identified = (n > 1) | ((n > 0) & (n >= total))
    var_k = torch.where(identified, var_k, torch.inf)
    moe_k = z_value(confidence, n.device) * torch.sqrt(torch.clamp_min(var_k, 0.0))
    return stats.mean, moe_k


# ---------------------------------------------------------------------------
# Accumulator registry: pluggable mergeable per-stratum summary kinds
# ---------------------------------------------------------------------------


class Extrema(NamedTuple):
    """Per-stratum sample extrema lattice; shapes (S+1,), ±inf identities."""

    min: torch.Tensor
    max: torch.Tensor


class QuantileSketch(NamedTuple):
    """Mergeable fixed-size per-stratum quantile histogram.

    ``bins`` is (S+1, SKETCH_NUM_BINS) f32: per-stratum counts of sampled
    tuples over a fixed log-domain bin layout (see :func:`sketch_bin_index`).
    The layout is a global constant, so the merge is plain addition.  Counts
    are unweighted on the edge; finalize expands stratum k's row by the
    Horvitz-Thompson factor N_k/n_k."""

    bins: torch.Tensor


# Sketch bin layout (global constants — the mergeability precondition).
# Geometric bins over magnitude: relative accuracy alpha = tanh(LOG_GAMMA/2)
# ~ 4%, covering magnitudes MIN_MAG .. MIN_MAG*e^(B*LOG_GAMMA); magnitudes
# outside clamp to the edge bins.  Layout, in ascending value order: B
# negative-magnitude bins (reversed), one zero bin, B positive bins.
SKETCH_BINS_PER_SIDE = 256
SKETCH_LOG_GAMMA = 0.08
SKETCH_MIN_MAG = 1e-4
SKETCH_NUM_BINS = 2 * SKETCH_BINS_PER_SIDE + 1


def sketch_bin_index(values: torch.Tensor) -> torch.Tensor:
    """Value -> bin index in [0, SKETCH_NUM_BINS): the fixed log layout.

    ``log`` may round differently by one ulp between libraries, so a value
    exactly on a bin edge can land in either neighbouring bin."""
    v = values.to(torch.float32)
    mag = torch.abs(v)
    # divisors are 0-dim tensors on v's device: IEEE division on every
    # device (CUDA turns division by a Python scalar into a reciprocal
    # multiply), so the edge megakernel's bin index agrees bin for bin
    min_mag = torch.full((), SKETCH_MIN_MAG, dtype=torch.float32, device=v.device)
    gamma = torch.full((), SKETCH_LOG_GAMMA, dtype=torch.float32, device=v.device)
    k = torch.floor(torch.log(torch.maximum(mag, min_mag) / min_mag) / gamma)
    k = k.clamp(0, SKETCH_BINS_PER_SIDE - 1).to(torch.int32)
    zero = SKETCH_BINS_PER_SIDE  # index of the |v| <= MIN_MAG bin
    return torch.where(
        v > SKETCH_MIN_MAG,
        zero + 1 + k,
        torch.where(v < -SKETCH_MIN_MAG, zero - 1 - k, torch.full_like(k, zero)),
    )


def sketch_bin_values(device=None) -> torch.Tensor:
    """(SKETCH_NUM_BINS,) representative value per bin (geometric mid)."""
    k = torch.arange(SKETCH_BINS_PER_SIDE, dtype=torch.float32, device=device)
    rep = SKETCH_MIN_MAG * torch.exp((k + 0.5) * SKETCH_LOG_GAMMA)
    zero = torch.zeros(1, dtype=torch.float32, device=device)
    return torch.cat([-rep.flip(0), zero, rep])


def sketch_bin_edges(device=None) -> torch.Tensor:
    """(SKETCH_NUM_BINS + 1,) ascending bin boundaries of the fixed layout."""
    k = torch.arange(SKETCH_BINS_PER_SIDE + 1, dtype=torch.float32, device=device)
    pos = SKETCH_MIN_MAG * torch.exp(k * SKETCH_LOG_GAMMA)
    return torch.cat([-pos.flip(0), pos])


def sketch_quantile(weighted_bins: torch.Tensor, q: float) -> torch.Tensor:
    """Invert a (..., SKETCH_NUM_BINS) weighted histogram at quantile ``q``.

    Finds the first bin whose cumulative mass reaches ``q`` of the total and
    interpolates linearly between that bin's edges by the within-bin mass
    fraction; NaN where the histogram is empty."""
    total = torch.sum(weighted_bins, -1, keepdim=True)
    cdf = torch.cumsum(weighted_bins, -1)
    target = torch.clamp_min(torch.tensor(q, dtype=torch.float32) * total, 1e-30)
    idx = torch.argmax((cdf >= target).to(torch.int32), -1)
    c_cur = torch.gather(cdf, -1, idx[..., None])[..., 0]
    c_prev = torch.where(
        idx > 0, torch.gather(cdf, -1, torch.clamp_min(idx - 1, 0)[..., None])[..., 0], 0.0
    )
    frac = torch.clamp((target[..., 0] - c_prev) / torch.clamp_min(c_cur - c_prev, 1e-30), 0.0, 1.0)
    edges = sketch_bin_edges(weighted_bins.device)
    lo_e = edges[idx]
    hi_e = edges[idx + 1]
    val = lo_e + frac * (hi_e - lo_e)
    return torch.where(total[..., 0] > 0, val, torch.nan)


class Accumulator:
    """Protocol of one registry citizen: a named mergeable summary kind.

    State is a NamedTuple of (S+1,)-leading tensors.  Laws the engine relies
    on: ``merge`` is associative + commutative with ``accumulate`` on an
    empty window as identity; ``merge_panes`` equals a sequential merge
    fold; ``psum`` equals merging all processes' states; ``zero_overflow``
    removes the out-of-region slot from estimation."""

    kind: str = "?"

    def accumulate(self, values, stratum_idx, mask, num_slots, counts=None):
        """Reduce one window's sampled tuples of a column to a state."""
        raise NotImplementedError

    def merge(self, a, b):
        """Exact pairwise combine of two states."""
        raise NotImplementedError

    def merge_panes(self, stacked):
        """Vectorized multi-way merge over a leading pane axis."""
        raise NotImplementedError

    def psum(self, state, group=None, shared=None):
        """Cross-process combine through ``torch.distributed`` collectives
        over ``group`` (``shared`` is an optional already-combined moments
        state for n/total reuse)."""
        raise NotImplementedError

    def zero_overflow(self, state):
        """Neutralize the overflow slot (merge identities there)."""
        raise NotImplementedError

    def payload_vectors(self) -> int:
        """(S+1)-float vectors this kind adds to one column's preagg uplink
        payload (excluding the n/total pair, shipped once per pass)."""
        raise NotImplementedError

    def payload_flatten(self, state):
        """Wire-format rows ``(name, tensor, quantize_ok, identity)`` of a
        state, stratum axis leading; ``payload_unflatten`` over them must
        rebuild the state bit-exactly."""
        raise NotImplementedError

    def payload_unflatten(self, rows):
        """Rebuild a state from a ``{name: tensor}`` mapping of rows."""
        raise NotImplementedError

    def interval(self, state, agg_kind, moments, *, q=None, confidence=0.95,
                 normals=None, replicates=0, grp=None, num_groups=1, **aux):
        """Sampling-error CI ``(lo, hi)`` for ``agg_kind`` finalized from this
        state, or None when the kind carries no bound logic (the engine then
        reports a zero-width interval).  ``normals`` holds the aggregate's
        bootstrap draws by name (see ``query.bootstrap_normals``)."""
        return None


class MomentsAccumulator(Accumulator):
    """Eq 4 sample moments (:class:`StratumStats`), exact Chan merges."""

    kind = "moments"

    def accumulate(self, values, stratum_idx, mask, num_slots, counts=None):
        return sample_stats(values, stratum_idx, mask, num_slots, counts=counts)

    def from_kernel_rows(self, count, s1, s2, counts):
        """Kernel hook: adapt edge_reduce's raw power-sum rows (kept count,
        Σy, Σy²; population ``counts``) to this accumulator's state."""
        return stats_from_raw_moments(count, s1, s2, counts)

    def merge(self, a, b):
        return merge_stats(a, b)

    def merge_panes(self, stacked):
        return merge_stats_panes(stacked)

    def psum(self, state, group=None, shared=None):
        if shared is None:
            return psum_stats(state, group)
        # columns accumulated from the same sample share n/total: reuse the
        # combined vectors and all-reduce only this column's wsum/raw2 pair
        return _from_raw2(
            shared.n,
            shared.total,
            _all_reduce(state.wsum, group),
            _all_reduce(state.m2 + state.n * state.mean * state.mean, group),
        )

    def zero_overflow(self, state):
        return zero_overflow_stats(state)

    def payload_vectors(self) -> int:
        return 2  # wsum + raw second moment (mean/m2 derived cloud-side)

    def payload_flatten(self, state):
        # n/total are exact count rows; m2 ships directly (recovering it
        # from n·mean² + m2 would cancel and break the bit-exact inverse)
        return (
            ("n", state.n, False, 0.0),
            ("total", state.total, False, 0.0),
            ("wsum", state.wsum, True, 0.0),
            ("m2", state.m2, True, 0.0),
        )

    def payload_unflatten(self, rows):
        n, wsum = rows["n"], rows["wsum"]
        return StratumStats(
            n=n, total=rows["total"], wsum=wsum, m2=rows["m2"], mean=_mean_of(n, wsum)
        )

    def interval(self, state, agg_kind, moments, *, q=None, confidence=0.95,
                 normals=None, replicates=0, grp=None, num_groups=1, sketch=None,
                 center=None, **aux):
        """``var``: stratified parametric bootstrap over the moment rows
        (singleton-guarded s², see :func:`guarded_s2`) from the draws
        ``normals["mean"]`` and ``normals["s2"]``.

        When the column also ships a quantile sketch (``sketch`` is its
        state, ``center`` the plug-in point estimate), the sketch's
        per-stratum kurtosis widens the s² spread, and a second, fully
        nonparametric CI is bootstrapped from the collapsed bin replicates
        (``normals["sketch"]``); the interval is the union of both."""
        if agg_kind != "var" or normals is None or replicates <= 0:
            return None
        from . import bounds  # deferred: bounds builds on this module

        if grp is not None and not isinstance(grp, Groups):
            grp = groups_of(grp, num_groups)
        s2_eff, unidentified = guarded_s2(
            state.n, state.total, state.m2, grp=grp, num_groups=num_groups
        )
        kurtosis = None if sketch is None else bounds.sketch_kurtosis(sketch.bins, state.n)
        lo, hi = bounds.var_interval(
            (normals["mean"], normals["s2"]), state.n, state.total, state.mean, s2_eff,
            confidence, grp=grp, num_groups=num_groups, unidentified=unidentified,
            kurtosis=kurtosis,
        )
        if sketch is not None and center is not None:
            lo_s, hi_s = bounds.var_sketch_interval(
                normals["sketch"], sketch.bins, state.n, state.total, confidence, center,
                grp=grp, num_groups=num_groups,
            )
            lo = torch.minimum(lo, lo_s)
            hi = torch.maximum(hi, hi_s)
        return lo, hi


class ExtremaAccumulator(Accumulator):
    """Per-stratum min/max lattices with ±inf identities."""

    kind = "extrema"

    def accumulate(self, values, stratum_idx, mask, num_slots, counts=None):
        v = values.to(torch.float32)
        ident = self.identity(num_slots, v.device)
        return Extrema(
            min=ident.min.scatter_reduce(
                0, stratum_idx.long(), torch.where(mask, v, torch.inf), reduce="amin"
            ),
            max=ident.max.scatter_reduce(
                0, stratum_idx.long(), torch.where(mask, v, -torch.inf), reduce="amax"
            ),
        )

    def from_kernel_rows(self, mins, maxs) -> Extrema:
        """Kernel hook: wrap extrema rows (±inf where a stratum kept nothing)."""
        return Extrema(min=mins, max=maxs)

    def identity(self, num_slots: int, device=None) -> Extrema:
        return Extrema(
            min=torch.full((num_slots,), torch.inf, dtype=torch.float32, device=device),
            max=torch.full((num_slots,), -torch.inf, dtype=torch.float32, device=device),
        )

    def merge(self, a, b):
        return Extrema(min=torch.minimum(a.min, b.min), max=torch.maximum(a.max, b.max))

    def merge_panes(self, stacked):
        return Extrema(min=torch.amin(stacked.min, 0), max=torch.amax(stacked.max, 0))

    def psum(self, state, group=None, shared=None):
        import torch.distributed as dist

        return Extrema(
            min=_all_reduce(state.min, group, dist.ReduceOp.MIN),
            max=_all_reduce(state.max, group, dist.ReduceOp.MAX),
        )

    def zero_overflow(self, state):
        return Extrema(min=_zero_last(state.min, torch.inf), max=_zero_last(state.max, -torch.inf))

    def payload_vectors(self) -> int:
        return 2  # min + max

    def payload_flatten(self, state):
        # identities are the lattice units: an empty stratum holds (+inf, -inf)
        return (
            ("min", state.min, True, float("inf")),
            ("max", state.max, True, float("-inf")),
        )

    def payload_unflatten(self, rows):
        return Extrema(min=rows["min"], max=rows["max"])

    def interval(self, state, agg_kind, moments, *, q=None, confidence=0.95,
                 normals=None, replicates=0, grp=None, num_groups=1, **aux):
        """``min``/``max``: closed-form order-statistic + Cantelli bounds from
        the rank slack of per-stratum sampling fractions (deterministic)."""
        if agg_kind not in ("min", "max"):
            return None
        from . import bounds  # deferred: bounds builds on this module

        s2 = torch.where(moments.n > 1, moments.m2 / torch.clamp_min(moments.n - 1.0, 1.0), 0.0)
        ext = state.max if agg_kind == "max" else state.min
        return bounds.extrema_interval(
            agg_kind, ext, moments.n, moments.total, moments.mean, s2,
            confidence, grp=grp, num_groups=num_groups,
        )


class QuantileSketchAccumulator(Accumulator):
    """DDSketch-style mergeable log-histogram (see :class:`QuantileSketch`)."""

    kind = "sketch"

    def accumulate(self, values, stratum_idx, mask, num_slots, counts=None):
        flat = stratum_idx.to(torch.int64) * SKETCH_NUM_BINS + sketch_bin_index(values)
        # 0/1 counts add exactly as integers, in any order
        bins = segment_sum(mask.to(torch.int32), flat, num_slots * SKETCH_NUM_BINS)
        bins = bins.to(torch.float32)
        return QuantileSketch(bins=bins.reshape(num_slots, SKETCH_NUM_BINS))

    def from_kernel_rows(self, bins) -> QuantileSketch:
        """Kernel hook: adopt (S, NUM_BINS) sketch rows already binned."""
        return QuantileSketch(bins=bins)

    def merge(self, a, b):
        return QuantileSketch(bins=a.bins + b.bins)

    def merge_panes(self, stacked):
        return QuantileSketch(bins=torch.sum(stacked.bins, 0))

    def psum(self, state, group=None, shared=None):
        return QuantileSketch(bins=_all_reduce(state.bins, group))

    def zero_overflow(self, state):
        return QuantileSketch(bins=_zero_last(state.bins, 0.0))

    def payload_vectors(self) -> int:
        return SKETCH_NUM_BINS

    def payload_flatten(self, state):
        # integer-valued counts: HT expansion reads them as masses, so they
        # never quantize
        return (("bins", state.bins, False, 0.0),)

    def payload_unflatten(self, rows):
        return QuantileSketch(bins=rows["bins"])

    def interval(self, state, agg_kind, moments, *, q=None, confidence=0.95,
                 normals=None, replicates=0, grp=None, num_groups=1, **aux):
        """``p<q>``: stratified multinomial bootstrap over the sketch bin rows
        (Poissonized and collapsed across strata, see :mod:`.bounds`) from the
        draws ``normals["sketch"]``."""
        if q is None or normals is None or replicates <= 0:
            return None
        from . import bounds  # deferred: bounds builds on this module

        return bounds.quantile_interval(
            normals["sketch"], state.bins, moments.n, moments.total, q, confidence,
            grp=grp, num_groups=num_groups,
        )


ACCUMULATORS: dict[str, Accumulator] = {}


def register_accumulator(acc: Accumulator) -> Accumulator:
    """Add (or replace) a registry citizen; returns it for chaining."""
    ACCUMULATORS[acc.kind] = acc
    return acc


MOMENTS = register_accumulator(MomentsAccumulator())
EXTREMA = register_accumulator(ExtremaAccumulator())
SKETCH = register_accumulator(QuantileSketchAccumulator())


def accumulator(kind: str) -> Accumulator:
    acc = ACCUMULATORS.get(kind)
    if acc is None:
        raise KeyError(f"unknown accumulator kind {kind!r}; registered: {sorted(ACCUMULATORS)}")
    return acc


# -- column-level operations over {kind: state} dicts ------------------------


def zero_overflow_accs(accs: dict) -> dict:
    return {k: accumulator(k).zero_overflow(s) for k, s in accs.items()}


def accumulate_column(kinds: Sequence[str], values, stratum_idx, mask, num_slots: int,
                      counts=None) -> dict:
    """One column's registry states for the requested accumulator kinds."""
    return {
        k: accumulator(k).accumulate(values, stratum_idx, mask, num_slots, counts=counts)
        for k in kinds
    }


def merge_accs(a: dict, b: dict) -> dict:
    return {k: accumulator(k).merge(a[k], b[k]) for k in a}


def stack_trees(trees: Sequence):
    """Stack like-structured trees of states (dicts, NamedTuples, tensors)
    along a new leading axis: a query's pane ring."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    if isinstance(first, tuple):
        return type(first)(*(stack_trees(list(xs)) for xs in zip(*trees)))
    return torch.stack(list(trees), 0)


def merge_accs_panes(stacked: dict) -> dict:
    """Vectorized pane merge of one column's stacked states (leading P axis)."""
    return {k: accumulator(k).merge_panes(st) for k, st in stacked.items()}


# -- ColumnStats: moments + extrema of one column in one record ---------------


def column_stats(values, stratum_idx, mask, num_slots: int, counts=None,
                 extrema: bool = True) -> ColumnStats:
    """Per-stratum moments (:func:`sample_stats`) and extrema of the sampled
    tuples of one column; ``extrema=False`` fills the extrema with their
    identities without reducing."""
    base = sample_stats(values, stratum_idx, mask, num_slots, counts=counts)
    ext = (EXTREMA.accumulate(values, stratum_idx, mask, num_slots) if extrema
           else EXTREMA.identity(num_slots, base.n.device))
    return ColumnStats(*base, min=ext.min, max=ext.max)


def merge_column_stats(a: ColumnStats, b: ColumnStats) -> ColumnStats:
    """Exact pairwise merge: Chan et al. for moments, lattice for extrema."""
    base = merge_stats(a.base, b.base)
    return ColumnStats(*base, min=torch.minimum(a.min, b.min), max=torch.maximum(a.max, b.max))


def merge_all_columns(stats: Sequence[ColumnStats]) -> ColumnStats:
    out = stats[0]
    for st in stats[1:]:
        out = merge_column_stats(out, st)
    return out


def stack_column_stats(stats: Sequence[ColumnStats]) -> ColumnStats:
    """Stack accumulators along a new leading pane axis: (P, S+1) fields."""
    return ColumnStats(*(torch.stack(xs, 0) for xs in zip(*stats)))


def merge_column_stats_panes(stacked: ColumnStats) -> ColumnStats:
    """Vectorized multi-way merge over a leading pane axis: one mean-shift
    pass (:func:`merge_stats_panes`) and one min/max reduction, the
    cloud-side pane merge of sliding and hopping windows."""
    base = merge_stats_panes(stacked.base)
    return ColumnStats(*base, min=torch.amin(stacked.min, 0), max=torch.amax(stacked.max, 0))
