"""Error bounds derived cloud-side from the shipped sufficient statistics.

Three bound families, one per accumulator kind, all from the per-stratum
moment rows ``(n_k, N_k, ȳ_k, s²_k)`` and sketch bin counts already shipped
(no extra uplink bytes):

``var``     — stratified parametric bootstrap over the moment rows: within
              stratum k the CLT gives ``ȳ*_k ~ N(ȳ_k, (1-f_k) s²_k / n_k)``
              and ``s²*_k`` resamples log-normally with relative variance
              ``(κ_k-1)(1-f_k)/(n_k-1)`` (κ from :func:`sketch_kurtosis` when
              the column ships a sketch, normal-theory κ = 3 otherwise);
              each replicate re-evaluates the plug-in population variance.
              With a sketch the interval is the union with the
              nonparametric :func:`var_sketch_interval` channel.

``p<q>``    — stratified multinomial bootstrap over sketch bins,
              Poissonized and collapsed across strata: finalize reads only
              the HT-weighted sum across strata, so per bin

                  Σ_k w_k Pois(c_kb)  ≈  N( Σ_k w_k c_kb,
                                            Σ_k w_k² (1-f_k) c_kb )

              with ``w_k = N_k/n_k`` and the finite-population correction
              ``(1-f_k)``.  Each replicate perturbs the weighted histogram
              (third-moment matched, pseudo-count smoothed, see
              :func:`collapsed_replicates`) and re-inverts the CDF.

``min/max`` — order-statistic rank bounds + Cantelli.  Under per-stratum
              SRS at fraction f_k, the probability that the ``m`` most
              extreme population values all evade the sample is
              ``≤ (1-f_k)^m``; hence with confidence c at most
              ``m_k = ⌈ln(1-c)/ln(1-f_k)⌉`` unsampled values of stratum k
              exceed the sample max, clipped to the ``N_k - n_k`` unsampled
              tuples, and Cantelli turns that rank slack into a value bound
              ``d_k = s_k·√(N_k/m_k − 1)``.  Deterministic.

The bootstraps take their standard-normal draws as arguments (the caller
draws them from a ``torch.Generator`` or injects them), so the bounds are a
pure function of the states and the draws.  Every family reads the
sampling fraction only through the realized ``(n_k, N_k)`` rows and shrinks
to zero width at fraction 1.  Grouped queries pass ``grp`` (a
:class:`~.estimators.Groups` or a stratum -> group index, the overflow slot
mapping to a discarded trailing group) and ``num_groups``; group sums run
in a fixed order (:func:`~.estimators.group_sum`), so a bound is the same
bits on every run.
"""

from __future__ import annotations

import torch

from .estimators import group_index, group_sum, sketch_bin_values, sketch_quantile
from .transfer import to_device


def _gsum(x: torch.Tensor, grp, num_groups: int) -> torch.Tensor:
    """Segment-sum strata into groups along the last axis (overflow group
    dropped); batched over leading axes."""
    return group_sum(x, grp, num_groups, dim=-1)


def _reduce(x: torch.Tensor, grp, num_groups: int) -> torch.Tensor:
    return torch.sum(x, -1) if grp is None else _gsum(x, grp, num_groups)


def percentile_interval(reps: torch.Tensor, confidence: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) percentile-bootstrap interval over the leading replicate axis
    (linear interpolation between order statistics)."""
    alpha = (1.0 - confidence) / 2.0
    qs = to_device([alpha, 1.0 - alpha], torch.float32, reps.device)
    lo_hi = torch.quantile(reps, qs, dim=0)
    return lo_hi[0], lo_hi[1]


def sketch_kurtosis(bins: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Per-stratum kurtosis ``κ̂_k = m4/m2²`` estimated from sketch bin rows.

    The sampling variance of a stratum's s² is ``≈ (κ-1) σ⁴ / n``; the moment
    rows carry no fourth moment, but a shipped sketch estimates κ for free.
    Strata too thin to estimate (n < 8) fall back to the normal value 3.
    Clipped to [1.5, 1e4]."""
    vals = sketch_bin_values(bins.device)
    cnt = torch.sum(bins, -1)
    mean = torch.sum(bins * vals, -1) / torch.clamp_min(cnt, 1.0)
    d = vals - mean[..., None]
    m2 = torch.sum(bins * d * d, -1) / torch.clamp_min(cnt, 1.0)
    m4 = torch.sum(bins * d * d * d * d, -1) / torch.clamp_min(cnt, 1.0)
    kappa = m4 / torch.clamp_min(m2 * m2, 1e-30)
    return torch.where((n >= 8) & (m2 > 0), torch.clamp(kappa, 1.5, 1e4), 3.0)


def moment_replicates(
    normals: tuple[torch.Tensor, torch.Tensor],
    n: torch.Tensor,
    total: torch.Tensor,
    mean: torch.Tensor,
    s2: torch.Tensor,
    kurtosis: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(R, S+1) parametric-bootstrap draws of per-stratum (mean, s²) rows from
    the standard normals ``normals = (e_mean, e_s2)``, each (R, S+1).

    Strata with ``n_k == 0`` draw no mean spread, strata with ``n_k < 2`` no
    s² spread; both spreads carry the finite-population correction, so fully
    sampled strata are reproduced exactly.  ``kurtosis`` sets the s² spread
    ``Var(s²) ≈ (κ-1) s⁴ / n``; None assumes normal tails (κ = 3)."""
    e1, e2 = normals
    f = torch.where(total > 0, n / torch.clamp_min(total, 1.0), 1.0)
    fpc = torch.clamp_min(1.0 - f, 0.0)
    kappa = torch.full_like(n, 3.0) if kurtosis is None else kurtosis
    se_mean = torch.where(n > 0, torch.sqrt(fpc * s2 / torch.clamp_min(n, 1.0)), 0.0)
    mean_r = mean + se_mean * e1
    # s² resamples log-normally (moment-matched): right-skewed like a
    # variance's sampling distribution, never negative, exactly s² at f = 1
    rel_sd = torch.where(
        n > 1,
        torch.sqrt(torch.clamp_min(kappa - 1.0, 0.0) * fpc / torch.clamp_min(n - 1.0, 1.0)),
        0.0,
    )
    sig = torch.sqrt(torch.log1p(rel_sd * rel_sd))
    s2_r = s2 * torch.exp(sig * e2 - 0.5 * sig * sig)
    return mean_r, s2_r


def var_interval(
    normals: tuple[torch.Tensor, torch.Tensor],
    n: torch.Tensor,
    total: torch.Tensor,
    mean: torch.Tensor,
    s2: torch.Tensor,
    confidence: float,
    grp=None,
    num_groups: int = 1,
    unidentified: torch.Tensor | None = None,
    kurtosis: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Bootstrap CI for the plug-in population variance, per group.

    ``s2`` should already be singleton-guarded; ``unidentified`` marks groups
    whose variance no stratum identifies (interval ``[0, inf)``)."""
    mean_r, s2_r = moment_replicates(normals, n, total, mean, s2, kurtosis=kurtosis)
    active = (n > 0) & (total > 0)
    w = torch.where(active, total, 0.0)
    covered = torch.clamp_min(_reduce(w, grp, num_groups), 1.0)
    sum_r = _reduce(w * mean_r, grp, num_groups)
    ey2_r = _reduce(w * (s2_r + mean_r * mean_r), grp, num_groups)
    mean_g_r = sum_r / covered
    var_r = torch.clamp_min(ey2_r / covered - mean_g_r * mean_g_r, 0.0)
    lo, hi = percentile_interval(var_r, confidence)
    lo = torch.clamp_min(lo, 0.0)
    if unidentified is not None:
        lo = torch.where(unidentified, 0.0, lo)
        hi = torch.where(unidentified, torch.inf, hi)
    return lo, hi


# Poisson-rate smoothing of occupied bins: resampling a sparse bin at the
# Gamma posterior-mean rate c+1 (exponential prior) restores heavy-tail
# coverage and vanishes under the fpc at full fraction.
SKETCH_PSEUDO_COUNT = 1.0


def _skewed_unit(eps: torch.Tensor, skew: torch.Tensor) -> torch.Tensor:
    """Zero-mean unit-variance draws with target skewness (Wilson-Hilferty):
    standard normals through the WH cube approximation of a gamma of shape
    ``α = 4/γ²``, standardized; exactly normal as γ → 0."""
    alpha = torch.where(skew > 1e-6, 4.0 / torch.clamp_min(skew * skew, 1e-12), 1e12)
    t = 1.0 - 1.0 / (9.0 * alpha) + eps / (3.0 * torch.sqrt(alpha))
    g = alpha * (t * t * t)
    return (g - alpha) / torch.sqrt(alpha)


def collapsed_replicates(
    eps: torch.Tensor,
    bins: torch.Tensor,
    n: torch.Tensor,
    total: torch.Tensor,
    grp=None,
    num_groups: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The collapsed stratified bootstrap over sketch bin rows.

    ``bins`` (S+1, B); ``eps`` (R, B), or (R, num_groups, B) when grouped,
    standard normals.  Returns ``(wb, wb_r)``: the HT-weighted histogram
    (B,) or (G, B) and R perturbed copies whose per-bin mean, variance and
    skew match the Poissonized resample collapsed across strata (variance
    ``Σ_k w_k²(1-f_k)(c_kb + 1)``, third moment ``Σ_k w_k³(1-f_k)(c_kb +
    1)``, pseudo-count on occupied bins)."""
    w = torch.where(n > 0, total / torch.clamp_min(n, 1.0), 0.0)
    fpc = torch.where(total > 0, torch.clamp_min(1.0 - n / torch.clamp_min(total, 1.0), 0.0), 0.0)
    cb = bins + SKETCH_PSEUDO_COUNT * (bins > 0)

    def strata_sum(x):  # (S+1, B) -> (B,) or (G, B)
        return torch.sum(x, 0) if grp is None else group_sum(x, grp, num_groups, dim=0)

    wb = strata_sum(w[:, None] * bins)
    v = strata_sum((w * w * fpc)[:, None] * cb)
    m3 = strata_sum((w * w * w * fpc)[:, None] * cb)
    skew = m3 / torch.pow(torch.clamp_min(v, 1e-30), 1.5)
    wb_r = torch.clamp_min(wb + torch.sqrt(v) * _skewed_unit(eps, skew), 0.0)
    return wb, wb_r


def quantile_interval(
    eps: torch.Tensor,
    bins: torch.Tensor,
    n: torch.Tensor,
    total: torch.Tensor,
    q: float,
    confidence: float,
    grp=None,
    num_groups: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Bootstrap CI for the HT-expanded sketch quantile, per group: each
    collapsed replicate (:func:`collapsed_replicates`) re-inverts its CDF."""
    _, wb_r = collapsed_replicates(eps, bins, n, total, grp=grp, num_groups=num_groups)
    return percentile_interval(sketch_quantile(wb_r, q), confidence)


def _hist_var(wb: torch.Tensor) -> torch.Tensor:
    """Population variance of a (..., B) weighted histogram."""
    vals = sketch_bin_values(wb.device)
    tot = torch.clamp_min(torch.sum(wb, -1), 1e-30)
    m1 = torch.sum(wb * vals, -1) / tot
    m2 = torch.sum(wb * vals * vals, -1) / tot
    return torch.clamp_min(m2 - m1 * m1, 0.0)


def var_sketch_interval(
    eps: torch.Tensor,
    bins: torch.Tensor,
    n: torch.Tensor,
    total: torch.Tensor,
    confidence: float,
    center: torch.Tensor,
    grp=None,
    num_groups: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Nonparametric var CI from a shipped sketch, per group: each collapsed
    replicate re-evaluates its weighted histogram's variance, and the
    interval is re-centred on ``center`` (the exact moment-based plug-in
    estimate), cancelling the binned statistic's constant bias."""
    wb, wb_r = collapsed_replicates(eps, bins, n, total, grp=grp, num_groups=num_groups)
    var_0 = _hist_var(wb)
    lo, hi = percentile_interval(_hist_var(wb_r), confidence)
    return torch.clamp_min(center + (lo - var_0), 0.0), center + (hi - var_0)


def _rank_slack(n: torch.Tensor, total: torch.Tensor, confidence: float) -> torch.Tensor:
    """m_k: with prob >= confidence at most this many unsampled tuples of
    stratum k lie beyond the sample extreme (0 when fully sampled)."""
    f = torch.where(total > 0, n / torch.clamp_min(total, 1.0), 1.0)
    log_miss = torch.log(torch.clamp_min(1.0 - f, 1e-30))
    log_conf = torch.log(torch.tensor(1.0 - confidence, dtype=torch.float32))
    log_conf = to_device(float(log_conf), torch.float32, n.device)
    m = torch.ceil(log_conf / torch.clamp_max(log_miss, -1e-30))
    return torch.minimum(m.clamp_min(0.0), torch.clamp_min(total - n, 0.0))


def extrema_interval(
    side: str,
    ext_value: torch.Tensor,
    n: torch.Tensor,
    total: torch.Tensor,
    mean: torch.Tensor,
    s2: torch.Tensor,
    confidence: float,
    grp=None,
    num_groups: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Order-statistic + Cantelli bound for ``min``/``max``, per group.

    Returns (lo, hi): for ``max`` the population extreme lies in
    ``[sample_max, hi]``; for ``min`` in ``[lo, sample_min]``."""
    sign = 1.0 if side == "max" else -1.0
    m = _rank_slack(n, total, confidence)
    d = torch.sqrt(s2 * torch.clamp_min(total / torch.clamp_min(m, 1.0) - 1.0, 0.0))
    # work in signed space (negate for min) so both sides are maxima
    witnessed = torch.where(total > 0, sign * ext_value, -torch.inf)
    bound = torch.where(m > 0, sign * mean + d, witnessed)
    # spread unobservable: an under-sampled stratum with n_k < 2 admits no
    # Cantelli bound — its population extreme is honestly unbounded
    bound = torch.where((m > 0) & (n < 2), torch.inf, bound)
    bound = torch.where(total > 0, torch.maximum(bound, witnessed), -torch.inf)
    if grp is None:
        far = torch.amax(bound)
        near = torch.amax(witnessed)
    else:
        far = _segment_max(bound, group_index(grp), num_groups)
        near = _segment_max(witnessed, group_index(grp), num_groups)
    if side == "max":
        return near, far
    return -far, -near


def _segment_max(x: torch.Tensor, grp: torch.Tensor, num_groups: int) -> torch.Tensor:
    """Per-group max (-inf for empty groups); the overflow group is dropped.
    A max does not depend on the order of its operands, so this is the same
    bits on every run."""
    out = torch.full((num_groups + 1,), -torch.inf, dtype=x.dtype, device=x.device)
    return out.scatter_reduce(0, grp.long(), x, reduce="amax")[:num_groups]
