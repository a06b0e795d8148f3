"""Error bounds derived cloud-side from the shipped sufficient statistics.

``min``/``max`` — order-statistic rank bounds + Cantelli.  Under
per-stratum SRS at fraction f_k, the probability that the ``m`` most
extreme population values all evade the sample is ``≤ (1-f_k)^m``; hence
with confidence c at most ``m_k = ⌈ln(1-c)/ln(1-f_k)⌉`` unsampled values of
stratum k exceed the sample max (and symmetrically for min), clipped to the
``N_k - n_k`` unsampled tuples.  Cantelli's one-sided inequality turns the
rank slack into a value bound: ``d_k = s_k·√(N_k/m_k − 1)``.  Fully sampled
strata get zero-width bounds; strata too thin to estimate spread
(n_k < 2, under-sampled) are unbounded (±inf).

The bound reads the sampling fraction only through the realized
per-stratum ``(n_k, N_k)`` rows, is deterministic, and shrinks to zero
width at fraction 1.  The bootstrap intervals behind ``var`` and ``p<q>``
are not part of this module yet.
"""

from __future__ import annotations

import torch


def _rank_slack(n: torch.Tensor, total: torch.Tensor, confidence: float) -> torch.Tensor:
    """m_k: with prob >= confidence at most this many unsampled tuples of
    stratum k lie beyond the sample extreme (0 when fully sampled)."""
    f = torch.where(total > 0, n / torch.clamp_min(total, 1.0), 1.0)
    log_miss = torch.log(torch.clamp_min(1.0 - f, 1e-30))
    log_conf = torch.log(torch.tensor(1.0 - confidence, dtype=torch.float32))
    m = torch.ceil(log_conf.to(n.device) / torch.clamp_max(log_miss, -1e-30))
    return torch.minimum(m.clamp_min(0.0), torch.clamp_min(total - n, 0.0))


def extrema_interval(
    side: str,
    ext_value: torch.Tensor,
    n: torch.Tensor,
    total: torch.Tensor,
    mean: torch.Tensor,
    s2: torch.Tensor,
    confidence: float,
    grp: torch.Tensor | None = None,
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
        far = _segment_max(bound, grp, num_groups)
        near = _segment_max(witnessed, grp, num_groups)
    if side == "max":
        return near, far
    return -far, -near


def _segment_max(x: torch.Tensor, grp: torch.Tensor, num_groups: int) -> torch.Tensor:
    """Per-group max (-inf for empty groups); the overflow group is dropped."""
    out = torch.full((num_groups + 1,), -torch.inf, dtype=x.dtype, device=x.device)
    return out.scatter_reduce(0, grp.long(), x, reduce="amax")[:num_groups]
