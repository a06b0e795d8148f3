"""EdgeSOS: decentralized, geohash-stratified online sampling (Algorithm 1).

Each edge node partitions its local window into geohash strata, computes
per-stratum target sizes and draws a Simple Random Sample within every
stratum, with no cross-node synchronization.  In fixed-shape form:

  * exact SRS: one uniform per tuple; a stable sort groups tuples by
    stratum in uniform order, each tuple's rank inside its stratum is its
    position in that run, and ``rank < n_k`` keeps exactly an SRS of size
    ``n_k`` per stratum;
  * bernoulli: keep tuples independently with per-stratum probability
    ``f_k`` (no sort, random sample sizes).

Both read one ``(N,)`` uniform vector ``u`` that the caller draws (or
injects): the sample is a pure function of ``(u, stratum_idx, fraction)``.
Every sort is stable, so ties in ``u`` break by tuple index on every
device.  The sample is a fixed-shape (mask, weight) pair with
Horvitz-Thompson weights.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .transfer import to_device


class SampleResult(NamedTuple):
    """Fixed-shape stratified sample.

    mask: (N,) bool — tuple kept?
    weight: (N,) f32 — Horvitz-Thompson weight (N_k/n_k or 1/f_k); 0 if dropped.
    n_k: (S+1,) i32 — realized per-stratum sample sizes.
    counts: (S+1,) i32 — per-stratum population sizes N_k of this window.
    """

    mask: torch.Tensor
    weight: torch.Tensor
    n_k: torch.Tensor
    counts: torch.Tensor


def segment_count(stratum_idx: torch.Tensor, flags: torch.Tensor, num_slots: int) -> torch.Tensor:
    """Per-slot count of true ``flags`` as int32 (exact on every device)."""
    out = torch.zeros(num_slots, dtype=torch.int32, device=stratum_idx.device)
    return out.index_add_(0, stratum_idx, flags.to(torch.int32))


def stratum_counts(stratum_idx: torch.Tensor, num_slots: int) -> torch.Tensor:
    """Per-stratum population counts N_k (including overflow slot)."""
    return segment_count(stratum_idx, torch.ones_like(stratum_idx, dtype=torch.bool), num_slots)


def _fraction(fraction, device) -> torch.Tensor:
    """A scalar or per-stratum fraction as an f32 tensor on ``device``."""
    return to_device(fraction, torch.float32, device)


def allocate_proportional(counts: torch.Tensor, fraction) -> torch.Tensor:
    """Paper's allocation: n_k = round(f * N_k) (half to even), clipped to
    [0, N_k].  ``fraction`` may be a scalar or a per-stratum vector."""
    target = torch.round(counts.to(torch.float32) * _fraction(fraction, counts.device))
    return torch.minimum(target.to(torch.int32).clamp_min(0), counts)


def allocate_neyman(
    counts: torch.Tensor, stddev: torch.Tensor, fraction, min_per_stratum: int = 1
) -> torch.Tensor:
    """Neyman (variance-optimal) allocation — beyond-paper option.

    n_k proportional to N_k * s_k at the same total budget f * N; falls
    back to proportional where variance info is degenerate."""
    counts_f = counts.to(torch.float32)
    total_budget = torch.sum(counts_f) * _fraction(fraction, counts.device)
    score = counts_f * torch.clamp_min(stddev.to(torch.float32), 0.0)
    denom = torch.sum(score)
    prop = torch.where(
        denom > 0,
        score / torch.clamp_min(denom, 1e-30),
        counts_f / torch.clamp_min(torch.sum(counts_f), 1.0),
    )
    target = torch.round(total_budget * prop).to(torch.int32)
    target = torch.maximum(target, torch.clamp_max(counts, min_per_stratum))
    return torch.minimum(target.clamp_min(0), counts)


def srs_ranks(u: torch.Tensor, stratum_idx: torch.Tensor, num_slots: int):
    """Random rank of each tuple within its stratum -> ``(ranks, counts)``.

    A stable sort by ``u`` shuffles, a stable sort by stratum then groups
    the shuffled tuples; ``ranks[i]`` is uniform over {0..N_k-1} within
    stratum k.  It depends only on ``(u, stratum_idx)``, never on the
    fraction, so the keep-sets ``ranks < n_k`` nest across fractions."""
    n = stratum_idx.shape[0]
    shuffle = torch.argsort(u, stable=True)
    order = torch.argsort(stratum_idx[shuffle], stable=True)
    perm = shuffle[order]  # original indices, grouped by stratum
    counts = stratum_counts(stratum_idx, num_slots)
    starts = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    ranks_sorted = torch.arange(n, dtype=torch.int32, device=u.device) - starts[stratum_idx[perm]]
    ranks = torch.empty(n, dtype=torch.int32, device=u.device)
    ranks[perm] = ranks_sorted
    return ranks, counts


def srs_sample(
    u: torch.Tensor, stratum_idx: torch.Tensor, num_slots: int, n_k: torch.Tensor,
    counts: torch.Tensor,
) -> SampleResult:
    """Exact within-stratum SRS with target sizes n_k (fixed shapes)."""
    ranks, _ = srs_ranks(u, stratum_idx, num_slots)
    mask = ranks < n_k[stratum_idx]
    w_k = torch.where(
        n_k > 0, counts.to(torch.float32) / torch.clamp_min(n_k, 1).to(torch.float32), 0.0
    )
    weight = torch.where(mask, w_k[stratum_idx], 0.0)
    return SampleResult(mask=mask, weight=weight, n_k=n_k, counts=counts)


def bernoulli_sample(
    u: torch.Tensor, stratum_idx: torch.Tensor, num_slots: int, fraction,
    backend: str = "segment",
) -> SampleResult:
    """Per-stratum Bernoulli(f_k) sampling (no sort; random n_k).

    ``u`` depends only on the window, not on stratum membership or the
    fraction, so one draw nests every fraction.  ``backend="pallas"``
    routes the gather + threshold + weight step through the sample_mask
    kernel's wrapper (the CUDA kernel on a CUDA tensor)."""
    counts = stratum_counts(stratum_idx, num_slots)
    frac_k = torch.broadcast_to(_fraction(fraction, u.device), (num_slots,))
    if backend == "pallas":
        from ..kernels.sample_mask import sample_mask

        mask, weight = sample_mask(stratum_idx, u, frac_k.contiguous())
    else:
        f = frac_k[stratum_idx]
        mask = u < f
        weight = torch.where(mask, 1.0 / torch.clamp_min(f, 1e-9), 0.0)
    n_k = segment_count(stratum_idx, mask, num_slots)
    return SampleResult(mask=mask, weight=weight, n_k=n_k, counts=counts)


def edgesos(
    u: torch.Tensor,
    stratum_idx: torch.Tensor,
    num_slots: int,
    fraction,
    *,
    method: str = "srs",
    stddev: torch.Tensor | None = None,
    min_per_stratum: int = 1,
    backend: str = "segment",
) -> SampleResult:
    """Algorithm 1 (EdgeSOS): stratified sample of one window.

    Args:
      u: (N,) f32 uniforms in [0, 1), one per tuple (drawn per window and
        edge node — never shared across nodes).
      stratum_idx: (N,) int32 stratum of each tuple (StratumTable.assign).
      num_slots: S+1.
      fraction: scalar or per-stratum sampling fraction in (0, 1].
      method: 'srs' (paper-faithful exact SRS) | 'bernoulli' | 'neyman'.
      stddev: per-stratum std estimates (required for 'neyman').
      backend: 'segment' | 'pallas' (Bernoulli selection kernel).
    """
    if method == "bernoulli":
        return bernoulli_sample(u, stratum_idx, num_slots, fraction, backend=backend)
    counts = stratum_counts(stratum_idx, num_slots)
    if method == "srs":
        n_k = allocate_proportional(counts, fraction)
    elif method == "neyman":
        if stddev is None:
            raise ValueError("neyman allocation requires per-stratum stddev")
        n_k = allocate_neyman(counts, stddev, fraction, min_per_stratum)
    else:
        raise ValueError(f"unknown method {method!r}")
    return srs_sample(u, stratum_idx, num_slots, n_k, counts)


def compact(mask: torch.Tensor, max_out: int, *arrays: torch.Tensor):
    """Gather kept tuples to the front of a padded ``(max_out, ...)`` buffer.

    The paper's "raw sampled data transmission" mode with static shapes:
    kept tuples first, in their original relative order, padding after
    (zeros, so a padding row's stratum index is 0, behind ``valid=False``).
    Returns ``(valid, gathered...)`` where ``valid`` is a (max_out,) bool
    mask.  The shapes never depend on the data, so nothing waits on the
    device."""
    n = mask.shape[0]
    take = min(max_out, n)
    # a stable sort of the dropped flag (uint8: one sort path on every
    # device) puts kept tuples first in their original order
    order = torch.argsort((~mask).to(torch.uint8), stable=True)
    kept = torch.sum(mask, dtype=torch.int32)
    idx = order[:take]
    valid = torch.arange(max_out, dtype=torch.int32, device=mask.device) < torch.clamp_max(kept, take)

    def gather(a):
        g = a[idx]
        if max_out > n:  # buffer larger than window: pad the tail
            g = torch.cat([g, torch.zeros((max_out - n,) + tuple(a.shape[1:]), dtype=a.dtype,
                                          device=a.device)])
        keep = valid.reshape((max_out,) + (1,) * (a.dim() - 1))
        return torch.where(keep, g, torch.zeros_like(g))

    return (valid,) + tuple(gather(a) for a in arrays)
