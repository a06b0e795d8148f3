"""QoS feedback loop: adapt the sampling fraction to SLOs (paper §3.4/3.6.4).

The paper's loop: if the observed relative error (RE) exceeds the
continuous query's SLO, raise the sampling fraction for later windows; a
cost function also maps a latency budget to a fraction ceiling.

The controller is analytic.  Under proportional allocation
Var(MEAN) ≈ ((1-f)/f) · V / N with V = Σ W_k s_k² about independent of the
fraction, so RE² ∝ (1-f)/f and the fraction that meets a target RE_t from
an observation (f, RE) is

    (1-f')/f' = (RE_t / RE)² (1-f)/f   =>   f' = 1 / (1 + r·(1-f)/f)

with r = (RE_t/RE)².  An EMA on RE plus min/max clamps give stability; a
tuple-budget ceiling implements the latency half of the SLO (EdgeSOS cost
is dominated by the window size, not the kept fraction, so latency maps to
a ceiling on the downstream volume f·N).

States are f32 tensors on one device; the creation functions place them on
the named device, CUDA unless told otherwise (``stratify.resolve_device``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from .stratify import resolve_device
from .transfer import to_device


@dataclasses.dataclass(frozen=True)
class SLO:
    """Continuous-query service level objectives."""

    target_relative_error: float = 0.10
    max_downstream_tuples: int | None = None  # latency budget proxy
    min_fraction: float = 0.05
    max_fraction: float = 1.0
    ema: float = 0.5  # smoothing on observed RE
    deadband: float = 0.05  # relative deadband around the target


class ControllerState(NamedTuple):
    fraction: torch.Tensor  # current sampling fraction (f32)
    re_ema: torch.Tensor  # smoothed observed relative error
    steps: torch.Tensor  # windows processed (int32)


def _f32(x, device) -> torch.Tensor:
    return to_device(x, torch.float32, device)


def init_state(fraction: float = 0.8, device=None) -> ControllerState:
    dev = resolve_device(device)
    return ControllerState(
        fraction=_f32(fraction, dev),
        re_ema=_f32(0.0, dev),
        steps=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _step(f, re_ema_prev, steps, observed_re, window_size, target, cap, min_f, max_f, ema,
          deadband):
    """The controller's math, elementwise; shared by :func:`update` and
    :func:`update_vector`.  Non-finite or negative observations map to the
    target, so they hold the fraction instead of poisoning the EMA."""
    re = torch.where(torch.isfinite(observed_re) & (observed_re >= 0), observed_re, target)
    re_ema = torch.where(steps == 0, re, ema * re + (1.0 - ema) * re_ema_prev)
    r = torch.square(target / torch.clamp_min(re_ema, 1e-9))
    odds = (1.0 - f) / torch.clamp_min(f, 1e-6)
    f_new = 1.0 / (1.0 + r * odds)
    # deadband: don't thrash when RE is already within ±deadband of target
    in_band = torch.abs(re_ema - target) <= deadband * target
    f_new = torch.where(in_band, f, f_new)
    if cap is not None:  # latency budget: cap downstream volume f·N
        f_new = torch.minimum(f_new, cap / torch.clamp_min(window_size.to(torch.float32), 1.0))
    return torch.clamp(f_new, min_f, max_f), re_ema


def update(state: ControllerState, observed_re: torch.Tensor, window_size: torch.Tensor,
           slo: SLO) -> ControllerState:
    """One controller step after a window's estimate is produced.

    ``observed_re`` is whatever error-bounded aggregate drives the query:
    the eq 10 RE for sum/mean or a bootstrap-CI RE for var/quantiles."""
    dev = state.fraction.device
    cap = (None if slo.max_downstream_tuples is None
           else _f32(slo.max_downstream_tuples, dev))
    f_new, re_ema = _step(
        state.fraction, state.re_ema, state.steps, _f32(observed_re, dev),
        to_device(window_size, torch.float32, dev), _f32(slo.target_relative_error, dev), cap,
        slo.min_fraction, slo.max_fraction, slo.ema, slo.deadband,
    )
    return ControllerState(fraction=f_new, re_ema=re_ema, steps=state.steps + 1)


class StackedSLO(NamedTuple):
    """Per-query SLO parameters stacked into (Q,) tensors for the vectorized
    controller of a ``StreamSession`` (``max_downstream_tuples=None`` maps
    to ``+inf``, so the cap is a no-op elementwise)."""

    target: torch.Tensor
    cap: torch.Tensor
    min_fraction: torch.Tensor
    max_fraction: torch.Tensor
    ema: torch.Tensor
    deadband: torch.Tensor


def stack_slos(slos, device=None) -> StackedSLO:
    """Stack a sequence of :class:`SLO` into a :class:`StackedSLO`."""
    slos = list(slos)
    dev = resolve_device(device)
    return StackedSLO(
        target=_f32([s.target_relative_error for s in slos], dev),
        cap=_f32([math.inf if s.max_downstream_tuples is None else float(s.max_downstream_tuples)
                  for s in slos], dev),
        min_fraction=_f32([s.min_fraction for s in slos], dev),
        max_fraction=_f32([s.max_fraction for s in slos], dev),
        ema=_f32([s.ema for s in slos], dev),
        deadband=_f32([s.deadband for s in slos], dev),
    )


def init_vector_state(fractions, device=None) -> ControllerState:
    """Vector controller state: one fraction per registered query."""
    f = _f32(fractions, resolve_device(device))
    return ControllerState(fraction=f, re_ema=torch.zeros_like(f),
                           steps=torch.zeros(f.shape, dtype=torch.int32, device=f.device))


def stack_states(entries, device=None) -> ControllerState:
    """Stack per-registration ``(fraction, re_ema, steps)`` host mirrors into
    one ``(Q,)`` :class:`ControllerState` (three host-to-device copies for
    the whole tenant population, right before the single
    :func:`update_vector` call of a pane)."""
    entries = list(entries)
    dev = resolve_device(device)
    return ControllerState(
        fraction=_f32([e[0] for e in entries], dev),
        re_ema=_f32([e[1] for e in entries], dev),
        steps=to_device([e[2] for e in entries], torch.int32, dev),
    )


def scatter_observations(num: int, segments, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense ``(Q,)`` ``(re_obs, window_size)`` vectors from sparse per-batch
    observation segments ``(rows, re_vec, n_vec)``.  Rows no segment covers
    hold the masked-entry conventions of :func:`update_vector` (``re=0``,
    ``n=1``)."""
    dev = resolve_device(device)
    re_obs = torch.zeros(num, dtype=torch.float32, device=dev)
    n_obs = torch.ones(num, dtype=torch.float32, device=dev)
    for rows, re_vec, n_vec in segments:
        idx = to_device(rows, torch.int64, dev)
        re_obs[idx] = _f32(re_vec, dev)
        n_obs[idx] = _f32(n_vec, dev)
    return re_obs, n_obs


def update_vector(state: ControllerState, observed_re: torch.Tensor, window_size: torch.Tensor,
                  slo: StackedSLO, active: torch.Tensor | None = None) -> ControllerState:
    """Elementwise controller step for a vector of registered queries: the
    math of :func:`update` over the query axis.  Entries where ``active`` is
    False keep their state and do not advance ``steps``; the latency budget
    caps each query's downstream volume independently (``cap=inf``
    disables it)."""
    f_new, re_ema = _step(
        state.fraction, state.re_ema, state.steps, observed_re, window_size, slo.target, slo.cap,
        slo.min_fraction, slo.max_fraction, slo.ema, slo.deadband,
    )
    if active is None:
        active = torch.ones(state.fraction.shape, dtype=torch.bool, device=state.fraction.device)
    return ControllerState(
        fraction=torch.where(active, f_new, state.fraction),
        re_ema=torch.where(active, re_ema, state.re_ema),
        steps=state.steps + active.to(torch.int32),
    )


# -- event-driven sampling ----------------------------------------------------
#
# The SLO controller above closes the loop on observed error; the hooks below
# close it on change.  A watcher compares a registration's per-stratum means
# pane over pane: while the stream is quiet the fraction decays toward an
# idle floor, and a distribution shift or a periodic heartbeat boosts it back
# to a hot fraction.


@dataclasses.dataclass(frozen=True)
class EventPolicy:
    """Heartbeat + change-trigger policy for one watched registration.

    ``change_threshold`` is a max relative per-stratum mean shift between
    consecutive panes; crossing it (or ``heartbeat_panes`` elapsing without
    a probe) boosts the fraction to ``hot_fraction``.  Quiet panes decay the
    fraction by ``idle_decay`` down to ``idle_fraction``."""

    heartbeat_panes: int = 8
    change_threshold: float = 0.25
    hot_fraction: float = 0.8
    idle_fraction: float = 0.1
    idle_decay: float = 0.7


@dataclasses.dataclass
class EventState:
    """Host-side per-registration event bookkeeping."""

    since_heartbeat: int = 0
    quiet_panes: int = 0
    hot_panes: int = 0


def change_score(prev_mean: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    """Scalar tensor: max relative per-stratum mean shift between two panes.

    Strata that are empty or non-finite in either pane are ignored; if no
    stratum is comparable the score is ``inf`` (an unobservable stream must
    fail hot, never idle blind)."""
    prev = prev_mean.to(torch.float32).reshape(-1)
    cur = mean.to(torch.float32).reshape(-1)
    ok = torch.isfinite(prev) & torch.isfinite(cur)
    denom = torch.clamp_min(torch.abs(prev), 1e-9)
    rel = torch.where(ok, torch.abs(cur - prev) / denom, 0.0)
    return torch.where(torch.any(ok), torch.amax(rel), torch.inf)


def event_fraction(state: EventState, score: float, fraction: float, policy: EventPolicy) -> float:
    """One host-side event-policy step; mutates ``state``, returns the new
    fraction.  ``score`` is a plain float (read back off the device)."""
    state.since_heartbeat += 1
    hot = (not math.isfinite(score)) or score >= policy.change_threshold
    if hot or state.since_heartbeat >= policy.heartbeat_panes:
        state.since_heartbeat = 0
        state.quiet_panes = 0
        state.hot_panes += 1
        return float(policy.hot_fraction)
    state.quiet_panes += 1
    return float(max(policy.idle_fraction, fraction * policy.idle_decay))


def fraction_for_target(variance_per_unit: torch.Tensor, population: torch.Tensor,
                        mean: torch.Tensor, slo: SLO, z: float = 1.96) -> torch.Tensor:
    """Feed-forward solve (the paper's ``fractionCalc``): the fraction whose
    predicted RE equals the target, given V = Σ W_k s_k² estimates.

        RE² = z² ((1-f)/f) V / (N mean²)  =>  f = 1 / (1 + N (RE_t mean / z)² / V)
    """
    tgt = slo.target_relative_error
    denom = torch.clamp_min(variance_per_unit, 1e-30)
    a = population * torch.square(tgt * mean / z) / denom
    return torch.clamp(1.0 / (1.0 + a), slo.min_fraction, slo.max_fraction)
