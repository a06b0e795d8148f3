"""The port's bootstrap bounds (``repro_torch.core.bounds``, CPU) against the
JAX package.

JAX draws its bootstrap normals from ``jax.random`` keys; the port takes
them from a ``torch.Generator`` or as injected ``normals``.  The parity
tests rebuild JAX's draws from the same key (the derivation of
``repro.core.query.finalize``) and inject them, so both sides bootstrap
the same replicates.

Tolerances: ``var`` intervals within rtol=1e-4 (with an absolute floor of
1e-4 of the largest finite magnitude, as the pipeline tests): the sums run
in another order, and a percentile of 200 replicates moves with them.
Quantile intervals equal, or lie within one sketch bin: CDF inversion is a
step function, and one ulp in a weight can move a replicate by a bin.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import bounds as jbounds
from repro.core import estimators as jest
from repro.core import pipeline as jpipe
from repro.core import query as jquery
from repro.core import stratify as jstrat
from repro.data import streams as jstreams
from repro_torch import convert
from repro_torch.core import bounds as tbounds
from repro_torch.core import estimators as test_
from repro_torch.core import query as tquery
from repro_torch.core import sampling as tsampling

R = 200
RTOL = 1e-4
BIN_RATIO = float(np.exp(jest.SKETCH_LOG_GAMMA))  # neighbouring bin edges' ratio


@pytest.fixture(scope="module")
def setup():
    jt = jstrat.make_table(*jstrat.SHENZHEN_BBOX, precision=5)
    w = jstreams.materialize(jstreams.shenzhen_taxi_stream(chunk_size=3000, num_chunks=2, seed=1))
    window = {k: w[k] for k in ("lat", "lon", "value", "occupancy")}
    table = convert.table_from_numpy(np.asarray(jt.codes), np.asarray(jt.neighborhood),
                                     jt.precision, jt.neighborhood_precision,
                                     jt.num_neighborhoods, device="cpu")
    return jt, table, window


def jax_normals(key, aggs, stats, num_slots, wb_shape) -> dict:
    """The draws JAX's finalize makes from ``key``, in the port's layout."""
    bkey = jax.random.fold_in(key, 0x626E64)
    out = {}
    for i, (kind, col) in enumerate(aggs):
        akey = jax.random.fold_in(bkey, i)
        if kind == "var":
            k_mom, k_sk = jax.random.split(akey)
            k1, k2 = jax.random.split(k_mom)
            out[i] = {"mean": jax.random.normal(k1, (R, num_slots)),
                      "s2": jax.random.normal(k2, (R, num_slots))}
            if "sketch" in stats[col]:
                out[i]["sketch"] = jax.random.normal(k_sk, (R,) + wb_shape)
        elif jquery.quantile_of(kind) is not None:
            out[i] = {"sketch": jax.random.normal(akey, (R,) + wb_shape)}
    return {i: {k: torch.from_numpy(np.array(v)) for k, v in d.items()} for i, d in out.items()}


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    finite = np.abs(want[np.isfinite(want)])
    floor = RTOL * (finite.max() if finite.size else 0.0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=floor)


def _within_a_bin(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    gap = np.abs(got[fin] - want[fin])
    assert np.all(gap <= (BIN_RATIO - 1.0) * np.abs(want[fin]) + 1e-6), (got, want)


AGG_CASES = {
    # var on a column that ships a sketch (union with the sketch channel)
    "var+sketch": (("var", "value"), ("p50", "value"), ("p99", "value")),
    # var alone on its column: the moment bootstrap with normal kurtosis
    "var": (("var", "occupancy"), ("mean", "value")),
}


@pytest.mark.parametrize("group_by", [None, "neighborhood"])
@pytest.mark.parametrize("case", sorted(AGG_CASES))
def test_finalize_bootstrap_matches_jax(setup, case, group_by):
    jt, table, window = setup
    aggs = AGG_CASES[case]
    key = jax.random.key(5)
    jq = jquery.Query(aggs=tuple(jquery.AggSpec(*a) for a in aggs), group_by=group_by,
                      bootstrap_replicates=R)
    res = jpipe.EdgeCloudPipeline(jt).execute(jq, key, window, 0.3)
    stats_np = {c: {k: {f: np.asarray(v) for f, v in s._asdict().items()} for k, s in kinds.items()}
                for c, kinds in res.stats.items()}
    stats = convert.accs_from_numpy(stats_np, device="cpu")
    plan = tquery.lower(tquery.Query(aggs=tuple(tquery.AggSpec(*a) for a in aggs),
                                     group_by=group_by, bootstrap_replicates=R), table)
    wb_shape = (plan.num_groups, jest.SKETCH_NUM_BINS) if group_by else (jest.SKETCH_NUM_BINS,)
    normals = jax_normals(key, aggs, stats, table.num_slots, wb_shape)
    # the port lays its own draws out the same way
    drawn = tquery.bootstrap_normals(plan, table, stats, torch.Generator().manual_seed(0))
    assert {i: {k: v.shape for k, v in d.items()} for i, d in drawn.items()} == \
        {i: {k: v.shape for k, v in d.items()} for i, d in normals.items()}
    got = tquery.finalize(plan, table, stats, normals=normals)
    for (kind, _), key_ in zip(aggs, (a.key for a in jq.aggs)):
        g, w = got[key_], res.estimates[key_]
        _close(g.value.numpy(), w.value)
        for field in ("ci_low", "ci_high"):
            if kind.startswith("p"):
                _within_a_bin(getattr(g, field).numpy(), getattr(w, field))
            else:
                _close(getattr(g, field).numpy(), getattr(w, field))
        if kind in ("var", "p50", "p99"):
            lo, hi, val = g.ci_low.numpy(), g.ci_high.numpy(), g.value.numpy()
            fin = np.isfinite(val)
            assert np.any(hi[fin] > lo[fin])  # a real interval, not a point


def _moment_rows(seed=2, s=30):
    rng = np.random.default_rng(seed)
    n = rng.integers(0, 40, s + 1).astype(np.float32)
    total = n + rng.integers(0, 60, s + 1).astype(np.float32)
    mean = rng.normal(10, 4, s + 1).astype(np.float32)
    s2 = rng.gamma(2.0, 3.0, s + 1).astype(np.float32)
    bins = np.zeros((s + 1, jest.SKETCH_NUM_BINS), np.float32)
    for k in range(s + 1):
        idx = rng.integers(250, 330, int(n[k]))
        np.add.at(bins[k], idx, 1.0)
    grp = np.minimum(np.arange(s + 1) // 7, 4).astype(np.int32)
    grp[-1] = 5  # the overflow slot's discarded group
    return n, total, mean, s2, bins, grp, 5


@pytest.mark.parametrize("grouped", [False, True])
def test_var_interval_and_kurtosis_match_jax(grouped):
    n, total, mean, s2, bins, grp, g = _moment_rows()
    key = jax.random.key(3)
    k1, k2 = jax.random.split(key)
    e1, e2 = jax.random.normal(k1, (R, n.shape[0])), jax.random.normal(k2, (R, n.shape[0]))
    kw_j = dict(grp=jnp.asarray(grp), num_groups=g) if grouped else {}
    kw_t = dict(grp=torch.from_numpy(grp), num_groups=g) if grouped else {}
    kj = jbounds.sketch_kurtosis(jnp.asarray(bins), jnp.asarray(n))
    kt = tbounds.sketch_kurtosis(torch.from_numpy(bins), torch.from_numpy(n))
    np.testing.assert_allclose(kt.numpy(), kj, rtol=1e-5)
    want = jbounds.var_interval(key, *map(jnp.asarray, (n, total, mean, s2)), 0.95, R,
                                kurtosis=kj, **kw_j)
    got = tbounds.var_interval((torch.from_numpy(np.array(e1)), torch.from_numpy(np.array(e2))),
                               *map(torch.from_numpy, (n, total, mean, s2)), 0.95,
                               kurtosis=kt, **kw_t)
    for a, b in zip(got, want):
        _close(a.numpy(), b)


@pytest.mark.parametrize("grouped", [False, True])
def test_collapsed_and_quantile_intervals_match_jax(grouped):
    n, total, _, _, bins, grp, g = _moment_rows(seed=4)
    key = jax.random.key(8)
    wb_shape = (g, jest.SKETCH_NUM_BINS) if grouped else (jest.SKETCH_NUM_BINS,)
    eps = jax.random.normal(key, (R,) + wb_shape)
    kw_j = dict(grp=jnp.asarray(grp), num_groups=g) if grouped else {}
    kw_t = dict(grp=torch.from_numpy(grp), num_groups=g) if grouped else {}
    args_t = (torch.from_numpy(np.array(eps)), torch.from_numpy(bins), torch.from_numpy(n),
              torch.from_numpy(total))
    wb_j, wbr_j = jbounds.collapsed_replicates(key, jnp.asarray(bins), jnp.asarray(n),
                                               jnp.asarray(total), R, **kw_j)
    wb_t, wbr_t = tbounds.collapsed_replicates(*args_t, **kw_t)
    np.testing.assert_allclose(wb_t.numpy(), wb_j, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(wbr_t.numpy(), wbr_j, rtol=1e-4, atol=1e-2)
    lo_j, hi_j = jbounds.quantile_interval(key, jnp.asarray(bins), jnp.asarray(n),
                                           jnp.asarray(total), 0.5, 0.95, R, **kw_j)
    lo_t, hi_t = tbounds.quantile_interval(*args_t, 0.5, 0.95, **kw_t)
    _within_a_bin(lo_t.numpy(), lo_j)
    _within_a_bin(hi_t.numpy(), hi_j)
    center = jnp.full(wb_shape[:-1], 30.0)
    vj = jbounds.var_sketch_interval(key, jnp.asarray(bins), jnp.asarray(n), jnp.asarray(total),
                                     0.95, R, center, **kw_j)
    vt = tbounds.var_sketch_interval(*args_t, 0.95, torch.from_numpy(np.array(center)), **kw_t)
    for a, b in zip(vt, vj):
        _close(a.numpy(), b)


def test_group_sum_is_a_fixed_order_segment_sum():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 1, (3, 101)).astype(np.float32))
    grp = torch.from_numpy(rng.integers(0, 9, 101).astype(np.int32))
    grp[-1] = 8
    got = test_.group_sum(x, grp, 8, dim=-1)
    want = test_.segment_sum(x.T, grp, 9)[:8].T
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    groups = test_.groups_of(grp, 8)
    assert torch.equal(test_.group_sum(x, groups, 8, dim=-1), got)
    # each group adds its strata one after another in ascending slot order
    for row, total in zip(x.numpy(), got[:, 3].numpy()):
        acc = np.float32(0.0)
        for value in row[grp.numpy() == 3]:
            acc = np.float32(acc + value)
        assert acc == total


def _skewed_population(seed, n=3_000, s=4):
    """A skewed (lognormal-mixture) stream over a few strata, the shape of
    the reference's coverage test."""
    rng = np.random.default_rng(seed)
    sidx = rng.integers(0, s, n)
    v = rng.lognormal(mean=1.0, sigma=0.6, size=n) * (1.0 + 0.8 * sidx) + 0.5
    return torch.from_numpy(sidx.astype(np.int32)), torch.from_numpy(v.astype(np.float32)), s


def _trial_intervals(v, sidx, slots, fraction, gen, replicates=300):
    u = torch.rand(v.shape[0], generator=gen)
    res = tsampling.edgesos(u, sidx, slots, fraction)
    mom = test_.sample_stats(v, sidx, res.mask, slots, counts=res.counts)
    sk = test_.SKETCH.accumulate(v, sidx, res.mask, slots)
    zeroed = test_.zero_overflow_stats(mom)
    zs = test_.SKETCH.zero_overflow(sk)
    n, N = zeroed.n, zeroed.total
    s2 = torch.where(n > 1, zeroed.m2 / torch.clamp_min(n - 1.0, 1.0), 0.0)
    active = (n > 0) & (N > 0)
    cov = torch.sum(torch.where(active, N, 0.0))
    mean_g = torch.sum(torch.where(active, N * zeroed.mean, 0.0)) / cov
    var_hat = torch.sum(torch.where(active, N * (s2 + zeroed.mean ** 2), 0.0)) / cov - mean_g ** 2
    normals = {"mean": torch.randn((replicates, slots), generator=gen),
               "s2": torch.randn((replicates, slots), generator=gen),
               "sketch": torch.randn((replicates, test_.SKETCH_NUM_BINS), generator=gen)}
    var_ci = test_.MOMENTS.interval(zeroed, "var", zeroed, normals=normals, replicates=replicates,
                                    sketch=zs, center=var_hat)
    p50_ci = test_.SKETCH.interval(zs, "p50", zeroed, q=0.5, replicates=replicates,
                                   normals={"sketch": torch.randn(
                                       (replicates, test_.SKETCH_NUM_BINS), generator=gen)})
    return var_ci, p50_ci


def test_bootstrap_coverage_with_torch_draws():
    """Empirical coverage of the 95% var and p50 intervals over 200 fixed-seed
    trials on a skewed stream stays within 7pp of nominal.  Truth is the
    estimators' own full-population values, so only sampling error counts."""
    sidx, v, s = _skewed_population(7)
    slots = s + 1
    full = torch.ones(v.shape, dtype=torch.bool)
    counts = tsampling.stratum_counts(sidx, slots)
    mom = test_.sample_stats(v, sidx, full, slots, counts=counts)
    n, N = mom.n, mom.total
    s2 = torch.where(n > 1, mom.m2 / torch.clamp_min(n - 1.0, 1.0), 0.0)
    active = (n > 0) & (N > 0)
    cov = torch.sum(torch.where(active, N, 0.0))
    mean_full = torch.sum(torch.where(active, N * mom.mean, 0.0)) / cov
    var_true = float(torch.sum(torch.where(active, N * (s2 + mom.mean ** 2), 0.0)) / cov
                     - mean_full ** 2)
    p50_true = float(test_.sketch_quantile(test_.SKETCH.accumulate(v, sidx, full, slots).bins.sum(0),
                                           0.5))
    gen = torch.Generator().manual_seed(2024)
    trials, hit_var, hit_p50 = 200, 0, 0
    for _ in range(trials):
        (vlo, vhi), (plo, phi) = _trial_intervals(v, sidx, slots, 0.4, gen)
        hit_var += int(float(vlo) <= var_true <= float(vhi))
        hit_p50 += int(float(plo) <= p50_true <= float(phi))
    for hits in (hit_var, hit_p50):
        assert abs(hits / trials - 0.95) <= 0.07, (hit_var, hit_p50)


def test_intervals_zero_width_at_full_fraction_and_reproducible(setup):
    _, table, window = setup
    from repro_torch.core import pipeline as tpipe

    pipe = tpipe.EdgeCloudPipeline(table, tpipe.PipelineConfig(backend="fused"), device="cpu")
    q = tquery.Query(aggs=(tquery.AggSpec("var", "value"), tquery.AggSpec("p50", "value"),
                           tquery.AggSpec("p99", "occupancy")), group_by="neighborhood")
    full = pipe.execute(q, torch.Generator().manual_seed(1), window, 1.0)
    for est in full.estimates.values():
        val = est.value.numpy()
        fin = np.isfinite(val)
        assert fin.any()
        np.testing.assert_allclose(est.ci_low.numpy()[fin], val[fin], rtol=1e-5)
        np.testing.assert_allclose(est.ci_high.numpy()[fin], val[fin], rtol=1e-5)
    a = pipe.execute(q, torch.Generator().manual_seed(9), window, 0.4)
    b = pipe.execute(q, torch.Generator().manual_seed(9), window, 0.4)
    c = pipe.execute(q, torch.Generator().manual_seed(10), window, 0.4)
    for key in a.estimates:
        for field in ("value", "ci_low", "ci_high"):
            # bit for bit, NaN of an empty group included
            assert torch.equal(getattr(a.estimates[key], field).view(torch.int32),
                               getattr(b.estimates[key], field).view(torch.int32))
    assert not torch.equal(a.estimates["var_value"].ci_high, c.estimates["var_value"].ci_high)
