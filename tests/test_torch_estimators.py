"""Port estimators, accumulators, bounds and the edge_reduce kernel's plain
version (``repro_torch``, CPU) against the JAX package.

Tolerances: integer-valued results (counts, sketch bins, extrema) match
exactly.  Float sums differ only by summation order and accumulator width
(the port's edge_reduce sums in double and rounds once; JAX sums in f32), so
they are held to the reference's own kernel-test tolerance
(``tests/test_kernels.py``: rtol=2e-6, atol=1e-3) or, where they pass
through further f32 arithmetic, to rtol=1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import bounds as jbounds
from repro.core import estimators as jest
from repro.kernels.edge_reduce.edge_reduce import edge_reduce_pallas
from repro_torch.core import bounds as tbounds
from repro_torch.core import estimators as t_est
from repro_torch.kernels.edge_reduce import edge_reduce, edge_reduce_plain
from repro_torch.kernels.edge_reduce.ref import edge_reduce_ref

KER_RTOL, KER_ATOL = 2e-6, 1e-3
RTOL = 1e-5


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _close(got, want, rtol=RTOL, atol=1e-6):
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=rtol, atol=atol)


def _window(n=6000, s=60, seed=0):
    """Skewed strata with the overflow slot, values across many magnitudes
    and signs (the sketch's whole layout), a random sampling mask."""
    rng = np.random.default_rng(seed)
    sidx = np.minimum((rng.random(n) ** 2 * s).astype(np.int32), s - 1)
    sign = np.where(rng.random(n) < 0.2, -1.0, 1.0)
    values = (sign * rng.lognormal(1.0, 2.5, n)).astype(np.float32)
    values[:20] = 0.0
    mask = rng.random(n) < 0.6
    return sidx, values, mask


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# -- the edge_reduce kernel's plain version ----------------------------------


@pytest.mark.parametrize("n,c,s", [(1, 1, 1), (100, 1, 9), (1300, 3, 40), (5000, 2, 600)])
@pytest.mark.parametrize("mask_mode", ["random", "all", "none"])
def test_edge_reduce_plain_matches_pallas_interpret(n, c, s, mask_mode):
    rng = np.random.default_rng(n + c)
    sidx = rng.integers(0, s, n).astype(np.int32)
    sidx[0] = s - 1  # the overflow slot
    vals = rng.normal(25, 8, (c, n)).astype(np.float32)
    mask = {"random": rng.random(n) < 0.6, "all": np.ones(n, bool), "none": np.zeros(n, bool)}[mask_mode]
    want = edge_reduce_pallas(jnp.asarray(sidx), jnp.asarray(vals), jnp.asarray(mask), s, interpret=True)
    got = edge_reduce(*_t(sidx, vals, mask), s)
    plain = edge_reduce_plain(*_t(sidx, vals, mask), s)
    ref = edge_reduce_ref(sidx, vals, mask, s)
    for g, p, w, r in zip(got, plain, want, ref):
        assert g.shape == tuple(w.shape) and g.dtype == torch.float32
        assert torch.equal(g, p)
        np.testing.assert_allclose(_np(g), _np(w), rtol=KER_RTOL, atol=KER_ATOL)
        np.testing.assert_allclose(_np(g), r, rtol=KER_RTOL, atol=KER_ATOL)
    assert np.array_equal(_np(got[0]), _np(want[0]))  # counts are exact


# -- accumulators --------------------------------------------------------------


def test_moments_accumulate_and_raw_moments_match_jax():
    sidx, vals, mask = _window()
    s = 61
    counts = np.bincount(sidx, minlength=s).astype(np.int32)
    want = jest.MOMENTS.accumulate(jnp.asarray(vals), jnp.asarray(sidx), jnp.asarray(mask), s,
                                   counts=jnp.asarray(counts))
    got = t_est.MOMENTS.accumulate(*_t(vals, sidx, mask), s, counts=torch.from_numpy(counts))
    # lognormal values reach ~1e4: f32 sums over a stratum agree to rtol=1e-5
    _close(got, want, rtol=RTOL, atol=1e-2)
    cnt, s1, s2 = edge_reduce_plain(*_t(sidx, vals[None], mask), s)
    want_raw = jest.stats_from_raw_moments(jnp.asarray(_np(cnt)), jnp.asarray(_np(s1[0])),
                                           jnp.asarray(_np(s2[0])), jnp.asarray(counts))
    got_raw = t_est.MOMENTS.from_kernel_rows(cnt, s1[0], s2[0], torch.from_numpy(counts))
    _close(got_raw, want_raw, rtol=RTOL)


def test_extrema_accumulate_matches_jax_exactly():
    sidx, vals, mask = _window(seed=1)
    s = 61
    want = jest.EXTREMA.accumulate(jnp.asarray(vals), jnp.asarray(sidx), jnp.asarray(mask), s)
    got = t_est.EXTREMA.accumulate(*_t(vals, sidx, mask), s)
    for g, w in zip(got, want):
        assert np.array_equal(_np(g), _np(w))  # including the ±inf identities


def _off_edge(values):
    """Values whose log-bin coordinate is not within 1e-4 of an integer:
    ``log`` may round differently by an ulp there (estimators.py:482)."""
    mag = np.maximum(np.abs(values.astype(np.float64)), t_est.SKETCH_MIN_MAG)
    t = np.log(mag / t_est.SKETCH_MIN_MAG) / t_est.SKETCH_LOG_GAMMA
    return np.abs(t - np.round(t)) > 1e-4


def test_sketch_accumulate_matches_jax():
    sidx, vals, mask = _window(seed=2)
    s = 61
    # plant values exactly on bin edges as well
    edges = _np(t_est.sketch_bin_edges())
    vals[20:60] = np.resize(edges, 40)
    want = jest.SKETCH.accumulate(jnp.asarray(vals), jnp.asarray(sidx), jnp.asarray(mask), s)
    got = t_est.SKETCH.accumulate(*_t(vals, sidx, mask), s)
    # per-stratum totals are exact whatever the bin of an edge value
    assert np.array_equal(_np(got.bins).sum(1), _np(want.bins).sum(1))
    # bin positions are exact for values off the bin edges
    off = mask & _off_edge(vals)
    want = jest.SKETCH.accumulate(jnp.asarray(vals), jnp.asarray(sidx), jnp.asarray(off), s)
    got = t_est.SKETCH.accumulate(*_t(vals, sidx, off), s)
    assert np.array_equal(_np(got.bins), _np(want.bins))
    assert np.array_equal(_np(t_est.sketch_bin_index(torch.from_numpy(vals[off]))),
                          _np(jest.sketch_bin_index(jnp.asarray(vals[off]))))
    _close([t_est.sketch_bin_values(), t_est.sketch_bin_edges()],
           [jest.sketch_bin_values(), jest.sketch_bin_edges()], rtol=1e-6, atol=0)


@pytest.mark.parametrize("kind", ["moments", "extrema", "sketch"])
def test_merge_merge_panes_zero_overflow_match_jax(kind):
    s = 61
    jacc, tacc = jest.accumulator(kind), t_est.accumulator(kind)
    states_j, states_t = [], []
    for seed in range(3):
        sidx, vals, mask = _window(n=2000, seed=10 + seed)
        counts = np.bincount(sidx, minlength=s).astype(np.int32)
        states_j.append(jacc.accumulate(jnp.asarray(vals), jnp.asarray(sidx), jnp.asarray(mask), s,
                                        counts=jnp.asarray(counts)))
        states_t.append(tacc.accumulate(*_t(vals, sidx, mask), s, counts=torch.from_numpy(counts)))
    exact = kind != "moments"
    tol = dict(rtol=RTOL, atol=1e-2)

    def same(got, want):
        if exact:
            for g, w in zip(got, want):
                assert np.array_equal(_np(g), _np(w))
        else:
            _close(got, want, **tol)

    same(tacc.merge(states_t[0], states_t[1]), jacc.merge(states_j[0], states_j[1]))
    stacked_t = type(states_t[0])(*(torch.stack(f) for f in zip(*states_t)))
    stacked_j = type(states_j[0])(*(jnp.stack(f) for f in zip(*states_j)))
    same(tacc.merge_panes(stacked_t), jacc.merge_panes(stacked_j))
    same(tacc.zero_overflow(states_t[2]), jacc.zero_overflow(states_j[2]))
    assert tacc.payload_vectors() == jacc.payload_vectors()


# -- estimators and bounds -----------------------------------------------------


def _stats(seed=3, s=61):
    sidx, vals, mask = _window(n=4000, s=s - 1, seed=seed)
    vals = np.abs(vals) % 50  # a value range where eq 5-10 are well conditioned
    counts = np.bincount(sidx, minlength=s).astype(np.int32)
    j = jest.zero_overflow_stats(jest.sample_stats(jnp.asarray(vals), jnp.asarray(sidx),
                                                   jnp.asarray(mask), s, jnp.asarray(counts)))
    t = t_est.zero_overflow_stats(t_est.sample_stats(*_t(vals, sidx, mask), s,
                                                     torch.from_numpy(counts)))
    return j, t


@pytest.mark.parametrize("confidence", [0.9, 0.95, 0.99])
def test_estimate_and_z_value_match_jax(confidence):
    j, t = _stats()
    np.testing.assert_allclose(_np(t_est.z_value(confidence)), _np(jest.z_value(confidence)), rtol=1e-6)
    _close(t_est.estimate(t, confidence), jest.estimate(j, confidence), rtol=RTOL, atol=1e-4)


def test_guarded_s2_grouped_matches_jax():
    j, t = _stats(seed=4)
    rng = np.random.default_rng(0)
    grp = np.concatenate([rng.integers(0, 7, 60), [7]]).astype(np.int32)
    # a lonely singleton stratum that must borrow its group's spread
    n = _np(t.n).copy()
    n[5] = 1.0
    jn, tn = jnp.asarray(n), torch.from_numpy(n)
    want = jest.guarded_s2(jn, j.total, j.m2, grp=jnp.asarray(grp), num_groups=7)
    got = t_est.guarded_s2(tn, t.total, t.m2, grp=torch.from_numpy(grp), num_groups=7)
    _close(got[:1], want[:1], rtol=RTOL, atol=1e-4)
    assert np.array_equal(_np(got[1]), _np(want[1]))


def test_sketch_quantile_matches_jax():
    rng = np.random.default_rng(5)
    bins = rng.poisson(3.0, (4, t_est.SKETCH_NUM_BINS)).astype(np.float32)
    bins[1] = 0.0  # an empty histogram gives NaN
    for q in (0.01, 0.5, 0.99):
        _close([t_est.sketch_quantile(torch.from_numpy(bins), q)],
               [jest.sketch_quantile(jnp.asarray(bins), q)], rtol=1e-6, atol=0)


@pytest.mark.parametrize("side", ["min", "max"])
@pytest.mark.parametrize("grouped", [False, True])
def test_extrema_interval_matches_jax(side, grouped):
    j, t = _stats(seed=6)
    sidx, vals, mask = _window(n=4000, s=60, seed=6)
    ext = jest.EXTREMA.accumulate(jnp.asarray(vals), jnp.asarray(sidx), jnp.asarray(mask), 61)
    e = np.array(getattr(ext, side))
    s2 = np.where(_np(t.n) > 1, _np(t.m2) / np.maximum(_np(t.n) - 1.0, 1.0), 0.0).astype(np.float32)
    grp = np.concatenate([np.arange(60) % 5, [5]]).astype(np.int32)
    kw_j = dict(grp=jnp.asarray(grp), num_groups=5) if grouped else {}
    kw_t = dict(grp=torch.from_numpy(grp), num_groups=5) if grouped else {}
    want = jbounds.extrema_interval(side, jnp.asarray(e), j.n, j.total, j.mean, jnp.asarray(s2), 0.95, **kw_j)
    got = tbounds.extrema_interval(side, torch.from_numpy(e), t.n, t.total, t.mean,
                                   torch.from_numpy(s2), 0.95, **kw_t)
    _close(got, want, rtol=RTOL, atol=1e-4)


@pytest.mark.parametrize("kind", ["moments", "extrema", "sketch"])
def test_payload_rows_and_single_process_psum(kind, tmp_path):
    """The wire rows match JAX's layout and invert bit-exactly; ``psum``
    over a one-process group returns the state (the collective plumbing;
    multi-process parity arrives with the sharded slice)."""
    import torch.distributed as dist

    s = 61
    sidx, vals, mask = _window(n=2000, seed=30)
    counts = np.bincount(sidx, minlength=s).astype(np.int32)
    jstate = jest.accumulator(kind).accumulate(jnp.asarray(vals), jnp.asarray(sidx),
                                               jnp.asarray(mask), s, counts=jnp.asarray(counts))
    acc = t_est.accumulator(kind)
    state = acc.accumulate(*_t(vals, sidx, mask), s, counts=torch.from_numpy(counts))
    rows = acc.payload_flatten(state)
    want = jest.accumulator(kind).payload_flatten(jstate)
    assert [(r[0], r[2], r[3]) for r in rows] == [(r[0], r[2], r[3]) for r in want]
    back = acc.payload_unflatten({name: t for name, t, _, _ in rows})
    for g, w in zip(back, state):
        assert torch.equal(g, w)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        summed = acc.psum(state)
    finally:
        dist.destroy_process_group()
    _close(summed, state, rtol=RTOL, atol=1e-2)


# -- column stats, pane merges, per-stratum views ------------------------------


def _panes(p=4, s=60):
    """P panes of one column's accumulated states in both packages."""
    out_j, out_t = [], []
    for seed in range(p):
        sidx, values, mask = _window(n=3000, s=s, seed=10 + seed)
        kinds = ("moments", "extrema", "sketch")
        out_j.append(jest.accumulate_column(kinds, jnp.asarray(values), jnp.asarray(sidx),
                                            jnp.asarray(mask), s))
        out_t.append(t_est.accumulate_column(kinds, *_t(values, sidx, mask), s))
    return out_j, out_t


def test_merge_accs_panes_matches_jax_and_pairwise_merges():
    jp, tp = _panes()
    got = t_est.merge_accs_panes(t_est.stack_trees(tp))
    want = jest.merge_accs_panes(jax.tree.map(lambda *x: jnp.stack(x), *jp))
    _close(got["moments"], want["moments"], rtol=RTOL, atol=1e-3)
    _close(got["extrema"], want["extrema"], rtol=0, atol=0)
    assert np.array_equal(_np(got["sketch"].bins), np.asarray(want["sketch"].bins))
    folded = tp[0]
    for p in tp[1:]:
        folded = t_est.merge_accs(folded, p)
    _close(folded["moments"], got["moments"], rtol=RTOL, atol=1e-3)


def test_column_stats_merges_match_jax():
    cols_j, cols_t = [], []
    for seed in range(3):
        sidx, values, mask = _window(n=2500, s=40, seed=30 + seed)
        cols_j.append(jest.column_stats(jnp.asarray(values), jnp.asarray(sidx), jnp.asarray(mask),
                                        40, extrema=seed != 2))
        cols_t.append(t_est.column_stats(*_t(values, sidx, mask), 40, extrema=seed != 2))
    for g, w in zip(cols_t, cols_j):
        _close(g, w, rtol=RTOL, atol=1e-3)
    _close(t_est.merge_column_stats(*cols_t[:2]), jest.merge_column_stats(*cols_j[:2]),
           rtol=RTOL, atol=1e-3)
    _close(t_est.merge_all_columns(cols_t), jest.merge_all_columns(cols_j), rtol=RTOL, atol=1e-3)
    _close(t_est.merge_column_stats_panes(t_est.stack_column_stats(cols_t)),
           jest.merge_column_stats_panes(jest.stack_column_stats(cols_j)), rtol=RTOL, atol=1e-3)
    assert cols_t[0].base == t_est.StratumStats(*cols_t[0][:5])


def test_per_stratum_means_and_substream_sums_match_jax():
    jp, tp = _panes(p=3)
    jm = [p["moments"] for p in jp]
    tm = [p["moments"] for p in tp]
    for g, w in zip(t_est.per_stratum_means(tm[0], 0.9), jest.per_stratum_means(jm[0], 0.9)):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(_np(t_est.substream_sums(tm)), np.asarray(jest.substream_sums(jm)),
                               rtol=RTOL)
    _close(t_est.merge_all(tm), jest.merge_all(jm), rtol=RTOL, atol=1e-3)
