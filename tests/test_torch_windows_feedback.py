"""The port's pane windows and QoS controller against the JAX package:
``WindowSpec`` (defaults and refusals), ``pane_windows`` over count and
time triggers (batches, padding and drop accounting identical), and the
controller (``update``, ``update_vector`` with masks, caps and non-finite
observations; the stacking helpers; the event policy) on the same inputs.
The controller runs in f32 in both packages; fractions and EMAs agree
within 1e-6.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import feedback as jfb
from repro.core import windows as jwin
from repro.data import streams as jstreams
from repro_torch.core import feedback as tfb
from repro_torch.core import windows as twin
from repro_torch.data import streams as tstreams

TOL = 1e-6

SPECS = [dict(), dict(kind="tumbling", size=3), dict(kind="sliding", size=4),
         dict(kind="hopping", size=6, stride=2), dict(kind="hopping", size=3, stride=3)]
BAD = [dict(kind="rolling"), dict(size=0), dict(kind="hopping", size=3),
       dict(kind="tumbling", size=3, stride=1), dict(kind="sliding", size=3, stride=2),
       dict(kind="hopping", size=2, stride=3)]


@pytest.mark.parametrize("kw", SPECS)
def test_window_spec_matches_jax(kw):
    a, b = jwin.WindowSpec(**kw), twin.WindowSpec(**kw)
    assert (a.kind, a.size, a.stride) == (b.kind, b.size, b.stride)


@pytest.mark.parametrize("kw", BAD)
def test_window_spec_refusals_match_jax(kw):
    with pytest.raises(ValueError) as j:
        jwin.WindowSpec(**kw)
    with pytest.raises(ValueError) as t:
        twin.WindowSpec(**kw)
    assert str(t.value) == str(j.value)


@pytest.mark.parametrize("trigger", [dict(pane_tuples=1500),
                                     dict(pane_seconds=30.0, capacity=1200)])
def test_pane_windows_match_jax(trigger):
    kw = dict(chunk_size=2500, num_chunks=3, seed=6)
    jp = list(jwin.pane_windows(jstreams.shenzhen_taxi_stream(**kw), **trigger))
    tp = list(twin.pane_windows(tstreams.shenzhen_taxi_stream(**kw), **trigger))
    assert len(jp) == len(tp) >= 3
    for a, b in zip(jp, tp):
        for f in ("sensor_id", "timestamp", "lat", "lon", "value", "valid"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
        assert a.extra.keys() == b.extra.keys()
        assert all(np.array_equal(a.extra[k], b.extra[k]) for k in a.extra)
        assert (a.n_dropped, a.drop_causes, a.capacity) == (b.n_dropped, b.drop_causes, b.capacity)
    if "pane_seconds" in trigger:
        assert sum(p.n_dropped for p in tp) > 0


def test_pane_windows_refusals():
    with pytest.raises(ValueError, match="exactly one"):
        twin.pane_windows(iter(()), pane_tuples=10, pane_seconds=1.0)
    with pytest.raises(ValueError, match="capacity"):
        twin.pane_windows(iter(()), pane_seconds=1.0)


def _slos():
    return [jfb.SLO(), jfb.SLO(target_relative_error=0.02, max_downstream_tuples=300),
            jfb.SLO(target_relative_error=0.05, min_fraction=0.2, ema=0.8, deadband=0.2),
            jfb.SLO(max_fraction=0.6)]


def _tslo(s):
    return tfb.SLO(**{f: getattr(s, f) for f in s.__dataclass_fields__})


def test_update_vector_matches_jax():
    rng = np.random.default_rng(4)
    q = 8
    slos = [_slos()[i % 4] for i in range(q)]
    frac = rng.uniform(0.05, 1.0, q).astype(np.float32)
    jstate = jfb.stack_states(zip(frac, np.zeros(q), np.zeros(q, np.int32)))
    tstate = tfb.stack_states(zip(frac, np.zeros(q), np.zeros(q, np.int32)), "cpu")
    jslo, tslo = jfb.stack_slos(slos), tfb.stack_slos([_tslo(s) for s in slos], "cpu")
    for step in range(5):
        re = rng.uniform(0.0, 0.2, q).astype(np.float32)
        re[step % q] = [np.inf, np.nan, -1.0, 0.0, 0.5][step]  # held or extreme
        nv = rng.integers(0, 5000, q).astype(np.float32)
        active = rng.random(q) < 0.7
        rows = [int(i) for i in np.flatnonzero(active)]
        j_re, j_n = jfb.scatter_observations(q, [(rows, re[rows], nv[rows])])
        t_re, t_n = tfb.scatter_observations(q, [(rows, torch.from_numpy(re[rows]),
                                                  torch.from_numpy(nv[rows]))], "cpu")
        np.testing.assert_array_equal(t_re.numpy(), np.asarray(j_re))
        np.testing.assert_array_equal(t_n.numpy(), np.asarray(j_n))
        jstate = jfb.update_vector(jstate, j_re, j_n, jslo, jnp.asarray(active))
        tstate = tfb.update_vector(tstate, t_re, t_n, tslo, torch.from_numpy(active))
        np.testing.assert_allclose(tstate.fraction.numpy(), np.asarray(jstate.fraction), atol=TOL)
        np.testing.assert_allclose(tstate.re_ema.numpy(), np.asarray(jstate.re_ema), atol=TOL)
        np.testing.assert_array_equal(tstate.steps.numpy(), np.asarray(jstate.steps))


@pytest.mark.parametrize("slo_index", range(4))
def test_scalar_update_matches_jax_and_vector(slo_index):
    slo = _slos()[slo_index]
    js, ts = jfb.init_state(0.7), tfb.init_state(0.7, "cpu")
    vs = tfb.init_vector_state([0.7], "cpu")
    stacked = tfb.stack_slos([_tslo(slo)], "cpu")
    for re, n in ((0.08, 1000), (float("inf"), 500), (0.01, 4000), (0.3, 20)):
        js = jfb.update(js, jnp.float32(re), jnp.int32(n), slo)
        ts = tfb.update(ts, torch.tensor(re), torch.tensor(n), _tslo(slo))
        vs = tfb.update_vector(vs, torch.tensor([re]), torch.tensor([float(n)]), stacked)
        assert abs(float(ts.fraction) - float(js.fraction)) <= TOL
        assert abs(float(ts.re_ema) - float(js.re_ema)) <= TOL
        assert int(ts.steps) == int(js.steps)
        assert abs(float(vs.fraction[0]) - float(ts.fraction)) <= TOL


def test_event_policy_matches_jax():
    rng = np.random.default_rng(2)
    prev = rng.normal(10, 2, 30).astype(np.float32)
    cur = prev * rng.uniform(0.9, 1.4, 30).astype(np.float32)
    cur[3] = np.nan
    assert float(tfb.change_score(torch.from_numpy(prev), torch.from_numpy(cur))) == \
        pytest.approx(float(jfb.change_score(prev, cur)), rel=1e-6)
    empty = np.full(4, np.nan, np.float32)
    assert math.isinf(float(tfb.change_score(torch.from_numpy(empty), torch.from_numpy(empty))))
    pol = jfb.EventPolicy(heartbeat_panes=3)
    jst, tst = jfb.EventState(), tfb.EventState()
    fj = ft = 0.5
    for score in (0.01, 0.02, 0.9, 0.01, float("inf"), 0.0, 0.0, 0.0):
        fj = jfb.event_fraction(jst, score, fj, pol)
        ft = tfb.event_fraction(tst, score, ft, tfb.EventPolicy(heartbeat_panes=3))
        assert ft == fj and dataclass_tuple(tst) == dataclass_tuple(jst)
    v = rng.uniform(1, 5, 6).astype(np.float32)
    got = tfb.fraction_for_target(torch.from_numpy(v), torch.tensor(5000.0), torch.tensor(20.0),
                                  _tslo(_slos()[1]))
    want = jfb.fraction_for_target(v, 5000.0, 20.0, _slos()[1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def dataclass_tuple(st):
    return (st.since_heartbeat, st.quiet_panes, st.hot_panes)
