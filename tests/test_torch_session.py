"""``StreamSession`` of the port (``repro_torch``, CPU) against the JAX
package's, and its contracts within the port.

Against JAX: one stream of six panes, eight registered queries over two
ROIs (SRS, Bernoulli across ROIs, a refined SRS group with its own
fractions, a raw-mode query, a grouped query), tumbling, sliding and
hopping windows, QoS controllers on three of them.  JAX steps with the
split-key chain of its ``StreamSession.run``; the port steps with
``uniforms=jax.random.uniform(sub, (N,))`` of the same subkeys.  Emitted
counters and ``comm_bytes`` are exact, estimates within rtol 1e-4 (f32
summation order; floor 1e-4 of the field's largest finite magnitude), the
controller fractions within 1e-5.

Within the port: a one-query session step equals ``execute`` bit for bit
(bootstrap bounds included), queries sharing a finalize signature share
one emit program, two runs are bitwise equal, a lossless codec leaves every emit
bit-identical to the dense session with fewer bytes, and register /
unregister churn over seen shapes builds no program.
"""

import numpy as np
import pytest
import torch

import jax

from repro.core import feedback as jfb
from repro.core import pipeline as jpipe
from repro.core import query as jquery
from repro.core import session as jsess
from repro.core import stratify as jstrat
from repro.core import windows as jwin
from repro.data import streams as jstreams
from repro_torch.core import feedback as tfb
from repro_torch.core import pipeline as tpipe
from repro_torch.core import query as tquery
from repro_torch.core import session as tsess
from repro_torch.core import stratify as tstrat
from repro_torch.core import windows as twin
from repro_torch.data import streams as tstreams

RTOL = 1e-4
FRAC_TOL = 1e-5
PANE = 2000
ROI_SOUTH = ((22.45, 22.66), (113.76, 114.64))
ROI_NORTH = ((22.64, 22.86), (113.76, 114.64))


def _registrations(mod, wmod, fbmod):
    """(query, kwargs of register) for the eight tenants."""
    Q, A = mod.Query, mod.AggSpec
    slo = fbmod.SLO(target_relative_error=0.02)
    return [
        (Q(aggs=(A("mean", "value"),), roi=ROI_SOUTH, bootstrap_replicates=0),
         dict(slo=slo, window=wmod.WindowSpec("sliding", size=3))),
        (Q(aggs=(A("mean", "occupancy"),), roi=ROI_NORTH, bootstrap_replicates=0),
         dict(window=wmod.WindowSpec("hopping", size=4, stride=2))),
        (Q(aggs=(A("mean", "value"), A("p50", "value")), method="bernoulli", roi=ROI_NORTH,
           bootstrap_replicates=0), dict(window=wmod.WindowSpec("tumbling", size=2))),
        (Q(aggs=(A("mean", "value"), A("max", "value")), method="bernoulli", roi=ROI_SOUTH,
           bootstrap_replicates=0), dict(slo=slo)),
        (Q(aggs=(A("sum", "value"), A("var", "value")), group_by="neighborhood",
           bootstrap_replicates=0), dict(initial_fraction=0.3)),
        (Q(aggs=(A("mean", "occupancy"), A("min", "value")), bootstrap_replicates=0),
         dict(initial_fraction=0.7, slo=slo, window=wmod.WindowSpec("sliding", size=2))),
        (Q(aggs=(A("mean", "value"),), mode="raw", bootstrap_replicates=0), {}),
        (Q(aggs=(A("mean", "value"),), roi=ROI_NORTH, confidence=0.99, bootstrap_replicates=0),
         dict(window=wmod.WindowSpec("sliding", size=3))),
    ]


@pytest.fixture(scope="module")
def stream():
    kw = dict(chunk_size=PANE, num_chunks=6, seed=11)
    jp = list(jwin.pane_windows(jstreams.shenzhen_taxi_stream(**kw), pane_tuples=PANE))
    tp = list(twin.pane_windows(tstreams.shenzhen_taxi_stream(**kw), pane_tuples=PANE))
    assert len(jp) == len(tp) == 6
    keys = []
    key = jax.random.key(21)
    for _ in jp:
        key, sub = jax.random.split(key)
        keys.append(sub)
    return jp, tp, keys


@pytest.fixture(scope="module")
def tables():
    return (jstrat.make_table(*jstrat.SHENZHEN_BBOX, precision=5),
            tstrat.make_table(*tstrat.SHENZHEN_BBOX, precision=5, device="cpu"))


def _close(got, want, exact=False):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if exact:
        assert np.array_equal(got, want, equal_nan=True)
        return
    finite = np.abs(want[np.isfinite(want)])
    floor = RTOL * (finite.max() if finite.size else 0.0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=floor)


@pytest.mark.parametrize("backend", ["pallas", "fused"])
def test_session_matches_jax(tables, stream, backend):
    jt, tt = tables
    jpanes, tpanes, keys = stream
    cfg = dict(backend=backend, raw_capacity=1500)
    js = jsess.StreamSession(jpipe.EdgeCloudPipeline(jt, jpipe.PipelineConfig(**cfg)),
                             initial_fraction=0.6)
    ts = tsess.StreamSession(tpipe.EdgeCloudPipeline(tt, tpipe.PipelineConfig(**cfg), device="cpu"),
                             initial_fraction=0.6)
    jregs = [js.register(q, **kw) for q, kw in _registrations(jquery, jwin, jfb)]
    tregs = [ts.register(q, **kw) for q, kw in _registrations(tquery, twin, tfb)]
    assert [r.qid for r in jregs] == [r.qid for r in tregs]
    assert len(ts._fusion_groups) == len(js._fusion_groups) == 5
    emitted = 0
    refined = False
    for jp, tp, key in zip(jpanes, tpanes, keys):
        refined |= any(ts._refines(g.fused_plan(), [r.fraction for r in g.members])
                       for g in ts._fusion_groups.values())
        want = js.step(key, jp)
        got = ts.step(None, tp, uniforms=np.array(jax.random.uniform(key, (len(tp.lat),))))
        assert got.comm_bytes == want.comm_bytes
        assert sorted(got.results) == sorted(want.results)
        for qid in want.results:
            w, g = want.results[qid], got.results[qid]
            for name in ("n_sampled", "n_valid", "n_overflow", "n_truncated", "comm_bytes",
                         "n_dropped"):
                assert int(getattr(g, name)) == int(getattr(w, name)), (qid, name)
            for key_ in w.estimates:
                for field in w.estimates[key_]._fields:
                    _close(getattr(g.estimates[key_], field).numpy(),
                           getattr(w.estimates[key_], field), exact=field in ("n", "population"))
            emitted += 1
        for qid, f in want.fractions.items():
            assert abs(got.fractions[qid] - float(f)) <= FRAC_TOL, qid
    assert refined  # the SRS pair with its own fractions took the refined pass
    assert emitted >= 20
    assert ts.total_comm_bytes == js.total_comm_bytes
    assert ts.total_passes == js.total_passes
    assert [r.steps for r in tregs] == [r.steps for r in jregs]
    assert [d._replace(group_key=None) for d in ts.plan_log] == \
        [tsess.PlanDecision(*d._replace(group_key=None)) for d in js.plan_log]


def _bits_equal(a, b) -> bool:
    return all(torch.equal(getattr(a[k], f).view(torch.int32), getattr(b[k], f).view(torch.int32))
               for k in a for f in a[k]._fields)


@pytest.mark.parametrize("backend", ["segment", "pallas", "fused"])
@pytest.mark.parametrize("method", ["srs", "bernoulli"])
def test_one_query_step_equals_execute(tables, stream, backend, method):
    """Same generator, same bits: the session draws the step's uniforms and
    then the bootstrap's normals exactly as ``execute`` does."""
    _, tt = tables
    pane = stream[1][0]
    pipe = tpipe.EdgeCloudPipeline(tt, tpipe.PipelineConfig(backend=backend), device="cpu")
    q = tquery.Query(aggs=(tquery.AggSpec("mean", "value"), tquery.AggSpec("var", "value"),
                           tquery.AggSpec("p99", "value")), group_by="neighborhood",
                     method=method, bootstrap_replicates=30)
    want = pipe.execute(q, torch.Generator().manual_seed(5), pane, 0.6)
    sess = tsess.StreamSession(pipe, initial_fraction=0.6)
    reg = sess.register(q)
    got = sess.step(torch.Generator().manual_seed(5), pane).results[reg.qid]
    assert _bits_equal(got.estimates, want.estimates)
    assert int(got.n_sampled) == int(want.n_sampled)
    assert got.comm_bytes == int(want.comm_bytes)


def _session(tt, stream, codec=None, backend="pallas"):
    pipe = tpipe.EdgeCloudPipeline(tt, tpipe.PipelineConfig(backend=backend, uplink_codec=codec,
                                                            raw_capacity=1500), device="cpu")
    sess = tsess.StreamSession(pipe, initial_fraction=0.6)
    regs = [sess.register(q, **kw) for q, kw in _registrations(tquery, twin, tfb)]
    # a bootstrap pair sharing one finalize signature (and so one emit program)
    for roi in (ROI_SOUTH, None):
        q = tquery.Query(aggs=(tquery.AggSpec("var", "value"), tquery.AggSpec("p50", "value")),
                         roi=roi, group_by="neighborhood", bootstrap_replicates=25)
        regs.append(sess.register(q, window=twin.WindowSpec("sliding", size=2)))
    gen = torch.Generator().manual_seed(8)
    return sess, regs, sess.run(stream[1], gen)


def _same_steps(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert sorted(x.results) == sorted(y.results)
        assert x.fractions == y.fractions
        for qid in x.results:
            rx, ry = x.results[qid], y.results[qid]
            assert _bits_equal(rx.estimates, ry.estimates), qid
            for name in ("n_sampled", "n_valid", "n_overflow", "n_truncated"):
                assert int(getattr(rx, name)) == int(getattr(ry, name))


@pytest.mark.parametrize("backend", ["pallas", "fused"])
def test_batched_emits_equal_singletons_and_runs_repeat(tables, stream, backend):
    _, tt = tables
    """Emits go query by query; the bootstrap pair, which shares a finalize
    signature and ring length, shares one cached emit program, and its
    members' emits still differ by ROI.  A second run is bitwise equal."""
    sess, regs, first = _session(tt, stream, backend=backend)
    pair = regs[-2:]
    assert tquery.finalize_signature(pair[0].plan) == tquery.finalize_signature(pair[1].plan)
    emitted = [s for s in first if pair[0].qid in s.results]
    assert emitted and all(pair[1].qid in s.results for s in emitted)
    assert sess.pipe.cache_stats["finalize"]["hits"] >= len(emitted)
    last = emitted[-1].results
    assert not _bits_equal(last[pair[0].qid].estimates, last[pair[1].qid].estimates)
    _, _, again = _session(tt, stream, backend=backend)
    _same_steps(first, again)
    assert [s.comm_bytes for s in first] == [s.comm_bytes for s in again]


@pytest.mark.parametrize("codec", ["sparse", "delta:sparse"])
def test_lossless_codec_session_equals_dense(tables, stream, codec):
    _, tt = tables
    dense_sess, _, dense = _session(tt, stream)
    coded_sess, _, coded = _session(tt, stream, codec=codec)
    _same_steps(dense, coded)
    assert coded_sess.total_comm_bytes < dense_sess.total_comm_bytes


def test_churn_builds_no_program(tables, stream):
    _, tt = tables
    sess, regs, _ = _session(tt, stream)
    pipe = sess.pipe
    before = pipe.compile_count
    for _ in range(3):
        extra = [sess.register(r.query, window=r.window) for r in regs[:4]]
        for r in extra:
            sess.unregister(r)
    sess.step(torch.Generator().manual_seed(1), stream[1][0])
    assert pipe.compile_count == before
    snap = pipe.cache_snapshot()
    assert snap["compile_count"] == before and snap["families"]["pass"]["hits"] > 0
    outcomes = [d.outcome for d in sess.plan_log[-24:]]
    assert outcomes.count("joined") == 12 and outcomes.count("left") == 12


def test_emit_all_is_lazy_and_repeats_the_windows(tables, stream):
    _, tt = tables
    sess, regs, steps = _session(tt, stream)
    before = (sess.pane_index, [(r.fraction, r.steps, len(r.ring)) for r in regs])
    out = sess.emit_all(torch.Generator().manual_seed(8))
    assert set(out) == {r.qid for r in regs}
    # a serving read: no pane, window or controller advances
    assert (sess.pane_index, [(r.fraction, r.steps, len(r.ring)) for r in regs]) == before
    raw_q = regs[6].qid  # a tumbling one-pane query: its window is the last pane
    assert _bits_equal(out[raw_q].estimates, steps[-1].results[raw_q].estimates)


def test_run_stream_shim_tracks_the_session(tables, stream):
    _, tt = tables
    pipe = tpipe.EdgeCloudPipeline(tt, device="cpu")
    q = tquery.Query(aggs=(tquery.AggSpec("mean", "value"),), bootstrap_replicates=0)
    slo = tfb.SLO(target_relative_error=0.02)
    history, state = pipe.run_stream(stream[1][:3], slo=slo, generator=torch.Generator().manual_seed(2),
                                     query=q)
    assert len(history) == 3 and float(state.fraction) == history[-1][1]
    legacy, lstate = pipe.run_stream(stream[1][:3], slo=slo,
                                     generator=torch.Generator().manual_seed(2))
    assert len(legacy) == 3 and abs(legacy[-1][1] - float(lstate.fraction)) == 0.0
    # the shim's first window answers the canonical query at the initial fraction
    first = pipe.process_window(torch.Generator().manual_seed(2), stream[1][0].lat,
                                stream[1][0].lon, stream[1][0].value, stream[1][0].valid, 0.8)
    assert float(first.estimate.mean) == float(legacy[0][0].estimate.mean)
