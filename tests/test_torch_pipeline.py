"""The port's main path end to end (``repro_torch``, CPU) against the JAX
package: ``EdgeCloudPipeline.execute`` with the segment, pallas and fused
backends (f32 and bf16 staging), the refined fused pass of a fusion group,
``finalize`` on states carried across by ``repro_torch.convert``, the
bootstrap draws of ``execute``, the copied stream generators and windows,
and the device rules.

Tolerances: counters and population counts are exact.  Estimates differ
only by f32 summation order (the port's edge_reduce sums in double, JAX in
f32; the raw-moment centering m2 = Σy² − nȳ² amplifies that in moe), so they
are held to rtol=1e-4 with an absolute floor of 1e-4 of the field's largest
finite magnitude.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import pipeline as jpipe
from repro.core import query as jquery
from repro.core import stratify as jstrat
from repro.core import windows as jwin
from repro.core import geohash as jgeo
from repro.data import streams as jstreams
from repro_torch import convert
from repro_torch.core import pipeline as tpipe
from repro_torch.core import query as tquery
from repro_torch.core import stratify as tstrat
from repro_torch.core import windows as twin
from repro_torch.data import streams as tstreams
from repro_torch.kernels import build
from repro_torch.kernels.edge_reduce import edge_reduce
from repro_torch.kernels.geohash import geohash_encode
from repro_torch.kernels.sample_mask import sample_mask

RTOL = 1e-4
FRACTION = 0.5
AGGS = (("sum", "value"), ("mean", "value"), ("count", "value"), ("min", "value"),
        ("max", "value"), ("var", "value"), ("p50", "value"), ("p99", "value"),
        ("mean", "occupancy"))


@pytest.fixture(scope="module")
def setup():
    jt = jstrat.make_table(*jstrat.SHENZHEN_BBOX, precision=5)
    tt = tstrat.make_table(*tstrat.SHENZHEN_BBOX, precision=5, device="cpu")
    w = jstreams.materialize(jstreams.shenzhen_taxi_stream(chunk_size=3000, num_chunks=2, seed=1))
    window = {k: w[k] for k in ("lat", "lon", "value", "occupancy")}
    # a few tuples outside the box, and padding, exercise the overflow slot
    window["lat"][:40] += 1.0
    window["valid"] = np.ones(len(w["lat"]), bool)
    window["valid"][-25:] = False
    prefix = jgeo.to_strings(np.asarray(jt.codes)[len(jt.codes) // 2 : len(jt.codes) // 2 + 1], 5)[0][:4]
    return jt, tt, window, prefix


def _close(got, want, exact=False):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if exact:
        assert np.array_equal(got, want, equal_nan=True)
        return
    finite = np.abs(want[np.isfinite(want)])
    floor = RTOL * (finite.max() if finite.size else 0.0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=floor)


def _same_estimates(got: dict, want: dict):
    assert got.keys() == want.keys()
    for key in want:
        for field in want[key]._fields:
            _close(getattr(got[key], field).numpy(), getattr(want[key], field),
                   exact=field in ("n", "population"))


def _queries(method, group_by, roi, mod):
    return mod.Query(aggs=tuple(mod.AggSpec(*a) for a in AGGS), group_by=group_by, roi=roi,
                     method=method, bootstrap_replicates=0)


CASES = [(None, None), ("stratum", "bbox"), ("neighborhood", "prefix")]


@pytest.mark.parametrize("backend", ["segment", "pallas", "fused"])
@pytest.mark.parametrize("method", ["srs", "bernoulli"])
@pytest.mark.parametrize("group_by,roi_kind", CASES)
def test_execute_matches_jax(setup, backend, method, group_by, roi_kind):
    _execute_matches_jax(setup, backend, method, group_by, roi_kind, "float32")


@pytest.mark.parametrize("method", ["srs", "bernoulli"])
def test_execute_fused_bf16_staging_matches_jax(setup, method):
    _execute_matches_jax(setup, "fused", method, "neighborhood", "bbox", "bfloat16")


def _execute_matches_jax(setup, backend, method, group_by, roi_kind, staging):
    jt, tt, window, prefix = setup
    roi = {None: None, "bbox": ((22.5, 22.7), (113.9, 114.3)), "prefix": prefix}[roi_kind]
    key = jax.random.key(11)
    n = len(window["lat"])
    want = jpipe.EdgeCloudPipeline(
        jt, jpipe.PipelineConfig(backend=backend, staging_dtype=staging)).execute(
        _queries(method, group_by, roi, jquery), key, window, FRACTION)
    before = dict(build.LAUNCHES)
    got = tpipe.EdgeCloudPipeline(
        tt, tpipe.PipelineConfig(backend=backend, staging_dtype=staging), device="cpu").execute(
        _queries(method, group_by, roi, tquery), None, window, FRACTION,
        uniforms=np.array(jax.random.uniform(key, (n,))))
    assert build.LAUNCHES == before  # CPU tensors take the plain versions
    for name in ("n_sampled", "n_valid", "n_overflow", "n_truncated", "comm_bytes"):
        assert int(getattr(got, name)) == int(getattr(want, name)), name
    assert int(want.n_overflow) > 0
    _same_estimates(got.estimates, want.estimates)
    for col in ("value", "occupancy"):
        _close(got.stats[col]["moments"].n.numpy(), want.stats[col]["moments"].n, exact=True)
    for field in ("min", "max"):
        _close(getattr(got.stats["value"]["extrema"], field).numpy(),
               getattr(want.stats["value"]["extrema"], field), exact=True)
    _close(got.stats["value"]["sketch"].bins.numpy().sum(1),
           np.asarray(want.stats["value"]["sketch"].bins).sum(1), exact=True)


def test_execute_draws_uniforms_from_the_generator(setup):
    _, tt, window, _ = setup
    pipe = tpipe.EdgeCloudPipeline(tt, tpipe.PipelineConfig(backend="pallas"), device="cpu")
    q = _queries("bernoulli", None, None, tquery)
    a = pipe.execute(q, torch.Generator().manual_seed(3), window, FRACTION)
    u = torch.rand(len(window["lat"]), generator=torch.Generator().manual_seed(3))
    b = pipe.execute(q, None, window, FRACTION, uniforms=u)
    assert int(a.n_sampled) == int(b.n_sampled)
    assert float(a.estimates["mean_value"].value) == float(b.estimates["mean_value"].value)
    with pytest.raises(ValueError):
        pipe.execute(q, None, window, FRACTION, uniforms=u[:-1])


def _stats_numpy(stats) -> dict:
    return {c: {k: {f: np.asarray(v) for f, v in s._asdict().items()} for k, s in kinds.items()}
            for c, kinds in stats.items()}


@pytest.mark.parametrize("group_by", [None, "stratum", "neighborhood"])
def test_finalize_on_carried_states_matches_jax(setup, group_by):
    jt, _, window, _ = setup
    key = jax.random.key(5)
    jq = _queries("srs", group_by, None, jquery)
    res = jpipe.EdgeCloudPipeline(jt).execute(jq, key, window, 0.3)
    table = convert.table_from_numpy(np.asarray(jt.codes), np.asarray(jt.neighborhood), jt.precision,
                                     jt.neighborhood_precision, jt.num_neighborhoods, device="cpu")
    stats = convert.accs_from_numpy(_stats_numpy(res.stats), device="cpu")
    tq = _queries("srs", group_by, None, tquery)
    got = tquery.finalize(tquery.lower(tq, table), table, stats)
    # execute's estimates are JAX's finalize of exactly these states
    _same_estimates(got, res.estimates)
    # no bootstrap: var and quantiles are zero-width point estimates
    for key_ in ("var_value", "p50_value"):
        value = got[key_].value.numpy()
        ok = np.isfinite(value)  # an empty group has no point estimate
        assert ok.any() and np.all(got[key_].ci_low.numpy()[ok] == value[ok])


def _member_queries(mod, method):
    """Three members of one fusion group, with differing aggregates (and,
    for Bernoulli, differing ROIs)."""
    rois = (None, ((22.5, 22.7), (113.9, 114.3)), ((22.6, 22.9), (113.7, 114.1)))
    aggs = ((("mean", "value"), ("max", "value")),
            (("p50", "value"), ("mean", "occupancy")),
            (("sum", "occupancy"), ("min", "occupancy"), ("var", "value")))
    return [mod.Query(aggs=tuple(mod.AggSpec(*a) for a in agg), method=method,
                      roi=rois[i] if method == "bernoulli" else None, bootstrap_replicates=0)
            for i, agg in enumerate(aggs)]


@pytest.mark.parametrize("backend", ["pallas", "fused"])
@pytest.mark.parametrize("method", ["srs", "bernoulli"])
def test_refined_fused_pass_matches_jax(setup, backend, method):
    """Three members at fractions 0.2, 0.5 and 0.8 thinned from one shared
    draw (SRS), or masked to their own ROIs (Bernoulli): the per-member
    counters are exact and the estimates within RTOL of JAX's refined pass."""
    jt, tt, window, _ = setup
    key = jax.random.key(21)
    fractions = (0.2, 0.5, 0.8)
    jfused = jquery.fuse([jquery.lower(q, jt) for q in _member_queries(jquery, method)])
    tfused = tquery.fuse([tquery.lower(q, tt) for q in _member_queries(tquery, method)])
    assert tquery.fusion_key(tfused.members[0]) == jquery.fusion_key(jfused.members[0])
    assert tfused.shared.column_kinds == jfused.shared.column_kinds
    assert tfused.cross_roi == jfused.cross_roi == (method == "bernoulli")
    cols = {c: jnp.asarray(window[c], jnp.float32) for c in jfused.columns}
    lat, lon = jnp.asarray(window["lat"], jnp.float32), jnp.asarray(window["lon"], jnp.float32)
    valid = jnp.asarray(window["valid"])
    want, want_comm = jpipe._fused_edge_program(
        jfused, jt, jpipe.PipelineConfig(backend=backend), key, lat, lon, cols, valid,
        jnp.asarray(fractions, jnp.float32))
    pipe = tpipe.EdgeCloudPipeline(tt, tpipe.PipelineConfig(backend=backend), device="cpu")
    got, comm = pipe.refined_pass(tfused, None, window, fractions,
                                  uniforms=np.array(jax.random.uniform(key, lat.shape)))
    assert comm == int(want_comm) == tquery.refined_preagg_bytes(tfused, tt.num_slots)
    for m, (g, w) in enumerate(zip(got, want)):
        for i in (1, 2, 3):  # n_sampled, n_valid, n_overflow
            assert int(g[i]) == int(w[i]), (m, i)
        for col in g[0]:
            _close(g[0][col]["moments"].n.numpy(), w[0][col]["moments"].n, exact=True)
        plan_t, plan_j = tfused.members[m], jfused.members[m]
        _same_estimates(tquery.finalize(plan_t, tt, g[0]), jquery.finalize(plan_j, jt, w[0]))
    # SRS members nest: a smaller fraction keeps a subset of a larger one's sample
    if method == "srs":
        n_by_member = [int(g[1]) for g in got]
        assert n_by_member == sorted(n_by_member)


@pytest.mark.parametrize("backend", ["pallas", "fused"])
def test_execute_bootstrap_matches_jax(setup, backend):
    """``var``/``p<q>`` answer with bootstrap intervals on every backend;
    with JAX's uniforms and normals injected they match JAX's execute."""
    jt, tt, window, _ = setup
    aggs = (("var", "value"), ("p50", "value"), ("p99", "occupancy"), ("var", "occupancy"))
    key = jax.random.key(13)
    n = len(window["lat"])
    jq = jquery.Query(aggs=tuple(jquery.AggSpec(*a) for a in aggs), group_by="neighborhood")
    tq = tquery.Query(aggs=tuple(tquery.AggSpec(*a) for a in aggs), group_by="neighborhood")
    want = jpipe.EdgeCloudPipeline(jt, jpipe.PipelineConfig(backend=backend)).execute(
        jq, key, window, FRACTION)
    pipe = tpipe.EdgeCloudPipeline(tt, tpipe.PipelineConfig(backend=backend), device="cpu")
    plan = pipe.plan(tq)
    bkey = jax.random.fold_in(key, 0x626E64)
    shape = (tq.bootstrap_replicates, plan.num_groups, 513)
    normals = {}
    for i, (kind, col) in enumerate(aggs):
        akey = jax.random.fold_in(bkey, i)
        if kind == "var":
            k_mom, k_sk = jax.random.split(akey)
            k1, k2 = jax.random.split(k_mom)
            # both columns ship a sketch (a quantile reads each)
            normals[i] = {"mean": jax.random.normal(k1, (shape[0], tt.num_slots)),
                          "s2": jax.random.normal(k2, (shape[0], tt.num_slots)),
                          "sketch": jax.random.normal(k_sk, shape)}
        else:
            normals[i] = {"sketch": jax.random.normal(akey, shape)}
    normals = {i: {k: torch.from_numpy(np.array(v)) for k, v in d.items()}
               for i, d in normals.items()}
    got = pipe.execute(tq, None, window, FRACTION,
                       uniforms=np.array(jax.random.uniform(key, (n,))), normals=normals)
    for (kind, _), spec in zip(aggs, tq.aggs):
        g, w = got.estimates[spec.key], want.estimates[spec.key]
        _close(g.value.numpy(), w.value)
        for field in ("ci_low", "ci_high"):
            a, b = getattr(g, field).numpy(), np.asarray(getattr(w, field))
            if kind == "var":
                _close(a, b)
            else:  # one ulp in a weight can move a replicate by a sketch bin
                fin = np.isfinite(b)
                assert np.array_equal(np.isfinite(a), fin)
                assert np.all(np.abs(a[fin] - b[fin]) <= 0.0833 * np.abs(b[fin]) + 1e-6)


def test_execute_draws_normals_after_uniforms_from_one_generator(setup):
    _, tt, window, _ = setup
    pipe = tpipe.EdgeCloudPipeline(tt, tpipe.PipelineConfig(backend="fused"), device="cpu")
    q = tquery.Query(aggs=(tquery.AggSpec("var", "value"), tquery.AggSpec("p50", "value")))
    a = pipe.execute(q, torch.Generator().manual_seed(4), window, FRACTION)
    gen = torch.Generator().manual_seed(4)
    u = torch.rand(len(window["lat"]), generator=gen)
    normals = tquery.bootstrap_normals(pipe.plan(q), tt, a.stats, gen)
    assert sorted(normals) == [0, 1] and sorted(normals[0]) == ["mean", "s2", "sketch"]
    b = pipe.execute(q, None, window, FRACTION, uniforms=u, normals=normals)
    for key in a.estimates:
        for field in ("value", "ci_low", "ci_high"):
            assert torch.equal(getattr(a.estimates[key], field), getattr(b.estimates[key], field))
    assert float(a.estimates["var_value"].ci_high) > float(a.estimates["var_value"].ci_low)


@pytest.mark.parametrize("kwargs", [dict(mode="raw"), dict(uplink_codec="sparse")])
def test_later_slices_raise_not_implemented(kwargs):
    """Raw mode and the uplink codecs are part of the port now and build;
    session checkpoints and the sharded path are not, and raise."""
    from repro_torch.core.session import StreamSession

    table = tstrat.make_table(*tstrat.CHICAGO_BBOX, precision=4, device="cpu")
    pipe = tpipe.EdgeCloudPipeline(table, tpipe.PipelineConfig(**kwargs), device="cpu")
    with pytest.raises(NotImplementedError, match="item 13"):
        StreamSession(pipe, sharded=True)
    with pytest.raises(NotImplementedError, match="item 11"):
        StreamSession(pipe).checkpoint()
    with pytest.raises(NotImplementedError, match="item 11"):
        StreamSession(pipe).restore({})
    with pytest.raises(NotImplementedError):
        pipe.run_stream([], sharded=True)
    with pytest.raises(ValueError):
        tpipe.PipelineConfig(uplink_codec="bogus")
    with pytest.raises(ValueError):
        tpipe.PipelineConfig(mode="bogus")
    with pytest.raises(ValueError):
        tpipe.PipelineConfig(backend="bogus")
    with pytest.raises(ValueError):
        tpipe.PipelineConfig(backend="pallas", staging_dtype="bfloat16")


def test_no_gpu_and_no_device_raises(monkeypatch):
    table = tstrat.make_table(*tstrat.CHICAGO_BBOX, precision=4, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tstrat.make_table(*tstrat.CHICAGO_BBOX, precision=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpipe.EdgeCloudPipeline(table)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.table_from_numpy(table.codes.numpy(), table.neighborhood.numpy(), 4, 2,
                                 table.num_neighborhoods)
    assert tpipe.EdgeCloudPipeline(table, device="cpu").device.type == "cpu"


def test_kernel_wrappers_raise_on_tensors_they_cannot_launch_on():
    """Off the CPU a wrapper launches its kernel or raises: a tensor on a
    device without the kernel is refused, never computed some other way."""
    meta = torch.empty(8, device="meta")
    sidx = torch.empty(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        geohash_encode(meta, meta, 5)
    with pytest.raises(ValueError):
        sample_mask(sidx, meta, meta)
    with pytest.raises(ValueError):
        edge_reduce(sidx, meta[None], torch.empty(8, dtype=torch.bool, device="meta"), 3)


def test_streams_and_windows_copies_match_jax():
    for name, kw in (("shenzhen_taxi_stream", dict(chunk_size=700, num_chunks=3, seed=4)),
                     ("chicago_aq_stream", dict(chunk_size=500, num_chunks=3, seed=4))):
        jchunks = list(getattr(jstreams, name)(**kw))
        tchunks = list(getattr(tstreams, name)(**kw))
        assert len(jchunks) == len(tchunks)
        for a, b in zip(jchunks, tchunks):
            assert a.keys() == b.keys()
            for k in a:
                assert np.array_equal(a[k], b[k]), (name, k)
        jb = list(jwin.count_windows(iter(jchunks), 600))
        tb = list(twin.count_windows(iter(tchunks), 600))
        assert len(jb) == len(tb) >= 2
        for a, b in zip(jb, tb):
            assert a.columns.keys() == b.columns.keys()
            for k in a.columns:
                assert np.array_equal(a.columns[k], b.columns[k])
            assert np.array_equal(a.lat, b.lat) and np.array_equal(a.valid, b.valid)
            assert (a.size, a.capacity, a.n_dropped) == (b.size, b.capacity, b.n_dropped)


def test_to_device_keeps_values_and_dtypes():
    """Host values reach a device with the dtype asked for and the values
    given: scalars, lists, read-only numpy arrays and CPU tensors; a tensor
    on another device moves with a plain ``.to``."""
    from repro_torch.core.transfer import to_device

    ro = np.arange(5, dtype=np.float64)
    ro.flags.writeable = False
    cases = [(0.8, torch.float32, torch.tensor(0.8, dtype=torch.float32)),
             (7, torch.int32, torch.tensor(7, dtype=torch.int32)),
             (np.float32(0.3), torch.float32, torch.tensor(0.3, dtype=torch.float32)),
             ([0.2, 0.5], torch.float32, torch.tensor([0.2, 0.5])),
             ([True, False], torch.bool, torch.tensor([True, False])),
             (ro, torch.float32, torch.arange(5, dtype=torch.float32)),
             (torch.arange(3), torch.int64, torch.arange(3))]
    for x, dtype, want in cases:
        got = to_device(x, dtype, "cpu")
        assert got.dtype == dtype and got.device.type == "cpu"
        assert torch.equal(got, want)
    meta = to_device(torch.empty(4, device="meta"), torch.float64, "meta")
    assert meta.device.type == "meta" and meta.dtype == torch.float64
