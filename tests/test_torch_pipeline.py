"""The port's main path end to end (``repro_torch``, CPU) against the JAX
package: ``EdgeCloudPipeline.execute`` with the segment and pallas
backends, ``finalize`` on states carried across by ``repro_torch.convert``,
the copied stream generators and windows, and the device rules.

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


@pytest.mark.parametrize("backend", ["segment", "pallas"])
@pytest.mark.parametrize("method", ["srs", "bernoulli"])
@pytest.mark.parametrize("group_by,roi_kind", CASES)
def test_execute_matches_jax(setup, backend, method, group_by, roi_kind):
    jt, tt, window, prefix = setup
    roi = {None: None, "bbox": ((22.5, 22.7), (113.9, 114.3)), "prefix": prefix}[roi_kind]
    key = jax.random.key(11)
    n = len(window["lat"])
    want = jpipe.EdgeCloudPipeline(jt, jpipe.PipelineConfig(backend=backend)).execute(
        _queries(method, group_by, roi, jquery), key, window, FRACTION)
    before = dict(build.LAUNCHES)
    got = tpipe.EdgeCloudPipeline(tt, tpipe.PipelineConfig(backend=backend), device="cpu").execute(
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


@pytest.mark.parametrize("kind", ["var", "p50"])
def test_bootstrap_bounds_raise_until_ported(setup, kind):
    _, tt, window, _ = setup
    pipe = tpipe.EdgeCloudPipeline(tt, device="cpu")
    q = tquery.Query(aggs=(tquery.AggSpec(kind, "value"),), bootstrap_replicates=10)
    with pytest.raises(NotImplementedError):
        pipe.execute(q, torch.Generator().manual_seed(0), window, FRACTION)


@pytest.mark.parametrize("kwargs", [dict(backend="fused"), dict(mode="raw"),
                                    dict(uplink_codec="sparse")])
def test_later_slices_raise_not_implemented(kwargs):
    with pytest.raises(NotImplementedError):
        tpipe.PipelineConfig(**kwargs)
    with pytest.raises(ValueError):
        tpipe.PipelineConfig(backend="bogus")


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
