"""Raw transmission mode of the port (``repro_torch``, CPU) against the JAX
package: ``sampling.compact``'s buffers, raw against preagg estimates per
aggregate kind, the truncation boundary of the static buffer, and raw
executes against JAX's on the same uniforms.

Tolerances: compact buffers, counters and ``comm_bytes`` are exact.  Raw
and preagg accumulate the same sample in another tuple order, so their
estimates agree to f32 summation order (rtol 1e-5 on values, 1e-4 on moe,
the reference's own raw-vs-preagg test); port against JAX as in
``tests/test_torch_pipeline.py`` (rtol 1e-4 with a floor of 1e-4 of the
field's largest finite magnitude).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import pipeline as jpipe
from repro.core import query as jquery
from repro.core import sampling as jsamp
from repro.core import stratify as jstrat
from repro.data import streams as jstreams
from repro_torch.core import pipeline as tpipe
from repro_torch.core import query as tquery
from repro_torch.core import sampling as tsamp
from repro_torch.core import stratify as tstrat

RTOL = 1e-4
FRACTION = 0.7
KINDS = ("sum", "mean", "count", "min", "max", "var")
AGGS = tuple((k, "value") for k in KINDS) + (("mean", "occupancy"), ("max", "occupancy"),
                                             ("p50", "value"), ("p99", "value"))


@pytest.fixture(scope="module")
def setup():
    jt = jstrat.make_table(*jstrat.SHENZHEN_BBOX, precision=5)
    tt = tstrat.make_table(*tstrat.SHENZHEN_BBOX, precision=5, device="cpu")
    w = jstreams.materialize(jstreams.shenzhen_taxi_stream(chunk_size=3000, num_chunks=2, seed=2))
    window = {k: w[k] for k in ("lat", "lon", "value", "occupancy")}
    window["lat"][:30] += 1.0  # out of the box: the overflow slot
    window["valid"] = np.ones(len(w["lat"]), bool)
    window["valid"][-20:] = False
    return jt, tt, window


def _query(mod, mode, group_by=None, method="srs", aggs=AGGS):
    return mod.Query(aggs=tuple(mod.AggSpec(*a) for a in aggs), mode=mode, group_by=group_by,
                     method=method, bootstrap_replicates=0)


def _close(got, want, rtol=RTOL, exact=False):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if exact:
        assert np.array_equal(got, want, equal_nan=True)
        return
    finite = np.abs(want[np.isfinite(want)])
    floor = rtol * (finite.max() if finite.size else 0.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor)


@pytest.mark.parametrize("max_out", [0, 700, 2000, 2600])
def test_compact_buffers_match_jax(max_out):
    rng = np.random.default_rng(max_out)
    n = 2000
    mask = rng.random(n) < 0.6
    sidx = rng.integers(0, 50, n).astype(np.int32)
    vals = rng.normal(0, 1, (n, 3)).astype(np.float32)
    want = jsamp.compact(jnp.asarray(mask), max_out, jnp.asarray(sidx), jnp.asarray(vals))
    got = tsamp.compact(torch.from_numpy(mask), max_out, torch.from_numpy(sidx),
                        torch.from_numpy(vals))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.array_equal(g.numpy(), np.asarray(w))
    # padding rows are zeros: stratum 0 behind valid = False
    assert int(got[0].sum()) == min(int(mask.sum()), max_out)
    assert not got[1][~got[0]].any() and not got[2][~got[0]].any()


@pytest.mark.parametrize("backend", ["segment", "pallas", "fused"])
@pytest.mark.parametrize("group_by", [None, "neighborhood"])
def test_raw_equals_preagg_per_kind(setup, backend, group_by):
    """Both transmission modes give the same estimates for the same sample,
    for every aggregate kind."""
    _, tt, window = setup
    pipe = tpipe.EdgeCloudPipeline(tt, tpipe.PipelineConfig(backend=backend, raw_capacity=5000),
                                   device="cpu")
    res = {mode: pipe.execute(_query(tquery, mode, group_by), torch.Generator().manual_seed(7),
                              window, FRACTION) for mode in ("preagg", "raw")}
    for name in ("n_sampled", "n_valid", "n_overflow"):
        assert int(getattr(res["raw"], name)) == int(getattr(res["preagg"], name)), name
    assert int(res["raw"].n_truncated) == 0
    assert int(res["raw"].comm_bytes) == tquery.raw_bytes(pipe.plan(_query(tquery, "raw")), 5000)
    for col in ("value", "occupancy"):
        _close(res["raw"].stats[col]["moments"].n, res["preagg"].stats[col]["moments"].n,
               exact=True)
    for a in AGGS:
        key = f"{a[0]}_{a[1]}"
        want, got = res["preagg"].estimates[key], res["raw"].estimates[key]
        np.testing.assert_allclose(got.value.numpy(), want.value.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=key)
        np.testing.assert_allclose(got.moe.numpy(), want.moe.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=key)


def test_raw_truncation_surfaced_and_boundary(setup):
    """Kept tuples beyond the static buffer are counted in ``n_truncated``;
    at or under capacity the count is zero and the estimates unaffected."""
    _, tt, window = setup
    q = _query(tquery, "raw", aggs=(("mean", "value"),))

    def run(cap, mode="raw"):
        pipe = tpipe.EdgeCloudPipeline(tt, tpipe.PipelineConfig(raw_capacity=cap), device="cpu")
        qq = q if mode == "raw" else _query(tquery, "preagg", aggs=(("mean", "value"),))
        return pipe.execute(qq, torch.Generator().manual_seed(2), window, 0.5)

    r_ok = run(len(window["lat"]))
    kept = int(r_ok.n_sampled)
    assert int(r_ok.n_truncated) == 0
    r_edge = run(kept)
    assert int(r_edge.n_truncated) == 0
    assert float(r_edge.estimates["mean_value"].value) == pytest.approx(
        float(r_ok.estimates["mean_value"].value), rel=1e-6)
    r_tight = run(kept - 1)
    assert int(r_tight.n_truncated) == 1
    assert int(r_tight.n_sampled) == kept
    assert int(run(kept, "preagg").n_truncated) == 0


@pytest.mark.parametrize("backend", ["segment", "pallas", "fused"])
@pytest.mark.parametrize("method", ["srs", "bernoulli"])
@pytest.mark.parametrize("cap", [None, 1500])
def test_raw_execute_matches_jax(setup, backend, method, cap):
    jt, tt, window = setup
    key = jax.random.key(13)
    n = len(window["lat"])
    want = jpipe.EdgeCloudPipeline(jt, jpipe.PipelineConfig(backend=backend, raw_capacity=cap)
                                   ).execute(_query(jquery, "raw", "neighborhood", method), key,
                                             window, FRACTION)
    got = tpipe.EdgeCloudPipeline(tt, tpipe.PipelineConfig(backend=backend, raw_capacity=cap),
                                  device="cpu").execute(
        _query(tquery, "raw", "neighborhood", method), None, window, FRACTION,
        uniforms=np.array(jax.random.uniform(key, (n,))))
    for name in ("n_sampled", "n_valid", "n_overflow", "n_truncated", "comm_bytes"):
        assert int(getattr(got, name)) == int(getattr(want, name)), name
    assert (int(got.n_truncated) > 0) == (cap is not None)
    for col in ("value", "occupancy"):
        _close(got.stats[col]["moments"].n, want.stats[col]["moments"].n, exact=True)
    for key_ in want.estimates:
        for field in want.estimates[key_]._fields:
            _close(getattr(got.estimates[key_], field).numpy(),
                   getattr(want.estimates[key_], field),
                   exact=field in ("n", "population"))
