"""The port's CUDA kernels and main path on the card.

Every test here needs a CUDA device and skips without one; on the GPU host
run them with ``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.
This file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed.  Each kernel is held against its plain PyTorch version
on the same inputs: geohash and sample_mask bit for bit, edge_reduce and the
edge megakernel counts (and the megakernel's extrema and sketch bins)
exactly and sums within the reference's kernel-test tolerance
(``tests/test_kernels.py``: rtol=2e-6, atol=1e-3), and every kernel gives the
same bits on a second run.  The fused backend keeps the pallas backend's
sample on the card.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import AggSpec, EdgeCloudPipeline, PipelineConfig, Query, make_table
from repro_torch.core.stratify import SHENZHEN_BBOX
from repro_torch.data import materialize, shenzhen_taxi_stream
from repro_torch.kernels import build
from repro_torch.kernels.edge_megakernel import edge_megakernel, edge_megakernel_plain
from repro_torch.kernels.edge_reduce import edge_reduce, edge_reduce_plain
from repro_torch.kernels.geohash import geohash_encode, geohash_encode_plain
from repro_torch.kernels.sample_mask import sample_mask, sample_mask_plain

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("precision", [1, 5, 6])
def test_geohash_kernel_bit_exact(cuda, precision):
    rng = np.random.default_rng(precision)
    lat = torch.from_numpy(rng.uniform(-90, 90, 100_000).astype(np.float32))
    lon = torch.from_numpy(rng.uniform(-180, 180, 100_000).astype(np.float32))
    got = geohash_encode(lat.to(cuda), lon.to(cuda), precision)
    assert torch.equal(got, geohash_encode(lat.to(cuda), lon.to(cuda), precision))
    assert torch.equal(got.cpu(), geohash_encode_plain(lat, lon, precision))


def test_sample_mask_kernel_bit_exact(cuda):
    rng = np.random.default_rng(1)
    n, s = 200_000, 6558
    args = [torch.from_numpy(rng.integers(0, s, n).astype(np.int32)),
            torch.from_numpy(rng.random(n).astype(np.float32)),
            torch.from_numpy(rng.uniform(0.05, 1.0, s).astype(np.float32))]
    m, w = sample_mask(*(a.to(cuda) for a in args))
    m2, w2 = sample_mask(*(a.to(cuda) for a in args))
    pm, pw = sample_mask_plain(*args)
    assert torch.equal(m, m2) and torch.equal(w, w2)
    assert torch.equal(m.cpu(), pm) and torch.equal(w.cpu(), pw)


def test_edge_reduce_kernel_deterministic(cuda):
    rng = np.random.default_rng(8)
    n, c, s = 200_000, 3, 6558
    # skewed slots: a few heavy runs longer than one chunk, many short ones
    sidx = torch.from_numpy(np.minimum((rng.random(n) ** 3 * s).astype(np.int32), s - 1))
    vals = torch.from_numpy(rng.normal(25, 8, (c, n)).astype(np.float32))
    mask = torch.from_numpy(rng.random(n) < 0.8)
    args = [sidx.to(cuda), vals.to(cuda), mask.to(cuda)]
    got = edge_reduce(*args, s)
    again = edge_reduce(*args, s)
    plain = edge_reduce_plain(sidx, vals, mask, s)
    for g, a, p in zip(got, again, plain):
        assert torch.equal(g, a)
        torch.testing.assert_close(g.cpu(), p, rtol=2e-6, atol=1e-3)
    assert torch.equal(got[0].cpu(), plain[0])


@pytest.mark.parametrize("method", ["srs", "bernoulli"])
def test_execute_on_card_matches_cpu(cuda, method):
    window = materialize(shenzhen_taxi_stream(num_chunks=5, seed=2))
    q = Query(aggs=(AggSpec("mean", "value"), AggSpec("max", "value"), AggSpec("p50", "value"),
                    AggSpec("mean", "occupancy")),
              group_by="neighborhood", method=method, bootstrap_replicates=0)
    table = make_table(*SHENZHEN_BBOX, precision=6, neighborhood_precision=4)
    cfg = PipelineConfig(backend="pallas")
    build.reset_launches()
    res = EdgeCloudPipeline(table, cfg).execute(
        q, torch.Generator(device=cuda).manual_seed(0), window, 0.8)
    assert build.LAUNCHES["geohash"] == 1 and build.LAUNCHES["edge_reduce"] == 1
    assert build.LAUNCHES["sample_mask"] == (1 if method == "bernoulli" else 0)
    u = torch.rand(len(window["lat"]), generator=torch.Generator(device=cuda).manual_seed(0),
                   device=cuda)
    ref = EdgeCloudPipeline(table.to("cpu"), cfg, device="cpu").execute(
        q, None, window, 0.8, uniforms=u.cpu())
    for name in ("n_sampled", "n_valid", "n_overflow"):
        assert int(getattr(res, name)) == int(getattr(ref, name))
    for key, est in res.estimates.items():
        # grouped sums on the card add in another order than on the CPU
        torch.testing.assert_close(est.value.cpu(), ref.estimates[key].value,
                                   rtol=1e-4, atol=0.0, equal_nan=True)


def test_empty_window_launches_only_what_writes(cuda):
    """An empty input launches no geohash or sample_mask kernel (nothing to
    write) and is not counted; edge_reduce still writes its zero sums."""
    build.reset_launches()
    none_f = torch.empty(0, device=cuda)
    none_i = torch.empty(0, dtype=torch.int32, device=cuda)
    assert geohash_encode(none_f, none_f, 5).shape == (0,)
    mask, weight = sample_mask(none_i, none_f, torch.ones(4, device=cuda))
    assert mask.shape == weight.shape == (0,)
    count, s1, s2 = edge_reduce(none_i, torch.empty((2, 0), device=cuda),
                                torch.empty(0, dtype=torch.bool, device=cuda), 4)
    assert not count.any() and not s1.any() and not s2.any() and s1.shape == (2, 4)
    assert build.LAUNCHES == {"geohash": 0, "sample_mask": 0, "edge_reduce": 1,
                              "edge_megakernel": 0}


@pytest.mark.parametrize("mode", ["sidx", "latlon"])
@pytest.mark.parametrize("staging", [torch.float32, torch.bfloat16])
def test_edge_megakernel_deterministic_and_matches_plain(cuda, mode, staging):
    rng = np.random.default_rng(5)
    n, m = 300_000, 3
    table = make_table(*SHENZHEN_BBOX, precision=6, neighborhood_precision=4)
    s = table.num_slots
    lat = torch.from_numpy(rng.uniform(22.40, 22.90, n).astype(np.float32)).to(cuda)
    lon = torch.from_numpy(rng.uniform(113.7, 114.7, n).astype(np.float32)).to(cuda)
    vals = torch.from_numpy(rng.normal(25, 8, (2, n)).astype(np.float32)).to(cuda).to(staging)
    ok = torch.from_numpy(rng.random((m, n)) < 0.8).to(cuda)
    if mode == "sidx":
        # skewed slots and SRS-like ranks against per-member n_k rows
        sidx = torch.from_numpy(np.minimum((rng.random(n) ** 3 * s).astype(np.int32), s - 1))
        where = dict(sidx=sidx.to(cuda)[None].expand(m, n))
        scores = torch.from_numpy(rng.integers(0, 200, n).astype(np.float32)).to(cuda)[None]
        thr = torch.from_numpy(rng.integers(0, 200, (m, s)).astype(np.float32)).to(cuda)
    else:
        where = dict(lat=lat, lon=lon, codes=table.codes, precision=6)
        scores = torch.from_numpy(rng.random((1, n)).astype(np.float32)).to(cuda)
        thr = torch.tensor([[0.2], [0.5], [0.8]], device=cuda).expand(m, s).contiguous()
    args = (vals, ok, scores.expand(m, n), thr, s)
    build.reset_launches()
    got = edge_megakernel(*args, **where, ext_idx=(0,), sk_idx=(0, 1))
    again = edge_megakernel(*args, **where, ext_idx=(0,), sk_idx=(0, 1))
    plain = edge_megakernel_plain(*args, **where, ext_idx=(0,), sk_idx=(0, 1))
    torch.cuda.synchronize()
    assert build.LAUNCHES["edge_megakernel"] == 2
    for name, g, a, p in zip(got._fields, got, again, plain):
        assert torch.equal(g, a), name
        if name in ("s1", "s2"):
            torch.testing.assert_close(g, p, rtol=2e-6, atol=1e-3)
        else:
            assert torch.equal(g, p), name


@pytest.mark.parametrize("method", ["srs", "bernoulli"])
def test_fused_execute_keeps_the_pallas_sample(cuda, method):
    window = materialize(shenzhen_taxi_stream(num_chunks=5, seed=2))
    q = Query(aggs=(AggSpec("mean", "value"), AggSpec("max", "value"), AggSpec("p50", "value"),
                    AggSpec("var", "occupancy")),
              group_by="neighborhood", method=method, bootstrap_replicates=50)
    table = make_table(*SHENZHEN_BBOX, precision=6, neighborhood_precision=4)
    u = torch.rand(len(window["lat"]), generator=torch.Generator(device=cuda).manual_seed(0),
                   device=cuda)
    build.reset_launches()
    fused = EdgeCloudPipeline(table, PipelineConfig(backend="fused")).execute(
        q, torch.Generator(device=cuda).manual_seed(1), window, 0.8, uniforms=u)
    assert build.LAUNCHES["edge_megakernel"] == 1 and build.LAUNCHES["edge_reduce"] == 0
    twice = EdgeCloudPipeline(table, PipelineConfig(backend="fused")).execute(
        q, torch.Generator(device=cuda).manual_seed(1), window, 0.8, uniforms=u)
    pallas = EdgeCloudPipeline(table, PipelineConfig(backend="pallas")).execute(
        q, torch.Generator(device=cuda).manual_seed(1), window, 0.8, uniforms=u)
    for name in ("n_sampled", "n_valid", "n_overflow"):
        assert int(getattr(fused, name)) == int(getattr(pallas, name))
    for col in ("value", "occupancy"):
        assert torch.equal(fused.stats[col]["moments"].n, pallas.stats[col]["moments"].n)
    for key, est in fused.estimates.items():
        for field in est._fields:
            # two identical executes give the same bits, NaN of empty groups included
            assert torch.equal(getattr(est, field).view(torch.int32),
                               getattr(twice.estimates[key], field).view(torch.int32))
        torch.testing.assert_close(est.value, pallas.estimates[key].value,
                                   rtol=1e-4, atol=0.0, equal_nan=True)
