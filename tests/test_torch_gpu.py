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
sample on the card, and the segment backend gives the same bits twice.  The
stratified_stats kernel is held against its plain version like
edge_reduce, over f32 and bf16 values, bool and float masks and indices
out of range; both sorted-tile kernels also on windows below one tile, with
a ragged last tile, at S = 1 and at the largest stratum table, and on a
window one slot dominates; and a session step on the card equals ``execute`` bit for
bit and the CPU's session within tolerance.  The
flash-attention kernel is held against its plain version (the model's
chunked attention) with the reference kernel test's tolerances (2e-5 f32,
2e-2 bf16), and the dense decoder's prefill launches it once per layer.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import (AggSpec, EdgeCloudPipeline, PipelineConfig, Query, StreamSession,
                              WindowSpec, make_table, pane_windows)
from repro_torch.configs import get_smoke_config
from repro_torch.core.stratify import SHENZHEN_BBOX
from repro_torch.data import materialize, shenzhen_taxi_stream
from repro_torch.kernels import build
from repro_torch.kernels.edge_megakernel import edge_megakernel, edge_megakernel_plain
from repro_torch.kernels.edge_reduce import edge_reduce, edge_reduce_plain
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from repro_torch.kernels.geohash import geohash_encode, geohash_encode_plain
from repro_torch.kernels.sample_mask import sample_mask, sample_mask_plain
from repro_torch.kernels.stratified_stats import stratified_stats, stratified_stats_plain
from repro_torch.models import init_params

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
    # skewed slots: a few heavy runs across thread ranges and tiles, many short ones
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
                              "edge_megakernel": 0, "stratified_stats": 0, "flash_attention": 0}


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


def test_segment_execute_is_bitwise_reproducible(cuda):
    window = materialize(shenzhen_taxi_stream(num_chunks=5, seed=3))
    q = Query(aggs=(AggSpec("sum", "value"), AggSpec("mean", "value"), AggSpec("p50", "value"),
                    AggSpec("var", "occupancy")),
              group_by="neighborhood", bootstrap_replicates=50)
    table = make_table(*SHENZHEN_BBOX, precision=6, neighborhood_precision=4)
    runs = [EdgeCloudPipeline(table, PipelineConfig(backend="segment")).execute(
        q, torch.Generator(device=cuda).manual_seed(4), window, 0.8) for _ in range(2)]
    for key, est in runs[0].estimates.items():
        for field in est._fields:
            assert torch.equal(getattr(est, field).view(torch.int32),
                               getattr(runs[1].estimates[key], field).view(torch.int32))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("float_mask", [False, True], ids=["bool_mask", "float_mask"])
def test_stratified_stats_kernel_deterministic_and_matches_plain(cuda, bf16, float_mask):
    rng = np.random.default_rng(12)
    n, s = 300_000, 6558
    sidx = np.minimum((rng.random(n) ** 3 * s).astype(np.int64), s - 1)
    pick = rng.random(n)
    sidx[pick < 0.01] = -1
    sidx[(pick >= 0.01) & (pick < 0.02)] = s + 5
    vals = torch.from_numpy(rng.normal(25, 8, n).astype(np.float32))
    if bf16:
        vals = vals.to(torch.bfloat16)
    mask = torch.from_numpy(rng.random(n).astype(np.float32) if float_mask else rng.random(n) < 0.8)
    args = [torch.from_numpy(sidx), vals, mask]
    build.reset_launches()
    got = stratified_stats(*(a.to(cuda) for a in args), s)
    again = stratified_stats(*(a.to(cuda) for a in args), s)
    assert build.LAUNCHES["stratified_stats"] == 2
    plain = stratified_stats_plain(*args, s)
    for g, a, p in zip(got, again, plain):
        assert torch.equal(g, a)
        torch.testing.assert_close(g.cpu(), p, rtol=2e-6, atol=1e-3)
    if not float_mask:
        assert torch.equal(got[0].cpu(), plain[0])


def _same_twice_and_plain(got, again, plain, exact_count: bool) -> None:
    """Two kernel runs bitwise equal; sums within the reference's kernel-test
    tolerance of the plain version; counts exact under a bool mask."""
    for g, a, p in zip(got, again, plain):
        assert torch.equal(g, a)
        torch.testing.assert_close(g.cpu(), p, rtol=2e-6, atol=1e-3)
    if exact_count:
        assert torch.equal(got[0].cpu(), plain[0])


# (N, S): a window below one tile, one below 1024 tuples, one wave of short
# tiles, two waves whose last tile is ragged (N not a multiple of the tile);
# S = 1 and the largest stratum table (Shenzhen at Geohash-6)
TILE_EDGES = [(1, 1), (100, 6558), (5000, 7), (300_000, 1), (8192 * 132 + 17, 6558)]


@pytest.mark.parametrize("n,s", TILE_EDGES, ids=lambda v: str(v))
def test_edge_reduce_kernel_at_tile_edges(cuda, n, s):
    rng = np.random.default_rng(n + s)
    args = [torch.from_numpy(rng.integers(0, s, n).astype(np.int32)),
            torch.from_numpy(rng.normal(25, 8, (2, n)).astype(np.float32)),
            torch.from_numpy(rng.random(n) < 0.8)]
    build.reset_launches()
    got = edge_reduce(*(a.to(cuda) for a in args), s)
    again = edge_reduce(*(a.to(cuda) for a in args), s)
    assert build.LAUNCHES["edge_reduce"] == 2
    assert got[1].shape == got[2].shape == (2, s)
    _same_twice_and_plain(got, again, edge_reduce_plain(*args, s), exact_count=True)


@pytest.mark.parametrize("n,s", TILE_EDGES, ids=lambda v: str(v))
def test_stratified_stats_kernel_at_tile_edges(cuda, n, s):
    """bf16 values, a float mask, and indices at -1 and past the last slot."""
    rng = np.random.default_rng(n + s + 1)
    sidx = rng.integers(0, s, n)
    pick = rng.random(n)
    sidx[pick < 0.02] = -1
    sidx[(pick >= 0.02) & (pick < 0.04)] = s + 3
    args = [torch.from_numpy(sidx),
            torch.from_numpy(rng.normal(25, 8, n).astype(np.float32)).to(torch.bfloat16),
            torch.from_numpy(rng.random(n).astype(np.float32))]
    got = stratified_stats(*(a.to(cuda) for a in args), s)
    again = stratified_stats(*(a.to(cuda) for a in args), s)
    _same_twice_and_plain(got, again, stratified_stats_plain(*args, s), exact_count=False)


@pytest.mark.parametrize("kernel", ["edge_reduce", "stratified_stats"])
def test_tile_kernels_on_a_window_one_slot_dominates(cuda, kernel):
    """Most tuples in one slot, so its run fills most of every tile and
    crosses every thread's range; the rest spread over the largest table."""
    rng = np.random.default_rng(22)
    n, s = 250_000, 6558
    hot = rng.random(n) < 0.85
    sidx = torch.from_numpy(np.where(hot, 4321, rng.integers(0, s, n)).astype(np.int32))
    mask = torch.from_numpy(rng.random(n) < 0.8)
    vals = torch.from_numpy(rng.normal(25, 8, (2, n)).astype(np.float32))
    if kernel == "edge_reduce":
        fn, plain, args = edge_reduce, edge_reduce_plain, [sidx, vals, mask]
    else:
        fn, plain, args = stratified_stats, stratified_stats_plain, [sidx, vals[0], mask]
    got = fn(*(a.to(cuda) for a in args), s)
    again = fn(*(a.to(cuda) for a in args), s)
    assert float(got[0].max()) > 0.8 * n * 0.85 * 0.95
    _same_twice_and_plain(got, again, plain(*args, s), exact_count=True)


def test_tile_kernels_refuse_records_above_the_budget(cuda):
    n, s = 1_200_000, 400_000
    sidx = torch.zeros(n, dtype=torch.int32, device=cuda)
    mask = torch.ones(n, dtype=torch.bool, device=cuda)
    vals = torch.ones((2, n), device=cuda)
    with pytest.raises(ValueError, match="budget"):
        edge_reduce(sidx, vals, mask, s)
    with pytest.raises(ValueError, match="budget"):
        stratified_stats(sidx, vals[0], mask, 4 * s)


@pytest.mark.parametrize("backend", ["pallas", "fused"])
def test_session_step_on_card_equals_execute_and_cpu(cuda, backend):
    stream = shenzhen_taxi_stream(num_chunks=4, seed=5)
    panes = list(pane_windows(stream, pane_tuples=40_000))
    table = make_table(*SHENZHEN_BBOX, precision=6, neighborhood_precision=4)
    cfg = PipelineConfig(backend=backend, uplink_codec="delta:sparse")
    q = Query(aggs=(AggSpec("mean", "value"), AggSpec("p50", "value"), AggSpec("var", "value")),
              group_by="neighborhood", bootstrap_replicates=20)
    pipe = EdgeCloudPipeline(table, cfg)
    want = pipe.execute(q, torch.Generator(device=cuda).manual_seed(1), panes[0], 0.8)
    sess = StreamSession(pipe, initial_fraction=0.8)
    reg = sess.register(q)
    got = sess.step(torch.Generator(device=cuda).manual_seed(1), panes[0]).results[reg.qid]
    for key, est in want.estimates.items():
        for field in est._fields:
            assert torch.equal(getattr(est, field).view(torch.int32),
                               getattr(got.estimates[key], field).view(torch.int32))
    sliding = Query(aggs=(AggSpec("mean", "occupancy"),), bootstrap_replicates=0)
    card_sess = StreamSession(pipe, initial_fraction=0.8)
    cpu_sess = StreamSession(EdgeCloudPipeline(table.to("cpu"), cfg, device="cpu"),
                             initial_fraction=0.8)
    for s in (card_sess, cpu_sess):
        s.register(sliding, window=WindowSpec("sliding", size=2))
    for pane in panes[:3]:
        u = torch.rand(len(pane.lat), generator=torch.Generator().manual_seed(7))
        on_card = card_sess.step(None, pane, uniforms=u.to(cuda)).results[0]
        on_cpu = cpu_sess.step(None, pane, uniforms=u).results[0]
        assert int(on_card.n_sampled) == int(on_cpu.n_sampled)
        torch.testing.assert_close(on_card.estimates["mean_occupancy"].value.cpu(),
                                   on_cpu.estimates["mean_occupancy"].value, rtol=1e-4, atol=0.0)


FLASH_SHAPES = [(1, 256, 4, 4, 64), (2, 512, 8, 2, 64), (1, 512, 8, 1, 128), (1, 256, 4, 4, 112),
                (1, 300, 4, 2, 64)]


@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_attention_kernel_matches_plain(cuda, shape, dtype):
    B, S, H, K, dh = shape
    gen = torch.Generator(device=cuda).manual_seed(S + dh)
    q, k, v = (torch.randn((B, S, n, dh), generator=gen, device=cuda).to(dtype)
               for n in (H, K, K))
    build.reset_launches()
    got = flash_attention(q, k, v)
    again = flash_attention(q, k, v)
    plain = flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attention"] == 2
    assert got.dtype == dtype and torch.equal(got, again)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), plain.float(), atol=tol, rtol=tol)


def test_flash_attention_reads_strided_heads(cuda):
    """q, k, v as head slices of one fused projection: read through strides."""
    B, S, H, K, dh = 2, 200, 8, 2, 64
    qkv = torch.randn((B, S, H + 2 * K, dh), generator=torch.Generator(device=cuda).manual_seed(1),
                      device=cuda)
    q, k, v = qkv[:, :, :H], qkv[:, :, H : H + K], qkv[:, :, H + K :]
    assert not q.is_contiguous()
    got = flash_attention(q, k, v)
    torch.testing.assert_close(got, flash_attention_plain(q, k, v), atol=2e-5, rtol=2e-5)


def test_dense_prefill_launches_flash_per_layer(cuda):
    cfg = get_smoke_config("qwen1.5-0.5b").replace(dtype=torch.float32, head_dim=32, num_heads=2,
                                                    num_kv_heads=2)
    model = init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    pos = torch.arange(40, device=cuda).expand(2, 40)
    build.reset_launches()
    logits, state = model.prefill(toks, pos, max_len=44)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attention"] == cfg.num_layers
    ref, ref_state = model.to("cpu").prefill(toks.cpu(), pos.cpu(), max_len=44)
    torch.testing.assert_close(logits.cpu(), ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(state.data["k"].cpu(), ref_state.data["k"], rtol=1e-4, atol=1e-4)


def test_flash_attention_refuses_unaligned_bf16(cuda):
    q = torch.zeros((1, 8, 2, 16), dtype=torch.bfloat16, device=cuda)
    kv = torch.zeros((1, 8, 2, 17), dtype=torch.bfloat16, device=cuda)[..., 1:]
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(q, kv, kv)


FLASH_SERVE_SHAPE = (4, 1024, 16, 16, 64)


@pytest.mark.parametrize("shape", FLASH_SHAPES + [FLASH_SERVE_SHAPE, (1, 128, 2, 2, 16),
                                                  (1, 200, 4, 2, 32)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("strided", [False, True], ids=["packed", "fused_qkv"])
def test_flash_attention_bf16_wgmma_path(cuda, shape, strided):
    """The bf16 path (wgmma + TMA) at every listed shape and the serving
    shape, with q, k, v packed or as head slices of one fused projection
    (GQA read through strides): within 2e-2 of the plain version, two runs
    bitwise equal."""
    B, S, H, K, dh = shape
    gen = torch.Generator(device=cuda).manual_seed(S + dh + strided)
    if strided:
        qkv = torch.randn((B, S, H + 2 * K, dh), generator=gen, device=cuda).to(torch.bfloat16)
        q, k, v = qkv[:, :, :H], qkv[:, :, H : H + K], qkv[:, :, H + K :]
    else:
        q, k, v = (torch.randn((B, S, n, dh), generator=gen, device=cuda).to(torch.bfloat16)
                   for n in (H, K, K))
    got = flash_attention(q, k, v)
    again = flash_attention(q, k, v)
    plain = flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), plain.float(), atol=2e-2, rtol=2e-2)


def test_flash_attention_refuses_a_q_tma_cannot_take(cuda):
    kv = torch.zeros((1, 8, 2, 16), dtype=torch.bfloat16, device=cuda)
    q = torch.zeros((1, 8, 2, 17), dtype=torch.bfloat16, device=cuda)[..., 1:]
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(q, kv, kv)
    q = torch.zeros((1, 8, 2 * 16 + 8), dtype=torch.bfloat16, device=cuda)[:, :, 1 : 1 + 32]
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(q.view(1, 8, 2, 16), kv, kv)


@pytest.mark.parametrize("mode", ["sidx", "latlon"])
def test_edge_megakernel_on_a_window_one_slot_dominates(cuda, mode):
    """Most tuples in one slot (a tile's run longer than the tile's other
    runs together), M = 3 members, bf16 staging: counts, extrema and bins
    exact, sums within the kernel tolerance, two runs bitwise equal."""
    rng = np.random.default_rng(21)
    n, m = 250_000, 3
    table = make_table(*SHENZHEN_BBOX, precision=6, neighborhood_precision=4)
    s = table.num_slots
    hot = rng.random(n) < 0.85
    lat = np.where(hot, 22.5431, rng.uniform(22.40, 22.90, n)).astype(np.float32)
    lon = np.where(hot, 114.0579, rng.uniform(113.7, 114.7, n)).astype(np.float32)
    vals = torch.from_numpy(rng.normal(25, 8, (2, n)).astype(np.float32)).to(cuda).to(torch.bfloat16)
    ok = torch.from_numpy(rng.random((m, n)) < 0.9).to(cuda)
    scores = torch.from_numpy(rng.random((1, n)).astype(np.float32)).to(cuda).expand(m, n)
    thr = torch.tensor([[0.2], [0.5], [0.8]], device=cuda).expand(m, s).contiguous()
    if mode == "sidx":
        sidx = np.where(hot, 4321, rng.integers(0, s + 1, n)).astype(np.int32)
        where = dict(sidx=torch.from_numpy(sidx).to(cuda)[None].expand(m, n))
    else:
        where = dict(lat=torch.from_numpy(lat).to(cuda), lon=torch.from_numpy(lon).to(cuda),
                     codes=table.codes, precision=6)
    args = (vals, ok, scores, thr, s)
    kw = dict(where, ext_idx=(0, 1), sk_idx=(1,))
    got = edge_megakernel(*args, **kw)
    again = edge_megakernel(*args, **kw)
    plain = edge_megakernel_plain(*args, **kw)
    torch.cuda.synchronize()
    assert float(got.pop.max()) > 0.8 * n * 0.9 * 0.9
    for name, g, a, p in zip(got._fields, got, again, plain):
        assert torch.equal(g, a), name
        if name in ("s1", "s2"):
            torch.testing.assert_close(g, p, rtol=2e-6, atol=1e-3)
        else:
            assert torch.equal(g, p), name


def test_edge_megakernel_on_an_empty_window(cuda):
    s = 11
    args = (torch.zeros((2, 0), device=cuda), torch.zeros((1, 0), dtype=torch.bool, device=cuda),
            torch.zeros((1, 0), device=cuda), torch.full((1, s), 0.5, device=cuda), s)
    kw = dict(sidx=torch.zeros((1, 0), dtype=torch.int32, device=cuda), ext_idx=(0,), sk_idx=(1,))
    got = edge_megakernel(*args, **kw)
    for name, g, p in zip(got._fields, got, edge_megakernel_plain(*args, **kw)):
        assert torch.equal(g, p), name
