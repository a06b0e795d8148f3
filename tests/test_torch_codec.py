"""The port's uplink codecs (``repro_torch.core.codec``) against the JAX
package's: the same accumulator states, taken from JAX executes and carried
across with ``repro_torch.convert``, encode to the same buffers, control
words and measured bytes in both packages for every codec spec, over three
panes of one delta stream; decoding gives the same rows.  Within the port:
lossless codecs round-trip bit for bit (the sign of zero and NaN payloads
included, and an exact sign flip across delta frames), a lossless codec
leaves ``execute``'s estimates bit-identical to the dense ones with fewer
bytes, and the lossy codecs keep counts exact and values within their
declared bounds.
"""

import numpy as np
import pytest
import torch

import jax

from repro.core import codec as jcodec
from repro.core import pipeline as jpipe
from repro.core import query as jquery
from repro.core import stratify as jstrat
from repro.core import windows as jwin
from repro.data import streams as jstreams
from repro_torch import convert
from repro_torch.core import codec as tcodec
from repro_torch.core import estimators as test
from repro_torch.core import pipeline as tpipe
from repro_torch.core import query as tquery
from repro_torch.core import stratify as tstrat

SPECS = ("sparse", "delta:sparse", "topk16", "quantize16", "quantize8")
LOSSLESS = ("sparse", "delta:sparse")
AGGS = (("mean", "value"), ("min", "value"), ("max", "occupancy"), ("p50", "value"),
        ("sum", "occupancy"))


@pytest.fixture(scope="module")
def jax_panes():
    """Three panes' consolidated states from JAX executes of one query."""
    jt = jstrat.make_table(*jstrat.SHENZHEN_BBOX, precision=5)
    panes = list(jwin.count_windows(jstreams.shenzhen_taxi_stream(chunk_size=2000, num_chunks=3,
                                                                   seed=5), 2000))[:3]
    q = jquery.Query(aggs=tuple(jquery.AggSpec(*a) for a in AGGS), group_by="neighborhood",
                     bootstrap_replicates=0)
    pipe = jpipe.EdgeCloudPipeline(jt)
    return [pipe.execute(q, jax.random.key(i), p, 0.6).stats for i, p in enumerate(panes)]


def _numpy_tree(stats) -> dict:
    return {c: {k: {f: np.asarray(v) for f, v in s._asdict().items()} for k, s in kinds.items()}
            for c, kinds in stats.items()}


def _same_payload(got, want):
    assert (got.codec, got.frame) == (want.codec, want.frame)
    assert got.nbytes == want.nbytes
    assert got.entries == want.entries
    assert len(got.buffers) == len(want.buffers)
    for g, w in zip(got.buffers, want.buffers):
        assert g.dtype == w.dtype and np.array_equal(g.view(np.uint8), w.view(np.uint8))


@pytest.mark.parametrize("spec", SPECS)
def test_same_states_encode_to_the_same_bytes(jax_panes, spec):
    jenc = jcodec.resolve_codec(spec).for_stream()
    tenc = tcodec.resolve_codec(spec).for_stream()
    frames = []
    for stats in jax_panes:
        carried = convert.accs_from_numpy(_numpy_tree(stats), device="cpu")
        want = jenc.encode(jcodec.flatten_stats(stats))
        got = tenc.encode(tcodec.flatten_stats(carried))
        _same_payload(got, want)
        frames.append(got.frame)
        jrows, trows = jenc.decode(want), tenc.decode(got)
        assert [(r.column, r.kind, r.name) for r in trows] == \
            [(r.column, r.kind, r.name) for r in jrows]
        for t, j in zip(trows, jrows):
            assert np.array_equal(t.array.view(np.uint32), j.array.view(np.uint32))
    assert frames == (["key", "delta", "delta"] if spec.startswith("delta") else ["raw"] * 3)


def _odd_states() -> dict:
    """States with -0.0, NaN and ±inf entries in occupied and empty strata."""
    rng = np.random.default_rng(3)
    s = 40
    n = np.zeros(s, np.float32)
    n[[2, 5, 9]] = [3.0, 1.0, 4.0]
    wsum = np.zeros(s, np.float32)
    wsum[[2, 5, 9, 11]] = [-0.0, 7.5, np.nan, -0.0]
    m2 = np.where(n > 0, rng.random(s), 0.0).astype(np.float32)
    mins = np.full(s, np.inf, np.float32)
    mins[[2, 5]] = [-0.0, -np.inf]
    maxs = np.full(s, -np.inf, np.float32)
    maxs[[2, 9]] = [0.0, np.nan]
    bins = np.zeros((s, test.SKETCH_NUM_BINS), np.float32)
    bins[2, [0, 256, 512]] = [1.0, -0.0, 2.0]
    return convert.accs_from_numpy({"value": {
        "moments": {"n": n, "total": n * 2, "wsum": wsum, "m2": m2,
                    "mean": np.where(n > 0, wsum / np.maximum(n, 1), 0).astype(np.float32)},
        "extrema": {"min": mins, "max": maxs},
        "sketch": {"bins": bins},
    }}, device="cpu")


def _bits_equal(a: dict, b: dict) -> bool:
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for c in a for k in a[c] for x, y in zip(a[c][k], b[c][k]))


@pytest.mark.parametrize("spec", LOSSLESS)
def test_lossless_roundtrip_keeps_signed_zero_and_nan(spec):
    stats = _odd_states()
    # the moments' mean is derived cloud-side from n and wsum, as the
    # payload carries it; rebuild it that way before comparing bits
    mom = stats["value"]["moments"]
    stats["value"]["moments"] = test.StratumStats(
        n=mom.n, total=mom.total, wsum=mom.wsum, m2=mom.m2,
        mean=torch.where(mom.n > 0, mom.wsum / torch.clamp_min(mom.n, 1.0), 0.0))
    stream = tcodec.resolve_codec(spec).for_stream()
    flipped = {"value": dict(stats["value"])}
    flipped["value"]["moments"] = stats["value"]["moments"]._replace(
        wsum=-stats["value"]["moments"].wsum)  # an exact sign flip across frames
    flipped["value"]["moments"] = flipped["value"]["moments"]._replace(
        mean=torch.where(mom.n > 0, flipped["value"]["moments"].wsum / torch.clamp_min(mom.n, 1.0),
                         0.0))
    for frame in (stats, flipped, stats):
        decoded, nbytes = tcodec.roundtrip(stream, frame)
        assert _bits_equal(decoded, frame)
        assert nbytes < sum(x.numel() * 4 for k in frame["value"].values() for x in k)


@pytest.mark.parametrize("spec", SPECS)
def test_execute_with_codec(spec):
    """Lossless specs: ``execute``'s estimates bit-identical to the dense
    run with the same generator, and fewer measured bytes than the dense
    model.  Lossy specs: counts exact, quantized values within half a step
    of their row's scale, top-k sketch totals exact."""
    table = tstrat.make_table(*tstrat.SHENZHEN_BBOX, precision=5, device="cpu")
    w = jstreams.materialize(jstreams.shenzhen_taxi_stream(chunk_size=3000, num_chunks=1, seed=6))
    q = tquery.Query(aggs=tuple(tquery.AggSpec(*a) for a in AGGS), group_by="neighborhood",
                     bootstrap_replicates=20)
    dense = tpipe.EdgeCloudPipeline(table, tpipe.PipelineConfig(backend="pallas"), device="cpu")
    coded = tpipe.EdgeCloudPipeline(table, tpipe.PipelineConfig(backend="pallas", uplink_codec=spec),
                                    device="cpu")
    a = dense.execute(q, torch.Generator().manual_seed(1), w, 0.6)
    b = coded.execute(q, torch.Generator().manual_seed(1), w, 0.6)
    assert isinstance(b.comm_bytes, int) and b.comm_bytes < int(a.comm_bytes)
    if spec in LOSSLESS:
        assert _bits_equal(b.stats, a.stats)
        for key in a.estimates:
            for f in a.estimates[key]._fields:
                assert torch.equal(getattr(a.estimates[key], f).view(torch.int32),
                                   getattr(b.estimates[key], f).view(torch.int32)), (key, f)
        return
    for col in b.stats:
        ma, mb = a.stats[col]["moments"], b.stats[col]["moments"]
        assert torch.equal(ma.n, mb.n) and torch.equal(ma.total, mb.total)
        if "sketch" in a.stats[col]:
            assert torch.equal(a.stats[col]["sketch"].bins.sum(1), b.stats[col]["sketch"].bins.sum(1))
    if spec.startswith("quantize"):
        rows = {(r.column, r.kind, r.name): r for r in tcodec.flatten_stats(a.stats)}
        decoded = {(r.column, r.kind, r.name): r for r in tcodec.flatten_stats(b.stats)}
        qmax = 32764 if spec == "quantize16" else 124
        for k, r in rows.items():
            fin = np.isfinite(r.array)
            if not r.quantize_ok:
                assert np.array_equal(decoded[k].array, r.array, equal_nan=True), k
                continue
            if k[2] == "mean":  # derived from the decoded n and wsum
                continue
            scale = max(float(np.float32(np.abs(r.array[fin]).max() / qmax)), 1e-38) if fin.any() else 1.0
            err = np.abs(decoded[k].array[fin].astype(np.float64) - r.array[fin])
            assert np.all(err <= 0.5 * scale * (1 + 1e-6) + 1e-30), k
            assert np.array_equal(np.isinf(decoded[k].array), np.isinf(r.array)), k
