"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py

Run from the root of the repository on a machine with an NVIDIA H100 and
the CUDA toolkit.  Phases, in order; any failure exits non-zero before the
last line is printed:

1. Card and build: the card's name and power limit, then one ``nvcc`` per
   CUDA source, all started together, and the build time; then the counts
   of wgmma (``HGMMA``) and TMA load (``UTMALDG``) instructions that
   ``cuobjdump -sass`` finds in the flash library (both must be non-zero:
   the bf16 path runs on them).
2. Kernel checks: each hand-written kernel against its plain PyTorch version
   on the card, on the inputs the main path gives it (the 1.2 M-tuple
   Shenzhen window at Geohash-6), twice, bitwise reproducible.
   edge_reduce and stratified_stats also run on the window with about 85%
   of its tuples moved into its busiest slot (one run fills most of every
   tile).  stratified_stats runs on the window's slots and ``value``
   column with f32 values and a bool mask (fraction 0.8), with bf16 values,
   and with a float weight mask and about 1% of the indices set to -1 and
   past the last slot, and at the reference kernel test's three shapes.
   The edge megakernel runs in sidx mode with three members (SRS ranks
   against three n_k rows), in latlon mode with two members (two ROI masks,
   two fractions), and in sidx mode once more with bf16 staging.  Flash
   attention runs at the reference kernel test's shapes (MHA, GQA, MQA,
   head_dim 112, ragged S 300) in f32 and bf16 and at the serving prefill's
   shape (B 4, S 1024, 16 heads, head_dim 64, bf16).
3. End to end: ``EdgeCloudPipeline.execute`` with ``backend="pallas"`` and
   ``backend="fused"`` for SRS and Bernoulli sampling on the Shenzhen
   window and on one Chicago air-quality window (Geohash-5), plus one
   grouped bootstrap query (var, p50, p99 with 200 replicates) on Shenzhen.
   Launch counters are zeroed just before this path and read just after
   it.  Every run is repeated on the card (bitwise equal) and on the CPU
   with the same uniforms (identical counters, estimates within
   tolerance), held against the exact full-population answer (MAPE < 10%
   at fraction 0.8), and each fused run against its pallas twin (the same
   sample: identical counters and per-stratum n).  The bootstrap query is
   repeated on both devices with the same injected normals.  Then the
   refined fused pass of three SRS members (fractions 0.2, 0.5, 0.8), with
   its own counters, on the card against the CPU.
   Last, every execute again on the segment backend, twice: bitwise equal,
   and the pallas run's sample.  Then three more paths, each with its own
   counters: raw mode (SRS and Bernoulli on pallas and fused, a buffer of
   the whole window, equal to the preagg run, and one of 500 000 tuples,
   whose truncation is counted exactly and held against the CPU); the
   uplink codecs (sparse and delta:sparse bitwise equal to the dense run
   with fewer bytes, topk16 / quantize16 / quantize8 with exact counts and
   values within each codec's declared bound); and the public
   ``stratified_stats`` op on the window, as the reference's kernel
   benchmark calls it.
3s. The continuous-query session: 16 dashboard tenants of
   ``benchmarks/multitenant_bench.py`` over two ROIs, three refined SRS
   members with their own fractions, a Bernoulli grouped query under an
   SLO, a raw-mode query and a bootstrap query, in tumbling, sliding (3)
   and hopping (6, 2) windows, over the Shenzhen stream cut into 6 panes of
   200 000 tuples; dense and with the delta:sparse codec, on pallas and
   fused.  A one-query step equals ``execute`` bit for bit, two runs each
   other, the lossless codec the dense session (with fewer bytes); sliding windows within 10% MAPE of the exact
   answer; the card against the CPU on the Chicago stream (13 panes of
   10 000 tuples, Geohash-5) with the same uniforms and normals.  Host ms
   per step and syncs per step.
4. Serving: qwen1.5-0.5b at full width and depth (24 layers, d 1024, 16
   heads, vocabulary 151936) with weights from a seeded CUDA generator
   serves 8 requests of 1024 prompt tokens in batches of 4, 32 greedy
   tokens each, through ``repro_torch.launch.serve.serve_requests``.
   Launch counters are zeroed just before and read just after: the flash
   kernel must launch once per layer per prefill.  Logits finite, tokens in
   the vocabulary, a second run bitwise equal; prefill and decode times and
   tokens per second.  Then the same config cut to 2 layers in f32, on the
   card (flash kernel) and on the CPU (plain attention) with the same
   weights: a 512-token prefill and 4 greedy steps give the same tokens and
   logits within 1e-4 of the row's largest.
5. Times: CUDA events, median of 25 launches after warm-up with the L2
   cache flushed before each, for every kernel, its plain version and the
   library call where one computes the same function (device time), and
   each kernel's host-clock time per call in a loop; host clock for each
   ``execute`` on both backends in turns (raw mode and the delta:sparse
   codec too, on the Shenzhen window), with the synchronizing CUDA
   operations one execute makes and the allocator's cudaMalloc calls, then
   one profiled ``execute`` per method and backend and one profiled
   prefill and decode step (device busy time and the heaviest device ops).
   stratified_stats is timed at the window's shape in f32 and bf16, its
   library call one f32 ``index_add_`` of the stacked rows.  The device
   time of the edge megakernel at ``latlon1``, of edge_reduce on the
   window's sample and of stratified_stats at its f32 case is split by pass
   (the profiler's per-kernel times of ten calls, each after an L2 flush).

``python3 chip_smoke.py --split-only DIR`` prints only those splits, for the
package in ``DIR/src`` (another checkout, such as the parent commit's), so
that two trees' splits can come from one card.

Each phase prints its seconds.  The line before the card line is a JSON
object with one entry per kernel (``launches``: the executes of phase 3 for
the edge kernels, the public op's path for stratified_stats, the serving
run for flash attention); the last line is ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
# ``--split-only DIR``: only the per-pass splits of the edge megakernel,
# edge_reduce and stratified_stats, of the package in DIR/src (another
# checkout, for an A/B on one card)
SPLIT_ONLY = len(sys.argv) == 3 and sys.argv[1] == "--split-only"
sys.path.insert(0, str((Path(sys.argv[2]).resolve() if SPLIT_ONLY else ROOT) / "src"))

FRACTION = 0.8
MAPE_LIMIT = 0.10  # the paper's bound at an 80% sampling rate
SEED = 0
REPS = 25
# published H100 SXM peaks (NVIDIA data sheet): HBM rate, and the f32 rate
# outside the tensor cores, used for these kernels' scalar integer/f32 work
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# s1/s2 of edge_reduce against its plain version: no looser than the
# reference's own kernel test (tests/test_kernels.py, rtol=2e-6, atol=1e-3)
ER_RTOL, ER_ATOL = 2e-6, 1e-3
# GPU execute against CPU execute (and fused against pallas) on the same
# uniforms: counters are exact; values differ only by f32 summation order
# between devices and kernels, moe additionally through the
# m2 = s2 - n*mean^2 cancellation
VALUE_RTOL, MOE_RTOL = 1e-4, 1e-3
# a quantile's bootstrap bound may move by one sketch bin (ratio e^0.08)
# when one ulp in a weight moves a replicate across a bin edge
BIN_RTOL = 0.0833
BACKENDS = ("pallas", "fused")
REFINED_FRACTIONS = (0.2, 0.5, 0.8)
REPLICATES = 200
EDGE_KERNELS = ("geohash", "sample_mask", "edge_reduce", "edge_megakernel")
# the bf16 tensor-core peak (NVIDIA data sheet, dense) for the flash bound
PEAK_BF16_OPS_PER_S = 989e12
# flash attention against its plain version: the reference kernel test's
# tolerances (tests/test_kernels.py).  On f32 the kernel keeps the softmax
# weights in f32; on bf16 it rounds them to bf16 for the wgmma product with
# V, as the plain version does, but from its own running max and
# normalizer, so the two differ at bf16 rounding
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# (B, S, H, K, dh): the reference kernel test's shapes, then the serving
# prefill's (4 requests of 1024 tokens, qwen1.5-0.5b's 16 heads of 64)
FLASH_SHAPES = [(1, 256, 4, 4, 64), (2, 512, 8, 2, 64), (1, 512, 8, 1, 128),
                (1, 256, 4, 4, 112), (1, 300, 4, 2, 64)]
FLASH_SERVE_SHAPE = (4, 1024, 16, 16, 64)
SERVE_ARCH = "qwen1.5-0.5b"
# stratified_stats: the reference kernel test's (N, S) shapes
STRAT_SHAPES = [(100, 7), (4096, 512), (20000, 1300)]
RAW_CAPACITY = 500_000  # below the ~960 k tuples kept at 0.8: truncates
CODEC_SPECS = ("sparse", "delta:sparse", "topk16", "quantize16", "quantize8")
LOSSLESS_SPECS = ("sparse", "delta:sparse")
QUANT_QMAX = {"quantize16": 32764, "quantize8": 124}  # core/codec.py's grids
# the session: panes of the Shenzhen stream, and the dashboard tenants' two
# ROIs of benchmarks/multitenant_bench.py; Chicago's halves for the
# card-vs-CPU session
SESSION_PANE, CHICAGO_PANE = 200_000, 10_000
SHENZHEN_ROIS = (((22.45, 22.66), (113.76, 114.64)), ((22.64, 22.86), (113.76, 114.64)))
CHICAGO_ROIS = (((41.60, 41.85), (-87.95, -87.50)), ((41.80, 42.05), (-87.95, -87.50)))
SESSION_TENANTS = 16
SESSION_SLO_TARGET = 0.05
FRACTION_TOL = 1e-5
SERVE_REQUESTS, SERVE_BATCH, PROMPT_LEN, MAX_NEW = 8, 4, 1024, 32
# the card against the CPU: the serving config cut to 2 layers, in f32
CROSS_LAYERS, CROSS_BATCH, CROSS_LEN, CROSS_STEPS = 2, 2, 512, 4
CROSS_RTOL = 1e-4

KERNEL_INFO = {
    "geohash": ("src/repro_torch/csrc/geohash.cu",
                "src/repro/kernels/geohash/geohash.py:55"),
    "sample_mask": ("src/repro_torch/csrc/sample_mask.cu",
                    "src/repro/kernels/sample_mask/sample_mask.py:59"),
    "edge_reduce": ("src/repro_torch/csrc/edge_reduce.cu",
                    "src/repro/kernels/edge_reduce/edge_reduce.py:77"),
    "edge_megakernel": ("src/repro_torch/csrc/edge_megakernel.cu",
                        "src/repro/kernels/edge_megakernel/edge_megakernel.py:210"),
    "stratified_stats": ("src/repro_torch/csrc/stratified_stats.cu",
                         "src/repro/kernels/stratified_stats/stratified_stats.py:54"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/flash_attention.py:66"),
}


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


# -- timing -------------------------------------------------------------------


class Timer:
    """Median CUDA-event time of ``fn`` with a cold L2 before each launch.

    A spin kernel keeps the card busy while the host enqueues ``fn``, so the
    events bracket only the device work, not the host's launch cost."""

    def __init__(self, device):
        # larger than the H100's 50 MB L2: zeroing it evicts the inputs
        self.flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=device)

    def ms(self, fn, reps: int = REPS, warm: int = 3) -> float:
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)  # about 1 ms at the H100's clock
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def call_ms(fn, calls: int = 200) -> float:
    """Host-clock time per call over back-to-back calls: what a caller in a
    loop waits, host launch cost included."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def host_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Median host-clock time of ``fn`` ending in a device synchronize."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def sync_count(fn) -> int:
    """Synchronizing CUDA operations one call of ``fn`` makes, as PyTorch's
    sync debug mode reports them (a prototype that may miss some)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum("synchronizing CUDA operation" in str(w.message) for w in caught)


def bound_ms(nbytes: float, ops: float, peak_ops: float = PEAK_OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- workloads ----------------------------------------------------------------


def load_window(name: str):
    from repro_torch.core import CHICAGO_BBOX, SHENZHEN_BBOX, make_table
    from repro_torch.data import chicago_aq_stream, materialize, shenzhen_taxi_stream

    if name == "shenzhen":
        # 60 chunks x 20 k = 1.2 M tuples, the size of the paper's dataset
        window = materialize(shenzhen_taxi_stream(seed=SEED))
        table = make_table(*SHENZHEN_BBOX, precision=6, neighborhood_precision=4)
        second = "occupancy"
    else:
        # 13 chunks x 10 k = 130 k tuples
        window = materialize(chicago_aq_stream(seed=SEED))
        table = make_table(*CHICAGO_BBOX, precision=5)
        second = "temperature"
    cols = {k: window[k] for k in ("lat", "lon", "value", second)}
    return table, cols, second


def queries(second: str, method: str):
    from repro_torch.core import AggSpec, Query

    flat = Query(
        aggs=(AggSpec("sum", "value"), AggSpec("mean", "value"), AggSpec("count", "value"),
              AggSpec("min", "value"), AggSpec("max", "value"), AggSpec("mean", second)),
        method=method,
    )
    grouped = Query(
        aggs=(AggSpec("mean", "value"), AggSpec("p50", "value"), AggSpec("p99", "value")),
        group_by="neighborhood", method=method, bootstrap_replicates=0,
    )
    return {"flat": flat, "grouped": grouped}


def bootstrap_query():
    from repro_torch.core import AggSpec, Query

    return Query(aggs=(AggSpec("var", "value"), AggSpec("p50", "value"), AggSpec("p99", "value")),
                 group_by="neighborhood", bootstrap_replicates=REPLICATES)


def refined_members(second: str = "occupancy"):
    """Three SRS members of one fusion group with their own aggregates."""
    from repro_torch.core import AggSpec, Query

    return [Query(aggs=(AggSpec("mean", "value"), AggSpec("max", "value")), bootstrap_replicates=0),
            Query(aggs=(AggSpec("p50", "value"), AggSpec("mean", second)),
                  group_by="neighborhood", bootstrap_replicates=0),
            Query(aggs=(AggSpec("sum", second), AggSpec("min", "value")),
                  bootstrap_replicates=0)]


def exact_answers(query, table_cpu, cols) -> dict:
    """Full-population answers from the whole window, in float64 numpy."""
    from repro_torch.core import geohash
    from repro_torch.core.query import quantile_of

    lat = torch.as_tensor(cols["lat"])
    lon = torch.as_tensor(cols["lon"])
    sidx = table_cpu.lookup(geohash.encode(lat, lon, table_cpu.precision)).numpy()
    inside = sidx < table_cpu.num_strata
    if query.group_by == "neighborhood":
        grp = table_cpu.neighborhood.numpy()[sidx[inside]]
        groups = range(table_cpu.num_neighborhoods)
    else:
        grp = np.zeros(int(inside.sum()), dtype=np.int64)
        groups = range(1)
    reducers = {"sum": np.sum, "mean": np.mean, "count": np.size, "min": np.min, "max": np.max,
                "var": np.var}
    out = {}
    for spec in query.aggs:
        y = np.asarray(cols[spec.column], dtype=np.float64)[inside]
        q = quantile_of(spec.kind)
        vals = []
        for g in groups:
            yg = y[grp == g]
            if yg.size == 0:
                vals.append(np.nan)
            else:
                vals.append(np.quantile(yg, q) if q is not None else reducers[spec.kind](yg))
        out[spec.key] = np.asarray(vals)
    return out


def mape(result, truth: dict) -> float:
    errs = []
    for key, t in truth.items():
        v = np.atleast_1d(result.estimates[key].value.detach().cpu().numpy().astype(np.float64))
        check(np.isfinite(v[np.isfinite(t)]).all(), f"{key}: non-finite estimate of a populated group")
        ok = np.isfinite(t) & (t != 0)
        errs.append(np.abs(v[ok] - t[ok]) / np.abs(t[ok]))
    return float(np.mean(np.concatenate(errs)))


def _f64(x):
    return x.detach().cpu().to(torch.float64)


def compare_results(gpu, cpu, label: str, exact_n: bool = False, bounds: bool = False) -> None:
    """Counters exact, estimates within tolerance (``bounds``: see
    :func:`compare_estimates`); with ``exact_n`` also the per-stratum kept
    counts of every column (the same sample)."""
    for name in ("n_sampled", "n_valid", "n_overflow"):
        g, c = int(getattr(gpu, name)), int(getattr(cpu, name))
        check(g == c, f"{label}: {name} {g} != {c}")
    if exact_n:
        for col, kinds in gpu.stats.items():
            check(torch.equal(_f64(kinds["moments"].n), _f64(cpu.stats[col]["moments"].n)),
                  f"{label}: per-stratum n of {col} differ")
    compare_estimates(gpu.estimates, cpu.estimates, label, bounds=bounds)


def compare_estimates(got: dict, want: dict, label: str, bounds: bool = False) -> None:
    """Values (and ``n``/``population`` exactly) within tolerance, and the
    error bound: moe within MOE_RTOL.  With ``bounds`` (bootstrap intervals)
    moe and the interval ends are held within VALUE_RTOL of the group's
    value (a bound sits near the value and its f32 rounding noise scales
    with it, not with a small moe), a quantile's within one sketch bin."""
    for key, est in got.items():
        ref = want[key]
        scale = _f64(ref.value).abs()
        fields = [("value", VALUE_RTOL, 0.0), ("n", 0.0, 0.0), ("population", 0.0, 0.0)]
        if bounds:
            tol = BIN_RTOL if key.startswith("p") else VALUE_RTOL  # p<q> aggregates
            fields += [(f, 0.0, tol) for f in ("moe", "ci_low", "ci_high")]
        else:
            fields += [("moe", MOE_RTOL, 0.0)]
        for field, rtol, vtol in fields:
            a, b = _f64(getattr(est, field)).flatten(), _f64(getattr(ref, field)).flatten()
            limit = rtol * b.abs() + vtol * torch.nan_to_num(scale.flatten(), nan=0.0, posinf=0.0)
            # equal values (infinities included) or both NaN, else within the limit
            close = (a == b) | (torch.isnan(a) & torch.isnan(b)) | ((a - b).abs() <= limit)
            worst = int(torch.argmin(close.to(torch.int32)))
            check(bool(torch.all(close)),
                  f"{label}: {key}.{field} element {worst}: {a[worst].item()} vs "
                  f"{b[worst].item()} (value {scale.flatten()[worst].item()}) beyond "
                  f"rtol={rtol}, value-relative {vtol}")


def same_bits(a: dict, b: dict) -> bool:
    """Two estimate dicts equal bit for bit (NaN of empty groups included)."""
    return all(torch.equal(getattr(a[k], f).view(torch.int32), getattr(b[k], f).view(torch.int32))
               for k in a for f in a[k]._fields)


# -- phases -------------------------------------------------------------------


def phase_build() -> float:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build_all()
    for name in build.KERNELS:
        build.kernel(name)  # load every library now
    return time.perf_counter() - t0


def kernel_inputs(table, cols, dev):
    """The inputs the main path hands each kernel on the Shenzhen window."""
    from repro_torch.core import geohash

    lat = torch.as_tensor(cols["lat"], device=dev)
    lon = torch.as_tensor(cols["lon"], device=dev)
    sidx = table.lookup(geohash.encode(lat, lon, table.precision))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    u = torch.rand(sidx.shape[0], generator=gen, device=dev)
    # per-stratum fractions, so a wrong gather cannot hide behind a constant
    frac = torch.rand(table.num_slots, generator=gen, device=dev) * 0.9 + 0.05
    values = torch.stack([torch.as_tensor(cols[c], device=dev) for c in list(cols)[2:]])
    return {"lat": lat, "lon": lon, "sidx": sidx, "u": u, "frac": frac,
            "values": values.contiguous(), "precision": table.precision,
            "num_slots": table.num_slots, "codes": table.codes}


def megakernel_cases(x) -> dict:
    """The megakernel's inputs at the main path's widths (C = 2 columns,
    extrema and sketch rows on the first): ``(args, kwargs)`` per case.

    sidx3: sidx mode, three SRS members (ranks against the n_k rows of
    fractions 0.2, 0.5, 0.8); latlon2: latlon mode, two members with their
    own ROI masks and fractions 0.8, 0.5; sidx3_bf16: sidx3 with bf16
    staging; latlon1 / sidx1 / latlon1_flat: the single-member shapes of
    ``execute`` (Bernoulli and SRS at 0.8; the flat query ships no sketch)."""
    from repro_torch.core import sampling

    n, s = x["sidx"].shape[0], x["num_slots"]
    lat, lon, u, vals = x["lat"], x["lon"], x["u"], x["values"]
    ranks, counts_all = sampling.srs_ranks(u, x["sidx"], s)
    nk = torch.stack([sampling.allocate_proportional(counts_all, f).to(torch.float32)
                      for f in REFINED_FRACTIONS])
    every = torch.ones(n, dtype=torch.bool, device=lat.device)
    rois = torch.stack([(lat <= 22.70) & (lon <= 114.30), (lat >= 22.55) & (lon >= 114.00)])
    sidx_kw = dict(ext_idx=(0,), sk_idx=(0,))
    latlon_kw = dict(lat=lat, lon=lon, codes=x["codes"], precision=x["precision"], ext_idx=(0,),
                     sk_idx=(0,))

    def thr(*fracs):
        return torch.tensor([[f] for f in fracs], device=lat.device).expand(len(fracs), s).contiguous()

    def sidx_case(m, v, nk_rows):
        return ((v, every[None].expand(m, n), ranks.to(torch.float32)[None].expand(m, n), nk_rows, s),
                dict(sidx_kw, sidx=x["sidx"][None].expand(m, n)))

    return {
        "sidx3": sidx_case(3, vals, nk),
        "latlon2": ((vals, rois, u[None].expand(2, n), thr(0.8, 0.5), s), latlon_kw),
        "sidx3_bf16": sidx_case(3, vals.to(torch.bfloat16), nk),
        "latlon1": ((vals, every[None], u[None], thr(FRACTION), s), latlon_kw),
        "sidx1": sidx_case(1, vals, nk[2:]),
        "latlon1_flat": ((vals, every[None], u[None], thr(FRACTION), s), dict(latlon_kw, sk_idx=())),
    }


def megakernel_bound(args, kw) -> tuple[float, str]:
    """Least time of one megakernel call: each input read once (an expanded
    member row once), each output written once, over the memory rate; or its
    operations over the f32 rate, whichever is larger."""
    vals, ok, scores, thr, s = args
    c, n = vals.shape
    m = ok.shape[0]
    e, k = len(kw.get("ext_idx", ())), len(kw.get("sk_idx", ()))

    def rows(t):  # member rows actually stored
        return 1 if t.stride(0) == 0 else t.shape[0]

    nbytes = n * (c * vals.element_size() + rows(ok) + 4 * rows(scores)) + 4 * thr.numel()
    if "sidx" in kw:
        nbytes += 4 * n * rows(kw["sidx"])
        ops_per = 5
    else:
        nbytes += 8 * n + 4 * kw["codes"].numel()
        ops_per = 20 + 3 * 13  # encode, then a 13-step binary search
    nbytes += 4 * m * s * (2 + 2 * c + 2 * e + k * 513)
    ops = m * n * (ops_per + 4 * c + 20 * k)  # products, sums, a log per sketch column
    return bound_ms(nbytes, ops)


def phase_kernel_checks(x) -> dict:
    from repro_torch.kernels.geohash import geohash_encode, geohash_encode_plain
    from repro_torch.kernels.sample_mask import sample_mask, sample_mask_plain

    err = {}
    a, b = geohash_encode(x["lat"], x["lon"], x["precision"]), geohash_encode(x["lat"], x["lon"], x["precision"])
    p = geohash_encode_plain(x["lat"], x["lon"], x["precision"])
    torch.cuda.synchronize()
    check(torch.equal(a, b), "geohash: two runs differ")
    check(torch.equal(a, p), "geohash: kernel codes differ from the plain version")
    err["geohash"] = float((a - p).abs().max())

    (m1, w1), (m2, w2) = (sample_mask(x["sidx"], x["u"], x["frac"]) for _ in range(2))
    pm, pw = sample_mask_plain(x["sidx"], x["u"], x["frac"])
    torch.cuda.synchronize()
    check(torch.equal(m1, m2) and torch.equal(w1, w2), "sample_mask: two runs differ")
    check(torch.equal(m1, pm), "sample_mask: mask differs from the plain version")
    check(torch.equal(w1, pw), "sample_mask: weight differs from the plain version")
    err["sample_mask"] = float((w1 - pw).abs().max())
    x["mask"] = m1

    x["skewed_sidx"] = skewed_sidx(x)
    err["edge_reduce"] = max(check_edge_reduce(label, sidx, x["values"], m1, x["num_slots"])
                             for label, sidx in (("window", x["sidx"]),
                                                 ("skewed", x["skewed_sidx"])))

    from repro_torch.kernels.edge_megakernel import edge_megakernel, edge_megakernel_plain

    cases = megakernel_cases(x)
    err["edge_megakernel"] = 0.0
    for label in ("sidx3", "latlon2", "sidx3_bf16"):
        args, kw = cases[label]
        k1, k2 = edge_megakernel(*args, **kw), edge_megakernel(*args, **kw)
        kp = edge_megakernel_plain(*args, **kw)
        torch.cuda.synchronize()
        check(all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(k1, k2)),
              f"edge_megakernel {label}: two runs differ")
        for name, got, ref in zip(k1._fields, k1, kp):
            if name in ("s1", "s2"):
                check(torch.allclose(got, ref, rtol=ER_RTOL, atol=ER_ATOL),
                      f"edge_megakernel {label}: {name} beyond rtol={ER_RTOL}, atol={ER_ATOL}")
                err["edge_megakernel"] = max(err["edge_megakernel"], float((got - ref).abs().max()))
            else:
                check(torch.equal(got, ref), f"edge_megakernel {label}: {name} differs from the plain version")
        check(float(k1.keep.sum()) > 0, f"edge_megakernel {label}: nothing kept")
    err["stratified_stats"] = stratified_checks(x)
    err["flash_attention"], err["flash_by_shape"] = flash_checks(x["lat"].device)
    return err


def skewed_sidx(x) -> torch.Tensor:
    """The window's slots with about 85% of the tuples moved into its
    busiest slot: that slot's run fills most of every tile of the sorted-tile
    kernels and crosses every thread's range."""
    sidx = x["sidx"]
    gen = torch.Generator(device=sidx.device).manual_seed(SEED + 3)
    hot = torch.rand(sidx.shape[0], generator=gen, device=sidx.device) < 0.85
    busiest = torch.bincount(sidx, minlength=x["num_slots"]).argmax().to(sidx.dtype)
    return torch.where(hot, busiest, sidx)


def check_edge_reduce(label: str, sidx, values, mask, s: int) -> float:
    """edge_reduce twice (bitwise equal) against its plain version: counts
    exact, sums within ER_RTOL / ER_ATOL -> max |kernel - plain|."""
    from repro_torch.kernels.edge_reduce import edge_reduce, edge_reduce_plain

    r1, r2 = edge_reduce(sidx, values, mask, s), edge_reduce(sidx, values, mask, s)
    rp = edge_reduce_plain(sidx, values, mask, s)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(r1, r2)), f"edge_reduce {label}: two runs differ")
    check(torch.equal(r1[0], rp[0]), f"edge_reduce {label}: counts differ from the plain version")
    for got, ref, name in zip(r1[1:], rp[1:], ("s1", "s2")):
        check(torch.allclose(got, ref, rtol=ER_RTOL, atol=ER_ATOL),
              f"edge_reduce {label}: {name} beyond rtol={ER_RTOL}, atol={ER_ATOL}")
    return max(float((g - r).abs().max()) for g, r in zip(r1, rp))


def stratified_cases(x) -> dict:
    """The public stratified_stats op's inputs on the Shenzhen window: its
    slots, the ``value`` column and a Bernoulli keep mask at FRACTION (f32
    and bf16 values), and a float weight mask with about 1% of the indices
    at -1 and 1% past the last slot (which must contribute nothing)."""
    sidx, vals, s = x["sidx"], x["values"][0].contiguous(), x["num_slots"]
    gen = torch.Generator(device=sidx.device).manual_seed(SEED + 2)
    weights = torch.rand(sidx.shape[0], generator=gen, device=sidx.device)
    pick = torch.rand(sidx.shape[0], generator=gen, device=sidx.device)
    odd = torch.where(pick < 0.01, -1, torch.where(pick < 0.02, s + sidx % 7, sidx))
    keep = x["u"] < FRACTION
    return {"f32": (sidx, vals, keep), "bf16": (sidx, vals.to(torch.bfloat16), keep),
            "weights_out_of_range": (odd, vals, weights)}


def check_stratified(label: str, args, s: int) -> tuple[float, tuple]:
    """The kernel twice (bitwise equal) against its plain version: counts
    exact under a bool mask, sums within the edge_reduce tolerances."""
    from repro_torch.kernels.stratified_stats import stratified_stats, stratified_stats_plain

    a, b = stratified_stats(*args, s), stratified_stats(*args, s)
    plain = stratified_stats_plain(*args, s)
    torch.cuda.synchronize()
    check(all(torch.equal(g, h) for g, h in zip(a, b)), f"stratified_stats {label}: two runs differ")
    check(all(g.shape == (s,) and g.dtype == torch.float32 for g in a),
          f"stratified_stats {label}: outputs {[(g.dtype, tuple(g.shape)) for g in a]}")
    if args[2].dtype == torch.bool:
        check(torch.equal(a[0], plain[0]), f"stratified_stats {label}: counts differ from plain")
    for name, got, ref in zip(("count", "s1", "s2"), a, plain):
        check(torch.allclose(got, ref, rtol=ER_RTOL, atol=ER_ATOL),
              f"stratified_stats {label}: {name} beyond rtol={ER_RTOL}, atol={ER_ATOL}")
    return max(float((g - r).abs().max()) for g, r in zip(a, plain)), a


def stratified_checks(x) -> float:
    """stratified_stats at the main path's shape (three input variants) and
    at the reference kernel test's shapes in f32 and bf16; keeps the main
    shape's outputs in ``x`` for the op path of phase 3."""
    from repro_torch.kernels.stratified_stats import stratified_stats_plain

    s = x["num_slots"]
    cases = stratified_cases(x)
    worst, first = 0.0, {}
    for label, args in cases.items():
        e, first[label] = check_stratified(label, args, s)
        worst = max(worst, e)
    # the window one slot dominates (not an op-path case)
    sidx, vals, keep = cases["f32"]
    worst = max(worst, check_stratified("skewed", (x["skewed_sidx"], vals, keep), s)[0])
    # the out-of-range tuples contribute nothing: the same sums without them
    sidx, vals, w = cases["weights_out_of_range"]
    inside = (sidx >= 0) & (sidx < s)
    ref = stratified_stats_plain(sidx[inside], vals[inside], w[inside], s)
    check(all(torch.allclose(g, r, rtol=ER_RTOL, atol=ER_ATOL)
              for g, r in zip(first["weights_out_of_range"], ref)),
          "stratified_stats: out-of-range indices changed the sums")
    dev = x["sidx"].device
    for n, slots in STRAT_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(SEED + n)
        sidx = torch.randint(0, slots, (n,), generator=gen, device=dev, dtype=torch.int32)
        vals = torch.randn(n, generator=gen, device=dev) * 3 + 10
        keep = torch.rand(n, generator=gen, device=dev) < 0.7
        for dt in (torch.float32, torch.bfloat16):
            label = f"{n}x{slots} {str(dt).removeprefix('torch.')}"
            worst = max(worst, check_stratified(label, (sidx, vals.to(dt), keep), slots)[0])
    x["strat_cases"], x["strat_first"] = cases, first
    return worst


def flash_inputs(shape, dtype, dev):
    """q (B, S, H, dh), k and v (B, S, K, dh) from a seeded CUDA generator."""
    b, s, h, k, dh = shape
    gen = torch.Generator(device=dev).manual_seed(SEED + s + dh)
    return tuple(torch.randn((b, s, n, dh), generator=gen, device=dev).to(dtype) for n in (h, k, k))


def flash_checks(dev) -> tuple[float, dict]:
    """The flash kernel against its plain version at every listed shape, and
    two runs bitwise equal -> (largest |kernel - plain|, that per shape)."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    cases = [(shape, dt) for shape in FLASH_SHAPES for dt in (torch.float32, torch.bfloat16)]
    cases.append((FLASH_SERVE_SHAPE, torch.bfloat16))
    by_shape = {}
    for shape, dtype in cases:
        label = f"flash_attention {'x'.join(map(str, shape))} {str(dtype).removeprefix('torch.')}"
        q, k, v = flash_inputs(shape, dtype, dev)
        a, b = flash_attention(q, k, v), flash_attention(q, k, v)
        plain = flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        check(a.dtype == dtype and a.shape == q.shape,
              f"{label}: output {a.dtype} {tuple(a.shape)}")
        check(torch.equal(a, b), f"{label}: two runs differ")
        tol = FLASH_TOL[dtype]
        diff = (a.float() - plain.float()).abs()
        check(bool(torch.all(diff <= tol + tol * plain.float().abs())),
              f"{label}: max |kernel - plain| {float(diff.max())} beyond atol=rtol={tol}")
        by_shape[label.removeprefix("flash_attention ")] = float(diff.max())
    return max(by_shape.values()), by_shape


def expected_kernels(backend: str, method: str) -> set:
    if backend == "pallas":
        return {"geohash", "edge_reduce"} | ({"sample_mask"} if method == "bernoulli" else set())
    # fused: Bernoulli resolves membership inside the megakernel; SRS
    # stratifies (geohash kernel) for its rank sort first
    return {"edge_megakernel"} | ({"geohash"} if method == "srs" else set())


def phase_end_to_end(windows, dev) -> tuple[dict, list, dict]:
    """The main path: reset the launch counters, run every execute on the
    card, read the counters; then the repeats and the checks."""
    from repro_torch.core import EdgeCloudPipeline, PipelineConfig
    from repro_torch.kernels import build

    pipes = {(name, b): EdgeCloudPipeline(w[0], PipelineConfig(backend=b), device=dev)
             for name, w in windows.items() for b in BACKENDS}
    runs = []
    build.reset_launches()
    for name, (table, cols, second) in windows.items():
        for backend in BACKENDS:
            for method in ("srs", "bernoulli"):
                for qname, q in queries(second, method).items():
                    before = dict(build.LAUNCHES)
                    gen = torch.Generator(device=dev).manual_seed(SEED)
                    res = pipes[(name, backend)].execute(q, gen, cols, FRACTION)
                    torch.cuda.synchronize()
                    moved = {k: build.LAUNCHES[k] - before[k] for k in build.LAUNCHES}
                    runs.append((name, backend, method, qname, q, res, moved))
    before = dict(build.LAUNCHES)
    boot = pipes[("shenzhen", "fused")].execute(
        bootstrap_query(), torch.Generator(device=dev).manual_seed(SEED), windows["shenzhen"][1],
        FRACTION)
    torch.cuda.synchronize()
    boot_moved = {k: build.LAUNCHES[k] - before[k] for k in build.LAUNCHES}
    launches = dict(build.LAUNCHES)

    lines = []
    by_run = {}
    for name, backend, method, qname, q, res, moved in runs:
        label = f"{name}/{backend}/{method}/{qname}"
        by_run[(name, backend, method, qname)] = res
        check(all(moved[k] > 0 for k in expected_kernels(backend, method)),
              f"{label}: kernels not launched: {moved}")
        table, cols, _ = windows[name]
        n = len(cols["lat"])
        again = pipes[(name, backend)].execute(q, torch.Generator(device=dev).manual_seed(SEED),
                                               cols, FRACTION)
        check(same_bits(res.estimates, again.estimates), f"{label}: two executes differ")
        u = torch.rand(n, generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
        cpu_pipe = EdgeCloudPipeline(table.to("cpu"), PipelineConfig(backend=backend), device="cpu")
        ref = cpu_pipe.execute(q, None, cols, FRACTION, uniforms=u.cpu())
        compare_results(res, ref, label)
        for est in res.estimates.values():
            check(est.value.shape == ((table.num_neighborhoods,) if q.group_by else ()),
                  f"{label}: estimate shape {tuple(est.value.shape)}")
        err = mape(res, exact_answers(q, table.to("cpu"), cols))
        check(err < MAPE_LIMIT, f"{label}: MAPE {err:.4f} >= {MAPE_LIMIT}")
        same = ""
        if backend == "fused":
            compare_results(res, by_run[(name, "pallas", method, qname)], f"{label} vs pallas",
                            exact_n=True)
            same = ", the pallas run's sample"
        lines.append(f"{label}: N={n} n_sampled={int(res.n_sampled)} n_valid={int(res.n_valid)} "
                     f"n_overflow={int(res.n_overflow)} launches={moved} MAPE={err:.6f} "
                     f"(GPU == CPU counters, two GPU runs bitwise equal{same})")
    lines.append(bootstrap_checks(boot, boot_moved, pipes[("shenzhen", "fused")], windows, dev))
    check(all(launches[k] > 0 for k in EDGE_KERNELS), f"a kernel never launched: {launches}")
    lines.append(segment_checks(windows, by_run, dev))
    return launches, lines, by_run


def segment_checks(windows, by_run, dev) -> str:
    """Every execute once more on the segment backend, twice: the two give
    the same bits, and the pallas run's sample (same uniforms)."""
    from repro_torch.core import EdgeCloudPipeline, PipelineConfig

    count = 0
    for name, (table, cols, second) in windows.items():
        pipe = EdgeCloudPipeline(table, PipelineConfig(backend="segment"), device=dev)
        for method in ("srs", "bernoulli"):
            for qname, q in queries(second, method).items():
                label = f"{name}/segment/{method}/{qname}"
                one, two = (pipe.execute(q, torch.Generator(device=dev).manual_seed(SEED), cols,
                                         FRACTION) for _ in range(2))
                check(same_bits(one.estimates, two.estimates), f"{label}: two executes differ")
                compare_results(one, by_run[(name, "pallas", method, qname)], f"{label} vs pallas",
                                exact_n=True)
                count += 1
    return (f"segment backend: {count} executes, each twice on the card: bitwise equal, and the "
            "pallas run's sample (counters, per-stratum n) with estimates within tolerance")


def bootstrap_checks(res, moved, pipe, windows, dev) -> str:
    """The grouped bootstrap query: kernels, reproducibility, accuracy, and
    the card against the CPU with the same uniforms and injected normals."""
    from repro_torch.core import EdgeCloudPipeline, PipelineConfig
    from repro_torch.core.query import bootstrap_normals

    label = "shenzhen/fused/srs/bootstrap"
    table, cols, _ = windows["shenzhen"]
    q = bootstrap_query()
    check(moved["edge_megakernel"] > 0 and moved["geohash"] > 0, f"{label}: kernels {moved}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    again = pipe.execute(q, gen, cols, FRACTION)
    check(same_bits(res.estimates, again.estimates), f"{label}: two executes differ")
    u = torch.rand(len(cols["lat"]), generator=torch.Generator(device=dev).manual_seed(SEED),
                   device=dev)
    normals = bootstrap_normals(pipe.plan(q), table.to("cpu"), res.stats,
                                torch.Generator().manual_seed(SEED))
    on_card = pipe.execute(q, None, cols, FRACTION, uniforms=u, normals=normals)
    cpu_pipe = EdgeCloudPipeline(table.to("cpu"), PipelineConfig(backend="fused"), device="cpu")
    ref = cpu_pipe.execute(q, None, cols, FRACTION, uniforms=u.cpu(), normals=normals)
    compare_results(on_card, ref, f"{label} GPU vs CPU", exact_n=True, bounds=True)
    widths = []
    for key, est in on_card.estimates.items():
        val, lo, hi = (_f64(t) for t in (est.value, est.ci_low, est.ci_high))
        fin = torch.isfinite(val) & (val != 0)
        # a group whose strata are all fully sampled has a zero-width interval
        check(bool(torch.all(hi[fin] >= lo[fin]) and torch.any(hi[fin] > lo[fin])),
              f"{label}: {key} intervals have no width")
        widths.append(f"{key} median width/value {float(((hi - lo) / val.abs())[fin].median()):.4f}")
    err = mape(res, exact_answers(q, table.to("cpu"), cols))
    check(err < MAPE_LIMIT, f"{label}: MAPE {err:.4f} >= {MAPE_LIMIT}")
    return (f"{label}: {REPLICATES} replicates, launches={moved}, MAPE={err:.6f}; "
            f"{'; '.join(widths)} (two GPU runs bitwise equal; GPU == CPU under injected "
            "normals: var bounds within 1e-4 of the value, quantile bounds within a sketch "
            "bin)")


def phase_refined(windows, dev) -> tuple[dict, list]:
    """The refined fused pass of three SRS members, its own path: counters
    zeroed just before and read just after; then the card against the CPU
    and each member against its own execute on the same uniforms."""
    from repro_torch.core import EdgeCloudPipeline, PipelineConfig
    from repro_torch.core.query import finalize, fuse, lower
    from repro_torch.kernels import build

    table, cols, _ = windows["shenzhen"]
    fused = fuse([lower(q, table) for q in refined_members()])
    pipe = EdgeCloudPipeline(table, PipelineConfig(backend="fused"), device=dev)
    build.reset_launches()
    members, comm = pipe.refined_pass(fused, torch.Generator(device=dev).manual_seed(SEED), cols,
                                      REFINED_FRACTIONS)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    check(launches["edge_megakernel"] == 1, f"refined pass: one megakernel launch expected: {launches}")
    u = torch.rand(len(cols["lat"]), generator=torch.Generator(device=dev).manual_seed(SEED),
                   device=dev)
    cpu_table = table.to("cpu")
    cpu_pipe = EdgeCloudPipeline(cpu_table, PipelineConfig(backend="fused"), device="cpu")
    cpu_members, cpu_comm = cpu_pipe.refined_pass(fused, None, cols, REFINED_FRACTIONS,
                                                  uniforms=u.cpu())
    check(comm == cpu_comm, "refined pass: comm bytes differ")
    lines, sampled = [], []
    for m, (plan, got, ref) in enumerate(zip(fused.members, members, cpu_members)):
        label = f"refined member {m} (fraction {REFINED_FRACTIONS[m]})"
        counters = [int(t) for t in got[1:]]
        check(counters == [int(t) for t in ref[1:]], f"{label}: counters GPU {counters} vs CPU")
        for col in got[0]:
            check(torch.equal(_f64(got[0][col]["moments"].n), _f64(ref[0][col]["moments"].n)),
                  f"{label}: per-stratum n of {col} differ")
        compare_estimates(finalize(plan, table, got[0]), finalize(plan, cpu_table, ref[0]), label)
        # the member's own execute at its fraction draws exactly this sample
        own = pipe.execute(plan.query, None, cols, REFINED_FRACTIONS[m], uniforms=u)
        check(int(own.n_sampled) == counters[0], f"{label}: own execute sampled {int(own.n_sampled)}")
        sampled.append(counters[0])
    check(sampled == sorted(sampled), f"refined pass: samples do not nest {sampled}")
    lines.append(f"refined fused pass, 3 SRS members at {REFINED_FRACTIONS}: launches={launches}, "
                 f"n_sampled={sampled}, comm_bytes={comm} (GPU == CPU counters and per-stratum n, "
                 "estimates within tolerance, each member == its own execute)")
    return launches, lines


def counted(fn):
    """Run ``fn`` with every launch counter at 0 before it; -> (its result,
    the counters read just after it)."""
    from repro_torch.kernels import build

    build.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(build.LAUNCHES)


def phase_raw(windows, by_run, dev) -> tuple[dict, list]:
    """Raw mode on the Shenzhen window, its own path (counters zeroed just
    before, read just after): SRS and Bernoulli on pallas and fused, with a
    buffer of the whole window and one of RAW_CAPACITY tuples.  Then the
    checks: the whole-window buffer gives the preagg run's sample and
    estimates; the small one counts its truncation exactly and ships
    ``raw_bytes``; two card runs are bitwise equal; the card against the
    CPU on the same uniforms."""
    from repro_torch.core import EdgeCloudPipeline, PipelineConfig
    from repro_torch.core.query import raw_bytes

    table, cols, second = windows["shenzhen"]
    n = len(cols["lat"])
    cases = [(b, m, cap) for b in BACKENDS for m in ("srs", "bernoulli") for cap in (n, RAW_CAPACITY)]

    def pipe(backend, cap, device=dev, tbl=table):
        return EdgeCloudPipeline(tbl, PipelineConfig(backend=backend, raw_capacity=cap), device=device)

    def raw_query(method):
        return dataclasses.replace(queries(second, method)["flat"], mode="raw")

    pipes = {(b, cap): pipe(b, cap) for b, _, cap in cases}
    runs, launches = counted(lambda: [
        pipes[(b, cap)].execute(raw_query(m), torch.Generator(device=dev).manual_seed(SEED), cols,
                                FRACTION) for b, m, cap in cases])
    check(all(launches[k] > 0 for k in EDGE_KERNELS), f"raw mode: a kernel never launched: {launches}")
    lines = []
    cpu_table = table.to("cpu")
    u = torch.rand(n, generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
    for (backend, method, cap), res in zip(cases, runs):
        label = f"raw {backend}/{method}/capacity {cap}"
        q = raw_query(method)
        again = pipes[(backend, cap)].execute(q, torch.Generator(device=dev).manual_seed(SEED), cols,
                                              FRACTION)
        check(same_bits(res.estimates, again.estimates), f"{label}: two executes differ")
        check(int(res.comm_bytes) == raw_bytes(pipes[(backend, cap)].plan(q), cap),
              f"{label}: comm_bytes {int(res.comm_bytes)}")
        dense = by_run[("shenzhen", backend, method, "flat")]
        kept = int(dense.n_sampled)
        check(int(res.n_truncated) == max(kept - cap, 0),
              f"{label}: n_truncated {int(res.n_truncated)} for {kept} kept")
        if cap == n:
            compare_results(res, dense, f"{label} vs preagg", exact_n=True)
            same = "the preagg run's sample and estimates"
        else:
            ref = pipe(backend, cap, "cpu", cpu_table).execute(q, None, cols, FRACTION,
                                                               uniforms=u.cpu())
            check(int(ref.n_truncated) == int(res.n_truncated), f"{label}: CPU n_truncated")
            compare_results(res, ref, f"{label} GPU vs CPU", exact_n=True)
            same = "GPU == CPU"
        lines.append(f"{label}: n_sampled={int(res.n_sampled)} n_truncated={int(res.n_truncated)} "
                     f"comm_bytes={int(res.comm_bytes)} ({same}; two GPU runs bitwise equal)")
    return launches, lines


def decoded_within_bound(spec: str, dense: dict, decoded: dict, label: str) -> None:
    """A codec's decoded states against the dense ones: rows that drive the
    bounds (counts, sketch bins) exact, except top-k bins, whose per-stratum
    totals are exact; quantized rows within half a step of their row's
    scale plus one ulp of the result (``core/codec.py``); every row exact,
    bit for bit, for a lossless codec."""
    from repro_torch.core.codec import flatten_stats

    want = {(r.column, r.kind, r.name): r for r in flatten_stats(dense)}
    got = {(r.column, r.kind, r.name): r for r in flatten_stats(decoded)}
    check(want.keys() == got.keys(), f"{label}: rows {sorted(got)}")
    tiny = float(np.finfo(np.float32).tiny)
    for key, row in want.items():
        a, b = row.array, got[key].array
        if spec.startswith("topk") and key[2] == "bins":
            check(np.array_equal(a.sum(1), b.sum(1)), f"{label}: {key} totals differ")
        elif spec.startswith("quantize") and row.quantize_ok:
            fin = np.isfinite(a)
            check(np.array_equal(np.isfinite(b), fin) and np.array_equal(a[~fin], b[~fin]),
                  f"{label}: {key} non-finite entries differ")
            amax = float(np.abs(a[fin]).max()) if fin.any() else 0.0
            scale = max(float(np.float32(amax / QUANT_QMAX[spec])), tiny) if amax > 0 else 1.0
            # the declared bound: half a step, plus one ulp of the f32 result
            err = np.abs(b[fin].astype(np.float64) - a[fin])
            limit = 0.5 * scale + np.spacing(np.abs(b[fin]))
            check(bool(np.all(err <= limit)),
                  f"{label}: {key} off by {err.max()} beyond scale/2 = {0.5 * scale} + 1 ulp")
        else:
            check(np.array_equal(a.view(np.uint32), b.view(np.uint32)), f"{label}: {key} changed")


def phase_codecs(windows, by_run, dev) -> tuple[dict, list]:
    """The uplink codecs on the Shenzhen window, their own path: the flat
    and grouped SRS queries on pallas and the bootstrap query on fused
    through every codec spec, with the dense runs' uniforms and normals
    (the same generator seed).  Lossless specs: estimates and states bitwise
    equal to the dense run; every spec ships fewer bytes than the dense
    model; lossy specs keep counts exact and values within their bounds."""
    from repro_torch.core import EdgeCloudPipeline, PipelineConfig
    from repro_torch.core.query import preagg_bytes

    table, cols, second = windows["shenzhen"]
    qs = dict(queries(second, "srs"), bootstrap=bootstrap_query())
    cases = [(spec, qname) for spec in CODEC_SPECS for qname in qs
             if qname != "bootstrap" or spec in LOSSLESS_SPECS]

    def backend_of(qname):
        return "fused" if qname == "bootstrap" else "pallas"

    pipes = {(spec, b): EdgeCloudPipeline(table, PipelineConfig(backend=b, uplink_codec=spec),
                                          device=dev) for spec in CODEC_SPECS for b in BACKENDS}
    runs, launches = counted(lambda: [
        pipes[(spec, backend_of(qname))].execute(qs[qname], torch.Generator(device=dev)
                                                 .manual_seed(SEED), cols, FRACTION)
        for spec, qname in cases])
    check(all(launches[k] > 0 for k in EDGE_KERNELS if k != "sample_mask"),
          f"codecs: a kernel never launched: {launches}")
    dense_boot = EdgeCloudPipeline(table, PipelineConfig(backend="fused"), device=dev).execute(
        qs["bootstrap"], torch.Generator(device=dev).manual_seed(SEED), cols, FRACTION)
    lines = []
    for (spec, qname), res in zip(cases, runs):
        label = f"codec {spec}/{qname}"
        dense = dense_boot if qname == "bootstrap" else by_run[("shenzhen", "pallas", "srs", qname)]
        dense_bytes = preagg_bytes(pipes[(spec, "pallas")].plan(qs[qname]), table.num_slots)
        check(isinstance(res.comm_bytes, int) and res.comm_bytes < dense_bytes,
              f"{label}: {res.comm_bytes} bytes against the dense {dense_bytes}")
        for name in ("n_sampled", "n_valid", "n_overflow"):
            check(int(getattr(res, name)) == int(getattr(dense, name)), f"{label}: {name}")
        if spec in LOSSLESS_SPECS:
            check(same_bits(res.estimates, dense.estimates), f"{label}: estimates differ from dense")
            decoded_within_bound("lossless", dense.stats, res.stats, label)
            kind = "bitwise equal to dense"
        else:
            decoded_within_bound(spec, dense.stats, res.stats, label)
            kind = "counts exact, values within the codec's bound"
        lines.append(f"{label}: {res.comm_bytes} bytes on the wire against {dense_bytes} dense "
                     f"({dense_bytes / res.comm_bytes:.1f}x); {kind}")
    return launches, lines


def phase_stratified_op(x) -> tuple[dict, str]:
    """The public op ``repro_torch.kernels.stratified_stats`` on the window
    (per-stratum moments of the sampled ``value`` column, as the reference's
    kernel benchmark calls it), its own path: each input variant once, the
    counters zeroed just before and read just after; the same bits as the
    kernel checks of phase 2."""
    from repro_torch.kernels import stratified_stats as op

    s = x["num_slots"]
    outs, launches = counted(lambda: {label: op.stratified_stats(*args, s)
                                      for label, args in x["strat_cases"].items()})
    check(launches["stratified_stats"] == len(outs),
          f"stratified_stats op: {launches['stratified_stats']} launches for {len(outs)} calls")
    for label, out in outs.items():
        check(all(torch.equal(a, b) for a, b in zip(out, x["strat_first"][label])),
              f"stratified_stats op {label}: differs from phase 2's run")
    kept = int(outs["f32"][0].sum())
    return launches, (f"stratified_stats op on N={x['sidx'].shape[0]} S+1={s}: "
                      f"{len(outs)} calls ({', '.join(outs)}), launches={launches['stratified_stats']}, "
                      f"{kept} tuples kept in the f32 call; phase 2's bits")


# -- the session ---------------------------------------------------------------


def session_panes(name: str) -> tuple:
    """(table, panes, second column, ROIs) of a session stream."""
    from repro_torch.core import CHICAGO_BBOX, SHENZHEN_BBOX, make_table, pane_windows
    from repro_torch.data import chicago_aq_stream, shenzhen_taxi_stream

    if name == "shenzhen":
        panes = list(pane_windows(shenzhen_taxi_stream(seed=SEED), pane_tuples=SESSION_PANE))
        table = make_table(*SHENZHEN_BBOX, precision=6, neighborhood_precision=4)
        return table, panes, "occupancy", SHENZHEN_ROIS
    panes = list(pane_windows(chicago_aq_stream(seed=SEED), pane_tuples=CHICAGO_PANE))
    return make_table(*CHICAGO_BBOX, precision=5), panes, "temperature", CHICAGO_ROIS


def register_tenants(sess, second: str, rois) -> dict:
    """The session's registrations: the dashboard tenants of
    ``benchmarks/multitenant_bench._tenants`` (mean of two columns, two
    ROIs, two confidences, analytic bounds) in tumbling, sliding (3) and
    hopping (6, 2) windows; the refined SRS members at their own fractions;
    a Bernoulli grouped query under an SLO; a raw-mode flat query; the
    bootstrap query."""
    from repro_torch.core import SLO, AggSpec, Query, WindowSpec

    shapes = (WindowSpec(), WindowSpec("sliding", size=3), WindowSpec("hopping", size=6, stride=2))
    cols = ("value", second)
    regs = {"tenants": [
        sess.register(Query(aggs=(AggSpec("mean", cols[i % 2]),), confidence=(0.95, 0.99)[(i // 2) % 2],
                            roi=rois[(i // 4) % 2], bootstrap_replicates=0), window=shapes[i % 3])
        for i in range(SESSION_TENANTS)]}
    regs["refined"] = [sess.register(q, initial_fraction=f)
                       for q, f in zip(refined_members(second), REFINED_FRACTIONS)]
    regs["bernoulli"] = sess.register(
        Query(aggs=(AggSpec("mean", "value"), AggSpec("p50", "value")), group_by="neighborhood",
              method="bernoulli", bootstrap_replicates=0),
        slo=SLO(target_relative_error=SESSION_SLO_TARGET), window=shapes[1])
    regs["raw"] = sess.register(dataclasses.replace(queries(second, "srs")["flat"], mode="raw"),
                                window=shapes[2])
    regs["bootstrap"] = sess.register(bootstrap_query())
    return regs


def run_session(pipe, panes, second, rois, uniforms=None, normals=None):
    """A fresh session over ``pipe`` stepped through ``panes`` with a seeded
    generator (or the given per-pane uniforms and normals); -> (session,
    registrations, steps, host ms per step)."""
    from repro_torch.core import StreamSession

    sess = StreamSession(pipe, initial_fraction=FRACTION)
    regs = register_tenants(sess, second, rois)
    gen = None if uniforms is not None else torch.Generator(device=pipe.device).manual_seed(SEED)
    steps, ms = [], []
    for i, pane in enumerate(panes):
        t0 = time.perf_counter()
        steps.append(sess.step(gen, pane, uniforms=None if uniforms is None else uniforms[i],
                               normals=None if normals is None else normals[i]))
        if pipe.device.type == "cuda":
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return sess, regs, steps, ms


def same_steps(a, b, label: str) -> int:
    """Two runs' steps bitwise equal: emitted queries, estimates, counters
    and fractions; -> the number of results compared."""
    check(len(a) == len(b), f"{label}: {len(a)} vs {len(b)} steps")
    count = 0
    for i, (x, y) in enumerate(zip(a, b)):
        check(sorted(x.results) == sorted(y.results), f"{label}: step {i} emits differ")
        check(x.fractions == y.fractions, f"{label}: step {i} fractions differ")
        for qid in x.results:
            rx, ry = x.results[qid], y.results[qid]
            check(same_bits(rx.estimates, ry.estimates), f"{label}: step {i} query {qid} differs")
            for name in ("n_sampled", "n_valid", "n_overflow", "n_truncated"):
                check(int(getattr(rx, name)) == int(getattr(ry, name)),
                      f"{label}: step {i} query {qid} {name}")
            count += 1
    return count


def sliding_mape(table, panes, regs, steps) -> float:
    """MAPE of the sliding tenants' emits against the exact mean over the
    window's panes (in the table and the ROI), float64 numpy."""
    from repro_torch.core import geohash

    cpu = table.to("cpu")
    inside, errs = [], []
    for p in panes:
        lat, lon = torch.as_tensor(p.lat), torch.as_tensor(p.lon)
        inside.append((cpu.lookup(geohash.encode(lat, lon, cpu.precision)) < cpu.num_strata).numpy())
    for reg in regs["tenants"]:
        if reg.window.kind != "sliding":
            continue
        (la, lb), (oa, ob) = reg.query.roi
        col = reg.query.aggs[0].column
        for i, st in enumerate(steps):
            sel = range(max(0, i - reg.window.size + 1), i + 1)
            ys = []
            for j in sel:
                p = panes[j]
                lat, lon = p.lat.astype(np.float32), p.lon.astype(np.float32)
                ok = inside[j] & (lat >= np.float32(la)) & (lat <= np.float32(lb)) & \
                    (lon >= np.float32(oa)) & (lon <= np.float32(ob)) & p.valid
                ys.append(np.asarray(p.columns[col], np.float64)[ok])
            truth = float(np.mean(np.concatenate(ys)))
            est = float(st.results[reg.qid].estimates[reg.query.aggs[0].key].value)
            errs.append(abs(est - truth) / abs(truth))
    return float(np.mean(errs))


def session_cpu_check(dev) -> str:
    """The card against the CPU on the Chicago stream: the same
    registrations stepped with the same per-pane uniforms and bootstrap
    normals; counters exact, estimates within tolerance, fractions within
    FRACTION_TOL."""
    from repro_torch.core import EdgeCloudPipeline, PipelineConfig
    from repro_torch.core.query import bootstrap_normals

    table, panes, second, rois = session_panes("chicago")
    cpu_table = table.to("cpu")
    uniforms = [torch.rand(len(p.lat), generator=torch.Generator().manual_seed(SEED + i))
                for i, p in enumerate(panes)]
    normals = [functools.partial(lambda seed, plan, stats: bootstrap_normals(
        plan, cpu_table, stats, torch.Generator().manual_seed(seed)), SEED + i)
        for i in range(len(panes))]
    cfg = PipelineConfig(backend="pallas", uplink_codec="delta:sparse")
    _, regs, on_card, _ = run_session(EdgeCloudPipeline(table, cfg, device=dev), panes, second, rois,
                                      uniforms=[u.to(dev) for u in uniforms], normals=normals)
    _, _, on_cpu, _ = run_session(EdgeCloudPipeline(cpu_table, cfg, device="cpu"), panes, second,
                                  rois, uniforms=uniforms, normals=normals)
    boot = regs["bootstrap"].qid
    count = 0
    for i, (g, c) in enumerate(zip(on_card, on_cpu)):
        label = f"chicago session step {i} GPU vs CPU"
        check(sorted(g.results) == sorted(c.results), f"{label}: emits differ")
        for qid in g.results:
            compare_results(g.results[qid], c.results[qid], f"{label} query {qid}",
                            bounds=qid == boot)
            count += 1
        for qid, f in c.fractions.items():
            check(abs(g.fractions[qid] - f) <= FRACTION_TOL, f"{label}: fraction of query {qid}")
    return (f"chicago session ({len(panes)} panes of {CHICAGO_PANE}, Geohash-5, pallas, "
            f"delta:sparse): {count} results GPU == CPU (counters exact, estimates within "
            f"tolerance, fractions within {FRACTION_TOL}) under the same uniforms and normals")


def phase_session(dev, card: str) -> tuple[dict, list]:
    """The continuous-query path: the registered tenants over the Shenzhen
    stream, dense and with the delta:sparse codec, on pallas and fused,
    counters zeroed just before these four runs and read just after; then
    the checks, times and syncs."""
    from repro_torch.core import EdgeCloudPipeline, PipelineConfig, StreamSession

    table, panes, second, rois = session_panes("shenzhen")
    configs = [(b, c) for b in BACKENDS for c in (None, "delta:sparse")]
    pipes = {(b, c): EdgeCloudPipeline(table, PipelineConfig(backend=b, uplink_codec=c), device=dev)
             for b, c in configs}
    runs, launches = counted(lambda: {
        cfg: run_session(pipes[cfg], panes, second, rois) for cfg in configs})
    check(all(launches[k] > 0 for k in EDGE_KERNELS), f"session: a kernel never launched: {launches}")
    lines = [f"session over {len(panes)} panes of {SESSION_PANE} (Shenzhen, Geohash-6, "
             f"{table.num_slots} slots): launches={launches}"]
    for (backend, codec), (sess, regs, steps, ms) in runs.items():
        emits = sum(len(st.results) for st in steps)
        lines.append(
            f"[{card}] session {backend}/{codec or 'dense'}: {len(sess.registrations)} queries in "
            f"{len(sess._fusion_groups)} fusion groups, {emits} results, "
            f"{sess.total_passes} passes, {sess.total_comm_bytes} uplink bytes; host ms per step "
            f"median {statistics.median(ms):.3f} (first {ms[0]:.3f}, all "
            f"{', '.join(f'{t:.1f}' for t in ms)}); programs built {sess.pipe.compile_count}")
    for backend in BACKENDS:
        sess, regs, dense, _ = runs[(backend, None)]
        coded_sess, _, coded, _ = runs[(backend, "delta:sparse")]
        n = same_steps(dense, coded, f"session {backend}: delta:sparse vs dense")
        check(coded_sess.total_comm_bytes < sess.total_comm_bytes,
              f"session {backend}: codec bytes {coded_sess.total_comm_bytes} >= dense")
        lines.append(f"session {backend}: delta:sparse bitwise equal to dense over {n} results, "
                     f"{coded_sess.total_comm_bytes} bytes against {sess.total_comm_bytes} "
                     f"({sess.total_comm_bytes / coded_sess.total_comm_bytes:.1f}x fewer)")
        err = sliding_mape(table, panes, regs, dense)
        check(err < MAPE_LIMIT, f"session {backend}: sliding-window MAPE {err:.4f} >= {MAPE_LIMIT}")
        lines.append(f"session {backend}: sliding windows' MAPE against the exact answer {err:.6f}")
        hop = [st for st in dense if regs["raw"].qid in st.results]
        check(len(hop) == 3 and int(hop[-1].results[regs["raw"].qid].n_valid) > 0,
              f"session {backend}: the hopping window emitted {len(hop)} times")
    # a second run, on pallas
    n = same_steps(runs[("pallas", None)][2],
                   run_session(pipes[("pallas", None)], panes, second, rois)[2], "session: two runs")
    lines.append(f"session pallas: two runs bitwise equal ({n} results)")
    # a one-query session's first step is execute
    for backend in BACKENDS:
        pipe = pipes[(backend, None)]
        q = bootstrap_query()
        want = pipe.execute(q, torch.Generator(device=dev).manual_seed(SEED), panes[0], FRACTION)
        one = StreamSession(pipe, initial_fraction=FRACTION)
        reg = one.register(q)
        got = one.step(torch.Generator(device=dev).manual_seed(SEED), panes[0]).results[reg.qid]
        check(same_bits(got.estimates, want.estimates), f"session {backend}: step != execute")
    lines.append("one-query session step == execute bit for bit (bootstrap query, pallas and fused)")
    # syncs per step, on a session two panes in
    for cfg in configs:
        sess = StreamSession(pipes[cfg], initial_fraction=FRACTION)
        register_tenants(sess, second, rois)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        for pane in panes[:2]:
            sess.step(gen, pane)
        syncs = sync_count(lambda: sess.step(gen, panes[2]))
        lines.append(f"session {cfg[0]}/{cfg[1] or 'dense'}: {syncs} syncs in one step "
                     f"({len(sess._fusion_groups)} groups)")
    lines.append(session_cpu_check(dev))
    return launches, lines


def serve_prompts(vocab_size: int) -> list:
    rng = np.random.default_rng(SEED)
    return [rng.integers(0, vocab_size, PROMPT_LEN).astype(np.int32) for _ in range(SERVE_REQUESTS)]


def phase_serving(dev, card: str) -> tuple[dict, list, tuple]:
    """The LM serving path: qwen1.5-0.5b at full width and depth serves the
    requests through the serve loop, counters zeroed just before and read
    just after; then the checks, a second run and the times.  Returns the
    launches, the lines, and the model with one batch's prefill and decode
    inputs for the profiles of phase 5."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.serve import serve_requests
    from repro_torch.models import init_params

    cfg = get_config(SERVE_ARCH)
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    prompts = serve_prompts(cfg.vocab_size)
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    served = serve_requests(model, cfg, prompts, SERVE_BATCH, MAX_NEW)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    label = f"serve {cfg.name} ({cfg.num_layers} layers, d {cfg.d_model}, vocab {cfg.vocab_size})"
    check(served.prefills == -(-SERVE_REQUESTS // SERVE_BATCH),
          f"{label}: {served.prefills} prefills")
    check(launches["flash_attention"] == cfg.num_layers * served.prefills,
          f"{label}: flash_attention launched {launches['flash_attention']} times, expected "
          f"{cfg.num_layers} per prefill x {served.prefills}")
    check(served.tokens.shape == (SERVE_REQUESTS, MAX_NEW),
          f"{label}: tokens {tuple(served.tokens.shape)}")
    check(bool(served.finite), f"{label}: a logit is not finite")
    check(int(served.tokens.min()) >= 0 and int(served.tokens.max()) < cfg.vocab_size,
          f"{label}: a token outside the vocabulary")
    t0 = time.perf_counter()
    again = serve_requests(model, cfg, prompts, SERVE_BATCH, MAX_NEW)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    check(torch.equal(served.tokens, again.tokens), f"{label}: two runs generate different tokens")
    check(torch.equal(served.last_logits.view(torch.uint8), again.last_logits.view(torch.uint8)),
          f"{label}: two runs end with different logits")

    batch = torch.as_tensor(np.stack(prompts[:SERVE_BATCH])).to(dev)
    positions = torch.arange(PROMPT_LEN, device=dev).expand(SERVE_BATCH, PROMPT_LEN)
    max_len = PROMPT_LEN + MAX_NEW
    prefill_ms = host_ms(lambda: model.prefill(batch, positions, max_len), reps=5, warm=1)
    logits, state = model.prefill(batch, positions, max_len)
    toks = torch.argmax(logits, -1).to(torch.int32)
    decode_ms = host_ms(lambda: model.decode_step(state, toks), reps=20, warm=2)
    n_tokens = served.tokens.numel()
    lines = [
        f"{label}: {SERVE_REQUESTS} requests x {PROMPT_LEN} prompt tokens in batches of "
        f"{SERVE_BATCH}, {MAX_NEW} greedy tokens each; launches={launches}; logits finite, tokens "
        f"in [0, {cfg.vocab_size}), two runs bitwise equal (tokens and last logits)",
        f"[{card}] {label}: prefill (B {SERVE_BATCH}, S {PROMPT_LEN}) {prefill_ms:.3f} ms, decode "
        f"{decode_ms:.3f} ms per step (B {SERVE_BATCH}, cache {max_len}); whole run "
        f"{serve_s * 1e3:.1f} ms for {n_tokens} generated tokens = {n_tokens / serve_s:.1f} "
        f"tokens/s (first run, with warm-up, {first_s * 1e3:.1f} ms); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
    ]
    lines.append(cross_check(cfg, dev))
    return launches, lines, (model, batch, positions, max_len, state, toks)


def cross_check(cfg, dev) -> str:
    """The serving config cut to 2 layers in f32, the same weights on the
    card (flash kernel) and on the CPU (plain attention): prefill and a
    greedy decode give the same tokens and close logits."""
    from repro_torch.kernels import build
    from repro_torch.models import DenseTransformer, init_tree, param_specs
    from repro_torch.models.transformer import map_leaves

    cfg = cfg.replace(num_layers=CROSS_LAYERS, dtype=torch.float32)
    tree = init_tree(param_specs(cfg), torch.Generator(device=dev).manual_seed(SEED + 1), dev)
    on_card = DenseTransformer(cfg, tree)
    on_cpu = DenseTransformer(cfg, map_leaves(lambda t: t.cpu(), tree))
    rng = np.random.default_rng(SEED + 1)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (CROSS_BATCH, CROSS_LEN)),
                           dtype=torch.int32)
    pos = torch.arange(CROSS_LEN).expand(CROSS_BATCH, CROSS_LEN)
    max_len = CROSS_LEN + CROSS_STEPS
    label = f"{cfg.name} cut to {CROSS_LAYERS} layers, f32, GPU vs CPU"
    build.reset_launches()
    g_logits, g_state = on_card.prefill(toks.to(dev), pos.to(dev), max_len)
    torch.cuda.synchronize()
    launched = build.LAUNCHES["flash_attention"]
    check(launched == CROSS_LAYERS,
          f"{label}: flash_attention launched {launched} times on the card")
    c_logits, c_state = on_cpu.prefill(toks, pos, max_len)
    check(build.LAUNCHES["flash_attention"] == CROSS_LAYERS, f"{label}: the CPU launched a kernel")
    worst = 0.0
    for step in range(CROSS_STEPS + 1):
        g, c = g_logits.cpu(), c_logits
        scale = c[:, : cfg.vocab_size].abs().amax(-1, keepdim=True)
        err = ((g - c).abs() / scale).nan_to_num(0.0)  # the padded rows are -1e30 on both
        check(bool(torch.all((g == c) | (err <= CROSS_RTOL))),
              f"{label}: step {step} logits differ by {float(err.max())} of the row's largest")
        worst = max(worst, float(err[:, : cfg.vocab_size].max()))
        g_tok, c_tok = (torch.argmax(t, -1).to(torch.int32) for t in (g_logits, c_logits))
        check(torch.equal(g_tok.cpu(), c_tok),
              f"{label}: step {step} tokens {g_tok.tolist()} vs {c_tok.tolist()}")
        if step < CROSS_STEPS:
            g_logits, g_state = on_card.decode_step(g_state, g_tok)
            c_logits, c_state = on_cpu.decode_step(c_state, c_tok)
    for name in ("k", "v"):
        kv_err = float((g_state.data[name].cpu() - c_state.data[name]).abs().max())
        check(kv_err <= CROSS_RTOL * float(c_state.data[name].abs().max()),
              f"{label}: {name} cache differs by {kv_err}")
    return (f"{label}: prefill of {CROSS_BATCH} x {CROSS_LEN} tokens and {CROSS_STEPS} greedy "
            f"steps, tokens equal, logits within {worst:.2e} of the row's largest (limit "
            f"{CROSS_RTOL}), "
            f"flash_attention launched {CROSS_LAYERS} times on the card and not on the CPU")


def phase_times(x, windows, dev, card: str) -> tuple[dict, list]:
    from repro_torch.kernels.edge_megakernel import edge_megakernel, edge_megakernel_plain
    from repro_torch.kernels.edge_reduce import edge_reduce, edge_reduce_plain
    from repro_torch.kernels.geohash import geohash_encode, geohash_encode_plain
    from repro_torch.kernels.sample_mask import sample_mask, sample_mask_plain
    from repro_torch.kernels.stratified_stats import stratified_stats, stratified_stats_plain

    timer = Timer(dev)
    n, s, c = x["sidx"].shape[0], x["num_slots"], x["values"].shape[0]
    # the stacked rows [m, m*y_c, (m*y_c)*y_c] the library call sums per slot
    m = x["mask"].to(torch.float32)
    my = m * x["values"]
    rows_t = torch.cat([m[None], my, my * x["values"]]).T.contiguous()
    cases = megakernel_cases(x)

    def mega(label, fn):
        args, kw = cases[label]
        return lambda: fn(*args, **kw)

    calls = {
        "geohash": (
            lambda: geohash_encode(x["lat"], x["lon"], x["precision"]),
            lambda: geohash_encode_plain(x["lat"], x["lon"], x["precision"]),
            None,
            # lat, lon in, codes out; ~20 integer ops a point
            bound_ms(12 * n, 20 * n),
        ),
        "sample_mask": (
            lambda: sample_mask(x["sidx"], x["u"], x["frac"]),
            lambda: sample_mask_plain(x["sidx"], x["u"], x["frac"]),
            None,
            # sidx, u, f in; mask, weight out; gather, compare, divide
            bound_ms(13 * n + 4 * s, 4 * n),
        ),
        "edge_reduce": (
            lambda: edge_reduce(x["sidx"], x["values"], x["mask"], s),
            lambda: edge_reduce_plain(x["sidx"], x["values"], x["mask"], s),
            # the one PyTorch call that sums the same rows per slot
            lambda: torch.zeros((s, 1 + 2 * c), device=dev).index_add_(0, x["sidx"], rows_t),
            # sidx, values, mask in; (1 + 2C) sums per slot out; 2C products
            # and 1 + 2C adds a tuple
            bound_ms(n * (4 + 4 * c + 1) + 4 * s * (1 + 2 * c), n * (1 + 4 * c)),
        ),
    }
    # stratified_stats at the main shape with f32 values and a bool mask
    # (the JSON entry) and with bf16 values; the library call is one f32
    # index_add_ of the stacked (N, 3) rows (float atomics: timed only)
    sidx_s, vals_s, keep_s = x["strat_cases"]["f32"]
    m_s = keep_s.to(torch.float32)
    rows_s = torch.stack([m_s, m_s * vals_s, m_s * vals_s * vals_s], 1)
    for label, case in (("stratified_stats", "f32"), ("stratified_stats/bf16", "bf16")):
        args = x["strat_cases"][case]
        nbytes = n * (4 + args[1].element_size() + 1) + 3 * 4 * s
        calls[label] = (
            functools.partial(stratified_stats, *args, s),
            functools.partial(stratified_stats_plain, *args, s),
            (lambda: torch.zeros((s, 3), device=dev).index_add_(0, sidx_s, rows_s))
            if case == "f32" else None,
            # index, value, mask in; three sums per slot out; 2 products and
            # 3 adds a tuple
            bound_ms(nbytes, 5 * n),
        )
    # the megakernel at execute's single-member shapes: latlon (Bernoulli,
    # the JSON entry), sidx (SRS) and latlon for the flat query (no sketch);
    # no single PyTorch call computes this function
    for label in ("latlon1", "sidx1", "latlon1_flat"):
        calls[f"edge_megakernel/{label}"] = (mega(label, edge_megakernel),
                                             mega(label, edge_megakernel_plain), None,
                                             megakernel_bound(*cases[label]))
    times, lines = {}, []
    for name, (kernel, plain, library, (b_ms, b_by)) in calls.items():
        t = {"ms": timer.ms(kernel), "call_ms": call_ms(kernel),
             "plain_ms": timer.ms(plain),
             "library_ms": None if library is None else timer.ms(library),
             "bound_ms": b_ms, "bound_by": b_by}
        times[name] = t
        lib = "n/a" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
        lines.append(f"[{card}] {name}: device {t['ms']:.4f} ms, per call {t['call_ms']:.4f} ms, "
                     f"bound {b_ms:.4f} ms ({b_by}), plain {t['plain_ms']:.4f} ms, library {lib}")
    # flash attention at the serving prefill's shape (the JSON entry), and in
    # f32 at the GPU-vs-CPU check's; the library call is PyTorch's fused
    # attention on the same tensors, timed only
    flash_shapes = {"flash_attention": (FLASH_SERVE_SHAPE, torch.bfloat16),
                    "flash_attention/f32": ((CROSS_BATCH, CROSS_LEN, 16, 16, 64), torch.float32)}
    for name, (shape, dtype) in flash_shapes.items():
        kernel, plain, library, (b_ms, b_by) = flash_calls(shape, dtype, dev)
        t = {"ms": timer.ms(kernel), "call_ms": call_ms(kernel), "plain_ms": timer.ms(plain),
             "library_ms": timer.ms(library), "bound_ms": b_ms, "bound_by": b_by}
        times[name] = t
        lines.append(f"[{card}] {name} {'x'.join(map(str, shape))}: device "
                     f"{t['ms']:.4f} ms, per call {t['call_ms']:.4f} ms, bound {b_ms:.4f} ms "
                     f"({b_by}), plain {t['plain_ms']:.4f} ms, library (SDPA) "
                     f"{t['library_ms']:.4f} ms")
    times["edge_megakernel"] = times["edge_megakernel/latlon1"]
    lines += [kernel_split(label, fn, card) for label, fn in split_calls(x).items()]
    return times, lines + execute_times(windows, dev, card)


def split_calls(x) -> dict:
    """The calls whose device time ``kernel_split`` splits by pass: the edge
    megakernel at execute's latlon shape (``latlon1``), edge_reduce on the
    window's sample and stratified_stats at the op's f32 case.  Works on any
    tree whose wrappers have these signatures."""
    from repro_torch.kernels.edge_megakernel import edge_megakernel
    from repro_torch.kernels.edge_reduce import edge_reduce
    from repro_torch.kernels.stratified_stats import stratified_stats

    args, kw = megakernel_cases(x)["latlon1"]
    s = x["num_slots"]
    strat = stratified_cases(x)["f32"]
    return {"edge_megakernel/latlon1": lambda: edge_megakernel(*args, **kw),
            "edge_reduce": lambda: edge_reduce(x["sidx"], x["values"], x["mask"], s),
            "stratified_stats": lambda: stratified_stats(*strat, s)}


def kernel_split(label: str, fn, card: str, reps: int = 10) -> str:
    """Device time of each pass of one call: the mean over ``reps`` profiled
    calls, each after an L2 flush, of every device kernel the call launches,
    grouped by pass.  Kernels the hand-written sources do not name (sorts,
    scans, elementwise ops of the glue) count as sort glue."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.bitwise_not_()  # evicts the inputs; its kernel is left out below
            fn()
        torch.cuda.synchronize()
    kernels = {e.key: e.self_device_time_total / reps / 1e3 for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
               and "bitwise_not" not in e.key}

    def pass_of(name: str) -> str:
        for pass_label, marks in (("resolve", ("resolve_kernel",)),
                                  ("tile: sort + records", ("tile_kernel",)),
                                  ("partial sums", ("partial_kernel",)),
                                  ("finish", ("finish_kernel",)),
                                  ("to_float", ("to_float_kernel",)),
                                  ("zero-fill", ("Fill", "fill", "Memset"))):
            if any(mark in name for mark in marks):
                return pass_label
        return "sort glue"

    passes: dict[str, float] = {}
    for name, ms in kernels.items():
        passes[pass_of(name)] = passes.get(pass_of(name), 0.0) + ms
    return (f"[{card}] {label} per-pass device ms (profiler, mean of {reps} calls after an L2 "
            f"flush): {json.dumps(passes)}; sum {sum(passes.values()):.4f} ms; "
            f"kernels: {json.dumps({k[:70]: round(v, 4) for k, v in kernels.items()})}")


def sass_line() -> str:
    """Counts of wgmma (HGMMA) and TMA load (UTMALDG) instructions in the
    built flash library's SASS: the bf16 path issues both."""
    from repro_torch.kernels import build

    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(build.library_path("flash_attention"))],
                          capture_output=True, text=True, check=True).stdout
    counts = {op: sass.count(op) for op in ("HGMMA", "UTMALDG")}
    check(all(counts.values()), f"flash_attention SASS lacks wgmma or TMA loads: {counts}")
    return f"flash_attention SASS ({cuobjdump.name} -sass): {json.dumps(counts)}"


def flash_calls(shape, dtype, dev):
    """(kernel, plain, library, bound) at one shape: q, k, v read once and o
    written once over the memory rate, or the causal products' operations
    (4 B H dh S (S+1) / 2) over the peak rate of the input type."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    q, k, v = flash_inputs(shape, dtype, dev)
    b, s, h, _, dh = shape
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    ops = 4 * b * h * dh * s * (s + 1) / 2
    peak = PEAK_BF16_OPS_PER_S if dtype == torch.bfloat16 else PEAK_OPS_PER_S
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return (lambda: flash_attention(q, k, v), lambda: flash_attention_plain(q, k, v),
            lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                                     enable_gqa=True),
            bound_ms(nbytes, ops, peak))


def execute_times(windows, dev, card: str) -> list:
    """Host-clock latency of each ``execute`` on both backends, timed in
    turns (pallas, fused, fused, pallas) on one card, with the raw-mode and
    codec executes of the Shenzhen window; then one profiled run per method
    and backend on the Shenzhen flat query: device busy time and the
    heaviest device ops.  The profiles come last because a profiler session
    leaves every later launch slower on the host."""
    from repro_torch.core import EdgeCloudPipeline, PipelineConfig

    lines, profiles = [], []
    for name, (table, cols, second) in windows.items():
        on_dev = {k: torch.as_tensor(v, device=dev) for k, v in cols.items()}
        qs = [(f"{method}/{qname}", q, {}) for method in ("srs", "bernoulli")
              for qname, q in queries(second, method).items()]
        if name == "shenzhen":
            srs = queries(second, "srs")
            qs += [("srs/bootstrap", bootstrap_query(), {}),
                   ("srs/flat raw", dataclasses.replace(srs["flat"], mode="raw"), {}),
                   ("srs/flat raw, capacity 500000", dataclasses.replace(srs["flat"], mode="raw"),
                    {"raw_capacity": RAW_CAPACITY}),
                   ("srs/flat delta:sparse", srs["flat"], {"uplink_codec": "delta:sparse"}),
                   ("srs/grouped delta:sparse", srs["grouped"], {"uplink_codec": "delta:sparse"})]
        for qlabel, q, kw in qs:
            pipes = {b: EdgeCloudPipeline(table, PipelineConfig(backend=b, **kw), device=dev)
                     for b in BACKENDS}
            gen = torch.Generator(device=dev).manual_seed(SEED)
            run = {b: functools.partial(pipe.execute, q, gen, on_dev, FRACTION)
                   for b, pipe in pipes.items()}
            turns = {b: [] for b in BACKENDS}
            mallocs = {b: 0 for b in BACKENDS}
            for b in ("pallas", "fused", "fused", "pallas"):
                before = torch.cuda.memory_stats().get("num_device_alloc", 0)
                turns[b].append(host_ms(run[b], reps=10))
                mallocs[b] += torch.cuda.memory_stats().get("num_device_alloc", 0) - before
            from_host = {b: host_ms(functools.partial(pipe.execute, q, gen, cols, FRACTION), reps=5)
                         for b, pipe in pipes.items()}
            syncs = {b: sync_count(run[b]) for b in BACKENDS}
            lines.append(f"[{card}] execute {name}/{qlabel} N={len(cols['lat'])}: "
                         + ", ".join(f"{b} {turns[b][0]:.3f} / {turns[b][1]:.3f} ms (window on "
                                     f"the card, two turns), {from_host[b]:.3f} ms (from host "
                                     f"numpy), {syncs[b]} syncs per execute, {mallocs[b]} cudaMalloc "
                                     "in the timed runs" for b in BACKENDS))
            if name == "shenzhen" and qlabel in ("srs/flat", "bernoulli/flat"):
                profiles += [(run[b], f"execute {name}/{b}/{qlabel}") for b in BACKENDS]
    return lines + [profile_line(fn, label, card) for fn, label in profiles]


def profile_line(fn, label: str, card: str) -> str:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (CPU ops also carry their kernels' device time)
    ops = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in ops)
    top = sorted(ops, key=lambda e: -e.self_device_time_total)[:10]
    heavy = ", ".join(f"{e.key[:60]} {e.self_device_time_total:.1f}us x{e.count}" for e in top)
    return (f"[{card}] profile {label}: wall {wall_us:.0f} us under the profiler, "
            f"device busy {busy_us:.0f} us ({busy_us / wall_us:.1%}), "
            f"{sum(e.count for e in ops)} device ops; heaviest: {heavy}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    print(f"[phase 1] {len(build.KERNELS)} kernels {list(build.KERNELS)} built in "
          f"{phase_build():.2f} s", flush=True)
    if SPLIT_ONLY:
        from repro_torch.kernels.sample_mask import sample_mask

        table, cols, _ = load_window("shenzhen")
        x = kernel_inputs(table, cols, dev)
        x["mask"] = sample_mask(x["sidx"], x["u"], x["frac"])[0]  # phase 2's mask
        for label, fn in split_calls(x).items():
            print(kernel_split(label, fn, card), flush=True)
        return 0
    print(f"[phase 1] {sass_line()}", flush=True)

    t0 = time.perf_counter()
    windows = {name: load_window(name) for name in ("shenzhen", "chicago")}
    table, cols, _ = windows["shenzhen"]
    x = kernel_inputs(table, cols, dev)
    err = phase_kernel_checks(x)
    flash_by_shape = err.pop("flash_by_shape")
    print(f"[phase 2] kernels {list(err)}: max |kernel - plain| {err}; "
          f"N={x['sidx'].shape[0]} S+1={x['num_slots']} C={x['values'].shape[0]}; "
          "bitwise reproducible across two runs", flush=True)
    print("[phase 2] flash_attention max |kernel - plain| by shape (B x S x H x K x dh): "
          + json.dumps(flash_by_shape), flush=True)
    print(f"[phase 2] {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    launches, lines, by_run = phase_end_to_end(windows, dev)
    print("[phase 3] main path (every execute) launches " + json.dumps(launches))
    for line in lines:
        print("[phase 3] " + line, flush=True)
    for name, phase in (("refined pass", lambda: phase_refined(windows, dev)),
                        ("raw mode", lambda: phase_raw(windows, by_run, dev)),
                        ("codecs", lambda: phase_codecs(windows, by_run, dev))):
        path_launches, lines = phase()
        print(f"[phase 3] {name} launches " + json.dumps(path_launches))
        for line in lines:
            print("[phase 3] " + line, flush=True)
    op_launches, line = phase_stratified_op(x)
    print("[phase 3] stratified_stats op launches " + json.dumps(op_launches))
    print("[phase 3] " + line, flush=True)
    launches["stratified_stats"] = op_launches["stratified_stats"]
    print(f"[phase 3] {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    session_launches, lines = phase_session(dev, card)
    print("[phase 3s] session launches " + json.dumps(session_launches))
    for line in lines:
        print("[phase 3s] " + line, flush=True)
    print(f"[phase 3s] {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    serve_launches, lines, served_with = phase_serving(dev, card)
    model, batch, positions, max_len, state, toks = served_with
    print("[phase 4] serving launches " + json.dumps(serve_launches))
    for line in lines:
        print("[phase 4] " + line, flush=True)
    launches["flash_attention"] = serve_launches["flash_attention"]
    print(f"[phase 4] {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    times, lines = phase_times(x, windows, dev, card)
    # the profiles come last (profiling slows every later launch)
    lines.append(profile_line(lambda: model.prefill(batch, positions, max_len),
                              f"prefill {SERVE_ARCH} B {SERVE_BATCH} S {PROMPT_LEN}", card))
    lines.append(profile_line(lambda: model.decode_step(state, toks),
                              f"decode step {SERVE_ARCH} B {SERVE_BATCH}", card))
    for line in lines:
        print("[phase 5] " + line, flush=True)
    print(f"[phase 5] {time.perf_counter() - t0:.1f} s", flush=True)

    kernels = []
    for name in build.KERNELS:
        t = times[name]
        source, replaces = KERNEL_INFO[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
