"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py

Run from the root of the repository on a machine with an NVIDIA H100 and
the CUDA toolkit.  Phases, in order; any failure exits non-zero before the
last line is printed:

1. Card and build: the card's name and power limit, then one ``nvcc`` per
   CUDA source, all started together, and the build time.
2. Kernel checks: each hand-written kernel against its plain PyTorch version
   on the card, on the inputs the main path gives it (the 1.2 M-tuple
   Shenzhen window at Geohash-6), twice, bitwise reproducible.
3. End to end: ``EdgeCloudPipeline.execute`` with ``backend="pallas"`` for
   SRS and Bernoulli sampling on the Shenzhen window and on one Chicago
   air-quality window (Geohash-5).  Launch counters are zeroed just before
   the main path and read just after it.  Every run is repeated on the CPU
   with the same uniforms (identical counters, estimates within tolerance)
   and held against the exact full-population answer (MAPE < 10% at
   fraction 0.8).
4. Times: CUDA events, median of 25 launches after warm-up with the L2
   cache flushed before each, for every kernel, its plain version and the
   library call where one computes the same function (device time), and
   each kernel's host-clock time per call in a loop; host clock for each
   method's ``execute``, and one profiled ``execute`` per method (device
   busy time and the heaviest device ops).

The line before the card line is a JSON object with one entry per kernel;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

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
# GPU execute against CPU execute on the same uniforms: counters are exact;
# values differ only by f32 summation order (grouped finalize sums with
# atomics on the card), moe additionally through the m2 = s2 - n*mean^2
# cancellation
VALUE_RTOL, MOE_RTOL = 1e-4, 1e-3

KERNEL_INFO = {
    "geohash": ("src/repro_torch/csrc/geohash.cu",
                "src/repro/kernels/geohash/geohash.py:55"),
    "sample_mask": ("src/repro_torch/csrc/sample_mask.cu",
                    "src/repro/kernels/sample_mask/sample_mask.py:59"),
    "edge_reduce": ("src/repro_torch/csrc/edge_reduce.cu",
                    "src/repro/kernels/edge_reduce/edge_reduce.py:77"),
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


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
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
    reducers = {"sum": np.sum, "mean": np.mean, "count": np.size, "min": np.min, "max": np.max}
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


def compare_results(gpu, cpu, label: str) -> None:
    for name in ("n_sampled", "n_valid", "n_overflow"):
        g, c = int(getattr(gpu, name)), int(getattr(cpu, name))
        check(g == c, f"{label}: {name} on the GPU {g} != CPU {c}")
    for key, est in gpu.estimates.items():
        ref = cpu.estimates[key]
        for field, rtol in (("value", VALUE_RTOL), ("moe", MOE_RTOL), ("n", 0.0),
                            ("population", 0.0)):
            a = getattr(est, field).detach().cpu().to(torch.float64)
            b = getattr(ref, field).to(torch.float64)
            check(torch.allclose(a, b, rtol=rtol, atol=0.0, equal_nan=True),
                  f"{label}: {key}.{field} GPU {a.flatten()[:4].tolist()} vs CPU "
                  f"{b.flatten()[:4].tolist()} beyond rtol={rtol}")


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
            "num_slots": table.num_slots}


def phase_kernel_checks(x) -> dict:
    from repro_torch.kernels.edge_reduce import edge_reduce, edge_reduce_plain
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

    r1 = edge_reduce(x["sidx"], x["values"], m1, x["num_slots"])
    r2 = edge_reduce(x["sidx"], x["values"], m1, x["num_slots"])
    rp = edge_reduce_plain(x["sidx"], x["values"], m1, x["num_slots"])
    torch.cuda.synchronize()
    check(all(torch.equal(s, t) for s, t in zip(r1, r2)), "edge_reduce: two runs differ")
    check(torch.equal(r1[0], rp[0]), "edge_reduce: counts differ from the plain version")
    for got, ref, name in zip(r1[1:], rp[1:], ("s1", "s2")):
        check(torch.allclose(got, ref, rtol=ER_RTOL, atol=ER_ATOL),
              f"edge_reduce: {name} beyond rtol={ER_RTOL}, atol={ER_ATOL}")
    err["edge_reduce"] = max(float((g - r).abs().max()) for g, r in zip(r1, rp))
    return err


def phase_end_to_end(windows, dev) -> tuple[dict, list]:
    """The main path: reset the launch counters, run every execute on the
    card, read the counters; then the CPU runs and the checks."""
    from repro_torch.core import EdgeCloudPipeline, PipelineConfig
    from repro_torch.kernels import build

    cfg = PipelineConfig(backend="pallas")
    runs = []
    build.reset_launches()
    for name, (table, cols, second) in windows.items():
        pipe = EdgeCloudPipeline(table, cfg, device=dev)
        for method in ("srs", "bernoulli"):
            for qname, q in queries(second, method).items():
                before = dict(build.LAUNCHES)
                gen = torch.Generator(device=dev).manual_seed(SEED)
                res = pipe.execute(q, gen, cols, FRACTION)
                torch.cuda.synchronize()
                moved = {k: build.LAUNCHES[k] - before[k] for k in build.LAUNCHES}
                runs.append((name, method, qname, q, res, moved))
    launches = dict(build.LAUNCHES)

    lines = []
    for name, method, qname, q, res, moved in runs:
        label = f"{name}/{method}/{qname}"
        expect = {"geohash", "edge_reduce"} | ({"sample_mask"} if method == "bernoulli" else set())
        check(all(moved[k] > 0 for k in expect), f"{label}: kernels not launched: {moved}")
        table, cols, _ = windows[name]
        n = len(cols["lat"])
        u = torch.rand(n, generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
        cpu_pipe = EdgeCloudPipeline(table.to("cpu"), cfg, device="cpu")
        ref = cpu_pipe.execute(q, None, cols, FRACTION, uniforms=u.cpu())
        compare_results(res, ref, label)
        for est in res.estimates.values():
            check(est.value.shape == ((table.num_neighborhoods,) if q.group_by else ()),
                  f"{label}: estimate shape {tuple(est.value.shape)}")
        err = mape(res, exact_answers(q, table.to("cpu"), cols))
        check(err < MAPE_LIMIT, f"{label}: MAPE {err:.4f} >= {MAPE_LIMIT}")
        lines.append(f"{label}: N={n} n_sampled={int(res.n_sampled)} n_valid={int(res.n_valid)} "
                     f"n_overflow={int(res.n_overflow)} launches={moved} MAPE={err:.6f} "
                     "(GPU == CPU counters)")
    check(all(launches[k] > 0 for k in build.KERNELS), f"a kernel never launched: {launches}")
    return launches, lines


def phase_times(x, windows, dev, card: str) -> tuple[dict, list]:
    from repro_torch.kernels.edge_reduce import edge_reduce, edge_reduce_plain
    from repro_torch.kernels.geohash import geohash_encode, geohash_encode_plain
    from repro_torch.kernels.sample_mask import sample_mask, sample_mask_plain

    timer = Timer(dev)
    n, s, c = x["sidx"].shape[0], x["num_slots"], x["values"].shape[0]
    # the stacked rows [m, m*y_c, (m*y_c)*y_c] the library call sums per slot
    m = x["mask"].to(torch.float32)
    my = m * x["values"]
    rows_t = torch.cat([m[None], my, my * x["values"]]).T.contiguous()
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
    lines.append(f"[{card}] edge_reduce glue: stable sort of sidx alone "
                 f"{timer.ms(lambda: torch.sort(x['sidx'], stable=True)):.4f} ms")
    return times, lines + execute_times(windows, dev, card)


def execute_times(windows, dev, card: str) -> list:
    """Host-clock latency of each ``execute``, and one profiled run of each
    on the Shenzhen window: device busy time and the heaviest device ops."""
    from repro_torch.core import EdgeCloudPipeline, PipelineConfig

    cfg = PipelineConfig(backend="pallas")
    lines = []
    for name, (table, cols, second) in windows.items():
        pipe = EdgeCloudPipeline(table, cfg, device=dev)
        on_dev = {k: torch.as_tensor(v, device=dev) for k, v in cols.items()}
        for method in ("srs", "bernoulli"):
            for qname, q in queries(second, method).items():
                gen = torch.Generator(device=dev).manual_seed(SEED)
                run_dev = functools.partial(pipe.execute, q, gen, on_dev, FRACTION)
                t_dev = host_ms(run_dev)
                t_host = host_ms(functools.partial(pipe.execute, q, gen, cols, FRACTION), reps=10)
                lines.append(f"[{card}] execute {name}/{method}/{qname} N={len(cols['lat'])}: "
                             f"{t_dev:.3f} ms (window on the card), "
                             f"{t_host:.3f} ms (window from host numpy)")
                if name == "shenzhen" and qname == "flat":
                    lines.append(profile_line(run_dev, f"{name}/{method}/{qname}", card))
    return lines


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
    return (f"[{card}] profile execute {label}: wall {wall_us:.0f} us under the profiler, "
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
    print(f"[phase 1] kernels built in {phase_build():.2f} s", flush=True)

    windows = {name: load_window(name) for name in ("shenzhen", "chicago")}
    table, cols, _ = windows["shenzhen"]
    x = kernel_inputs(table, cols, dev)
    err = phase_kernel_checks(x)
    print(f"[phase 2] kernels {list(err)}: max |kernel - plain| {err}; "
          f"N={x['sidx'].shape[0]} S+1={x['num_slots']} C={x['values'].shape[0]}; "
          "bitwise reproducible across two runs", flush=True)

    launches, lines = phase_end_to_end(windows, dev)
    print("[phase 3] main path launches " + json.dumps(launches))
    for line in lines:
        print("[phase 3] " + line, flush=True)

    times, lines = phase_times(x, windows, dev, card)
    for line in lines:
        print("[phase 4] " + line, flush=True)

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
