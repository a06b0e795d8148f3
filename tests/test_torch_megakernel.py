"""The edge megakernel's plain version (``repro_torch``, CPU) against the JAX
package's interpreted Pallas kernel and numpy oracle, in both membership
modes.

Cases cover N off the 512-point block, the overflow slot, absent codes in
latlon mode, an all-masked window (keep 0, extrema ±inf), M in {1, 3},
column subsets for the extrema and sketch rows, and bf16 staging against
the oracle on pre-rounded values.  Tolerances are the reference's own
megakernel test's (``tests/test_megakernel.py``: rtol=2e-6, atol=1e-3) for
the sums; counts, extrema and sketch bins match exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.edge_megakernel.edge_megakernel import edge_megakernel_pallas
from repro.kernels.edge_megakernel.ref import edge_megakernel_ref as jax_ref
from repro.kernels.geohash.ref import encode_ref
from repro_torch.kernels import build
from repro_torch.kernels.edge_megakernel import MegaResult, edge_megakernel, edge_megakernel_plain
from repro_torch.kernels.edge_megakernel.ref import edge_megakernel_ref

RTOL, ATOL = 2e-6, 1e-3
EXACT = ("pop", "keep", "mins", "maxs", "bins")


def _assert_matches(got: MegaResult, want, label):
    for name, g, w in zip(MegaResult._fields, got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, f"{label}:{name}"
        if name in EXACT:
            assert np.array_equal(g, w), f"{label}:{name}"
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=f"{label}:{name}")


def _sidx_case(n, m, c, s, seed, ok_mode):
    rng = np.random.default_rng(seed)
    sidx = rng.integers(0, s, (m, n)).astype(np.int32)
    if n > 1:
        sidx[:, 0] = s - 1  # the overflow slot
    vals = rng.normal(25, 8, (c, n)).astype(np.float32)
    ok = {"random": rng.random((m, n)) < 0.7, "all": np.ones((m, n), bool),
          "none": np.zeros((m, n), bool)}[ok_mode]
    scores = rng.random((m, n)).astype(np.float32)
    thr = rng.uniform(0.0, 1.0, (m, s)).astype(np.float32)
    return sidx, vals, ok, scores, thr


def _latlon_case(n, m, seed):
    rng = np.random.default_rng(seed)
    lat = rng.uniform(0.0, 1.0, n).astype(np.float32)
    lon = rng.uniform(0.0, 1.0, n).astype(np.float32)
    codes = np.unique(np.asarray(encode_ref(lat, lon, 4)))[::2]  # every other cell absent
    vals = rng.normal(5, 3, (2, n)).astype(np.float32)
    ok = rng.random((m, n)) < 0.8
    scores = rng.random((m, n)).astype(np.float32)
    s = int(codes.shape[0]) + 1  # the table's strata plus the overflow slot
    thr = np.broadcast_to(rng.uniform(0.2, 0.9, (m, 1)).astype(np.float32), (m, s)).copy()
    return lat, lon, codes.astype(np.int32), s, vals, ok, scores, thr


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


SIDX_CASES = [
    # n, m, c, s, ok_mode, ext_idx, sk_idx
    (700, 1, 2, 40, "random", (0,), (1,)),
    (700, 3, 3, 40, "all", (0, 2), (1,)),
    (513, 3, 2, 7, "none", (0, 1), (0, 1)),
    (1, 1, 1, 1, "random", (0,), (0,)),
    (300, 2, 4, 25, "random", (), ()),
]


@pytest.mark.parametrize("n,m,c,s,ok_mode,ext_idx,sk_idx", SIDX_CASES)
def test_sidx_mode_matches_pallas_interpret_and_oracle(n, m, c, s, ok_mode, ext_idx, sk_idx):
    sidx, vals, ok, scores, thr = _sidx_case(n, m, c, s, n + m + c, ok_mode)
    before = dict(build.LAUNCHES)
    got = edge_megakernel(*_t(vals, ok, scores, thr), s, sidx=torch.from_numpy(sidx),
                          ext_idx=ext_idx, sk_idx=sk_idx)
    assert build.LAUNCHES == before  # CPU tensors take the plain version
    plain = edge_megakernel_plain(*_t(vals, ok, scores, thr), s, sidx=torch.from_numpy(sidx),
                                  ext_idx=ext_idx, sk_idx=sk_idx)
    for g, p in zip(got, plain):
        assert torch.equal(g, p)
    okf = ok.astype(np.float32)
    want = edge_megakernel_pallas(
        jnp.asarray(vals), jnp.asarray(okf), jnp.asarray(scores), jnp.asarray(thr), s,
        sidx=jnp.asarray(sidx), ext_idx=ext_idx, sk_idx=sk_idx, interpret=True,
    )
    _assert_matches(got, want, "pallas")
    _assert_matches(got, jax_ref(vals, okf, scores, thr, s, sidx=sidx, ext_idx=ext_idx,
                                 sk_idx=sk_idx), "jax ref")
    _assert_matches(got, edge_megakernel_ref(vals, okf, scores, thr, s, sidx=sidx,
                                             ext_idx=ext_idx, sk_idx=sk_idx), "port ref")
    if ok_mode == "none":
        assert not got.keep.any() and not got.pop.any()
        assert torch.all(got.mins == torch.inf) and torch.all(got.maxs == -torch.inf)


@pytest.mark.parametrize("n,m", [(600, 1), (777, 3)])
def test_latlon_mode_matches_pallas_interpret_and_oracle(n, m):
    lat, lon, codes, s, vals, ok, scores, thr = _latlon_case(n, m, n)
    got = edge_megakernel(*_t(vals, ok, scores, thr), s, lat=torch.from_numpy(lat),
                          lon=torch.from_numpy(lon), codes=torch.from_numpy(codes), precision=4,
                          ext_idx=(0,), sk_idx=(1,))
    okf = ok.astype(np.float32)
    want = edge_megakernel_pallas(
        jnp.asarray(vals), jnp.asarray(okf), jnp.asarray(scores), jnp.asarray(thr), s,
        lat=jnp.asarray(lat), lon=jnp.asarray(lon), codes=jnp.asarray(codes.astype(np.uint32)),
        precision=4, ext_idx=(0,), sk_idx=(1,), interpret=True,
    )
    _assert_matches(got, want, "pallas")
    ref = jax_ref(vals, okf, scores, thr, s, lat=lat, lon=lon, codes=codes, precision=4,
                  ext_idx=(0,), sk_idx=(1,))
    _assert_matches(got, ref, "jax ref")
    # absent codes land in no slot: the kept count falls short of the direct one
    kept_all = (ok & (scores < thr[:, :1])).sum(1)
    assert np.all(got.keep.numpy().sum(1) < kept_all)
    assert not got.pop[:, -1].any()  # the overflow slot matches no code


@pytest.mark.parametrize("mode", ["sidx", "latlon"])
def test_bf16_staging_matches_oracle_on_prerounded_values(mode):
    """Staged bf16 values are widened to f32 before any product: the result
    equals the f32 pass over the bf16-rounded values."""
    if mode == "sidx":
        sidx, vals, ok, scores, thr = _sidx_case(900, 2, 2, 30, 3, "random")
        where = dict(sidx=torch.from_numpy(sidx))
        ref_where = dict(sidx=sidx)
        s = 30
    else:
        lat, lon, codes, s, vals, ok, scores, thr = _latlon_case(900, 2, 4)
        where = dict(lat=torch.from_numpy(lat), lon=torch.from_numpy(lon),
                     codes=torch.from_numpy(codes), precision=4)
        ref_where = dict(lat=lat, lon=lon, codes=codes, precision=4)
    staged = torch.from_numpy(vals).to(torch.bfloat16)
    rounded = staged.to(torch.float32).numpy()
    got = edge_megakernel(staged, *_t(ok, scores, thr), s, ext_idx=(0,), sk_idx=(1,), **where)
    ref = jax_ref(rounded, ok.astype(np.float32), scores, thr, s, ext_idx=(0,), sk_idx=(1,),
                  **ref_where)
    _assert_matches(got, ref, f"bf16 {mode}")
    f32 = edge_megakernel(torch.from_numpy(rounded), *_t(ok, scores, thr), s, ext_idx=(0,),
                          sk_idx=(1,), **where)
    for g, f in zip(got, f32):
        assert torch.equal(g, f)


def test_expanded_member_rows_equal_materialized_ones():
    """ok, scores and sidx may be one row expanded over members (the refined
    SRS pass); the result equals the materialized rows'."""
    sidx, vals, ok, scores, thr = _sidx_case(400, 1, 2, 12, 9, "random")
    v, o, sc, t = _t(vals, ok, scores, np.repeat(thr, 3, 0))
    si = torch.from_numpy(sidx)
    a = edge_megakernel(v, o.expand(3, -1), sc.expand(3, -1), t, 12, sidx=si.expand(3, -1))
    b = edge_megakernel(v, o.repeat(3, 1), sc.repeat(3, 1), t, 12, sidx=si.repeat(3, 1))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(a.keep[0], a.keep[2])


def test_wrapper_rejects_what_the_kernel_cannot_take():
    """Off the CPU the wrapper launches its kernel or raises; it refuses a
    tensor on a device without the kernel and unsorted column subsets."""
    meta = torch.empty((1, 8), device="meta")
    with pytest.raises(ValueError):
        edge_megakernel(meta, torch.empty((1, 8), dtype=torch.bool, device="meta"), meta,
                        torch.empty((1, 3), device="meta"), 3,
                        sidx=torch.empty((1, 8), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="latlon"):
        edge_megakernel_plain(torch.zeros((1, 4)), torch.ones((1, 4), dtype=torch.bool),
                              torch.zeros((1, 4)), torch.ones((1, 3)), 3)
