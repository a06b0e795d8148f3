"""Port geohash + stratify (``repro_torch``, CPU) against the JAX package.

Every comparison here is bit for bit: codes, stratum indices and
neighborhood ids are integers, and the quantize is the same float32
subtract-and-multiply in both packages.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import geohash as jgeo
from repro.core import stratify as jstrat
from repro.kernels.geohash.geohash import encode_pallas
from repro_torch.core import geohash as tgeo
from repro_torch.core import stratify as tstrat
from repro_torch.kernels.geohash import geohash_encode, geohash_encode_plain
from repro_torch.kernels.geohash.ref import geohash_encode_ref

BBOXES = {"shenzhen": tstrat.SHENZHEN_BBOX, "chicago": tstrat.CHICAGO_BBOX}


def _points(precision: int, seed: int = 0):
    """Uniform points plus float32 cell edges and their one-ulp neighbours,
    the poles and the antimeridian (where truncation and clipping bite)."""
    rng = np.random.default_rng(seed)
    lon_bits, lat_bits = tgeo.split_bits(precision)
    lat_cell, lon_cell = tgeo.cell_size_deg(precision)
    lat = [rng.uniform(-90, 90, 1500), [-90.0, 90.0, 0.0]]
    lon = [rng.uniform(-180, 180, 1500), [-180.0, 180.0, 0.0]]
    lat_e = (-90.0 + rng.integers(0, 1 << lat_bits, 150) * lat_cell).astype(np.float32)
    lon_e = (-180.0 + rng.integers(0, 1 << lon_bits, 150) * lon_cell).astype(np.float32)
    for e, out in ((lat_e, lat), (lon_e, lon)):
        out += [e, np.nextafter(e, np.float32(np.inf)), np.nextafter(e, np.float32(-np.inf))]
    lat = np.concatenate(lat).astype(np.float32)
    lon = np.concatenate(lon).astype(np.float32)
    n = min(len(lat), len(lon))
    return lat[:n], lon[:n]


@pytest.mark.parametrize("precision", [1, 2, 3, 4, 5, 6])
def test_encode_matches_jax_and_pallas_interpret(precision):
    lat, lon = _points(precision, seed=precision)
    want = np.asarray(jgeo.encode(jnp.asarray(lat), jnp.asarray(lon), precision)).astype(np.int64)
    pallas = np.asarray(
        encode_pallas(jnp.asarray(lat), jnp.asarray(lon), precision, block=512, interpret=True)
    ).astype(np.int64)
    assert np.array_equal(pallas, want)
    tl, to = torch.from_numpy(lat), torch.from_numpy(lon)
    for got in (tgeo.encode(tl, to, precision), geohash_encode(tl, to, precision),
                geohash_encode_plain(tl, to, precision)):
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy().astype(np.int64), want)
    assert np.array_equal(geohash_encode_ref(lat, lon, precision).astype(np.int64), want)


@pytest.mark.parametrize("precision", [2, 5, 6])
def test_decode_parent_and_strings_match_jax(precision):
    lat, lon = _points(precision, seed=10 + precision)
    codes = np.asarray(jgeo.encode(jnp.asarray(lat), jnp.asarray(lon), precision))
    tcodes = torch.from_numpy(codes.astype(np.int32))
    for got, want in zip(tgeo.decode(tcodes, precision), jgeo.decode(jnp.asarray(codes), precision)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    for pp in range(1, precision + 1):
        want = np.asarray(jgeo.parent(jnp.asarray(codes), precision, pp)).astype(np.int64)
        assert np.array_equal(tgeo.parent(tcodes, precision, pp).numpy(), want)
    strings = jgeo.to_strings(codes, precision)
    assert tgeo.to_strings(codes, precision) == strings
    assert np.array_equal(tgeo.from_strings(strings), jgeo.from_strings(strings).astype(np.int64))
    for la, lo in zip(lat[:50], lon[:50]):
        assert tgeo.encode_host(float(la), float(lo), precision) == jgeo.encode_host(
            float(la), float(lo), precision)


def test_encode_rejects_bad_precision():
    lat = torch.zeros(3)
    for p in (0, 7):
        with pytest.raises(ValueError):
            geohash_encode(lat, lat, p)


def _tables(name, precision):
    jt = jstrat.make_table(*BBOXES[name], precision=precision)
    tt = tstrat.make_table(*BBOXES[name], precision=precision, device="cpu")
    return jt, tt


@pytest.mark.parametrize("name", sorted(BBOXES))
@pytest.mark.parametrize("precision", [5, 6])
def test_make_table_matches_jax(name, precision):
    jt, tt = _tables(name, precision)
    assert tt.codes.dtype == torch.int32
    assert np.array_equal(tt.codes.numpy().astype(np.int64), np.asarray(jt.codes).astype(np.int64))
    assert np.array_equal(tt.neighborhood.numpy(), np.asarray(jt.neighborhood))
    assert (tt.num_strata, tt.num_slots, tt.num_neighborhoods, tt.neighborhood_precision) == (
        jt.num_strata, jt.num_slots, jt.num_neighborhoods, jt.neighborhood_precision)
    # the explicit-code constructor rebuilds the same table
    ft = tstrat.make_table_from_codes(np.asarray(jt.codes)[::-1], precision, device="cpu")
    assert torch.equal(ft.codes, tt.codes) and torch.equal(ft.neighborhood, tt.neighborhood)


def test_shenzhen_geohash6_table_size():
    """The main path's table: 6557 strata, codes below 2**31 (int32-safe)."""
    tt = tstrat.make_table(*tstrat.SHENZHEN_BBOX, precision=6, neighborhood_precision=4, device="cpu")
    assert tt.num_strata == 6557
    assert int(tt.codes.max()) < 2**31


@pytest.mark.parametrize("name", sorted(BBOXES))
@pytest.mark.parametrize("precision", [5, 6])
def test_assign_matches_jax_including_out_of_region(name, precision):
    jt, tt = _tables(name, precision)
    (lat_lo, lat_hi), (lon_lo, lon_hi) = BBOXES[name]
    rng = np.random.default_rng(precision)
    pad = 0.2  # a margin outside the box lands in the overflow slot
    lat = rng.uniform(lat_lo - pad, lat_hi + pad, 4000).astype(np.float32)
    lon = rng.uniform(lon_lo - pad, lon_hi + pad, 4000).astype(np.float32)
    want = np.array(jt.assign(jnp.asarray(lat), jnp.asarray(lon)))
    assert (want == jt.num_strata).any() and (want < jt.num_strata).any()
    for backend in ("segment", "pallas"):
        got = tt.assign(torch.from_numpy(lat), torch.from_numpy(lon), backend=backend)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)
    assert np.array_equal(
        tt.neighborhood_of(torch.from_numpy(want)).numpy(),
        np.asarray(jt.neighborhood_of(jnp.asarray(want))),
    )
