"""The port's ``stratified_stats`` op against the JAX package's.

On CPU tensors the port's wrapper takes its plain version (one double
``index_add_``, rounded to f32 once); the JAX op runs its Pallas kernel in
interpret mode off the TPU, as ``tests/test_kernels.py`` runs it.  Inputs
come from a numpy generator with a seed and go to both as numpy arrays.

Tolerances: counts are exact with a bool mask; sums are held to rtol 1e-5,
atol 1e-3 (the JAX kernel accumulates in f32 over 512-tuple blocks, the port
in double; the reference's own kernel test allows rtol 2e-3, atol 0.3).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.stratified_stats import stratified_stats as jax_stratified_stats
from repro.kernels.stratified_stats.ref import stratified_stats_ref as jax_ref
from repro_torch.kernels import build
from repro_torch.kernels.stratified_stats import stratified_stats, stratified_stats_plain
from repro_torch.kernels.stratified_stats.ref import stratified_stats_ref

RTOL, ATOL = 1e-5, 1e-3
SHAPES = [(100, 7), (4096, 512), (20000, 1300)]  # the reference kernel test's


def _inputs(n, s, seed, out_of_range=False, float_mask=False):
    rng = np.random.default_rng(seed)
    sidx = rng.integers(0, s, n).astype(np.int32)
    if out_of_range:
        # about 1% each of -1 padding and indices at or past num_slots
        pick = rng.random(n)
        sidx[pick < 0.01] = -1
        sidx[(pick >= 0.01) & (pick < 0.02)] = s + rng.integers(0, 3, n)[(pick >= 0.01) & (pick < 0.02)]
    vals = rng.normal(10, 3, n).astype(np.float32)
    mask = rng.random(n).astype(np.float32) if float_mask else rng.random(n) < 0.7
    return sidx, vals, mask


def _port(sidx, vals, mask, s, bf16=False):
    v = torch.from_numpy(vals)
    if bf16:
        v = v.to(torch.bfloat16)
    before = dict(build.LAUNCHES)
    out = stratified_stats(torch.from_numpy(sidx), v, torch.from_numpy(mask), s)
    assert build.LAUNCHES == before  # CPU tensors take the plain version
    return [o.numpy() for o in out]


def _jax(sidx, vals, mask, s, bf16=False):
    v = jnp.asarray(vals, jnp.bfloat16 if bf16 else jnp.float32)
    return [np.asarray(o) for o in jax_stratified_stats(jnp.asarray(sidx), v, jnp.asarray(mask), s)]


@pytest.mark.parametrize("n,s", SHAPES)
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_stratified_stats_matches_jax(n, s, bf16):
    sidx, vals, mask = _inputs(n, s, seed=n + s)
    got = _port(sidx, vals, mask, s, bf16)
    want = _jax(sidx, vals, mask, s, bf16)
    assert all(g.dtype == np.float32 and g.shape == (s,) for g in got)
    np.testing.assert_array_equal(got[0], want[0])  # bool mask: counts exact
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n,s", SHAPES)
def test_out_of_range_indices_and_float_mask(n, s):
    """-1 padding and indices >= num_slots contribute nothing; a float mask
    multiplies in as the weight m."""
    sidx, vals, mask = _inputs(n, s, seed=3 * n + s, out_of_range=True, float_mask=True)
    got = _port(sidx, vals, mask, s)
    want = _jax(sidx, vals, mask, s)
    oracle = jax_ref(sidx, vals, mask, s)
    for g, w, o in zip(got, want, oracle):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g, o, rtol=RTOL, atol=ATOL)
    # dropping the out-of-range tuples by hand gives the same bits
    ok = (sidx >= 0) & (sidx < s)
    kept = _port(sidx[ok], vals[ok], mask[ok], s)
    for g, k in zip(got, kept):
        np.testing.assert_array_equal(g, k)


def test_wide_indices_do_not_wrap_into_range():
    """An int64 index past 2**32 must be dropped, not wrapped into a slot."""
    sidx = np.array([2**32 + 1, 1, -2**40, 2], np.int64)
    vals = np.array([5.0, 1.0, 7.0, 2.0], np.float32)
    mask = np.ones(4, bool)
    count, s1, _ = stratified_stats_plain(torch.from_numpy(sidx), torch.from_numpy(vals),
                                          torch.from_numpy(mask), 3)
    assert count.tolist() == [0.0, 1.0, 1.0] and s1.tolist() == [0.0, 1.0, 2.0]


def test_ref_copy_matches_jax_oracle():
    sidx, vals, mask = _inputs(5000, 300, seed=9, out_of_range=True, float_mask=True)
    for a, b in zip(stratified_stats_ref(sidx, vals, mask, 300), jax_ref(sidx, vals, mask, 300)):
        np.testing.assert_array_equal(a, b)


def test_wrapper_refuses_tensors_it_cannot_launch_on():
    meta = torch.empty(8, device="meta")
    with pytest.raises(ValueError):
        stratified_stats(torch.empty(8, dtype=torch.int32, device="meta"), meta,
                         torch.empty(8, dtype=torch.bool, device="meta"), 3)
