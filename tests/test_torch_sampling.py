"""Port EdgeSOS sampling (``repro_torch``, CPU) against the JAX package.

The JAX package draws one ``jax.random.uniform(key, (N,))`` vector per
window for both methods; the port takes that vector as ``u``.  With it,
masks, ``n_k`` and counts must match bit for bit, weights too (both sides
form them with the same float32 division).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import sampling as jsamp
from repro.kernels.sample_mask.sample_mask import sample_mask_pallas
from repro_torch.core import sampling as tsamp
from repro_torch.kernels.sample_mask import sample_mask, sample_mask_plain
from repro_torch.kernels.sample_mask.ref import sample_mask_ref

S = 37  # strata; slot S is the overflow slot
N = 20_000  # large enough that jax.random.uniform repeats values (ties)


def _case(seed: int):
    rng = np.random.default_rng(seed)
    # skewed strata sizes, a few empty strata, some overflow tuples
    sidx = np.minimum((rng.random(N) ** 2 * (S + 1)).astype(np.int32), S)
    key = jax.random.key(seed)
    u = np.array(jax.random.uniform(key, (N,)))  # writable copy for torch
    return key, sidx, u


def _fraction(kind: str, f: float, seed: int):
    if kind == "scalar":
        return f
    rng = np.random.default_rng(seed)
    vec = np.clip(f * rng.uniform(0.5, 1.5, S + 1), 0.05, 1.0).astype(np.float32)
    return vec


@pytest.mark.parametrize("method", ["srs", "bernoulli"])
@pytest.mark.parametrize("kind", ["scalar", "per_stratum"])
@pytest.mark.parametrize("f", [0.1, 0.5, 0.8, 1.0])
def test_edgesos_matches_jax_bit_for_bit(method, kind, f):
    key, sidx, u = _case(seed=int(f * 10))
    frac = _fraction(kind, f, seed=3)
    want = jsamp.edgesos(key, jnp.asarray(sidx), S + 1, jnp.asarray(frac), method=method)
    for backend in ("segment", "pallas"):
        got = tsamp.edgesos(torch.from_numpy(u), torch.from_numpy(sidx), S + 1,
                            torch.as_tensor(frac), method=method, backend=backend)
        assert np.array_equal(got.mask.numpy(), np.asarray(want.mask))
        assert np.array_equal(got.n_k.numpy(), np.asarray(want.n_k))
        assert np.array_equal(got.counts.numpy(), np.asarray(want.counts))
        assert np.array_equal(got.weight.numpy(), np.asarray(want.weight))


def test_uniform_ties_break_by_tuple_index():
    """JAX's argsort is stable: tied uniforms keep tuple order, on every
    device.  Ties are real at this N (jax uniforms have 23-bit spacing)."""
    key, sidx, u = _case(seed=5)
    assert len(np.unique(u)) < N
    ranks, counts = tsamp.srs_ranks(torch.from_numpy(u), torch.from_numpy(sidx), S + 1)
    want, want_counts = jsamp.srs_ranks(key, jnp.asarray(sidx), S + 1)
    assert np.array_equal(ranks.numpy(), np.asarray(want))
    assert np.array_equal(counts.numpy(), np.asarray(want_counts))
    # an engineered all-ties window: ranks follow tuple order inside a stratum
    flat = torch.full((N,), 0.5)
    ranks, _ = tsamp.srs_ranks(flat, torch.from_numpy(sidx), S + 1)
    for k in (0, 3, S):
        assert np.array_equal(ranks.numpy()[sidx == k], np.arange(int((sidx == k).sum())))


def test_allocate_proportional_rounds_half_to_even():
    counts = np.array([1, 3, 5, 7, 2, 6, 0, 9], np.int32)  # f*N = k + 0.5 ties
    for f in (0.5, np.float32(0.5)):
        want = np.asarray(jsamp.allocate_proportional(jnp.asarray(counts), f))
        got = tsamp.allocate_proportional(torch.from_numpy(counts), f).numpy()
        assert np.array_equal(got, want)
        assert np.array_equal(got, [0, 2, 2, 4, 1, 3, 0, 4])


def test_allocate_neyman_and_counts_match_jax():
    rng = np.random.default_rng(2)
    counts = rng.integers(0, 500, S + 1).astype(np.int32)
    sd = rng.uniform(0, 5, S + 1).astype(np.float32)
    for f in (0.1, 0.6):
        want = jsamp.allocate_neyman(jnp.asarray(counts), jnp.asarray(sd), f)
        got = tsamp.allocate_neyman(torch.from_numpy(counts), torch.from_numpy(sd), f)
        assert np.array_equal(got.numpy(), np.asarray(want))
    _, sidx, u = _case(seed=9)
    assert np.array_equal(tsamp.stratum_counts(torch.from_numpy(sidx), S + 1).numpy(),
                          np.asarray(jsamp.stratum_counts(jnp.asarray(sidx), S + 1)))


def test_srs_keep_sets_nest_across_fractions():
    _, sidx, u = _case(seed=4)
    masks = [tsamp.edgesos(torch.from_numpy(u), torch.from_numpy(sidx), S + 1, f).mask
             for f in (0.2, 0.5, 0.9)]
    for lo, hi in zip(masks, masks[1:]):
        assert bool((lo <= hi).all())


@pytest.mark.parametrize("n,s", [(100, 9), (3000, 700)])
def test_sample_mask_plain_matches_pallas_interpret(n, s):
    rng = np.random.default_rng(n)
    sidx = rng.integers(0, s, n).astype(np.int32)
    frac = rng.uniform(0.05, 1.0, s).astype(np.float32)
    u = rng.random(n).astype(np.float32)
    pm, pw = sample_mask_pallas(jnp.asarray(sidx), jnp.asarray(u), jnp.asarray(frac), interpret=True)
    args = (torch.from_numpy(sidx), torch.from_numpy(u), torch.from_numpy(frac))
    for gm, gw in (sample_mask(*args), sample_mask_plain(*args)):
        assert np.array_equal(gm.numpy(), np.asarray(pm))
        # rtol as the reference's own kernel test (tests/test_kernels.py)
        np.testing.assert_allclose(gw.numpy(), np.asarray(pw), rtol=1e-5)
    rm, rw = sample_mask_ref(sidx, u, frac)
    gm, gw = sample_mask_plain(*args)
    assert np.array_equal(gm.numpy(), rm) and np.array_equal(gw.numpy(), rw)
