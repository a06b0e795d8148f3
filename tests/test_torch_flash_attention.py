"""The flash-attention plain version of ``repro_torch`` (CPU) against the JAX
package's interpreted Pallas kernel and numpy oracle.

Shapes are the reference kernel test's (``tests/test_kernels.py``): MHA,
GQA, MQA, head_dim 112 and a ragged S = 300, in f32 and bf16, with the
reference's tolerances (2e-5 f32, 2e-2 bf16: the Pallas kernel keeps the
softmax weights in f32, the model's attention casts them to bf16).  The
port's plain version is its model attention, held against the JAX kernel
as the reference holds its own model layer (3e-5).
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_ref
from repro.models.layers import chunked_causal_attention as jax_chunked
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models.layers import chunked_causal_attention

SHAPES = [
    (1, 256, 4, 4, 64),  # MHA
    (2, 512, 8, 2, 64),  # GQA
    (1, 512, 8, 1, 128),  # MQA
    (1, 256, 4, 4, 112),  # zamba head_dim
    (1, 300, 4, 2, 64),  # ragged seq
]
DTYPES = {"float32": (jnp.float32, torch.float32, np.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, ml_dtypes.bfloat16)}


def _inputs(shape, seed=0):
    B, S, H, K, dh = shape
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (B, S, H, dh)).astype(np.float32),
            rng.normal(0, 1, (B, S, K, dh)).astype(np.float32),
            rng.normal(0, 1, (B, S, K, dh)).astype(np.float32))


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float32).numpy()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_matches_jax_kernel_and_oracle(shape, dtype):
    jdt, tdt, ndt = DTYPES[dtype]
    q, k, v = _inputs(shape)
    build.reset_launches()
    got = flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)))
    assert build.LAUNCHES["flash_attention"] == 0  # CPU tensors take the plain version
    assert got.dtype == tdt and got.shape == q.shape
    kernel = np.asarray(jax_flash(*(jnp.asarray(a, jdt) for a in (q, k, v))).astype(jnp.float32))
    oracle = np.asarray(jax_ref(*(a.astype(ndt) for a in (q, k, v)))).astype(np.float32)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_f32(got), kernel, atol=tol, rtol=tol)
    np.testing.assert_allclose(_f32(got), oracle, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_port_oracle_is_the_reference_oracle(dtype):
    _, _, ndt = DTYPES[dtype]
    q, k, v = (a.astype(ndt) for a in _inputs((1, 96, 4, 2, 32), seed=1))
    np.testing.assert_array_equal(np.asarray(flash_attention_ref(q, k, v)),
                                  np.asarray(jax_ref(q, k, v)))


def test_model_chunked_attention_matches_jax_kernel():
    """As ``tests/test_kernels.py`` holds its kernel to the model layer."""
    q, k, v = _inputs((2, 512, 8, 2, 64), seed=2)
    kernel = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = chunked_causal_attention(*map(torch.from_numpy, (q, k, v)), q_chunk=128)
    np.testing.assert_allclose(got.numpy(), kernel, atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("q_chunk,window", [(64, 0), (64, 96), (256, 0)])
def test_chunked_attention_matches_jax_layer(q_chunk, window):
    q, k, v = _inputs((2, 256, 4, 2, 32), seed=3)
    want = np.asarray(jax_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  q_chunk=q_chunk, window=window))
    got = chunked_causal_attention(*map(torch.from_numpy, (q, k, v)), q_chunk=q_chunk,
                                   window=window)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_plain_takes_the_prefill_chunk():
    """``q_chunk`` reaches the chunked attention, clipped to S, and keeps the
    reference's S % q_chunk rule."""
    q, k, v = map(torch.from_numpy, _inputs((1, 96, 2, 2, 16), seed=4))
    whole = flash_attention_plain(q, k, v, q_chunk=1024)
    torch.testing.assert_close(flash_attention(q, k, v, q_chunk=32), whole, atol=1e-6, rtol=1e-6)
    with pytest.raises(AssertionError):
        flash_attention(q, k, v, q_chunk=64)


def test_wrapper_refuses_mixed_devices():
    q, k, v = map(torch.from_numpy, _inputs((1, 16, 2, 2, 16)))
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention(q.to("meta"), k, v)
