"""Oracle: dense causal SDPA with GQA in pure numpy (f32 softmax).

Jax-free and self-contained (edgelint EDG006), a copy of the JAX package's
oracle.  Inputs convert through ``np.asarray``: numpy arrays, with bf16
values as ``ml_dtypes.bfloat16`` arrays (a torch bf16 tensor goes through
f32 and ``ml_dtypes`` first).  All math runs in f32, with the softmax
weights rounded through the value dtype — mirroring the model's
``w.astype(v.dtype)`` recombination — and the output cast back to the input
dtype.
"""

from __future__ import annotations

import numpy as np


def flash_attention_ref(q, k, v):
    """q: (B, S, H, dh); k/v: (B, S, K, dh); H = K * G. Causal."""
    q_np, k_np, v_np = np.asarray(q), np.asarray(k), np.asarray(v)
    in_dtype = v_np.dtype
    qf = q_np.astype(np.float32)
    kf = k_np.astype(np.float32)
    vf = v_np.astype(np.float32)
    B, S, H, dh = qf.shape
    K = kf.shape[2]
    G = H // K
    qg = qf.reshape(B, S, K, G, dh)
    s = np.einsum("bqkgd,btkd->bkgqt", qg, kf) / np.float32(dh**0.5)
    mask = np.tril(np.ones((S, S), bool))
    s = np.where(mask, s, np.float32(-1e30))
    s = s - s.max(axis=-1, keepdims=True)
    e = np.exp(s)
    w = e / e.sum(axis=-1, keepdims=True)
    # round weights through the kernel's recombination dtype, then back up
    w = w.astype(in_dtype).astype(np.float32)
    o = np.einsum("bkgqt,btkd->bqkgd", w, vf)
    return o.reshape(B, S, H, dh).astype(in_dtype)
