"""Shared neural layers of the serving path: norms, rotary embeddings,
attention, MLP, embedding and logits.

Plain functions on tensors, with the JAX package's signatures and layouts
(activations (B, S, H, dh), weights ``wq`` (d, H, dh), ``wo`` (H, dh, d)),
so that each can be held against its counterpart on the same inputs.  A
weight is cast to ``cfg.dtype`` where it is used, as the reference does;
the model hands these functions weights it already keeps in ``cfg.dtype``,
so the cast is free on the hot path.

The causal attention of a prefill is :func:`chunked_causal_attention`, the
plain version behind the hand-written flash kernel
(``kernels/flash_attention``): logits in f32 from the operands, an f32
softmax, and the weights cast to ``v.dtype`` before the product with V.
Left out until their slices: M-RoPE (vlm), cross attention (encdec), the
sharded decode attention and the mesh constraints (sharding; the identity
on one card), and the weighted loss (training).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .base import ModelConfig, ParamSpec

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), torch.float32, (None,), init="ones")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * scale
    return out.to(dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def _rope_angles(positions: torch.Tensor, dh: int, theta: float) -> torch.Tensor:
    """positions (..., S) -> angles (..., S, dh//2), f32."""
    half = dh // 2
    exponent = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    inv_freq = 1.0 / (theta**exponent)
    return positions.to(torch.float32)[..., None] * inv_freq


def rope_tables(positions: torch.Tensor, dh: int, theta: float, dtype) -> tuple:
    """(cos, sin), each (B, S, 1, dh//2) in ``dtype``, for positions (B, S):
    computed once and shared by every layer of a prefill or decode step."""
    ang = _rope_angles(positions, dh, theta)
    return torch.cos(ang)[:, :, None, :].to(dtype), torch.sin(ang)[:, :, None, :].to(dtype)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Half-split (LLaMA) rotation of x (B, S, H, dh) by :func:`rope_tables`."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, dh); positions: (B, S). Half-split (LLaMA) convention."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta, x.dtype))


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _sdpa_block(q, k, v, *, causal_offset: int | None, scale: float):
    """One (q_block x kv_prefix) attention block, f32 softmax.

    q: (B, Q, H, dh); k/v: (B, T, K, dh) with H = K * G (GQA).
    causal_offset: absolute position of q[0] minus position of k[0];
      None -> no causal mask (full prefix is visible).
    """
    B, Q, H, dh = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, Q, K, G, dh)
    # f32 logits from the operands: a product of two bf16 values is exact in
    # f32, so this equals a bf16 product accumulated in f32
    scores = torch.einsum("bqkgd,btkd->bkgqt", qg.to(torch.float32), k.to(torch.float32)) * scale
    if causal_offset is not None:
        qpos = torch.arange(Q, device=q.device)[:, None] + causal_offset
        kpos = torch.arange(T, device=q.device)[None, :]
        scores = torch.where(qpos >= kpos, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqt,btkd->bqkgd", w, v)
    return out.reshape(B, Q, H, dh)


def chunked_causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_chunk: int = 1024,
    window: int = 0,
) -> torch.Tensor:
    """Causal (optionally sliding-window) attention, chunked over queries.

    Chunk i attends to the exact prefix slice it can see.  S must be at most
    ``q_chunk`` or a multiple of it, as in the reference."""
    B, S, H, dh = q.shape
    scale = 1.0 / (dh**0.5)
    if S <= q_chunk:
        return _sdpa_block(q, k, v, causal_offset=0, scale=scale)
    assert S % q_chunk == 0, (S, q_chunk)
    outs = []
    for i in range(S // q_chunk):
        q_start = i * q_chunk
        kv_end = q_start + q_chunk
        kv_start = 0 if window <= 0 else max(0, kv_end - window - q_chunk)
        outs.append(_sdpa_block(q[:, q_start:kv_end], k[:, kv_start:kv_end],
                                v[:, kv_start:kv_end], causal_offset=q_start - kv_start,
                                scale=scale))
    return torch.cat(outs, dim=1)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     length: int) -> torch.Tensor:
    """Single-token attention against a cache.

    q: (B, 1, H, dh); caches: (B, T, K, dh); length: the valid cache
    length, a host int (the same for the whole batch, as the model's decode
    position is).  Only the first ``length`` entries are read, where the
    reference masks the rest with -1e30: their weights are exactly 0.
    """
    B, _, H, dh = q.shape
    k_cache, v_cache = k_cache[:, :length], v_cache[:, :length]
    K = k_cache.shape[2]
    G = H // K
    scale = 1.0 / (dh**0.5)
    qg = q.reshape(B, K, G, dh)
    scores = torch.einsum("bkgd,btkd->bkgt", qg.to(torch.float32),
                          k_cache.to(torch.float32)) * scale
    w = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgt,btkd->bkgd", w, v_cache)
    return out.reshape(B, 1, H, dh)


# ---------------------------------------------------------------------------
# Attention layer (projections + output)
# ---------------------------------------------------------------------------


def attention_specs(cfg: ModelConfig, d_model: int | None = None) -> dict:
    d = d_model or cfg.d_model
    dh, H, K = cfg.dh, cfg.num_heads, cfg.num_kv_heads
    spec = {
        "wq": ParamSpec((d, H, dh), cfg.param_dtype, ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, K, dh), cfg.param_dtype, ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, K, dh), cfg.param_dtype, ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((H, dh, d), cfg.param_dtype, ("heads", "head_dim", "embed"), init="scaled"),
    }
    if cfg.qkv_bias:
        spec["bq"] = ParamSpec((H, dh), cfg.param_dtype, ("heads", "head_dim"), init="zeros")
        spec["bk"] = ParamSpec((K, dh), cfg.param_dtype, ("kv_heads", "head_dim"), init="zeros")
        spec["bv"] = ParamSpec((K, dh), cfg.param_dtype, ("kv_heads", "head_dim"), init="zeros")
    return spec


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk"): x (B, S, d) @ w (d, h, k) as one matmul."""
    d, h, k = w.shape
    return torch.matmul(x, w.reshape(d, h * k)).unflatten(-1, (h, k))


def attention_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig):
    dt = cfg.dtype
    q = _project(x, p["wq"].to(dt))
    k = _project(x, p["wk"].to(dt))
    v = _project(x, p["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return q, k, v


def attention_out(p: dict, o: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """einsum("bshk,hkd->bsd")."""
    wo = p["wo"].to(cfg.dtype)
    return torch.matmul(o.flatten(-2), wo.reshape(-1, wo.shape[-1]))


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_specs(cfg: ModelConfig, d_ff: int | None = None, gated: bool = True) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    spec = {
        "w_up": ParamSpec((d, f), cfg.param_dtype, ("embed", "mlp")),
        "w_down": ParamSpec((f, d), cfg.param_dtype, ("mlp", "embed"), init="scaled"),
    }
    if gated:
        spec["w_gate"] = ParamSpec((d, f), cfg.param_dtype, ("embed", "mlp"))
    return spec


def mlp(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = cfg.dtype
    up = torch.matmul(x, p["w_up"].to(dt))
    if "w_gate" in p:
        gate = torch.matmul(x, p["w_gate"].to(dt))
        h = F.silu(gate) * up
    else:
        h = F.gelu(up, approximate="tanh")
    return torch.matmul(h, p["w_down"].to(dt))


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embedding_specs(cfg: ModelConfig) -> dict:
    spec = {"tok": ParamSpec((cfg.padded_vocab, cfg.d_model), cfg.param_dtype, ("vocab", "embed"),
                             init="embed")}
    if not cfg.tie_embeddings:
        spec["unembed"] = ParamSpec((cfg.d_model, cfg.padded_vocab), cfg.param_dtype,
                                    ("embed", "vocab"))
    return spec


def embed_tokens(p: dict, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return F.embedding(tokens.long(), p["tok"].to(cfg.dtype))


def logits_fn(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x (..., d) -> logits (..., padded_vocab) in ``cfg.dtype``; the rows of
    the vocabulary's padding read -1e30, so they never win an argmax.  With
    tied embeddings the product reads ``tok`` transposed in place."""
    if cfg.tie_embeddings:
        w = p["tok"].to(cfg.dtype).t()
    else:
        w = p["unembed"].to(cfg.dtype)
    logits = torch.matmul(x, w)
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = NEG_INF
    return logits
