"""Decoder-only LM of the dense family (qwen1.5, internlm2): parameter
specs, prefill and decode.

:class:`DenseTransformer` holds one :class:`DecoderLayer` module per layer.
Its parameters come in the JAX package's tree layout (``layers/*`` leaves
stacked over the layers, ``(L, ...)``), which it takes apart, and stay in
``cfg.param_dtype``; each module also keeps one ``cfg.dtype`` copy of its
matrices, made at load time, where the reference casts per use (the same
values).  The rmsnorm scales stay f32.

The prefill's causal attention is :func:`~repro_torch.kernels.flash_attention.flash_attention`:
the hand-written kernel on CUDA tensors, the model's chunked attention with
``q_chunk = min(cfg.chunk_size * 4, S)`` on CPU tensors, as the reference
calls it.  Decode attends with the plain :func:`~.layers.decode_attention`
(plain jnp in the reference too) and writes each step's key and value into
the cache in place, where the reference returns an updated copy.  The
cache keeps the reference's ``(L, B, T, K, dh)`` layout; the position is a
host int, so a step never reads the card.

Left out, because they have no counterpart on one card run without
gradients: rematerialization (``_remat``), XLA's ``optimization_barrier``
and the mesh ``constrain`` calls.  Families other than ``dense``, sliding
windows, M-RoPE and embedding inputs raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..kernels.flash_attention import flash_attention
from . import layers as L
from .base import ModelConfig, map_leaves, stack_specs

FAMILIES = ("dense",)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not carry yet."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported; the port carries {FAMILIES}")
    if cfg.attention_window or cfg.mrope_sections or cfg.embeddings_in:
        raise NotImplementedError(
            f"{cfg.name}: sliding windows, M-RoPE and embedding inputs are not ported")


def param_specs(cfg: ModelConfig) -> dict:
    """The reference's spec tree: embedding, final norm, stacked layers."""
    check_supported(cfg)
    layer = {
        "ln1": L.rmsnorm_spec(cfg.d_model),
        "attn": L.attention_specs(cfg),
        "ln2": L.rmsnorm_spec(cfg.d_model),
        "mlp": L.mlp_specs(cfg),
    }
    return {
        "embedding": L.embedding_specs(cfg),
        "final_norm": L.rmsnorm_spec(cfg.d_model),
        "layers": map_leaves(lambda s: stack_specs(s, cfg.num_layers), layer),
    }


class DecodeState(NamedTuple):
    """Key/value caches ``{"k", "v"}``, each (L, B, T, K, dh) in
    ``cfg.dtype``, and ``pos``, the tokens already consumed (a host int)."""

    data: dict
    pos: int


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, device) -> DecodeState:
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.dh)
    kv = {n: torch.zeros(shape, dtype=cfg.dtype, device=device) for n in ("k", "v")}
    return DecodeState(data=kv, pos=0)


def _frozen(tree: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False) for k, v in tree.items()})


class _Casting(nn.Module):
    """A module that keeps ``cfg.dtype`` copies of its matrices, rebuilt by
    :meth:`refresh` whenever its parameters move."""

    cfg: ModelConfig

    def refresh(self) -> None:
        raise NotImplementedError

    def _apply(self, fn, recurse=True):
        out = super()._apply(fn, recurse)
        self.refresh()
        return out

    def _cast(self, params: nn.ParameterDict) -> dict:
        return {k: p.detach().to(self.cfg.dtype) for k, p in params.items()}


class DecoderLayer(_Casting):
    """rmsnorm -> attention -> residual -> rmsnorm -> gated MLP -> residual."""

    def __init__(self, cfg: ModelConfig, p: dict):
        super().__init__()
        self.cfg = cfg
        self.ln1 = nn.Parameter(p["ln1"], requires_grad=False)
        self.attn = _frozen(p["attn"])
        self.ln2 = nn.Parameter(p["ln2"], requires_grad=False)
        self.mlp = _frozen(p["mlp"])
        self.refresh()

    def refresh(self) -> None:
        self._attn, self._mlp = self._cast(self.attn), self._cast(self.mlp)

    def prefill(self, h, cos, sin, q_chunk: int):
        """h (B, S, d) -> (h, rotated keys, values) of this layer."""
        cfg = self.cfg
        q, k, v = L.attention_qkv(self._attn, L.rmsnorm(h, self.ln1, cfg.norm_eps), cfg)
        qr, kr = L.rotate(q, cos, sin), L.rotate(k, cos, sin)
        o = flash_attention(qr, kr, v, q_chunk=q_chunk)
        h = h + L.attention_out(self._attn, o, cfg)
        h = h + L.mlp(self._mlp, L.rmsnorm(h, self.ln2, cfg.norm_eps), cfg)
        return h, kr, v

    def decode(self, h, cos, sin, k_cache, v_cache, pos: int):
        """h (B, d) at position ``pos``; writes the caches (B, T, K, dh) there."""
        cfg = self.cfg
        q, k, v = L.attention_qkv(self._attn, L.rmsnorm(h, self.ln1, cfg.norm_eps)[:, None, :], cfg)
        q, k = L.rotate(q, cos, sin), L.rotate(k, cos, sin)
        k_cache[:, pos] = k[:, 0]
        v_cache[:, pos] = v[:, 0]
        o = L.decode_attention(q, k_cache, v_cache, pos + 1)
        h = h + L.attention_out(self._attn, o, cfg)[:, 0, :]
        return h + L.mlp(self._mlp, L.rmsnorm(h, self.ln2, cfg.norm_eps)[:, None, :], cfg)[:, 0, :]


class DenseTransformer(_Casting):
    """The dense decoder from a parameter tree in the reference's layout
    (tensors on the device the model runs on)."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.embedding = _frozen(params["embedding"])
        self.final_norm = nn.Parameter(params["final_norm"], requires_grad=False)
        stacked = params["layers"]
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, map_leaves(lambda x, i=i: x[i], stacked))
            for i in range(cfg.num_layers)
        )
        self.refresh()

    def refresh(self) -> None:
        self._emb = self._cast(self.embedding)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, positions: torch.Tensor, max_len: int | None = None):
        """tokens, positions (B, S) -> (last-token logits (B, padded_vocab),
        :class:`DecodeState` with the prompt's keys and values, T = max_len)."""
        cfg = self.cfg
        B, S = tokens.shape
        x = L.embed_tokens(self._emb, tokens, cfg)
        cos, sin = L.rope_tables(positions, cfg.dh, cfg.rope_theta, cfg.dtype)
        state = init_decode_state(cfg, B, max_len or S, x.device)
        q_chunk = min(cfg.chunk_size * 4, S)
        for i, layer in enumerate(self.layers):
            x, k, v = layer.prefill(x, cos, sin, q_chunk)
            state.data["k"][i, :, :S] = k
            state.data["v"][i, :, :S] = v
        x = L.rmsnorm(x, self.final_norm, cfg.norm_eps)
        logits = L.logits_fn(self._emb, x[:, -1, :], cfg)
        return logits, state._replace(pos=S)

    @torch.no_grad()
    def decode_step(self, state: DecodeState, tokens: torch.Tensor):
        """One token (B,) for the whole batch -> (logits (B, padded_vocab),
        the state one position on; its caches are updated in place)."""
        cfg = self.cfg
        pos = state.pos
        ks, vs = state.data["k"], state.data["v"]
        if pos >= ks.shape[2]:
            raise ValueError(f"decode position {pos} is past the cache length {ks.shape[2]}")
        x = L.embed_tokens(self._emb, tokens, cfg)
        positions = torch.full((tokens.shape[0], 1), pos, device=x.device)
        cos, sin = L.rope_tables(positions, cfg.dh, cfg.rope_theta, cfg.dtype)
        for i, layer in enumerate(self.layers):
            x = layer.decode(x, cos, sin, ks[i], vs[i], pos)
        x = L.rmsnorm(x, self.final_norm, cfg.norm_eps)
        return L.logits_fn(self._emb, x, cfg), state._replace(pos=pos + 1)
