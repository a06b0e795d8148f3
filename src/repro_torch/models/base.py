"""Model substrate foundations: configs, parameter specs, initialization.

Every parameter is described by a :class:`ParamSpec` carrying its shape,
dtype, logical axes and an initializer tag; :func:`init_tree` draws a spec
tree into a tree of tensors from an explicit ``torch.Generator``.  The
logical axes are kept so that specs stay field-for-field comparable with
the JAX package's; on one card nothing maps them to a mesh.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch


class ParamSpec(NamedTuple):
    shape: tuple[int, ...]
    dtype: Any
    axes: tuple[str | None, ...]  # logical axis names, len == len(shape)
    init: str = "normal"  # normal | zeros | ones | embed | scaled


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Superset config covering the assigned architectures (every field of
    the JAX package's config, so config files copy over one for one)."""

    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25
    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_expand: int = 2
    conv_width: int = 4
    # --- hybrid (zamba2): shared attention block cadence ---
    shared_attn_every: int = 0
    # --- xLSTM ---
    slstm_every: int = 0  # 1-in-N layers is sLSTM; 0 -> no sLSTM
    # --- enc-dec ---
    encoder_layers: int = 0
    decoder_layers: int = 0
    # --- modality stubs (vlm/audio): inputs are precomputed embeddings ---
    embeddings_in: bool = False
    mrope_sections: tuple[int, ...] = ()  # qwen2-vl M-RoPE (t, h, w) rotary split
    # --- long-context handling ---
    attention_window: int = 0  # 0 = full causal; >0 = sliding window
    # --- numerics / structure ---
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    vocab_round: int = 256  # pad vocab for TP divisibility + lane alignment
    chunk_size: int = 256  # chunked linear attention / blockwise attn chunk
    remat: str = "full"  # none | full | dots | offload (activation ckpt policy)
    # --- data-layer (paper integration) ---
    data_num_strata: int = 64  # strata slots for stratified loss telemetry

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        return round_up(self.vocab_size, self.vocab_round)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Initialization from specs
# ---------------------------------------------------------------------------


def init_leaf(spec: ParamSpec, generator: torch.Generator, device) -> torch.Tensor:
    """One parameter drawn for its tag: ``zeros``/``ones``; ``embed``
    N(0, 0.02²); ``normal`` N(0, 1/fan_in) with fan_in the product of all
    but the last axis (the first axis of a vector); ``scaled`` half that
    standard deviation (residual-out projections)."""
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    draw = torch.randn(spec.shape, generator=generator, device=device, dtype=torch.float32)
    if spec.init == "embed":
        return (draw * 0.02).to(spec.dtype)
    fan_in = math.prod(spec.shape[:-1]) if len(spec.shape) >= 2 else spec.shape[0]
    scale = 1.0 / max(fan_in, 1) ** 0.5
    if spec.init == "scaled":
        scale = scale * 0.5
    return (draw * scale).to(spec.dtype)


def map_leaves(fn, tree) -> Any:
    """Apply ``fn`` to every leaf (anything but a dict) of a nested dict."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_tree(specs, generator: torch.Generator, device) -> Any:
    """Draw a nested dict of specs into a nested dict of tensors."""
    return map_leaves(lambda spec: init_leaf(spec, generator, device), specs)


def stack_specs(spec: ParamSpec, n: int, axis_name: str | None = "layers") -> ParamSpec:
    """Prepend a stacking dimension (the stacked-over-layers layout)."""
    return ParamSpec(
        shape=(n,) + spec.shape, dtype=spec.dtype, axes=(axis_name,) + spec.axes, init=spec.init
    )
