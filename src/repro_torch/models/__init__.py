"""Model zoo of the port: family dispatch over the ported architectures.

The port carries the dense decoder family (``transformer``), enough to
serve qwen1.5 and internlm2; the other families of the JAX package raise
``NotImplementedError``.  A model is an ``nn.Module`` built from a
parameter tree in the reference's layout: :func:`init_params` draws one
from a seeded generator, ``repro_torch.convert.model_from_numpy`` carries
one over from numpy.
"""

from __future__ import annotations

import torch

from ..core.stratify import resolve_device
from . import base, layers, transformer
from .base import ModelConfig, ParamSpec, init_tree
from .transformer import DecodeState, DenseTransformer, init_decode_state


def param_specs(cfg: ModelConfig) -> dict:
    return transformer.param_specs(cfg)


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None) -> DenseTransformer:
    """A model with parameters drawn by their spec tags from ``generator``
    (which must live on ``device``; CUDA unless ``device="cpu"``)."""
    dev = resolve_device(device)
    return DenseTransformer(cfg, init_tree(param_specs(cfg), generator, dev))


def decode_step(model: DenseTransformer, state: DecodeState, tokens):
    return model.decode_step(state, tokens)


__all__ = [
    "DecodeState",
    "DenseTransformer",
    "ModelConfig",
    "ParamSpec",
    "base",
    "decode_step",
    "init_decode_state",
    "init_params",
    "init_tree",
    "layers",
    "param_specs",
    "transformer",
]
