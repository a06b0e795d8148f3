"""Architecture registry: one module per ported architecture.

Only the architectures whose family the port carries are listed; the JAX
package's registry holds the rest.
"""

from __future__ import annotations

import importlib

from ..models.base import ModelConfig

ARCH_MODULES = {
    "internlm2-1.8b": "internlm2_1_8b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
}

ARCH_NAMES = tuple(ARCH_MODULES)


def _module(name: str):
    if name not in ARCH_MODULES:
        raise KeyError(f"unknown or unported arch {name!r}; the port carries {ARCH_NAMES}")
    return importlib.import_module(f".{ARCH_MODULES[name]}", __package__)


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE


__all__ = ["ARCH_NAMES", "get_config", "get_smoke_config"]
