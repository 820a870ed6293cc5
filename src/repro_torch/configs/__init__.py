"""Architecture registry of the archs the port serves.

``get_config("<arch-id>")`` / ``get_smoke_config`` as in the JAX package;
only full-attention decoder stacks whose layers the port has are listed
(the dense ``attn_mlp`` archs of the JAX package's registry, in its order).
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ModelConfig  # noqa: F401

ARCHS: List[str] = ["yi-6b", "qwen1.5-4b", "qwen2.5-3b", "granite-3-2b"]


def _module_name(arch: str) -> str:
    return "repro_torch.configs." + arch.replace("-", "_").replace(".", "_")


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; the port serves {ARCHS}")
    return importlib.import_module(_module_name(arch))


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config for CPU tests."""
    return _module(arch).SMOKE
