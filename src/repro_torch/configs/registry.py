"""Architecture registry: ``--arch <id>`` -> ModelSpec (+ reduced config).

Only the architectures the port serves so far; the rest of the JAX
registry waits for the modules they need (Mamba, encoders, frontends).
mistral-7b-swa's sliding window is served by the dense two-dispatch engine
only; rwkv6-3b, attention-free, by the two-dispatch engine in either
layout (the unified step refuses state-carrying layers, as the
reference's does).
"""

from __future__ import annotations

import importlib

from ..core.modelspec import ModelSpec

_ARCH_MODULES: dict[str, str] = {
    "minitron-8b": ".minitron_8b",
    "mistral-7b-swa": ".mistral_7b_swa",
    "qwen1.5-0.5b": ".qwen15_05b",
    "deepseek-moe-16b": ".deepseek_moe_16b",
    "granite-moe-3b-a800m": ".granite_moe_3b",
    "rwkv6-3b": ".rwkv6_3b",
}

ARCH_IDS: tuple[str, ...] = tuple(_ARCH_MODULES)


def _module(arch_id: str):
    try:
        rel = _ARCH_MODULES[arch_id]
    except KeyError:
        raise ValueError(f"unknown arch {arch_id!r}; the port serves "
                         f"{sorted(_ARCH_MODULES)}") from None
    return importlib.import_module(rel, package=__package__)


def get_spec(arch_id: str) -> ModelSpec:
    """Full published config."""
    return _module(arch_id).SPEC


def get_reduced(arch_id: str) -> ModelSpec:
    """Reduced same-family config for CPU tests."""
    return _module(arch_id).REDUCED
