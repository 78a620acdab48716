"""Architecture registry: ``--arch <id>`` -> ModelSpec (+ reduced config).

The reference registry's eleven architectures, plus the paper's Table-IV
models (``PAPER_MODELS``) by name for the analytical side.  The port
builds all eleven.  The unified engine serves the attention stacks
(minitron-8b, qwen1.5-0.5b, deepseek-7b, yi-34b, pixtral-12b's backbone
on token prompts, deepseek-moe-16b, granite-moe-3b-a800m);
mistral-7b-swa's sliding window is served by the dense two-dispatch
engine only; jamba-v0.1-52b (Mamba, attention and MoE) and rwkv6-3b carry
per-slot state and serve through the two-dispatch engine in either layout
(the unified step refuses state-carrying layers, as the reference's
does); hubert-xlarge, an encoder with no token embedding, runs
``Model.forward(embeds=)`` only.
"""

from __future__ import annotations

import importlib

from ..core.modelspec import PAPER_MODELS, ModelSpec

_ARCH_MODULES: dict[str, str] = {
    "minitron-8b": ".minitron_8b",
    "mistral-7b-swa": ".mistral_7b_swa",
    "qwen1.5-0.5b": ".qwen15_05b",
    "deepseek-moe-16b": ".deepseek_moe_16b",
    "granite-moe-3b-a800m": ".granite_moe_3b",
    "rwkv6-3b": ".rwkv6_3b",
    "deepseek-7b": ".deepseek_7b",
    "yi-34b": ".yi_34b",
    "jamba-v0.1-52b": ".jamba_52b",
    "hubert-xlarge": ".hubert_xlarge",
    "pixtral-12b": ".pixtral_12b",
}

ARCH_IDS: tuple[str, ...] = tuple(_ARCH_MODULES)


def _module(arch_id: str):
    try:
        rel = _ARCH_MODULES[arch_id]
    except KeyError:
        raise ValueError(
            f"unknown arch {arch_id!r}; assigned archs: "
            f"{sorted(_ARCH_MODULES)}; paper models: "
            f"{sorted(PAPER_MODELS)}") from None
    return importlib.import_module(rel, package=__package__)


def get_spec(arch_id: str) -> ModelSpec:
    """Full published config (a paper Table-IV model by name too)."""
    if arch_id in PAPER_MODELS:
        return PAPER_MODELS[arch_id]
    return _module(arch_id).SPEC


def get_reduced(arch_id: str) -> ModelSpec:
    """Reduced same-family config for CPU tests."""
    return _module(arch_id).REDUCED
