"""JAX parameter tree -> the port's state dict.

``from_jax_params`` takes the reference model's ``init`` pytree with every
leaf already a numpy array (bf16 leaves included: they are widened to f32,
numpy having no bf16 of its own) and returns the names
``Model.load_state_dict`` expects.  The reference stacks layer parameters
per period position over a leading ``repeats`` axis
(``params["layers"]["pos{i}"]``); layer i is position ``i % period``,
repeat ``i // period``.  Weights keep the (in, out) orientation both sides
use as ``h @ w``.  An MoE layer's ``ffn`` holds the router, the 3-D
expert tensors and, with shared experts, the nested ``shared`` MLP dict,
which becomes ``layers.{i}.ffn.shared.{name}``.  An RWKV-6 layer has a
``mixer`` only (its channel mix is its FFN).  A tied head has no
``lm_head``: the port reads ``embed.T`` as the reference does.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core.modelspec import ModelSpec
from .transformer import layer_classes, stack_period


def _f32(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _flatten(tree: dict, prefix: str, r: int,
             state: dict[str, torch.Tensor]) -> None:
    """Repeat ``r`` of every leaf of a stacked subtree, dot-named."""
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            _flatten(leaf, f"{prefix}.{name}", r, state)
        else:
            state[f"{prefix}.{name}"] = _f32(leaf[r])


def from_jax_params(params_np: dict, spec: ModelSpec
                    ) -> dict[str, torch.Tensor]:
    """numpy JAX param tree -> {name: f32 CPU tensor} for
    ``Model.load_state_dict``."""
    period, _ = stack_period(spec)
    classes = layer_classes(spec)
    state: dict[str, torch.Tensor] = {"embed": _f32(params_np["embed"])}
    for i in range(spec.n_layers):
        if classes[i].kind == "mamba":
            raise NotImplementedError(
                f"layer {i} of {spec.name!r} is {classes[i].key}: mamba "
                "layers are not ported yet (ROADMAP: queue 1, item 13)")
        stacked = params_np["layers"][f"pos{i % period}"]
        for block in ("mixer", "ffn"):
            _flatten(stacked.get(block, {}), f"layers.{i}.{block}",
                     i // period, state)
    state["final_norm"] = _f32(params_np["final_norm"])
    if not spec.tied_embeddings:
        state["lm_head"] = _f32(params_np["lm_head"])
    return state
