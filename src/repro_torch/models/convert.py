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
``mixer`` only (its channel mix is its FFN); a Mamba layer's ``mixer``
holds the reference's Mamba leaves (``a_log`` and ``d_skip`` float32 on
both sides) beside its ``ffn``.  A tied head has no ``lm_head``: the port
reads ``embed.T`` as the reference does; an encoder-only frontend model
(hubert) has no ``embed`` at all.

``shard_state`` cuts such a state (or any full model's ``state_dict()``)
to one rank's part of a (pp, tp) mesh, the names a
``Model(spec, ..., shard=shard)`` expects: its stage's layers, renumbered
from 0, and the tp slice of every leaf :data:`~.common.TP_SHARD_DIM`
names.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core.modelspec import ModelSpec
from .common import TP_SHARD_DIM, Shard
from .transformer import stack_period


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
    state: dict[str, torch.Tensor] = {}
    if "embed" in params_np:
        state["embed"] = _f32(params_np["embed"])
    for i in range(spec.n_layers):
        stacked = params_np["layers"][f"pos{i % period}"]
        for block in ("mixer", "ffn"):
            _flatten(stacked.get(block, {}), f"layers.{i}.{block}",
                     i // period, state)
    state["final_norm"] = _f32(params_np["final_norm"])
    if not spec.tied_embeddings:
        state["lm_head"] = _f32(params_np["lm_head"])
    return state


def shard_state(state: dict[str, torch.Tensor], spec: ModelSpec,
                shard: Shard) -> dict[str, torch.Tensor]:
    """The part of the full ``state`` of ``spec`` that rank ``shard`` holds:
    the layers of its pipeline stage (renumbered from 0), each
    column-parallel leaf's columns and each row-parallel leaf's rows of
    its tp slice (heads are contiguous d_head blocks, so a slice is whole
    heads), the untied head's vocab slice; the embedding and the norms
    whole."""
    stage = shard.stage_layers(spec.n_layers)
    out: dict[str, torch.Tensor] = {}
    for name, t in state.items():
        if name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            if int(i) not in stage:
                continue
            name = f"layers.{int(i) - stage.start}.{rest}"
        dim = TP_SHARD_DIM.get(name.rsplit(".", 1)[-1])
        if dim is not None and shard.tp > 1:
            size = t.shape[dim] // shard.tp
            t = t.narrow(dim, shard.tp_rank * size, size)
        out[name] = t.contiguous()
    return out
