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

``from_jax_opt_state`` converts the reference's AdamW state (m and v
mirror the parameter tree) to the port's optimizer state the same way.

``shard_state`` cuts such a state (or any full model's ``state_dict()``)
to one rank's part, the names its model (``Model(spec, ..., shard=)`` or
``build_model(spec, mesh=, policy=)``) expects: its pipeline stage's
layers, renumbered from 0, and each tensor cut as that model's
``param_placements`` say.  The reference's ``init`` on a mesh pads the
experts to a multiple of the ``model`` axis (``e_pad`` rows of ``w_up``,
``w_gate`` and ``w_down``); such a tree converts as it is, and a rank
takes its ``e_pad / model`` rows.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core.modelspec import ModelSpec
from .common import Shard
from .model import Model
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


def from_jax_opt_state(state_np: dict, spec: ModelSpec) -> dict:
    """The reference's AdamW state (``{"m": tree, "v": tree, "step"}``,
    every leaf a numpy array; m and v shaped as the parameters) -> the
    port's optimizer state, ``{"m": {name: f32}, "v": {name: f32},
    "step": int}`` under the names of :func:`from_jax_params`."""
    return {"m": from_jax_params(state_np["m"], spec),
            "v": from_jax_params(state_np["v"], spec),
            "step": int(state_np["step"])}


def shard_state(state: dict[str, torch.Tensor], spec: ModelSpec,
                shard, policy=None) -> dict[str, torch.Tensor]:
    """The part of the full ``state`` of ``spec`` that one rank holds, by
    the names its model has: ``shard`` a :class:`~.common.Shard`, or a
    ``DeviceMesh`` with ``policy`` (as ``build_model`` takes them).  The
    layers of the rank's pipeline stage (renumbered from 0), and each
    tensor cut as the rank's ``Model.param_placements`` says: a
    column-parallel leaf's columns and a row-parallel leaf's rows of its
    slice (heads are contiguous d_head blocks, so a slice is whole heads),
    an untied head's vocab slice, its experts' rows; the embedding and
    the norms whole."""
    kw = (dict(shard=shard) if isinstance(shard, Shard)
          else dict(mesh=shard, policy=policy))
    model = Model(spec, torch.device("meta"), torch.float32, **kw)
    first = (model.shard or Shard()).stage_layers(spec.n_layers).start
    out: dict[str, torch.Tensor] = {}
    for name, place in model.param_placements().items():
        src = name
        if name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            src = f"layers.{first + int(i)}.{rest}"
        out[name] = place.local(state[src]).contiguous()
    return out
