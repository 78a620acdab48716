"""Dense feed-forward blocks: SwiGLU (LLaMA), GELU (GPT), squared-ReLU
(Nemotron/Minitron) — the port of ``repro.models.mlp``."""

from __future__ import annotations

import torch
from torch import nn

from ..core.modelspec import ModelSpec
from .common import activation, dense_init_, rms_norm, weight


class MLP(nn.Module):
    def __init__(self, spec: ModelSpec, device, dtype):
        super().__init__()
        d, ff = spec.d_model, spec.d_ff
        self.norm = weight((d,), device, dtype, fill=1.0)
        self.w_up = weight((d, ff), device, dtype)
        self.w_down = weight((ff, d), device, dtype)
        if spec.act == "swiglu":
            self.w_gate = weight((d, ff), device, dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        dense_init_(self.w_up, generator)
        dense_init_(self.w_down, generator)
        if hasattr(self, "w_gate"):
            dense_init_(self.w_gate, generator)


def mlp_block(spec: ModelSpec, params: MLP, x: torch.Tensor, *,
              norm: bool = True, tp=None) -> torch.Tensor:
    """``norm=False`` takes x as already normalised (the MoE block's shared
    experts see the block's normed input).  ``tp``: a tensor-parallel
    shard's communicator; the parameters are this rank's FFN columns, the
    normed input enters the column-parallel products through
    ``tp.enter`` (Megatron's f) and the row-parallel ``w_down``'s partial
    products are summed over the tp ranks by ``tp.exit`` (g, the
    reference's ``psum``)."""
    act = activation(spec.act)
    h = rms_norm(x, params.norm) if norm else x
    if tp is not None:
        h = tp.enter(h)
    up = h @ params.w_up
    if spec.act == "swiglu":
        up = act(h @ params.w_gate) * up
    else:
        up = act(up)
    out = up @ params.w_down
    if tp is not None:
        out = tp.exit(out)
    return out
