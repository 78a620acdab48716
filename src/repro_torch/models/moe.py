"""Mixture-of-Experts block, dense path (the port of ``repro.models.moe``'s
single-device implementation).

Fine-grained routed experts (DeepSeek-MoE: 64 experts top-6) with optional
always-on shared experts.  Router: f32 logits -> softmax -> top-k ->
renormalise.  ``_moe_dense`` is the reference's no-drop path, the one it
takes without a mesh: every expert runs on every token through three
:func:`repro_torch.kernels.ops.expert_gemm` calls (swiglu), and the expert
outputs are combined with the routing weights in f32.  The shared experts
run as a dense MLP of width ``shared_experts * d_ff_expert`` on the block's
normed input.

The reference's expert-parallel ``_moe_shardmap`` (all-to-all dispatch
over a mesh) is not ported: the port has no mesh yet (ROADMAP: queue 1,
item 15).
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.modelspec import ModelSpec
from ..kernels import ops
from .common import activation, dense_init_, rms_norm, weight
from .mlp import MLP, mlp_block


def _shared_spec(spec: ModelSpec) -> ModelSpec:
    m = spec.moe
    return spec.scaled(d_ff=m.shared_experts * m.d_ff_expert)


class MoE(nn.Module):
    """Parameters of one MoE block: ``norm`` (D,), ``router`` (D, E),
    ``w_up``/``w_gate`` (E, D, F), ``w_down`` (E, F, D) and, with shared
    experts, an :class:`MLP` named ``shared``."""

    def __init__(self, spec: ModelSpec, device, dtype):
        super().__init__()
        m = spec.moe
        d, ff, e = spec.d_model, m.d_ff_expert, m.num_experts
        self.norm = weight((d,), device, dtype, fill=1.0)
        self.router = weight((d, e), device, dtype)
        self.w_up = weight((e, d, ff), device, dtype)
        self.w_down = weight((e, ff, d), device, dtype)
        if spec.act == "swiglu":
            self.w_gate = weight((e, d, ff), device, dtype)
        self.shared = (MLP(_shared_spec(spec), device, dtype)
                       if m.shared_experts else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        # the reference's init_moe: dense_init with in_axis=0 everywhere, so
        # the 3-D expert tensors take E, not D, as their fan-in.  Kept as it
        # is (ROADMAP: section 3), so random weights give activations of the
        # reference's scale.
        dense_init_(self.router, generator)
        dense_init_(self.w_up, generator)
        dense_init_(self.w_down, generator)
        if hasattr(self, "w_gate"):
            dense_init_(self.w_gate, generator)
        if self.shared is not None:
            self.shared.reset_parameters(generator)


def _route(spec: ModelSpec, h: torch.Tensor, router_w: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """h: (N, D) -> (weights (N, K) f32, ids (N, K)):
    softmax -> top-k -> renormalise."""
    logits = h.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    weights, ids = torch.topk(probs, spec.moe.top_k, dim=-1)
    return weights / weights.sum(-1, keepdim=True).clamp_min(1e-9), ids


def _expert_ffn(spec: ModelSpec, params: MoE, x: torch.Tensor,
                impl: str) -> torch.Tensor:
    """Batched per-expert FFN: x, one (C, D) matrix broadcast over the
    experts, -> (E, C, D).  Each product is rounded to x's dtype, and the
    activation runs in it, as in the reference."""
    act = activation(spec.act)
    up = ops.expert_gemm(x, params.w_up, impl=impl)
    if spec.act == "swiglu":
        up = act(ops.expert_gemm(x, params.w_gate, impl=impl)) * up
    else:
        up = act(up)
    return ops.expert_gemm(up, params.w_down, impl=impl)


def _moe_dense(spec: ModelSpec, params: MoE, h: torch.Tensor,
               impl: str) -> torch.Tensor:
    """Every expert on every token, combined by the routing weights: no
    token is dropped.  h: (..., D) normed input."""
    d = h.shape[-1]
    hf = h.reshape(-1, d)
    n = hf.shape[0]
    weights, ids = _route(spec, hf, params.router)
    e = params.w_up.shape[0]
    comb = torch.zeros((n, e), dtype=torch.float32, device=h.device)
    comb.scatter_add_(1, ids, weights)  # (N, E) combine weights
    # the (N, D) tokens broadcast over the experts: read through an
    # expert stride of 0, no copy (and no (E, N, D) gradient)
    outs = _expert_ffn(spec, params, hf, impl)
    y = torch.einsum("end,ne->nd", outs.float(), comb)
    return y.reshape(h.shape).to(h.dtype)


def moe_block(spec: ModelSpec, params: MoE, x: torch.Tensor, *,
              impl: str = "kernel") -> torch.Tensor:
    """x: (..., D) -> the block's residual update (..., D).  ``impl``
    routes the expert GEMMs (``kernels.ops.IMPLS``)."""
    h = rms_norm(x, params.norm)
    y = _moe_dense(spec, params, h, impl)
    if params.shared is not None:
        y = y + mlp_block(_shared_spec(spec), params.shared, h, norm=False)
    return y
