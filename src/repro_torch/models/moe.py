"""Mixture-of-Experts block (the port of ``repro.models.moe``).

Fine-grained routed experts (DeepSeek-MoE: 64 experts top-6) with optional
always-on shared experts.  Router: f32 logits -> softmax -> top-k ->
renormalise.  Two implementations, as the reference's:

  dense    : every expert runs on every token through three
             :func:`repro_torch.kernels.ops.expert_gemm` calls (swiglu),
             and the expert outputs are combined with the routing weights
             in f32.  No token is dropped: the correctness oracle, taken
             without a mesh.  On a mesh whose ``model`` axis holds the
             experts, each rank runs its own experts and the combined
             outputs are summed over the axis.
  shardmap : expert parallelism over the ``model`` mesh axis (the
             reference's ``_moe_shardmap``): each (token, k) assignment
             takes a slot at its destination rank in arrival order, is
             exchanged with an all-to-all, is scattered into per-expert
             buffers (E_local, C_cap, D) that the expert GEMM kernels run
             on, and comes back through the reverse all-to-all to be
             combined in f32.  Fixed capacities (``c_send`` per link,
             ``c_cap`` per expert, from ``capacity_factor``) give static
             shapes; overflow assignments are dropped as GShard/Switch
             drop them.  ``moe_block(impl="auto")`` takes it when the
             experts are split over more than one rank.

The experts are padded to a multiple of the ``model`` axis (``e_pad``, the
reference's ``init_moe``); the router keeps ``num_experts`` columns, so a
padded expert never receives a token.  The shared experts run as a dense
MLP of width ``shared_experts * d_ff_expert`` on the block's normed input
(tensor-parallel over the axis when the model was built so).
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.modelspec import ModelSpec
from ..kernels import ops
from ..launch.mesh import (AxisComm, all_to_all, copy_in, gather_slices,
                           reduce_out)
from .common import activation, dense_init_, rms_norm, weight
from .mlp import MLP, mlp_block

#: the ``impl`` choices of :func:`moe_block`, as the reference's ``moe_impl``
MOE_IMPLS = ("auto", "dense", "shardmap")


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _shared_spec(spec: ModelSpec, tp: int = 1) -> ModelSpec:
    m = spec.moe
    return spec.scaled(d_ff=m.shared_experts * m.d_ff_expert // tp)


class MoE(nn.Module):
    """Parameters of one MoE block: ``norm`` (D,), ``router`` (D, E),
    ``w_up``/``w_gate`` (E_local, D, F), ``w_down`` (E_local, F, D) and,
    with shared experts, an :class:`MLP` named ``shared``.  ``n_shards``
    ranks split the experts, padded to ``e_pad`` (a multiple of
    ``n_shards``): a rank holds ``e_local = e_pad / n_shards`` of them.
    ``shared_tp`` ranks split the shared MLP's columns."""

    def __init__(self, spec: ModelSpec, device, dtype, n_shards: int = 1,
                 shared_tp: int = 1):
        super().__init__()
        m = spec.moe
        d, ff, e = spec.d_model, m.d_ff_expert, m.num_experts
        self.n_shards = n_shards
        self.e_pad = _round_up(e, max(n_shards, 1))
        e_local = self.e_pad // n_shards
        self.shared_tp = shared_tp
        self.norm = weight((d,), device, dtype, fill=1.0)
        self.router = weight((d, e), device, dtype)
        self.w_up = weight((e_local, d, ff), device, dtype)
        self.w_down = weight((e_local, ff, d), device, dtype)
        if spec.act == "swiglu":
            self.w_gate = weight((e_local, d, ff), device, dtype)
        self.shared = (MLP(_shared_spec(spec, shared_tp), device, dtype)
                       if m.shared_experts else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        # the reference's init_moe: dense_init with in_axis=0 everywhere, so
        # the 3-D expert tensors take E (padded), not D, as their fan-in.
        # Kept as it is (ROADMAP: section 3), so random weights give
        # activations of the reference's scale.
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
    """Batched per-expert FFN: x (E, C, D), or one (C, D) matrix broadcast
    over the experts, -> (E, C, D).  Each product is rounded to x's dtype,
    and the activation runs in it, as in the reference."""
    act = activation(spec.act)
    up = ops.expert_gemm(x, params.w_up, impl=impl)
    if spec.act == "swiglu":
        up = act(ops.expert_gemm(x, params.w_gate, impl=impl)) * up
    else:
        up = act(up)
    return ops.expert_gemm(up, params.w_down, impl=impl)


def _moe_dense(spec: ModelSpec, params: MoE, h: torch.Tensor,
               impl: str, mesh=None) -> torch.Tensor:
    """Every expert on every token, combined by the routing weights: no
    token is dropped.  h: (..., D) normed input.  With the experts split
    over a mesh's ``model`` axis, each rank runs its own experts on its
    columns of the combine weights and the sums are added over the axis."""
    split = params.n_shards > 1
    if split:
        h = copy_in(h, mesh, "model")
    d = h.shape[-1]
    hf = h.reshape(-1, d)
    n = hf.shape[0]
    router = copy_in(params.router, mesh, "model") if split \
        else params.router
    weights, ids = _route(spec, hf, router)
    e_local = params.w_up.shape[0]
    comb = torch.zeros((n, params.e_pad), dtype=torch.float32,
                       device=h.device)
    comb.scatter_add_(1, ids, weights)  # (N, E) combine weights
    if split:
        start = mesh.index("model") * e_local
        comb = comb[:, start:start + e_local]
    # the (N, D) tokens broadcast over the experts: read through an
    # expert stride of 0, no copy (and no (E, N, D) gradient)
    outs = _expert_ffn(spec, params, hf, impl)
    y = torch.einsum("end,ne->nd", outs.float(), comb)
    if split:
        y = reduce_out(y, mesh, "model")
    return y.reshape(h.shape).to(h.dtype)


def _sorted_positions(dest: torch.Tensor, n_bins: int) -> torch.Tensor:
    """For each element, its arrival rank within its destination bin."""
    onehot = torch.nn.functional.one_hot(dest.long(), n_bins)  # (N, M)
    pos = onehot.cumsum(0) - 1  # rank within bin
    return pos.gather(1, dest.long()[:, None])[:, 0]


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the cotangent times ``s`` backward."""

    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def moe_capacities(spec: ModelSpec, n_loc: int, m_sz: int, e_local: int,
                   capacity_factor: float, partition_tokens: bool
                   ) -> tuple[bool, int, int]:
    """(partition, c_send, c_cap) of the reference's ``_moe_shardmap`` for
    ``n_loc`` local tokens over ``m_sz`` ranks: the tokens are split over
    the ranks before routing when they divide, leave 8 or more a rank and
    ``partition_tokens`` asks; each link carries ``c_send`` assignments and
    each expert ``c_cap`` tokens, both rounded up to 8."""
    partition = (n_loc % m_sz == 0) and (n_loc // m_sz >= 8) \
        and partition_tokens
    n_route = n_loc // m_sz if partition else n_loc
    c_send = _round_up(max(int(n_route * spec.moe.top_k * capacity_factor
                               / m_sz), 1), 8)
    c_cap = _round_up(max(int(m_sz * c_send / e_local), 1), 8)
    return partition, c_send, c_cap


def _moe_shardmap(spec: ModelSpec, params: MoE, h: torch.Tensor,
                  impl: str, mesh, capacity_factor: float,
                  partition_tokens: bool, dispatch_log: list | None = None
                  ) -> torch.Tensor:
    """The reference's ``_moe_shardmap`` and its body on this rank.
    h: (..., D) local normed tokens, the same on every rank of the
    ``model`` axis (the data axes hold other tokens).

    The gradient is the reference's: the cotangents of the replicated
    inputs (h, the router) are summed over the axis (Megatron's f), and
    without ``partition`` the output's cotangent is divided by the axis
    size first (shard_map's transpose of an output it takes as
    replicated), so that an expert's gradient, which every rank's copy of
    a token reaches, counts each token once.  With ``partition`` each rank
    routes its own 1/m_sz of the tokens and the gathered output's
    cotangent is taken as it is, this rank's rows.

    ``dispatch_log`` (a list, or None) receives the call's geometry and
    drops on this rank: partition, c_send, c_cap, assignments routed, and
    the assignments dropped at the send and at the expert buffers (device
    scalars: reading them waits for the card)."""
    m_sz = params.n_shards
    e_local = params.w_up.shape[0]
    k = spec.moe.top_k
    d = h.shape[-1]
    hf_full = copy_in(h, mesh, "model").reshape(-1, d)
    n_loc = hf_full.shape[0]
    partition, c_send, c_cap = moe_capacities(
        spec, n_loc, m_sz, e_local, capacity_factor, partition_tokens)
    dev = h.device
    if partition:
        n = n_loc // m_sz
        hf = hf_full.narrow(0, mesh.index("model") * n, n)
    else:
        n = n_loc
        hf = hf_full
    weights, ids = _route(spec, hf, copy_in(params.router, mesh, "model"))

    flat_ids = ids.reshape(-1)  # (N*K,) global expert id
    flat_w = weights.reshape(-1)  # f32
    src = torch.arange(n, device=dev).repeat_interleave(k)
    dest = flat_ids // e_local  # destination rank
    pos = _sorted_positions(dest, m_sz)
    keep = pos < c_send
    # --- dispatch: (M, C_send, ...) send buffers (kept slots are unique)
    at = (dest * c_send + pos)[keep]
    send_tok = hf.new_zeros((m_sz * c_send, d)).index_put(
        (at,), hf[src[keep]])
    send_eid = torch.full((m_sz * c_send,), e_local, dtype=torch.int32,
                          device=dev)
    send_eid[at] = (flat_ids[keep] % e_local).to(torch.int32)
    send_slot = torch.full((m_sz * c_send,), -1, dtype=torch.long,
                           device=dev)
    send_slot[at] = torch.arange(n * k, device=dev)[keep]

    r_tok = all_to_all(send_tok, mesh, "model")  # (M*C_send, D) by source
    r_eid = mesh.all_to_all_single(send_eid, "model", tag="all_to_all_ids")

    # --- local per-expert buffers; row e_local is the invalid sentinel
    epos = _sorted_positions(r_eid, e_local + 1)  # +1: invalid bin
    ekeep = (r_eid < e_local) & (epos < c_cap)
    flat = torch.where(ekeep, r_eid.long() * c_cap + epos, e_local * c_cap)
    ebuf = r_tok.new_zeros(((e_local + 1) * c_cap, d)).index_add(
        0, flat, torch.where(ekeep[:, None], r_tok, 0))
    eout = _expert_ffn(spec, params, ebuf[:e_local * c_cap].view(
        e_local, c_cap, d), impl)  # (E_loc, C_cap, D)
    eout = torch.cat([eout.reshape(e_local * c_cap, d),
                      eout.new_zeros((c_cap, d))])
    back = torch.where(ekeep[:, None], eout.index_select(0, flat), 0)

    # --- combine: reverse exchange, then the f32 weighted sum of each
    # token's K slots (kept slots are unique; dropped ones add 0)
    ret = all_to_all(back, mesh, "model").float()
    valid = send_slot >= 0
    slot = send_slot[valid]
    y = ret.new_zeros((n * k, d)).index_put(
        (slot,), ret[valid] * flat_w[slot][:, None])
    y = y.view(n, k, d).sum(1)
    if dispatch_log is not None:
        dispatch_log.append(dict(
            partition=partition, c_send=c_send, c_cap=c_cap,
            assignments=n * k, dropped_send=(~keep).sum(),
            dropped_expert=((r_eid < e_local) & ~ekeep).sum()))
    if partition:
        y = gather_slices(y, mesh, "model")  # (n_loc, d)
    else:
        y = _ScaleGrad.apply(y, 1.0 / m_sz)
    return y.reshape(h.shape).to(h.dtype)


def moe_block(spec: ModelSpec, params: MoE, x: torch.Tensor, *,
              impl: str = "kernel", mesh=None, moe_impl: str = "auto",
              capacity_factor: float = 1.25,
              partition_tokens: bool = False,
              dispatch_log: list | None = None) -> torch.Tensor:
    """x: (..., D) -> the block's residual update (..., D).  ``impl``
    routes the expert GEMMs (``kernels.ops.IMPLS``).  ``moe_impl`` (the
    reference's ``ModelContext.moe_impl``): ``"auto"`` takes ``shardmap``
    when the experts are split over more than one rank of ``mesh``'s
    ``model`` axis, else ``dense``; ``capacity_factor`` and
    ``partition_tokens`` are the reference's ``moe_capacity_factor`` and
    ``moe_partition_tokens``; an expert-parallel call appends its geometry
    and drops to ``dispatch_log`` (a list) when one is given."""
    if moe_impl not in MOE_IMPLS:
        raise ValueError(f"unknown moe impl {moe_impl!r}; have {MOE_IMPLS}")
    h = rms_norm(x, params.norm)
    choice = moe_impl
    if choice == "auto":
        choice = "shardmap" if params.n_shards > 1 else "dense"
    if choice == "shardmap":
        if params.n_shards == 1:
            raise ValueError("moe impl 'shardmap' needs experts split over "
                             "a mesh's model axis (build_model(mesh=))")
        y = _moe_shardmap(spec, params, h, impl, mesh, capacity_factor,
                          partition_tokens, dispatch_log)
    else:
        y = _moe_dense(spec, params, h, impl, mesh)
    if params.shared is not None:
        tp = AxisComm(mesh, "model") if params.shared_tp > 1 else None
        y = y + mlp_block(_shared_spec(spec, params.shared_tp),
                          params.shared, h, norm=False, tp=tp)
    return y
