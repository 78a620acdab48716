"""Model profiler (paper §III-A): ModelSpec x stage x parallelism x
optimizations -> per-NPU operator graph.

For every decoder layer we emit the operators of Fig. 3 (QKV projection,
logit = Q.K', softmax, attend = S.V, output projection, MLP / MoE / SSM
mixer) with shapes already divided by the parallelism degrees, plus the
collectives each parallelism strategy requires (paper §III-C):

  TP  : AllReduce after attention-out and after MLP-down (or RS+AG when
        ``opt.allreduce_decomposed``), AllGather for SP-sharded activations.
  EP  : All-to-All for token dispatch and combine, AllReduce shared with TP.
  PP  : Send-Recv per pipeline boundary.

The same functions serve prefill (q_len = kv_len = tau_p), decode
(q_len = 1, kv_len = context) and chunked iterations (mixed), so all stages
share one source of operator shapes — mirroring how GenZ "stores model
operators offline" and reuses them across stages and context lengths.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from .modelspec import ModelSpec
from .network import Collective
from .operators import (CollectiveCall, Operator, Optimizations, collective,
                        elementwise, gemm)
from .parallelism import ParallelismConfig


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _pad_div(n: int, parts: int) -> int:
    """Shard size under GSPMD-style padding: ceil(n / parts)."""
    return _ceil_div(n, parts)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def attention_ops(spec: ModelSpec, batch: float, q_len: float, kv_len: float,
                  par: ParallelismConfig, opt: Optimizations,
                  causal_square: bool) -> list[Operator]:
    """Operators of one multi-head attention block on one NPU.

    ``causal_square``: True for a causal self-attention pass where q_len ==
    kv_len (prefill/training); the average number of keys each query attends
    to is then (kv_len+1)/2, halving logit/attend FLOPs.
    """
    d = spec.d_model
    hq = _pad_div(spec.n_heads, par.tp)
    hkv = _pad_div(spec.n_kv_heads, min(par.tp, spec.n_kv_heads))
    if par.tp <= spec.n_kv_heads:
        hkv = _pad_div(spec.n_kv_heads, par.tp)
    else:
        hkv = 1  # replicated KV heads beyond the GQA group count
    dh = spec.d_head
    ab, kb = opt.abytes(), opt.kvbytes()
    toks = batch * q_len

    eff_kv = spec.attn.effective_kv_len(int(kv_len))
    if opt.kv_window is not None:
        eff_kv = min(eff_kv, opt.kv_window)
    eff_kv = eff_kv * (1.0 - opt.kv_prune)
    avg_kv = (eff_kv + 1) / 2.0 if (causal_square and spec.attn.causal) else eff_kv

    ops: list[Operator] = []
    ops.append(elementwise("attn.norm", toks * d, opt, flops_per_elem=5))
    ops.append(gemm("attn.qkv", toks, d, (hq + 2 * hkv) * dh, opt))
    if spec.pos == "rope":
        ops.append(elementwise("attn.rope", toks * (hq + hkv) * dh, opt,
                               flops_per_elem=3))

    # logit (Q.K') + softmax + attend (S.V).  With flash attention these are
    # fused: HBM traffic is Q + K + V + O only; otherwise the S matrix makes
    # a round trip.
    logit_flops = 2.0 * batch * hq * q_len * avg_kv * dh
    attend_flops = 2.0 * batch * hq * q_len * avg_kv * dh
    softmax_flops = 5.0 * batch * hq * q_len * avg_kv
    kv_read = batch * eff_kv * hkv * dh * 2 * kb  # K and V (cache or fresh)
    q_read = toks * hq * dh * ab
    o_write = toks * hq * dh * ab
    if opt.flash_attention:
        ops.append(Operator(
            name="attn.flash(logit+softmax+attend)", kind="attn",
            flops=logit_flops + softmax_flops + attend_flops,
            bytes_in=q_read + kv_read, bytes_out=o_write))
    else:
        s_bytes = batch * hq * q_len * avg_kv * ab
        ops.append(Operator(name="attn.logit", kind="attn", flops=logit_flops,
                            bytes_in=q_read + kv_read / 2, bytes_out=s_bytes))
        ops.append(Operator(name="attn.softmax", kind="attn",
                            flops=softmax_flops, bytes_in=s_bytes,
                            bytes_out=s_bytes))
        ops.append(Operator(name="attn.attend", kind="attn",
                            flops=attend_flops,
                            bytes_in=s_bytes + kv_read / 2, bytes_out=o_write))

    ops.append(gemm("attn.out", toks, hq * dh, d, opt))
    # KV-cache append for the new tokens.
    ops.append(Operator(name="attn.kv_append", kind="elementwise",
                        bytes_out=toks * hkv * dh * 2 * kb))

    if par.tp > 1:
        ar_bytes = toks * d * ab
        skip = par.inner_skip("tp")
        if opt.allreduce_decomposed:
            ops.append(collective("attn.rs", Collective.REDUCE_SCATTER,
                                  ar_bytes, par.tp, skip))
            ops.append(collective("attn.ag", Collective.ALL_GATHER,
                                  ar_bytes, par.tp, skip))
        else:
            ops.append(collective("attn.ar", Collective.ALL_REDUCE,
                                  ar_bytes, par.tp, skip))
    return ops


# ---------------------------------------------------------------------------
# Feed-forward: dense MLP and MoE
# ---------------------------------------------------------------------------

def mlp_ops(spec: ModelSpec, batch: float, q_len: float,
            par: ParallelismConfig, opt: Optimizations,
            d_ff: int | None = None, name: str = "mlp",
            tp_collective: bool = True) -> list[Operator]:
    d = spec.d_model
    ff = _pad_div(d_ff if d_ff is not None else spec.d_ff, par.tp)
    toks = batch * q_len
    ab = opt.abytes()
    ops = [elementwise(f"{name}.norm", toks * d, opt, flops_per_elem=5)]
    if spec.act == "swiglu":
        ops.append(gemm(f"{name}.gate", toks, d, ff, opt))
        ops.append(gemm(f"{name}.up", toks, d, ff, opt))
        ops.append(elementwise(f"{name}.act*up", toks * ff, opt,
                               flops_per_elem=5, reads=2))
    else:
        ops.append(gemm(f"{name}.up", toks, d, ff, opt))
        ops.append(elementwise(f"{name}.act", toks * ff, opt,
                               flops_per_elem=8))
    ops.append(gemm(f"{name}.down", toks, ff, d, opt))
    if tp_collective and par.tp > 1:
        ar_bytes = toks * d * ab
        skip = par.inner_skip("tp")
        if opt.allreduce_decomposed:
            ops.append(collective(f"{name}.rs", Collective.REDUCE_SCATTER,
                                  ar_bytes, par.tp, skip))
            ops.append(collective(f"{name}.ag", Collective.ALL_GATHER,
                                  ar_bytes, par.tp, skip))
        else:
            ops.append(collective(f"{name}.ar", Collective.ALL_REDUCE,
                                  ar_bytes, par.tp, skip))
    return ops


def moe_ops(spec: ModelSpec, batch: float, q_len: float,
            par: ParallelismConfig, opt: Optimizations) -> list[Operator]:
    """MoE block: router -> (A2A dispatch) -> expert FFNs -> (A2A combine).

    Token placement follows the paper's balanced assumption (§IV-C), with
    ``opt.moe_load_balance`` interpolating to the pathological all-to-one
    case: the busiest NPU processes ``hot`` tokens.
    """
    m = spec.moe
    assert m is not None
    d = spec.d_model
    toks = batch * q_len
    ab = opt.abytes()
    ops: list[Operator] = []
    ops.append(elementwise("moe.norm", toks * d, opt, flops_per_elem=5))
    ops.append(gemm("moe.router", toks, d, m.num_experts, opt))
    ops.append(elementwise("moe.topk", toks * m.num_experts, opt,
                           flops_per_elem=3))

    routed_tok = toks * m.top_k
    experts_here = _pad_div(m.num_experts, par.ep)
    balanced = routed_tok / par.ep
    worst = routed_tok * min(1.0, experts_here / max(m.top_k, 1))
    hot_tokens = balanced * opt.moe_load_balance + worst * (1 - opt.moe_load_balance)

    if par.ep > 1:
        a2a = routed_tok * d * ab / par.ep
        skip = par.inner_skip("ep")
        ops.append(collective("moe.dispatch(a2a)", Collective.ALL_TO_ALL,
                              a2a, par.ep, skip))

    ff = _pad_div(m.d_ff_expert, par.tp)
    # Routed experts: hot_tokens spread over the experts resident here.  The
    # GEMMs are effectively batched per expert; weights for *all* resident
    # experts are streamed (this is what makes decode MoE bandwidth-hungry).
    n_mats = 3 if spec.act == "swiglu" else 2
    expert_w = experts_here * n_mats * d * ff * opt.wbytes()
    expert_flops = 2.0 * hot_tokens * d * ff * n_mats
    act_bytes = hot_tokens * (d + ff) * ab * n_mats
    ops.append(Operator(name="moe.experts", kind="gemm", flops=expert_flops,
                        bytes_in=act_bytes / 2, bytes_out=act_bytes / 2,
                        bytes_weight=expert_w))
    if spec.act == "swiglu":
        ops.append(elementwise("moe.act*up", hot_tokens * ff, opt,
                               flops_per_elem=5, reads=2))

    for s in range(m.shared_experts):
        ops.extend(mlp_ops(spec, batch, q_len, par, opt, d_ff=m.d_ff_expert,
                           name=f"moe.shared{s}", tp_collective=False))

    if par.ep > 1:
        a2a = routed_tok * d * ab / par.ep
        skip = par.inner_skip("ep")
        ops.append(collective("moe.combine(a2a)", Collective.ALL_TO_ALL,
                              a2a, par.ep, skip))
    ops.append(elementwise("moe.weighted_sum", toks * d * m.top_k, opt,
                           flops_per_elem=2))
    if par.tp > 1:
        ops.append(collective("moe.ar", Collective.ALL_REDUCE, toks * d * ab,
                              par.tp, par.inner_skip("tp")))
    return ops


# ---------------------------------------------------------------------------
# State-space mixers (Mamba / RWKV6)
# ---------------------------------------------------------------------------

def mamba_ops(spec: ModelSpec, batch: float, q_len: float,
              par: ParallelismConfig, opt: Optimizations) -> list[Operator]:
    s = spec.ssm
    assert s is not None and s.kind == "mamba"
    d = spec.d_model
    di = _pad_div(s.d_inner(d), par.tp)
    n = s.d_state
    toks = batch * q_len
    ab = opt.abytes()
    dt_rank = max(s.d_inner(d) // 16, 1)
    ops = [
        elementwise("ssm.norm", toks * d, opt, flops_per_elem=5),
        gemm("ssm.in_proj", toks, d, 2 * di, opt),
        Operator(name="ssm.conv1d", kind="elementwise",
                 flops=2.0 * toks * di * s.d_conv,
                 bytes_in=toks * di * ab, bytes_out=toks * di * ab,
                 bytes_weight=di * s.d_conv * opt.wbytes()),
        gemm("ssm.x_proj", toks, di, dt_rank + 2 * n, opt),
        gemm("ssm.dt_proj", toks, dt_rank, di, opt),
        # selective scan: per token/channel ~6N flops (discretize dA, dB,
        # state update, C readout); state (di x n) is re-read per token in
        # the recurrent (decode) form, once per chunk in the scan form.
        Operator(name="ssm.scan", kind="scan",
                 flops=6.0 * toks * di * n,
                 bytes_in=toks * di * (2 + (n if q_len == 1 else 0)) * ab,
                 bytes_out=toks * di * ab
                 + (batch * di * n * ab if q_len == 1 else 0)),
        elementwise("ssm.gate", toks * di, opt, flops_per_elem=4, reads=2),
        gemm("ssm.out_proj", toks, di, d, opt),
    ]
    if par.tp > 1:
        ops.append(collective("ssm.ar", Collective.ALL_REDUCE, toks * d * ab,
                              par.tp, par.inner_skip("tp")))
    return ops


def rwkv6_ops(spec: ModelSpec, batch: float, q_len: float,
              par: ParallelismConfig, opt: Optimizations) -> list[Operator]:
    s = spec.ssm
    assert s is not None and s.kind == "rwkv6"
    d = spec.d_model
    dtp = _pad_div(d, par.tp)
    nh = _pad_div(d // s.head_size, par.tp)
    hs = s.head_size
    toks = batch * q_len
    ab = opt.abytes()
    ops = [
        elementwise("rwkv.tm.norm+shift", toks * d, opt, flops_per_elem=6,
                    reads=2),
        gemm("rwkv.tm.r", toks, d, dtp, opt),
        gemm("rwkv.tm.k", toks, d, dtp, opt),
        gemm("rwkv.tm.v", toks, d, dtp, opt),
        gemm("rwkv.tm.g", toks, d, dtp, opt),
        gemm("rwkv.tm.w_lora", toks, d, 64, opt),
        gemm("rwkv.tm.w_lora2", toks, 64, dtp, opt),
        # wkv state update: per token/head: decay (N^2), outer-product add
        # (N^2), readout (2 N^2) -> ~4 N^2 flops; state is nh x N x N.
        Operator(name="rwkv.tm.wkv", kind="scan",
                 flops=4.0 * toks * nh * hs * hs,
                 bytes_in=toks * 4 * nh * hs * ab
                 + (batch * nh * hs * hs * ab if q_len == 1 else 0),
                 bytes_out=toks * nh * hs * ab
                 + (batch * nh * hs * hs * ab if q_len == 1 else 0)),
        gemm("rwkv.tm.out", toks, dtp, d, opt),
        elementwise("rwkv.cm.norm+shift", toks * d, opt, flops_per_elem=6,
                    reads=2),
        gemm("rwkv.cm.key", toks, d, _pad_div(spec.d_ff, par.tp), opt),
        elementwise("rwkv.cm.relu^2", toks * _pad_div(spec.d_ff, par.tp), opt,
                    flops_per_elem=2),
        gemm("rwkv.cm.value", toks, _pad_div(spec.d_ff, par.tp), d, opt),
    ]
    if par.tp > 1:
        ab_bytes = toks * d * ab
        ops.append(collective("rwkv.ar.tm", Collective.ALL_REDUCE, ab_bytes,
                              par.tp, par.inner_skip("tp")))
        ops.append(collective("rwkv.ar.cm", Collective.ALL_REDUCE, ab_bytes,
                              par.tp, par.inner_skip("tp")))
    return ops


# ---------------------------------------------------------------------------
# Whole-model graphs
# ---------------------------------------------------------------------------

def layer_ops(spec: ModelSpec, layer_idx: int, batch: float, q_len: float,
              kv_len: float, par: ParallelismConfig, opt: Optimizations,
              causal_square: bool) -> list[Operator]:
    kind = spec.layer_kinds()[layer_idx]
    ops: list[Operator] = []
    if kind == "attn":
        ops.extend(attention_ops(spec, batch, q_len, kv_len, par, opt,
                                 causal_square))
    else:
        if spec.ssm and spec.ssm.kind == "rwkv6":
            return rwkv6_ops(spec, batch, q_len, par, opt)
        ops.extend(mamba_ops(spec, batch, q_len, par, opt))
    if spec.moe is not None and spec.moe.is_moe_layer(layer_idx):
        ops.extend(moe_ops(spec, batch, q_len, par, opt))
    elif spec.d_ff > 0:
        ops.extend(mlp_ops(spec, batch, q_len, par, opt))
    return ops


def embedding_ops(spec: ModelSpec, batch: float, q_len: float,
                  opt: Optimizations) -> list[Operator]:
    toks = batch * q_len
    return [Operator(name="embed.lookup", kind="embed",
                     bytes_in=toks * 4,  # token ids
                     bytes_out=toks * spec.d_model * opt.abytes(),
                     bytes_weight=toks * spec.d_model * opt.wbytes())]


def head_ops(spec: ModelSpec, batch: float, q_len: float,
             par: ParallelismConfig, opt: Optimizations,
             head_q_len: float | None = None) -> list[Operator]:
    """LM-head projection.  During prefill only the *last* position's logits
    are needed (``head_q_len=1``); training scores every position."""
    if not spec.decoder and spec.vocab == 0:
        return []
    toks = batch * (head_q_len if head_q_len is not None else q_len)
    vocab = _pad_div(spec.vocab, par.tp)
    ops = [elementwise("head.norm", toks * spec.d_model, opt, flops_per_elem=5),
           gemm("head.proj", toks, spec.d_model, vocab, opt)]
    if par.tp > 1:
        ops.append(collective("head.ag", Collective.ALL_GATHER,
                              toks * spec.vocab * opt.abytes(), par.tp,
                              par.inner_skip("tp")))
    return ops


@dataclass(frozen=True)
class PassSpec:
    """One forward pass: which tokens are processed and which KV is read."""
    batch: float
    q_len: float
    kv_len: float
    causal_square: bool  # prefill-style causal triangle


def model_ops(spec: ModelSpec, fwd: PassSpec, par: ParallelismConfig,
              opt: Optimizations, include_embed_head: bool = True,
              layers_per_stage: int | None = None,
              head_q_len: float | None = None) -> list[Operator]:
    """Per-NPU operator list for one forward pass of one pipeline stage.

    Layers are profiled per *distinct* shape and replicated via
    ``Operator.count`` (the paper's operator-reuse runtime optimization).
    """
    n_layers = layers_per_stage or _ceil_div(spec.n_layers, par.pp)
    ops: list[Operator] = []
    if include_embed_head:
        ops.extend(embedding_ops(spec, fwd.batch, fwd.q_len, opt))

    # Group identical layers (same kind, same MoE-ness) and emit one profile
    # with a count — operator reuse.
    groups: dict[tuple, int] = {}
    kinds = spec.layer_kinds()
    for i in range(n_layers):
        li = i % spec.n_layers
        key = (kinds[li],
               spec.moe is not None and spec.moe.is_moe_layer(li))
        groups[key] = groups.get(key, 0) + 1
    rep_idx: dict[tuple, int] = {}
    for i in range(spec.n_layers):
        key = (kinds[i], spec.moe is not None and spec.moe.is_moe_layer(i))
        rep_idx.setdefault(key, i)
    for key, cnt in groups.items():
        li = rep_idx[key]
        for op in layer_ops(spec, li, fwd.batch, fwd.q_len, fwd.kv_len, par,
                            opt, fwd.causal_square):
            ops.append(op.times(cnt))

    if par.pp > 1:
        act_bytes = fwd.batch * fwd.q_len * spec.d_model * opt.abytes()
        ops.append(collective("pp.send_recv", Collective.SEND_RECV, act_bytes,
                              2, par.inner_skip("pp")))
    if include_embed_head:
        ops.extend(head_ops(spec, fwd.batch, fwd.q_len, par, opt,
                            head_q_len=head_q_len))
    return ops


def pass_flops(ops: list[Operator]) -> float:
    return sum(o.flops * o.count for o in ops)


def pass_bytes(ops: list[Operator]) -> float:
    return sum(o.mem_bytes * o.count for o in ops)


def pass_weight_bytes(ops: list[Operator]) -> float:
    return sum(o.bytes_weight * o.count for o in ops)
