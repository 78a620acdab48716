"""Sharding policies: named logical->mesh rule sets (a copy of
``repro.sharding.policy``; plain Python).

Baseline policies reproduce the paper's parallelism mapping (TP innermost on
the fast ICI axis, DP outside, EP sharing the model axis for MoE layers —
paper §III-C order TP:EP:PP).  The §Perf-optimized variants (e.g.
``inference_seqkv``) are alternative layouts discovered in the hillclimb and
are selectable per run.

Logical axes
------------
weights : vocab, embed, mlp, heads, kv_heads, head_dim, experts, expert_mlp,
          ssm_inner, ssm_state, ssm_heads, layers (scan stack; never sharded)
acts    : batch, seq, kv_seq, act_embed, act_mlp, act_heads, act_kv_heads,
          act_vocab, act_experts, act_ssm_inner
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Mapping


@dataclass(frozen=True)
class ShardingPolicy:
    name: str
    rules: Mapping[str, Any]
    #: gradient-checkpointing policy for the layer body (training)
    remat: str = "none"  # none | full | dots_saveable
    #: shard KV cache along sequence instead of kv-heads (flash-decode style)
    seq_shard_kv: bool = False
    description: str = ""

    def with_rules(self, **updates) -> "ShardingPolicy":
        merged = dict(self.rules)
        merged.update(updates)
        return replace(self, rules=merged)


_BASE_RULES: dict[str, Any] = {
    # weights
    "vocab": "model",
    "embed": None,
    "mlp": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "experts": "model",
    "expert_mlp": None,
    "ssm_inner": "model",
    "ssm_state": None,
    "ssm_heads": "model",
    "conv": None,
    "layers": None,
    "lora": None,
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "seq_res": None,  # residual-stream sequence (the layer-scan carry)
    "kv_seq": None,
    "act_embed": None,
    "act_mlp": "model",
    "act_heads": "model",
    "act_kv_heads": "model",
    "act_vocab": "model",
    "act_experts": "model",
    "act_ssm_inner": "model",
}


def inference_tp() -> ShardingPolicy:
    """Paper-faithful inference layout: Megatron TP on the model axis
    (heads / d_ff / vocab sharded), batch data-parallel, KV cache sharded on
    kv-heads (GSPMD pads when kv_heads < model-axis size)."""
    return ShardingPolicy(
        name="inference_tp", rules=dict(_BASE_RULES),
        description="TP on model axis; KV sharded on kv-heads (baseline)")


def inference_seqkv() -> ShardingPolicy:
    """§Perf variant: decode with the KV cache sharded along *sequence*
    (flash-decode style sequence parallelism).  Removes the kv-head padding
    waste when kv_heads < model-axis size; attention becomes a partial-
    softmax + AllReduce combine, which GSPMD derives automatically."""
    rules = dict(_BASE_RULES)
    rules.update({
        "kv_seq": "model",
        "act_kv_heads": None,
        "act_heads": None,  # queries replicated; each shard sees all heads
    })
    return ShardingPolicy(
        name="inference_seqkv", rules=rules, seq_shard_kv=True,
        description="decode KV sharded on sequence; partial-softmax combine")


def inference_2d() -> ShardingPolicy:
    """§Perf variant: inference with weights 2D-sharded (TP x FSDP) — the
    data axis holds weight shards that GSPMD all-gathers per layer.  Trades
    a small per-layer collective for 16x less resident weight memory; what
    lets yi-34b's 32k prefill fit a 16 GB chip."""
    rules = dict(_BASE_RULES)
    rules.update({"embed": "data"})
    return ShardingPolicy(
        name="inference_2d", rules=rules,
        description="TP(model) x FSDP(data) weights for inference")


def inference_prefill_opt() -> ShardingPolicy:
    """§Perf variant for long prefill: 2D weights + the KV cache *stored*
    sequence-sharded (always divisible, no GQA padding), while attention
    compute keeps q-head sharding — the cache is write-only during prefill
    so its storage layout is free to differ from the compute layout."""
    rules = dict(_BASE_RULES)
    rules.update({"embed": "data", "kv_seq": "model",
                  "act_kv_heads": None})
    return ShardingPolicy(
        name="inference_prefill_opt", rules=rules,
        description="2D weights + seq-sharded KV cache storage for prefill")


def train_2d() -> ShardingPolicy:
    """Training layout: TP on the model axis + FSDP (ZeRO-3) over the data
    axis — weight matrices shard their d_model dimension over 'data', so
    params/grads/optimizer state all scale with the full mesh — plus
    Megatron-style sequence parallelism on the residual stream: the layer-
    scan carry (B, S, D) shards its sequence over the model axis, so stored
    activations (the remat checkpoints) scale with TP too.  Without this,
    60-layer models store L x B_loc x S x D carries and blow past HBM."""
    rules = dict(_BASE_RULES)
    rules.update({
        "embed": "data",
        "expert_mlp": None,
        "head_dim": None,
        "batch": ("pod", "data"),
        "seq_res": "model",
    })
    return ShardingPolicy(
        name="train_2d", rules=rules, remat="full",
        description="FSDP(data) x TP(model) 2D weights + SP residuals + remat")


def train_2d_noSP() -> ShardingPolicy:
    """Ablation: the same 2D layout without sequence-parallel residuals
    (the paper's plain-TP AllReduce scheme).  Used in §Perf to quantify what
    SP buys on the memory term."""
    p = train_2d()
    rules = dict(p.rules)
    rules.update({"seq_res": None})
    return replace(p, name="train_2d_noSP", rules=rules,
                   description="FSDP x TP without sequence parallelism")


def train_2d_noremat() -> ShardingPolicy:
    """§Perf variant: same 2D layout without gradient checkpointing — when
    per-device activations have HBM headroom (small models / high DP), the
    re-forward's duplicate TP collectives and recompute disappear."""
    return replace(train_2d(), name="train_2d_noremat", remat="none",
                   description="FSDP x TP + SP residuals, no remat")


POLICIES = {
    "inference_tp": inference_tp,
    "inference_seqkv": inference_seqkv,
    "inference_2d": inference_2d,
    "inference_prefill_opt": inference_prefill_opt,
    "train_2d": train_2d,
    "train_2d_noSP": train_2d_noSP,
    "train_2d_noremat": train_2d_noremat,
}


def get_policy(name: str) -> ShardingPolicy:
    try:
        return POLICIES[name]()
    except KeyError:
        raise KeyError(f"unknown sharding policy {name!r}; have {sorted(POLICIES)}")
