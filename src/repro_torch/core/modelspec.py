"""Model descriptions: the port's own copy of ``repro.core.modelspec``.

Same fields, same defaults and the same derived ``d_head``/``n_kv_heads``,
so a spec written for the JAX package describes the same architecture
here.  Only what the port's model and engine read is kept: the analytical
accounting (parameter counts, KV formulas) stays with the reference.  The
``ssm`` field selects the RWKV-6 mixer (Mamba is refused by name).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class AttnSpec:
    kind: str = "full"  # full | swa (sliding window) | none
    window: int | None = None  # for swa
    causal: bool = True  # False for encoder-only models


@dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    d_ff_expert: int
    shared_experts: int = 0
    period: int = 1
    first_dense: int = 0

    def is_moe_layer(self, layer_idx: int) -> bool:
        if layer_idx < self.first_dense:
            return False
        return (layer_idx - self.first_dense) % self.period == 0


@dataclass(frozen=True)
class SSMSpec:
    kind: str = "mamba"  # mamba | rwkv6
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    head_size: int = 64


@dataclass(frozen=True)
class ModelSpec:
    """Complete architectural description of one model."""

    name: str
    d_model: int
    n_layers: int
    d_ff: int
    vocab: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 0  # defaults to d_model // n_heads
    attn: AttnSpec = field(default_factory=AttnSpec)
    moe: MoESpec | None = None
    ssm: SSMSpec | None = None
    hybrid_pattern: tuple[str, ...] | None = None
    qkv_bias: bool = False
    tied_embeddings: bool = False
    act: str = "swiglu"  # swiglu | gelu | relu2
    norm: str = "rmsnorm"
    pos: str = "rope"  # rope | none | learned
    rope_theta: float = 1e4
    frontend: str = "none"
    decoder: bool = True
    max_seq: int = 1 << 20

    def __post_init__(self):
        if self.n_heads and not self.d_head:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if self.n_heads and not self.n_kv_heads:
            object.__setattr__(self, "n_kv_heads", self.n_heads)

    @property
    def is_attention_free(self) -> bool:
        return all(k == "ssm" for k in self.layer_kinds())

    def layer_kinds(self) -> tuple[str, ...]:
        if self.hybrid_pattern is not None:
            pat = self.hybrid_pattern
            return tuple(pat[i % len(pat)] for i in range(self.n_layers))
        kind = "ssm" if (self.ssm is not None and self.n_heads == 0) \
            else "attn"
        return tuple(kind for _ in range(self.n_layers))

    def scaled(self, **kw) -> "ModelSpec":
        return dataclasses.replace(self, **kw)
