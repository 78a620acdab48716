"""Model descriptions (paper §II-A, Table IV): the port's copy of
``repro.core.modelspec``.

``ModelSpec`` is the single source of truth for both halves of the port:
the GenZ analytical profiler (``repro_torch.core.profiler``) derives
operator shapes, FLOPs and bytes from it, and the port's model and engine
(``repro_torch.models``, ``repro_torch.serving``) build and serve the same
object, so a prediction and a measurement describe the same architecture.
Same fields, defaults, derived ``d_head``/``n_kv_heads`` and accounting
(parameter counts, the §VI-A KV formulas) as the reference, and the same
Table-IV presets (``PAPER_MODELS``).  The ``ssm`` field selects the RWKV-6
mixer in the served model (Mamba is refused by name there).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Literal, Sequence

from .hardware import DTYPE_BYTES

LayerKind = Literal["attn", "ssm"]


@dataclass(frozen=True)
class AttnSpec:
    kind: str = "full"  # full | swa (sliding window) | none
    window: int | None = None  # for swa
    causal: bool = True  # False for encoder-only models

    def effective_kv_len(self, kv_len: int) -> int:
        if self.kind == "swa" and self.window is not None:
            return min(kv_len, self.window)
        return kv_len


@dataclass(frozen=True)
class MoESpec:
    num_experts: int  # routed experts E
    top_k: int  # experts activated per token K
    d_ff_expert: int  # hidden dim of each routed expert
    shared_experts: int = 0  # always-on experts (DeepSeek-MoE style)
    period: int = 1  # MoE every `period` layers (Jamba: 2)
    first_dense: int = 0  # leading dense layers before MoE starts

    def is_moe_layer(self, layer_idx: int) -> bool:
        if layer_idx < self.first_dense:
            return False
        return (layer_idx - self.first_dense) % self.period == 0


@dataclass(frozen=True)
class SSMSpec:
    kind: str = "mamba"  # mamba | rwkv6
    d_state: int = 16  # mamba state width N
    d_conv: int = 4  # mamba conv kernel
    expand: int = 2  # mamba inner expansion
    head_size: int = 64  # rwkv6 head size

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model


@dataclass(frozen=True)
class ModelSpec:
    """Complete architectural description of one model."""

    name: str
    d_model: int
    n_layers: int
    d_ff: int
    vocab: int
    n_heads: int = 0  # 0 for attention-free models
    n_kv_heads: int = 0
    d_head: int = 0  # defaults to d_model // n_heads
    attn: AttnSpec = field(default_factory=AttnSpec)
    moe: MoESpec | None = None
    ssm: SSMSpec | None = None
    #: per-layer kinds for hybrid stacks; cycled over n_layers.  None means
    #: all layers are "attn" (or "ssm" when n_heads == 0).
    hybrid_pattern: tuple[str, ...] | None = None
    qkv_bias: bool = False
    tied_embeddings: bool = False
    act: str = "swiglu"  # swiglu | gelu
    norm: str = "rmsnorm"
    pos: str = "rope"  # rope | none | learned
    rope_theta: float = 1e4
    frontend: str = "none"  # none | audio | vision (stub modality frontends)
    decoder: bool = True  # False => encoder-only (no decode stage)
    max_seq: int = 1 << 20

    # -- derived ------------------------------------------------------------
    def __post_init__(self):
        if self.n_heads and not self.d_head:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if self.n_heads and not self.n_kv_heads:
            object.__setattr__(self, "n_kv_heads", self.n_heads)

    @property
    def is_attention_free(self) -> bool:
        return all(k == "ssm" for k in self.layer_kinds())

    @property
    def supports_long_context(self) -> bool:
        """True when decode cost does not scale quadratically with context:
        SSM / hybrid / sliding-window models."""
        kinds = self.layer_kinds()
        if all(k == "ssm" for k in kinds):
            return True
        if any(k == "ssm" for k in kinds):
            return True  # hybrid: attention layers are the minority
        return self.attn.kind == "swa"

    def layer_kinds(self) -> tuple[str, ...]:
        if self.hybrid_pattern is not None:
            pat = self.hybrid_pattern
            return tuple(pat[i % len(pat)] for i in range(self.n_layers))
        kind: str = "ssm" if (self.ssm is not None and self.n_heads == 0) else "attn"
        return tuple(kind for _ in range(self.n_layers))

    def n_attn_layers(self) -> int:
        return sum(1 for k in self.layer_kinds() if k == "attn")

    def n_ssm_layers(self) -> int:
        return sum(1 for k in self.layer_kinds() if k == "ssm")

    def moe_layer_indices(self) -> list[int]:
        if self.moe is None:
            return []
        return [i for i in range(self.n_layers) if self.moe.is_moe_layer(i)]

    # -- parameter accounting ------------------------------------------------
    def attn_params_per_layer(self) -> int:
        d, hq, hkv, dh = self.d_model, self.n_heads, self.n_kv_heads, self.d_head
        p = d * (hq * dh) + 2 * d * (hkv * dh) + (hq * dh) * d
        if self.qkv_bias:
            p += (hq + 2 * hkv) * dh
        return p

    def ssm_params_per_layer(self) -> int:
        s = self.ssm
        assert s is not None
        d = self.d_model
        if s.kind == "mamba":
            di, n = s.d_inner(d), s.d_state
            # in_proj (x & z), conv, x->(dt,B,C) proj, dt_proj, A, D, out_proj
            return (d * 2 * di + di * s.d_conv
                    + di * (di // 16 + 2 * n) + (di // 16) * di
                    + di * n + di + di * d)
        if s.kind == "rwkv6":
            # time-mix: r,k,v,g,output projections + low-rank w/decay MLPs
            tm = 5 * d * d + 2 * (d * 64 + 64 * d)
            return tm
        raise ValueError(s.kind)

    def mlp_params(self, d_ff: int) -> int:
        n_mats = 3 if self.act == "swiglu" else 2
        return n_mats * self.d_model * d_ff

    def ffn_params_per_layer(self, layer_idx: int) -> int:
        if self.moe is not None and self.moe.is_moe_layer(layer_idx):
            m = self.moe
            router = self.d_model * m.num_experts
            return (router + (m.num_experts + m.shared_experts)
                    * self.mlp_params(m.d_ff_expert))
        return self.mlp_params(self.d_ff)

    def active_ffn_params_per_layer(self, layer_idx: int) -> int:
        if self.moe is not None and self.moe.is_moe_layer(layer_idx):
            m = self.moe
            router = self.d_model * m.num_experts
            return (router + (m.top_k + m.shared_experts)
                    * self.mlp_params(m.d_ff_expert))
        return self.mlp_params(self.d_ff)

    def norm_params_per_layer(self) -> int:
        return 2 * self.d_model

    def embedding_params(self) -> int:
        n = self.vocab * self.d_model
        if not self.tied_embeddings and self.decoder:
            n *= 2  # separate LM head
        return n

    def _layer_params(self, layer_idx: int, active: bool) -> int:
        kinds = self.layer_kinds()
        mixer = (self.attn_params_per_layer() if kinds[layer_idx] == "attn"
                 else self.ssm_params_per_layer())
        ffn = (self.active_ffn_params_per_layer(layer_idx) if active
               else self.ffn_params_per_layer(layer_idx))
        # RWKV6 channel-mix replaces the standard MLP but keeps d_ff sizing
        # (2 matrices: key d->dff, value dff->d).
        if kinds[layer_idx] == "ssm" and self.ssm and self.ssm.kind == "rwkv6":
            ffn = 2 * self.d_model * self.d_ff
        return mixer + ffn + self.norm_params_per_layer()

    def param_count(self) -> int:
        """Total parameters (weights kept in memory)."""
        total = self.embedding_params()
        for i in range(self.n_layers):
            total += self._layer_params(i, active=False)
        total += self.d_model  # final norm
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only selected experts)."""
        total = self.embedding_params()
        for i in range(self.n_layers):
            total += self._layer_params(i, active=True)
        total += self.d_model
        return total

    # -- KV cache ------------------------------------------------------------
    def kv_bytes_per_token(self, dtype: str = "bf16") -> float:
        """KV-cache bytes per token per request (attention layers only;
        paper §VI-A: KV = 2 * B * (tau_p + S_b * tau_d) * H_kv * d * L)."""
        b = DTYPE_BYTES[dtype]
        return 2.0 * self.n_kv_heads * self.d_head * self.n_attn_layers() * b

    def ssm_state_bytes(self, dtype: str = "bf16") -> float:
        """Constant-size recurrent state per request for SSM layers."""
        if self.ssm is None:
            return 0.0
        b = DTYPE_BYTES[dtype]
        s = self.ssm
        if s.kind == "mamba":
            di = s.d_inner(self.d_model)
            per_layer = di * s.d_state + di * s.d_conv
        else:  # rwkv6
            heads = self.d_model // s.head_size
            per_layer = heads * s.head_size * s.head_size + 2 * self.d_model
        return per_layer * self.n_ssm_layers() * b

    def kv_cache_bytes(self, batch: int, tau_p: int, tau_d: int,
                       beam: int = 1, dtype: str = "bf16") -> float:
        """Paper §VI-A formula; beams share the prefill cache."""
        eff_len = self.attn.effective_kv_len(tau_p + beam * tau_d)
        toks = tau_p + beam * tau_d if self.attn.kind != "swa" else eff_len
        return (batch * toks * self.kv_bytes_per_token(dtype)
                + batch * self.ssm_state_bytes(dtype))

    def weight_bytes(self, dtype: str = "bf16") -> float:
        return self.param_count() * DTYPE_BYTES[dtype]

    def scaled(self, **kw) -> "ModelSpec":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Paper Table IV model presets.
# ---------------------------------------------------------------------------

def _dense(name, d, layers, heads, kv, wff, vocab=128256, **kw) -> ModelSpec:
    return ModelSpec(name=name, d_model=d, n_layers=layers, n_heads=heads,
                     n_kv_heads=kv, d_ff=int(wff * d), vocab=vocab, **kw)


PAPER_MODELS: dict[str, ModelSpec] = {}


def _register_paper(spec: ModelSpec) -> ModelSpec:
    PAPER_MODELS[spec.name] = spec
    return spec


_register_paper(_dense("gemma2-2b", 2304, 26, 8, 4, 4, vocab=256000))
_register_paper(_dense("llama2-7b", 4096, 32, 32, 32, 2.6875, vocab=32000))
_register_paper(_dense("llama3-8b", 4096, 32, 32, 8, 3.5))
_register_paper(_dense("gemma2-27b", 4608, 46, 32, 16, 8, vocab=256000))
_register_paper(ModelSpec(
    name="mixtral-8x22b", d_model=6144, n_layers=56, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=32768,
    moe=MoESpec(num_experts=8, top_k=2, d_ff_expert=16384)))
_register_paper(ModelSpec(
    name="mixtral-8x7b", d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000,
    moe=MoESpec(num_experts=8, top_k=2, d_ff_expert=14336)))
_register_paper(_dense("llama3-70b", 8192, 80, 64, 8, 3.5))
_register_paper(_dense("gpt3-175b", 12288, 96, 96, 96, 4, vocab=50257, act="gelu"))
_register_paper(_dense("llama3-405b", 16384, 126, 128, 8, 3.25))
_register_paper(ModelSpec(
    name="gpt4-1.8t", d_model=10752, n_layers=120, n_heads=84, n_kv_heads=84,
    d_ff=4 * 10752, vocab=100256, act="gelu",
    moe=MoESpec(num_experts=16, top_k=2, d_ff_expert=4 * 10752)))
_register_paper(_dense("dense-5t", 49152, 128, 192, 24, 4, vocab=128256))
_register_paper(ModelSpec(
    name="moe-10t", d_model=13824, n_layers=128, n_heads=108, n_kv_heads=12,
    d_ff=4 * 13824, vocab=128256,
    moe=MoESpec(num_experts=32, top_k=4, d_ff_expert=4 * 13824)))
_register_paper(ModelSpec(
    name="falcon-mamba-7b", d_model=4096, n_layers=64, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=65024, ssm=SSMSpec(kind="mamba", d_state=16, expand=2),
    pos="none"))


def paper_model(name: str) -> ModelSpec:
    try:
        return PAPER_MODELS[name]
    except KeyError:
        raise KeyError(f"unknown paper model {name!r}; have {sorted(PAPER_MODELS)}")
