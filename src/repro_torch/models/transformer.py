"""Decoder stack (the port of ``repro.models.transformer``).

The reference stacks parameters per period position over a ``repeats``
axis and runs ``lax.scan`` over it.  The port keeps one module per layer
and a Python loop; ``layer_classes``/``stack_period`` are kept so the
parameter converter can find layer i in the reference's stacked tree
(position ``i % period``, repeat ``i // period``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..core.modelspec import ModelSpec
from .attention import (Attention, AttnCache, PackedSegs, PagedAttnCache,
                        attention_block)
from .mlp import MLP, mlp_block
from .moe import MoE, moe_block
from .ssm import (RWKV6, Mamba, MambaCache, RWKVCache, mamba_block,
                  rwkv6_block)

#: one layer's serving cache
LayerCache = AttnCache | PagedAttnCache | MambaCache | RWKVCache


@dataclass(frozen=True)
class LayerClass:
    kind: str  # attn | mamba | rwkv6
    is_moe: bool

    @property
    def key(self) -> str:
        return f"{self.kind}{'_moe' if self.is_moe else ''}"


def layer_classes(spec: ModelSpec) -> list[LayerClass]:
    kinds = spec.layer_kinds()
    out = []
    for i, k in enumerate(kinds):
        if k == "ssm":
            kind = "rwkv6" if (spec.ssm and spec.ssm.kind == "rwkv6") \
                else "mamba"
        else:
            kind = "attn"
        is_moe = spec.moe is not None and spec.moe.is_moe_layer(i)
        out.append(LayerClass(kind, is_moe))
    return out


def stack_period(spec: ModelSpec) -> tuple[int, int]:
    """-> (period, repeats): smallest p with class[i] == class[i mod p]."""
    classes = layer_classes(spec)
    n = len(classes)
    for p in range(1, n + 1):
        if n % p:
            continue
        if all(classes[i] == classes[i % p] for i in range(n)):
            return p, n // p
    return n, 1


class Layer(nn.Module):
    """One layer.  Attention or Mamba: ``mixer`` + ``ffn`` (the MoE block
    where the layer class is MoE, else the dense MLP; a Jamba layer has
    either).  RWKV-6: ``mixer`` (time mix and channel mix) and no ``ffn``,
    as in the reference: the channel mix is its FFN."""

    def __init__(self, spec: ModelSpec, cls: LayerClass, device, dtype,
                 shard=None):
        super().__init__()
        self.cls = cls
        if cls.kind == "rwkv6":
            self.mixer = RWKV6(spec, device, dtype)
            self.ffn = None
            return
        self.mixer = (Mamba if cls.kind == "mamba" else Attention)(
            spec, device, dtype)
        if cls.is_moe:
            self.ffn = (MoE(spec, device, dtype) if shard is None else
                        MoE(spec, device, dtype, n_shards=shard.ep,
                            shared_tp=shard.shared_tp))
        else:
            self.ffn = MLP(spec, device, dtype) if spec.d_ff > 0 else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.mixer.reset_parameters(generator)
        if self.ffn is not None:
            self.ffn.reset_parameters(generator)


def _apply_one(spec: ModelSpec, layer: Layer, x: torch.Tensor,
               positions: torch.Tensor, cache: LayerCache | None, *,
               impl: str, tp, ffn_tp, moe_kw: dict, **attn_kw
               ) -> torch.Tensor:
    kind = layer.cls.kind
    if kind == "attn":
        x = x + attention_block(spec, layer.mixer, x, positions, cache,
                                impl=impl, tp=tp, **attn_kw)
    elif attn_kw["packed"] is not None:
        raise NotImplementedError(
            "the token-packed unified step supports attention-only "
            f"stacks; layer kind {kind!r} carries sequential state")
    elif kind == "mamba":
        x = x + mamba_block(spec, layer.mixer, x, cache,
                            mask=attn_kw["mask"])
    else:
        # both residuals inside the block: the stack adds none
        return rwkv6_block(spec, layer.mixer, x, cache,
                           mask=attn_kw["mask"], impl=impl)
    if layer.cls.is_moe:
        x = x + moe_block(spec, layer.ffn, x, impl=impl, **moe_kw)
    elif layer.ffn is not None:
        x = x + mlp_block(spec, layer.ffn, x, tp=ffn_tp)
    return x


def apply_stack(spec: ModelSpec, layers: nn.ModuleList, x: torch.Tensor,
                positions: torch.Tensor,
                caches: list[LayerCache | None], *,
                lengths: torch.Tensor | None = None,
                page_table: torch.Tensor | None = None,
                packed: PackedSegs | None = None,
                mask: torch.Tensor | None = None,
                views: dict | None = None,
                impl: str = "kernel", tp=None, ffn_tp=None,
                moe_kw: dict | None = None) -> torch.Tensor:
    """Run every layer; each writes its K/V (or its Mamba or RWKV state)
    into its own cache, in place.  ``layers`` may be one pipeline stage's
    contiguous layers (a period-1 stack: the reference shards its stacked
    ``repeats`` axis).
    A None cache is the full pass of :meth:`Model.forward`: attention over
    the S tokens themselves, a Mamba layer from zero state, nothing
    kept.  ``impl`` routes every kernel of
    the stack, attention, expert GEMMs and the WKV scan
    (``kernels.ops.IMPLS``).
    ``lengths``/``page_table`` are the (B,) valid tokens and the shared
    (B, max_pages) page table; ``packed`` the shared segment table when x
    is a token-packed unified step; ``mask`` the (B,) bool selection of the
    dense rows whose K/V or state a chunk writes (see
    :func:`attention_block`); ``views`` the dequantize buffers the layers of
    a quantized cache share (``ModelCache.views``; None: this call's own).
    ``tp`` and ``ffn_tp`` are a shard's communicator where its attention
    and its dense FFN are split (a serving shard splits both, a training
    mesh's each where it divides), which sums each split block's
    row-parallel product over the ranks, and ``moe_kw`` the MoE blocks' mesh and
    knobs (:func:`repro_torch.models.moe.moe_block`)."""
    views = {} if views is None else views
    moe_kw = moe_kw or {}
    for layer, cache in zip(layers, caches, strict=True):
        x = _apply_one(spec, layer, x, positions, cache, lengths=lengths,
                       page_table=page_table, packed=packed, mask=mask,
                       views=views, impl=impl, tp=tp, ffn_tp=ffn_tp,
                       moe_kw=moe_kw)
    return x
