"""Top-level model: embedding -> decoder stack -> head, with the serving
steps (the port of ``repro.models.model``'s serving half).

    model = build_model(spec)                          # on the card, bf16
    cache = model.init_cache(batch, max_len, layout="paged", page_size=16)
    logits, cache = model.unified_step(cache, tokens, positions, packed)
    scratch = model.init_cache(rows, max_len, layout="dense")
    logits, scratch = model.prefill_chunk(scratch, tokens)
    logits, cache = model.decode_step(cache, tokens)

Every step writes K/V (or an RWKV layer's state) into the cache's tensors
in place.  ``unified_step`` and ``decode_step``, the steps the serving
engine captures in CUDA graphs, also advance the cache's own ``lengths``
tensor and return the cache they were given; the prefills return a
``ModelCache`` holding the same layers and new lengths.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..core.modelspec import ModelSpec
from ..device import resolve_device
from . import transformer as T
from .attention import (AttnCache, PackedSegs, PagedAttnCache,
                        init_attn_cache, init_paged_attn_cache)
from .common import embed_init_, rms_norm, weight
from .ssm import RWKVCache, init_rwkv_cache


@dataclass
class ModelCache:
    """Serving cache.  ``page_table`` is the (B, max_pages) int32 slot
    table the paged decode reads (None for the dense layout; the packed
    step reads each segment's pages from its ``PackedSegs.page_table``).
    An RWKV layer's cache is per-slot state in either layout."""
    layers: list[AttnCache | PagedAttnCache | RWKVCache]  # one per layer
    lengths: torch.Tensor  # (B,) int32 valid tokens per slot
    page_table: torch.Tensor | None = None


class Model(nn.Module):
    """Parameters and forward of one decoder.  The attribute
    ``kernel_impl`` picks the route of every kernel call, attention and
    expert GEMMs (``kernels.ops.IMPLS``): ``"kernel"`` (the Hopper kernels
    for tensors on the card, the plain versions on the CPU) or ``"plain"``
    (the plain versions everywhere)."""

    kernel_impl = "kernel"

    def __init__(self, spec: ModelSpec, device: torch.device,
                 dtype: torch.dtype):
        super().__init__()
        if not spec.decoder or spec.frontend != "none":
            raise NotImplementedError(
                f"{spec.name!r}: encoder-only and frontend-embedding "
                "models are not ported yet (ROADMAP: queue 1, item 13)")
        self.spec = spec
        self.device = device
        self.dtype = dtype
        d = spec.d_model
        self.embed = weight((spec.vocab, d), device, dtype)
        self.layers = nn.ModuleList(
            T.Layer(spec, cls, device, dtype) for cls in T.layer_classes(spec))
        self.final_norm = weight((d,), device, dtype, fill=1.0)
        if not spec.tied_embeddings:
            self.lm_head = weight((d, spec.vocab), device, dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        embed_init_(self.embed, generator)
        for layer in self.layers:
            layer.reset_parameters(generator)
        if not self.spec.tied_embeddings:
            embed_init_(self.lm_head, generator)

    # -- helpers ----------------------------------------------------------
    def _head_w(self) -> torch.Tensor:
        if self.spec.tied_embeddings:
            return self.embed.T
        return self.lm_head

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        return rms_norm(h, self.final_norm) @ self._head_w()

    # -- serving ----------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, *, layout: str = "paged",
                   page_size: int = 16, n_pages: int | None = None
                   ) -> ModelCache:
        """Serving cache.  ``layout="dense"``: one (batch, max_len, Hkv, Dh)
        cache per attention layer.  ``layout="paged"``: one (n_pages, Hkv,
        page_size, Dh) pool per attention layer, sized by default to the
        dense reservation plus the null page, and a zero (batch, max_pages)
        page table.  An RWKV layer gets its per-slot state in both layouts:
        paging never applies to state."""
        dev, spec = self.device, self.spec
        lengths = torch.zeros((batch,), dtype=torch.int32, device=dev)
        if layout not in ("dense", "paged"):
            raise ValueError(f"unknown cache layout {layout!r}")
        page_table = None
        if layout == "paged":
            if max_len % page_size:
                raise ValueError(f"max_len {max_len} must be a multiple of "
                                 f"page_size {page_size}")
            max_pages = max_len // page_size
            if n_pages is None:  # +1: reserved null page
                n_pages = batch * max_pages + 1
            page_table = torch.zeros((batch, max_pages), dtype=torch.int32,
                                     device=dev)

        def one(cls: T.LayerClass):
            if cls.kind == "rwkv6":
                return init_rwkv_cache(spec, batch, dev, self.dtype)
            if layout == "dense":
                return init_attn_cache(spec, batch, max_len, dev, self.dtype)
            return init_paged_attn_cache(spec, n_pages, page_size, dev,
                                         self.dtype)

        return ModelCache(layers=[one(cls) for cls in T.layer_classes(spec)],
                          lengths=lengths, page_table=page_table)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, *, cache: ModelCache,
                lengths: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, ModelCache]:
        """Process (B, S) prompts into a fresh dense cache and return the
        logits at each row's last valid position.  ``lengths``: (B,) true
        prompt lengths (right padding allowed; default the full width)."""
        b, s = tokens.shape
        dev = tokens.device
        if lengths is None:
            lengths = torch.full((b,), s, dtype=torch.int32, device=dev)
        positions = torch.arange(s, device=dev).expand(b, s)
        x = T.apply_stack(self.spec, self.layers, self.embed[tokens.long()],
                          positions, cache.layers,
                          lengths=torch.zeros((b,), dtype=torch.int32,
                                              device=dev),
                          impl=self.kernel_impl)
        x = x[torch.arange(b, device=dev), lengths.long() - 1]
        return self._logits(x), ModelCache(layers=cache.layers,
                                           lengths=lengths,
                                           page_table=cache.page_table)

    @torch.no_grad()
    def prefill_chunk(self, cache: ModelCache, tokens: torch.Tensor, *,
                      rows: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, ModelCache]:
        """Chunked-prefill continuation on a dense cache: the next (B, S)
        tokens of each row from its ``cache.lengths``.  ``rows`` (R,) names
        the rows whose state advances (their K/V or RWKV state written,
        their lengths moved on by S); the others keep theirs bit for bit,
        as the
        reference's masked ``jnp.where`` keeps them (None: every row).
        Returns the (B, V) logits at each row's last chunk position (rows
        outside ``rows`` are unspecified) and the cache."""
        b, s = tokens.shape
        dev = tokens.device
        positions = cache.lengths[:, None].long() + torch.arange(s,
                                                                 device=dev)
        x = T.apply_stack(self.spec, self.layers, self.embed[tokens.long()],
                          positions, cache.layers, lengths=cache.lengths,
                          page_table=cache.page_table, rows=rows,
                          impl=self.kernel_impl)
        if rows is None:
            lengths = cache.lengths + s
        else:
            lengths = cache.lengths.clone()
            lengths[rows] += s
        return self._logits(x[:, -1]), ModelCache(
            layers=cache.layers, lengths=lengths,
            page_table=cache.page_table)

    @torch.no_grad()
    def unified_step(self, cache: ModelCache, tokens: torch.Tensor,
                     positions: torch.Tensor, packed: PackedSegs
                     ) -> tuple[torch.Tensor, ModelCache]:
        """Token-packed unified serving step.  ``tokens``/``positions``:
        (T,) packed; ``packed``: the segment table.  K/V of every packed
        token go straight into their pages.  Returns per-segment
        last-position logits (S, V) and ``cache`` itself (pools updated in
        place; slot lengths written in place for the slots that ran)."""
        x = self.embed[tokens.long()]
        x = T.apply_stack(self.spec, self.layers, x, positions, cache.layers,
                          packed=packed, impl=self.kernel_impl)
        # each segment's logits come from its last valid packed position
        # (inactive segments produce garbage rows the engine ignores)
        last = packed.q_start.long() + packed.q_len.long().clamp(min=1) - 1
        logits = self._logits(x[last])
        b = cache.lengths.shape[0]
        cache.lengths.copy_(torch.where(packed.q_len[:b] > 0,
                                        packed.kv_len[:b], cache.lengths))
        return logits, cache

    @torch.no_grad()
    def decode_step(self, cache: ModelCache, tokens: torch.Tensor
                    ) -> tuple[torch.Tensor, ModelCache]:
        """One autoregressive step for every slot: (B, 1) tokens at each
        slot's ``cache.lengths`` -> (B, V) logits and ``cache`` itself.
        Every slot's length advances in place, idle ones too, as in the
        reference (their writes clamp inside their own row, or land on the
        null page)."""
        x = T.apply_stack(self.spec, self.layers, self.embed[tokens.long()],
                          cache.lengths[:, None], cache.layers,
                          lengths=cache.lengths, page_table=cache.page_table,
                          impl=self.kernel_impl)
        cache.lengths.add_(1)
        return self._logits(x)[:, 0], cache


def build_model(spec: ModelSpec, device: str | torch.device | None = None,
                dtype: torch.dtype = torch.bfloat16, *, seed: int = 0,
                kv_quant: bool = False) -> Model:
    """Build ``spec`` with random weights on ``device`` (default: the card;
    raises without one).  Weights are drawn on the device from a generator
    seeded ``seed``, tensor by tensor, so no f32 copy of the whole model
    ever exists."""
    dev = resolve_device(device)
    if kv_quant:
        raise NotImplementedError("the int8 KV cache is not ported yet "
                                  "(ROADMAP: queue 1, item 3)")
    model = Model(spec, dev, dtype)
    model.reset_parameters(torch.Generator(device=dev).manual_seed(seed))
    return model
