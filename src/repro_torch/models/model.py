"""Top-level model: embedding -> decoder stack -> head, with the full
pass and the serving steps (the port of ``repro.models.model``).

    model = build_model(spec)                          # on the card, bf16
    logits = model.forward(tokens)                     # (B, S, V), no cache
    logits = model.forward(embeds=frames)              # hubert, pixtral
    loss = model.loss(tokens, targets)                 # training (grads)
    cache = model.init_cache(batch, max_len, layout="paged", page_size=16)
    logits, cache = model.unified_step(cache, tokens, positions, packed)
    dec, seg, cache = model.verify_step(cache, tokens, positions, packed,
                                        n_decode=b, width=k + 1)
    scratch = model.init_cache(rows, max_len, layout="dense")
    logits, scratch = model.prefill_chunk(scratch, tokens, mask=mask)
    logits, cache = model.decode_step(cache, tokens)

Audio and vision models take precomputed frontend embeddings (``embeds=``,
(B, S, d_model)) in place of token ids: the modality frontend is a stub,
as in the reference.  An encoder-only frontend model (hubert-xlarge,
``decoder=False``) has no token embedding and must be given ``embeds``;
a decoder with a frontend (pixtral-12b) has both.

A model built with a :class:`~repro_torch.models.common.Shard` (``shard=``)
is one rank's part of a (pp, tp) mesh: its ``spec`` is the rank's geometry
(heads, kv heads and FFN width over tp, the stage's n_layers / pp layers),
``full_spec`` the model's, and its steps run the shard's collectives: two
all-reduces per layer over the tp ranks, the vocab-parallel head's logits
gathered, and the pipeline ring over the stages (``Shard.comm``).

``forward`` and ``loss`` follow the caller's grad mode: the weights are
made trainable with ``model.requires_grad_(True)`` (the trainer does it),
and attention then runs through the differentiable flash function
(``kernels.ops.FlashAttention``: on the card the flash forward with its
log-sum-exp and the flash backward kernel).  The serving steps run under
``torch.no_grad()`` whatever the weights' flags.

Every step writes K/V (or a Mamba or RWKV layer's state) into the cache's
tensors in place.  ``unified_step``, ``prefill_chunk`` and
``decode_step``, the steps the serving engine captures in CUDA graphs,
also advance the cache's own ``lengths`` tensor and return the cache they
were given; ``verify_step`` leaves the lengths to its caller (the
speculative round's rollback writes them); ``prefill`` returns a
``ModelCache`` holding the same layers and new lengths.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.modelspec import ModelSpec
from ..device import resolve_device
from . import transformer as T
from .attention import PackedSegs, init_attn_cache, init_paged_attn_cache
from .common import (Shard, embed_init_, local_spec, rms_norm,
                     tag_tp_shards, weight)
from .ssm import init_mamba_cache, init_rwkv_cache


def _chunk_nll(x: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """Masked negative log-likelihood summed over one chunk: logits in
    f32 from the head product in the model's dtype."""
    logits = (x @ w).float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, targets.long()[..., None])[..., 0]
    return ((lse - picked) * mask).sum()


@dataclass
class ModelCache:
    """Serving cache.  ``page_table`` is the (B, max_pages) int32 slot
    table the paged decode reads (None for the dense layout; the packed
    step reads each segment's pages from its ``PackedSegs.page_table``).
    A Mamba or RWKV layer's cache is per-slot state in either layout.
    ``views`` holds the buffers an int8 cache is dequantized into, one K/V
    pair per shape, shared by every layer (empty for a full-precision
    cache)."""
    layers: list[T.LayerCache]  # one per layer
    lengths: torch.Tensor  # (B,) int32 valid tokens per slot
    page_table: torch.Tensor | None = None
    views: dict = field(default_factory=dict)


class Model(nn.Module):
    """Parameters and forward of one decoder.  The attribute
    ``kernel_impl`` picks the route of every kernel call, attention and
    expert GEMMs (``kernels.ops.IMPLS``): ``"kernel"`` (the Hopper kernels
    for tensors on the card, the plain versions on the CPU) or ``"plain"``
    (the plain versions everywhere).  ``kv_quant`` (the reference's
    ``ModelContext.kv_quant``) makes :meth:`init_cache` give attention
    layers int8 K/V with per-(token, head) scales."""

    kernel_impl = "kernel"
    kv_quant = False

    def __init__(self, spec: ModelSpec, device: torch.device,
                 dtype: torch.dtype, shard: Shard | None = None):
        super().__init__()
        self.full_spec = spec
        self.shard = shard
        if shard is not None:
            spec = dataclasses.replace(local_spec(spec, shard.tp),
                                       n_layers=spec.n_layers // shard.pp)
        self.spec = spec
        self.device = device
        self.dtype = dtype
        d = spec.d_model
        # decoders own a token embedding even with a modality frontend (a
        # VLM decodes text tokens); encoder-only frontends (HuBERT) don't
        self.embed = (weight((spec.vocab, d), device, dtype)
                      if spec.frontend == "none" or spec.decoder else None)
        self.layers = nn.ModuleList(
            T.Layer(spec, cls, device, dtype) for cls in T.layer_classes(spec))
        self.final_norm = weight((d,), device, dtype, fill=1.0)
        if not spec.tied_embeddings:
            self.lm_head = weight((d, spec.vocab // self._tp), device, dtype)
        if shard is not None:
            tag_tp_shards(self, shard.tp, shard.tp_rank)

    @property
    def _tp(self) -> int:
        return 1 if self.shard is None else self.shard.tp

    def _stage(self) -> range:
        """The global indices of this model's layers."""
        if self.shard is None:
            return range(self.spec.n_layers)
        return self.shard.stage_layers(self.full_spec.n_layers)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw every weight from ``generator``.  A shard draws every tensor
        of the whole model in the same order and keeps its slices (another
        stage's layers are drawn into ``meta`` tensors and dropped), so it
        holds exactly its part of the unsharded model of the same seed."""
        if self.embed is not None:
            embed_init_(self.embed, generator)
        stage = self._stage()
        for i, cls in enumerate(T.layer_classes(self.full_spec)):
            if i in stage:
                layer = self.layers[i - stage.start]
            else:
                layer = T.Layer(self.spec, cls, torch.device("meta"),
                                self.dtype)
                tag_tp_shards(layer, self._tp, self.shard.tp_rank)
            layer.reset_parameters(generator)
        if not self.spec.tied_embeddings:
            embed_init_(self.lm_head, generator)

    # -- helpers ----------------------------------------------------------
    def _embed_in(self, tokens: torch.Tensor | None,
                  embeds: torch.Tensor | None) -> torch.Tensor:
        """Precomputed frontend embeddings in the model's dtype, else the
        token embedding of ``tokens``."""
        if embeds is not None:
            return embeds.to(self.dtype)
        if self.embed is None:
            raise AssertionError("encoder-only frontend archs take embeds")
        # the lookup's backward sums each token's rows in a fixed order:
        # advanced indexing's accumulating scatter differs run to run
        return F.embedding(tokens.long(), self.embed)

    def _head_w(self) -> torch.Tensor:
        if self.spec.tied_embeddings:
            return self.embed.T
        return self.lm_head

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        logits = rms_norm(h, self.final_norm) @ self._head_w()
        if self._tp > 1 and not self.spec.tied_embeddings:
            # the vocab-parallel untied head: the step's one logits gather
            # (a tied head stays replicated: the embedding serves lookups)
            logits = self.shard.comm.all_gather_last(logits)
        return logits

    def _stack(self, x: torch.Tensor, positions: torch.Tensor, caches,
               **kw) -> torch.Tensor:
        """``T.apply_stack`` over this model's layers with its kernel
        route; a shard sums over its tp ranks and, with pp > 1, runs its
        stage inside the pipeline ring, which returns the last stage's
        hidden state on every rank."""
        tp = self.shard.comm if self._tp > 1 else None

        def run(h: torch.Tensor) -> torch.Tensor:
            return T.apply_stack(self.spec, self.layers, h, positions,
                                 caches, impl=self.kernel_impl, tp=tp, **kw)
        if self.shard is None or self.shard.pp == 1:
            return run(x)
        return self.shard.comm.pp_ring(x, run)

    # -- encoder / full forward and training loss --------------------------
    def _full_pass(self, x: torch.Tensor,
                   positions: torch.Tensor | None) -> torch.Tensor:
        """The stack over (B, S, D) ``x`` with no cache: a Mamba or RWKV
        layer starts from zero state and keeps nothing."""
        b, s, _ = x.shape
        if positions is None:
            positions = torch.arange(s, device=x.device).expand(b, s)
        return self._stack(x, positions, [None] * len(self.layers))

    def forward(self, tokens: torch.Tensor | None = None, *,
                embeds: torch.Tensor | None = None,
                positions: torch.Tensor | None = None) -> torch.Tensor:
        """Full pass with no cache: (B, S) tokens or (B, S, D) ``embeds`` ->
        (B, S, V) logits at every position.  Attention is one flash call
        per layer over the S tokens (causal as the spec says: HuBERT's is
        bidirectional); a Mamba or RWKV layer starts from zero state.
        ``positions`` (B, S) default to 0..S-1 (read only by RoPE).  Runs
        under the caller's grad mode."""
        x = self._full_pass(self._embed_in(tokens, embeds), positions)
        return self._logits(x)

    def loss(self, tokens: torch.Tensor | None = None,
             targets: torch.Tensor | None = None, *,
             embeds: torch.Tensor | None = None,
             mask: torch.Tensor | None = None,
             chunk: int = 512) -> torch.Tensor:
        """Mean next-token (or unit-prediction) cross entropy of
        ``targets`` (B, S), masked by ``mask`` (B, S) (default: every
        position), as an f32 scalar (the port of ``Model.loss``).  The head
        and the log-softmax run over ``chunk`` positions at a time, each
        chunk under ``torch.utils.checkpoint`` (the reference's
        ``jax.checkpoint``): its (B, chunk, V) logits are recomputed in the
        backward, so the (B, S, V) logits never exist."""
        x = self._full_pass(self._embed_in(tokens, embeds), None)
        b, s, _ = x.shape
        x = rms_norm(x, self.final_norm)
        w = self._head_w()
        if mask is None:
            mask = torch.ones((b, s), dtype=torch.float32, device=x.device)
        mask = mask.float()
        chunk = min(chunk, s)
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for c0 in range(0, s, chunk):
            # the reference pads the last chunk with masked zeros; its
            # positions add 0, so the port runs the shorter chunk as it is
            total = total + checkpoint(
                _chunk_nll, x[:, c0:c0 + chunk], targets[:, c0:c0 + chunk],
                mask[:, c0:c0 + chunk], w, use_reentrant=False)
        return total / mask.sum().clamp(min=1.0)

    # -- serving ----------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, *, layout: str = "paged",
                   page_size: int = 16, n_pages: int | None = None
                   ) -> ModelCache:
        """Serving cache.  ``layout="dense"``: one (batch, max_len, Hkv, Dh)
        cache per attention layer.  ``layout="paged"``: one (n_pages, Hkv,
        page_size, Dh) pool per attention layer, sized by default to the
        dense reservation plus the null page, and a zero (batch, max_pages)
        page table.  With ``kv_quant`` every attention layer's K/V are int8
        with f32 scales.  An RWKV layer gets its per-slot state in both
        layouts: paging and quantization never apply to state, and a Mamba
        layer's is its conv inputs and SSM state."""
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
            if cls.kind == "mamba":
                return init_mamba_cache(spec, batch, dev, self.dtype)
            if layout == "dense":
                return init_attn_cache(spec, batch, max_len, dev, self.dtype,
                                       quantized=self.kv_quant)
            return init_paged_attn_cache(spec, n_pages, page_size, dev,
                                         self.dtype, quantized=self.kv_quant)

        return ModelCache(layers=[one(cls) for cls in T.layer_classes(spec)],
                          lengths=lengths, page_table=page_table)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor | None = None, *,
                embeds: torch.Tensor | None = None, cache: ModelCache,
                lengths: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, ModelCache]:
        """Process (B, S) prompts (or (B, S, D) frontend ``embeds``) into a
        fresh dense cache and return the logits at each row's last valid
        position.  ``lengths``: (B,) true prompt lengths (right padding
        allowed; default the full width)."""
        x = self._embed_in(tokens, embeds)
        b, s, _ = x.shape
        dev = x.device
        if lengths is None:
            lengths = torch.full((b,), s, dtype=torch.int32, device=dev)
        positions = torch.arange(s, device=dev).expand(b, s)
        x = self._stack(x, positions, cache.layers,
                        lengths=torch.zeros((b,), dtype=torch.int32,
                                            device=dev),
                        views=cache.views)
        x = x[torch.arange(b, device=dev), lengths.long() - 1]
        return self._logits(x), ModelCache(layers=cache.layers,
                                           lengths=lengths,
                                           page_table=cache.page_table,
                                           views=cache.views)

    @torch.no_grad()
    def prefill_chunk(self, cache: ModelCache, tokens: torch.Tensor, *,
                      mask: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, ModelCache]:
        """Chunked-prefill continuation on a dense cache: the next (B, S)
        tokens of each row from its ``cache.lengths``.  ``mask`` (B,) bool
        selects the rows whose state advances (their K/V or RWKV state
        written, their lengths moved on by S, all in place); the others keep
        theirs bit for bit, as the reference's masked ``jnp.where`` keeps
        them (None: every row).  Every shape is fixed by (B, S), so one
        capture serves every chunk of that width.  Returns the (B, V) logits
        at each row's last chunk position (unselected rows' are unspecified)
        and ``cache`` itself."""
        b, s = tokens.shape
        dev = tokens.device
        positions = cache.lengths[:, None].long() + torch.arange(s,
                                                                 device=dev)
        x = self._stack(self._embed_in(tokens, None), positions,
                        cache.layers, lengths=cache.lengths,
                        page_table=cache.page_table, mask=mask,
                        views=cache.views)
        if mask is None:
            cache.lengths.add_(s)
        else:
            cache.lengths.add_(mask.to(cache.lengths.dtype) * s)
        return self._logits(x[:, -1]), cache

    @torch.no_grad()
    def unified_step(self, cache: ModelCache, tokens: torch.Tensor,
                     positions: torch.Tensor, packed: PackedSegs
                     ) -> tuple[torch.Tensor, ModelCache]:
        """Token-packed unified serving step.  ``tokens``/``positions``:
        (T,) packed; ``packed``: the segment table.  K/V of every packed
        token go straight into their pages.  Returns per-segment
        last-position logits (S, V) and ``cache`` itself (pools updated in
        place; slot lengths written in place for the slots that ran)."""
        x = self._embed_in(tokens, None)
        x = self._stack(x, positions, cache.layers, packed=packed,
                        views=cache.views)
        # each segment's logits come from its last valid packed position
        # (inactive segments produce garbage rows the engine ignores)
        last = packed.q_start.long() + packed.q_len.long().clamp(min=1) - 1
        logits = self._logits(x[last])
        b = cache.lengths.shape[0]
        cache.lengths.copy_(torch.where(packed.q_len[:b] > 0,
                                        packed.kv_len[:b], cache.lengths))
        return logits, cache

    @torch.no_grad()
    def verify_step(self, cache: ModelCache, tokens: torch.Tensor,
                    positions: torch.Tensor, packed: PackedSegs, *,
                    n_decode: int, width: int
                    ) -> tuple[torch.Tensor, torch.Tensor, ModelCache]:
        """Token-packed speculative verify step: like :meth:`unified_step`,
        but the first ``n_decode`` segments are fixed-stride verify windows
        (``width`` = K+1 tokens at packed offsets [0, n_decode * width):
        the slot's committed feed token and K draft proposals, causal
        within the window), and the logits come back at every window
        position.  Returns ``(dec_logits (n_decode, width, V), seg_logits
        (S, V), cache)``; ``seg_logits`` are each segment's last-valid-
        position logits (the engine samples the prefill rows' from them).
        ``cache.lengths`` is left unchanged: the committed frontier depends
        on the accept counts, so the caller writes the lengths after
        rejection sampling."""
        x = self._embed_in(tokens, None)
        x = self._stack(x, positions, cache.layers, packed=packed,
                        views=cache.views)
        last = packed.q_start.long() + packed.q_len.long().clamp(min=1) - 1
        # one head product for both, so the head is read once
        n = n_decode * width
        logits = self._logits(torch.cat([x[:n], x[last]]))
        return (logits[:n].reshape(n_decode, width, -1), logits[n:], cache)

    @torch.no_grad()
    def decode_step(self, cache: ModelCache, tokens: torch.Tensor
                    ) -> tuple[torch.Tensor, ModelCache]:
        """One autoregressive step for every slot: (B, 1) tokens at each
        slot's ``cache.lengths`` -> (B, V) logits and ``cache`` itself.
        Every slot's length advances in place, idle ones too, as in the
        reference (their writes clamp inside their own row, or land on the
        null page)."""
        x = self._stack(self._embed_in(tokens, None),
                        cache.lengths[:, None], cache.layers,
                        lengths=cache.lengths, page_table=cache.page_table,
                        views=cache.views)
        cache.lengths.add_(1)
        return self._logits(x)[:, 0], cache


def build_model(spec: ModelSpec, device: str | torch.device | None = None,
                dtype: torch.dtype = torch.bfloat16, *, seed: int = 0,
                kv_quant: bool = False, shard: Shard | None = None) -> Model:
    """Build ``spec`` with random weights on ``device`` (default: the card;
    raises without one).  Weights are drawn on the device from a generator
    seeded ``seed``, tensor by tensor, so no f32 copy of the whole model
    ever exists.  ``kv_quant`` gives the model int8 KV caches.  With
    ``shard`` the model is that rank's part, holding the same weights as
    its slices of the unsharded model of the same seed (each full tensor
    drawn in turn and sliced)."""
    dev = resolve_device(device)
    model = Model(spec, dev, dtype, shard=shard)
    model.kv_quant = kv_quant
    model.reset_parameters(torch.Generator(device=dev).manual_seed(seed))
    return model
