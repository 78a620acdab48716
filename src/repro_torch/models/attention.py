"""Grouped-query attention with a KV cache (the port of
``repro.models.attention``'s serving modes).

KV cache layouts:

  dense : (B, T_max, Hkv, Dh) per layer (:class:`AttnCache`), left-aligned
          with a per-row ``lengths`` vector.  Chunked prefill and decode
          insert at ``lengths`` and attend with ``kv_len``/``q_offset``
          masks through :func:`repro_torch.kernels.ops.multi_head_attention`.
  paged : a flat (n_pages, Hkv, page_size, Dh) pool per layer
          (:class:`PagedAttnCache`): the resident layout, head axis ahead of
          the page-token axis, so one (page, head) tile is contiguous.
          Decode scatters the new token into its slot's current page and
          attends through the (B, max_pages) page table
          (:func:`~repro_torch.kernels.ops.paged_decode_attention`); the
          token-packed unified step (:class:`PackedSegs`) writes every
          packed token's K/V straight into its request's pages and attends
          each segment against exactly the pages it owns
          (:func:`~repro_torch.kernels.ops.ragged_paged_attention`).

Unlike the reference, whose arrays are immutable, the port writes new K/V
into the caches in place (no copy of a cache per layer per step).  Writes
clamp where the reference's ``dynamic_update_slice`` does, so an idle slot
whose length has run past the cache writes at its last position, never
outside its own row.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..core.modelspec import ModelSpec
from ..kernels import ops as kops
from .common import apply_rope, dense_init_, rms_norm, weight


@dataclass(frozen=True)
class PackedSegs:
    """Segment table of one token-packed unified step.

    S segments (one per decode slot, one per prefill row) at fixed,
    nondecreasing token offsets.  ``max_q`` is the widest segment the
    layout allows (the engine's chunk size).  The first ``n_decode``
    segments are decode slots of stride ``decode_q`` at packed offsets
    [0, n_decode * decode_q): the attention then runs them as their own
    max_q=decode_q sub-batch so decode slots never pay a chunk-wide query
    tile.  ``n_decode=0`` means no split is known.
    """
    q_start: torch.Tensor  # (S,) int32 token offset of each segment
    q_len: torch.Tensor  # (S,) int32 new tokens this step (0 = inactive)
    kv_len: torch.Tensor  # (S,) int32 valid KV tokens *after* this step
    page_table: torch.Tensor  # (S, max_pages) int32 pages of each segment
    max_q: int = 1
    n_decode: int = 0
    decode_q: int = 1


@dataclass
class AttnCache:
    """Per-layer dense KV cache: ``k``/``v`` are (B, T, Hkv, Dh)."""
    k: torch.Tensor
    v: torch.Tensor


def init_attn_cache(spec: ModelSpec, batch: int, max_len: int, device,
                    dtype) -> AttnCache:
    shape = (batch, max_len, spec.n_kv_heads, spec.d_head)
    return AttnCache(k=torch.zeros(shape, device=device, dtype=dtype),
                     v=torch.zeros(shape, device=device, dtype=dtype))


@dataclass
class PagedAttnCache:
    """Per-layer paged KV pool: ``k``/``v`` are (n_pages, Hkv, page_size,
    Dh).  Page 0 is the reserved null page (see
    :mod:`repro_torch.serving.paging`)."""
    k: torch.Tensor
    v: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.k.shape[2]


def init_paged_attn_cache(spec: ModelSpec, n_pages: int, page_size: int,
                          device, dtype) -> PagedAttnCache:
    shape = (n_pages, spec.n_kv_heads, page_size, spec.d_head)
    return PagedAttnCache(k=torch.zeros(shape, device=device, dtype=dtype),
                          v=torch.zeros(shape, device=device, dtype=dtype))


def paged_insert_rows(paged: PagedAttnCache, dense: AttnCache, row: int,
                      pages: torch.Tensor) -> None:
    """Scatter dense scratch row ``row`` into the pool pages named by
    ``pages`` (in place).  ``pages`` is the (max_pages,) page ids covering
    the request, 0-padded: the row's tail lands on the null page, many
    times over, which leaves page 0 holding one of those writes and no
    other request's page touched.  T must equal max_pages * page_size."""
    ps = paged.page_size
    idx = pages.long()
    for pool, scr in ((paged.k, dense.k), (paged.v, dense.v)):
        col = scr[row]  # (T, Hkv, Dh)
        chunks = col.reshape((idx.shape[0], ps) + tuple(col.shape[1:]))
        # (mp, ps, Hkv, Dh) -> the pool's resident (mp, Hkv, ps, Dh)
        pool[idx] = chunks.transpose(1, 2).to(pool.dtype)


class Attention(nn.Module):
    """Attention parameters, in the reference's (in, out) orientation."""

    def __init__(self, spec: ModelSpec, device, dtype):
        super().__init__()
        d, hq, hkv, dh = spec.d_model, spec.n_heads, spec.n_kv_heads, \
            spec.d_head
        self.norm = weight((d,), device, dtype, fill=1.0)
        self.wq = weight((d, hq * dh), device, dtype)
        self.wk = weight((d, hkv * dh), device, dtype)
        self.wv = weight((d, hkv * dh), device, dtype)
        self.wo = weight((hq * dh, d), device, dtype)
        if spec.qkv_bias:
            self.bq = weight((hq * dh,), device, dtype, fill=0.0)
            self.bk = weight((hkv * dh,), device, dtype, fill=0.0)
            self.bv = weight((hkv * dh,), device, dtype, fill=0.0)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            dense_init_(w, generator)


def _project_qkv(spec: ModelSpec, params: Attention, x: torch.Tensor,
                 positions: torch.Tensor):
    """x: (..., S, D) -> q (..., S, Hq, Dh), k, v (..., S, Hkv, Dh)."""
    lead = tuple(x.shape[:-1])
    hq, hkv, dh = spec.n_heads, spec.n_kv_heads, spec.d_head
    h = rms_norm(x, params.norm)
    q = h @ params.wq
    k = h @ params.wk
    v = h @ params.wv
    if spec.qkv_bias:
        q = q + params.bq
        k = k + params.bk
        v = v + params.bv
    q = q.reshape(lead + (hq, dh))
    k = k.reshape(lead + (hkv, dh))
    v = v.reshape(lead + (hkv, dh))
    if spec.pos == "rope":
        q = apply_rope(q, positions, spec.rope_theta)
        k = apply_rope(k, positions, spec.rope_theta)
    return q, k, v


def _packed_paged_attention(cache: PagedAttnCache, q: torch.Tensor,
                            k: torch.Tensor, v: torch.Tensor,
                            packed: PackedSegs, impl: str) -> torch.Tensor:
    """Write every packed token's K/V into its request's pages (position
    ``kv_len - q_len + i`` for token i of its segment; tokens outside any
    live segment land on the null page), then attend each segment against
    the pages it owns.  Returns (T, Hq, Dh)."""
    ps = cache.page_size
    t = q.shape[0]
    s_count, max_pages = packed.page_table.shape
    dev = q.device
    qs = packed.q_start.long()
    ql = packed.q_len.long()
    kl = packed.kv_len.long()
    tok = torch.arange(t, device=dev)
    seg = (torch.searchsorted(qs, tok, right=True) - 1).clamp(0, s_count - 1)
    off_in_seg = tok - qs[seg]
    valid = (off_in_seg >= 0) & (off_in_seg < ql[seg])
    pos = (kl[seg] - ql[seg] + off_in_seg).clamp(0, max_pages * ps - 1)
    page_ids = torch.where(valid, packed.page_table.long()[seg, pos // ps],
                           0)
    offs = pos % ps
    cache.k[page_ids, :, offs] = k.to(cache.k.dtype)
    cache.v[page_ids, :, offs] = v.to(cache.v.dtype)

    nd, dq = packed.n_decode, packed.decode_q
    if 0 < nd < s_count and packed.max_q > dq:
        # static decode/prefill split: the nd decode segments run at
        # max_q=decode_q instead of dragging a chunk-wide query tile
        o_dec = kops.ragged_paged_attention(
            q[:nd * dq], cache.k, cache.v, packed.page_table[:nd],
            packed.q_start[:nd], packed.q_len[:nd], packed.kv_len[:nd],
            max_q=dq, impl=impl)
        o_pre = kops.ragged_paged_attention(
            q[nd * dq:], cache.k, cache.v, packed.page_table[nd:],
            packed.q_start[nd:] - nd * dq, packed.q_len[nd:],
            packed.kv_len[nd:], max_q=packed.max_q, impl=impl)
        return torch.cat([o_dec, o_pre], dim=0)
    return kops.ragged_paged_attention(
        q, cache.k, cache.v, packed.page_table, packed.q_start,
        packed.q_len, packed.kv_len, max_q=packed.max_q, impl=impl)


def _attend(spec: ModelSpec, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor, *, kv_len=None, q_offset=0, impl: str
            ) -> torch.Tensor:
    """Attention over dense K/V, with the spec's sliding window."""
    window = spec.attn.window if spec.attn.kind == "swa" else None
    return kops.multi_head_attention(q, k, v, causal=spec.attn.causal,
                                     window=window, kv_len=kv_len,
                                     q_offset=q_offset, impl=impl)


def _paged_attention(spec: ModelSpec, cache: PagedAttnCache,
                     q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, page_table: torch.Tensor,
                     impl: str) -> torch.Tensor:
    """Paged decode step: scatter the new token's K/V into its page (in
    place), then attend against the pages the table names.  q: (B, 1, Hq,
    Dh); k, v: (B, 1, Hkv, Dh)."""
    if q.shape[1] != 1:
        raise ValueError("the paged layout serves single-token decode; "
                         "prefill runs on a dense scratch cache and is "
                         "paged at insert")
    if spec.attn.kind == "swa":
        # the reference's kernel route here takes no window while its
        # gather route applies one; the two part once a context passes the
        # window (ROADMAP section 3)
        raise NotImplementedError(
            "sliding-window attention in the paged two-dispatch decode "
            "(ROADMAP: section 3); serve it with cache_layout='dense'")
    ps = cache.page_size
    max_pages = page_table.shape[1]
    b = q.shape[0]
    pos = lengths.long()
    # page of the token being written, clamped so a garbage slot past
    # max_seq stays in bounds (its table row points at the null page)
    page_idx = (pos // ps).clamp(max=max_pages - 1)
    page_ids = page_table.long()[torch.arange(b, device=q.device), page_idx]
    offs = pos % ps
    cache.k[page_ids, :, offs] = k[:, 0].to(cache.k.dtype)
    cache.v[page_ids, :, offs] = v[:, 0].to(cache.v.dtype)
    return kops.paged_decode_attention(q, cache.k, cache.v, page_table,
                                       lengths + 1, impl=impl)


def _dense_cached_attention(spec: ModelSpec, cache: AttnCache,
                            q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, lengths: torch.Tensor,
                            rows: torch.Tensor | None,
                            impl: str) -> torch.Tensor:
    """Prefill (lengths == 0), chunked-prefill continuation and decode
    (S == 1) on the dense cache: insert the S new K/V rows at each row's
    ``lengths`` (in place), then attend causally against the valid prefix.
    ``rows`` (R,) names the batch rows whose K/V are written (None: all);
    the others keep their cache bit for bit and their outputs are
    unspecified."""
    b, s = q.shape[:2]
    t = cache.k.shape[1]
    dev = q.device
    sel = torch.arange(b, device=dev) if rows is None else rows.long()
    if s == t:  # fresh full-width prefill: static insert, attend directly
        cache.k[sel] = k[sel].to(cache.k.dtype)
        cache.v[sel] = v[sel].to(cache.v.dtype)
        return _attend(spec, q, k, v, impl=impl)
    # start clamped to T - S, as dynamic_update_slice clamps it
    start = lengths.long()[sel].clamp(0, t - s)
    pos = start[:, None] + torch.arange(s, device=dev)
    cache.k[sel[:, None], pos] = k[sel].to(cache.k.dtype)
    cache.v[sel[:, None], pos] = v[sel].to(cache.v.dtype)
    return _attend(spec, q, cache.k, cache.v, kv_len=lengths + s,
                   q_offset=lengths, impl=impl)


def attention_block(spec: ModelSpec, params: Attention, x: torch.Tensor,
                    positions: torch.Tensor,
                    cache: AttnCache | PagedAttnCache, *,
                    lengths: torch.Tensor | None = None,
                    page_table: torch.Tensor | None = None,
                    packed: PackedSegs | None = None,
                    rows: torch.Tensor | None = None,
                    impl: str = "kernel") -> torch.Tensor:
    """Three cached modes, as the reference's:

      * packed unified step (PagedAttnCache + ``packed``): x is the (T, D)
        token-packed mixed decode+prefill batch; K/V go to pages and the
        ragged attention serves every segment;
      * paged decode (PagedAttnCache, x (B, 1, D)): scatter into the slot's
        current page, attend through ``page_table``;
      * dense (AttnCache, x (B, S, D)): prefill, chunked continuation or
        decode at ``lengths``, writing only ``rows``.

    Returns the attention output (before the residual add)."""
    if packed is not None and spec.attn.kind == "swa":
        raise NotImplementedError(
            "the packed unified step has no sliding-window masking, as in "
            "the reference")
    q, k, v = _project_qkv(spec, params, x, positions)
    if packed is not None:
        o = _packed_paged_attention(cache, q, k, v, packed, impl)
    elif isinstance(cache, PagedAttnCache):
        o = _paged_attention(spec, cache, q, k, v, lengths, page_table, impl)
    else:
        o = _dense_cached_attention(spec, cache, q, k, v, lengths, rows,
                                    impl)
    return o.reshape(tuple(x.shape[:-1]) + (spec.n_heads * spec.d_head,)) \
        @ params.wo
