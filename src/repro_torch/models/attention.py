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

int8 KV cache (``quantized=True``; the reference's ``kv_quant``): ``k``/``v``
hold int8 codes and ``k_scale``/``v_scale`` the f32 absmax/127 scale of each
(token, KV head).  Every write quantizes (:func:`_quantize_kv`); every read
dequantizes (:func:`_dequantize_kv`, one pass per tensor) into buffers that
all layers of one cache share (``views``, one pair per shape), and the
attention kernels read that view: the ragged kernel for the packed step,
the flash kernel for the paged decode's gathered slots and for the dense
cache.
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
    """Per-layer dense KV cache: ``k``/``v`` are (B, T, Hkv, Dh); int8
    with the (B, T, Hkv) f32 ``k_scale``/``v_scale`` when quantized (None
    for the full-precision cache)."""
    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None


def _zeros_kv(cls, shape, device, dtype, quantized: bool):
    """A cache of ``cls`` whose K/V have ``shape``: ``dtype`` zeros, or int8
    codes and f32 scales of ``shape[:-1]`` (the reference's layout)."""
    if not quantized:
        return cls(k=torch.zeros(shape, device=device, dtype=dtype),
                   v=torch.zeros(shape, device=device, dtype=dtype))
    codes = [torch.zeros(shape, device=device, dtype=torch.int8)
             for _ in range(2)]
    scales = [torch.zeros(shape[:-1], device=device, dtype=torch.float32)
              for _ in range(2)]
    return cls(*codes, *scales)


def init_attn_cache(spec: ModelSpec, batch: int, max_len: int, device,
                    dtype, quantized: bool = False) -> AttnCache:
    return _zeros_kv(AttnCache,
                     (batch, max_len, spec.n_kv_heads, spec.d_head),
                     device, dtype, quantized)


@dataclass
class PagedAttnCache:
    """Per-layer paged KV pool: ``k``/``v`` are (n_pages, Hkv, page_size,
    Dh); int8 with the (n_pages, Hkv, page_size) f32 ``k_scale``/
    ``v_scale`` pools when quantized.  Page 0 is the reserved null page
    (see :mod:`repro_torch.serving.paging`)."""
    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @property
    def page_size(self) -> int:
        return self.k.shape[2]


def init_paged_attn_cache(spec: ModelSpec, n_pages: int, page_size: int,
                          device, dtype, quantized: bool = False
                          ) -> PagedAttnCache:
    return _zeros_kv(PagedAttnCache,
                     (n_pages, spec.n_kv_heads, page_size, spec.d_head),
                     device, dtype, quantized)


def kv_tensors(cache: AttnCache | PagedAttnCache) -> list[torch.Tensor]:
    """K, V and, when quantized, their scales: every tensor of the cache,
    each with the batch (or page) axis first."""
    return [t for t in (cache.k, cache.v, cache.k_scale, cache.v_scale)
            if t is not None]


def paged_insert_rows(paged: PagedAttnCache, dense: AttnCache,
                      row: torch.Tensor, pages: torch.Tensor) -> None:
    """Scatter dense scratch row ``row`` (a (1,) device tensor, so that one
    capture serves every row) into the pool pages named by ``pages`` (in
    place), the scales with the codes when quantized.  ``pages`` is the
    (max_pages,) page ids covering the request, 0-padded: the row's tail
    lands on the null page, many times over, which leaves page 0 holding
    one of those writes and no other request's page touched.  T must equal
    max_pages * page_size."""
    ps = paged.page_size
    idx = pages.long()
    for pool, scr in zip(kv_tensors(paged), kv_tensors(dense), strict=True):
        col = scr[row.long()]  # (1, T, Hkv, ...)
        chunks = col.reshape((idx.shape[0], ps) + tuple(scr.shape[2:]))
        # (mp, ps, Hkv, ...) -> the pool's resident (mp, Hkv, ps, ...)
        pool[idx] = chunks.transpose(1, 2).to(pool.dtype)


def _quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., H, D) -> int8 codes and (..., H) f32 scales, the reference's
    arithmetic: absmax over D in f32 over 127 (0 maps to 1.0), the values
    divided by it, rounded half to even and clamped to [-127, 127]."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0
    scale = torch.where(scale == 0, 1.0, scale)
    codes = torch.round(xf / scale[..., None]).clamp_(-127, 127)
    return codes.to(torch.int8), scale


def _dequantize_kv(codes: torch.Tensor, scale: torch.Tensor, dtype,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """``(codes.float() * scale[..., None]).to(dtype)`` in one pass: the
    product in f32, rounded once into ``dtype`` (into ``out`` when
    given)."""
    if out is None:
        out = torch.empty(codes.shape, dtype=dtype, device=codes.device)
    return torch.mul(codes, scale[..., None], out=out)


def _view_pair(views: dict, shape: tuple[int, ...], dtype,
               device) -> list[torch.Tensor]:
    """The K and V buffers of ``shape`` in ``views`` that every layer of
    one cache dequantizes into (made at the first read of that shape, then
    reused: a step's replays read and write the same memory)."""
    key = (tuple(shape), dtype)
    if key not in views:
        views[key] = [torch.empty(shape, dtype=dtype, device=device)
                      for _ in range(2)]
    return views[key]


def _stores(cache: AttnCache | PagedAttnCache, k: torch.Tensor,
            v: torch.Tensor) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """(destination, new values) of one write, in ``kv_tensors`` order: K
    and V in the cache's dtype or, quantized, their codes and scales."""
    if cache.k_scale is None:
        new = [k.to(cache.k.dtype), v.to(cache.v.dtype)]
    else:
        (kq, ks), (vq, vs) = _quantize_kv(k), _quantize_kv(v)
        new = [kq, vq, ks, vs]
    return list(zip(kv_tensors(cache), new))


def _dequantized(cache: AttnCache | PagedAttnCache, views: dict,
                 dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """The whole cache's K/V as attention reads them: the tensors
    themselves, or, quantized, dequantized into the shared view buffers."""
    if cache.k_scale is None:
        return cache.k, cache.v
    kb, vb = _view_pair(views, cache.k.shape, dtype, cache.k.device)
    return (_dequantize_kv(cache.k, cache.k_scale, dtype, out=kb),
            _dequantize_kv(cache.v, cache.v_scale, dtype, out=vb))


def _gathered(cache: PagedAttnCache, page_table: torch.Tensor,
              views: dict, dtype) -> list[torch.Tensor]:
    """A quantized pool's K/V of the slots the (B, max_pages) table names,
    dequantized into the shared (B, max_pages * page_size, Hkv, Dh) view
    buffers in the reference's ``paged_gather`` linearization: one gather
    of the codes and scales, then one pass that reads them through the
    page-to-token transpose and writes the view (out-of-range ids clamp,
    as the reference's gather does)."""
    b, mp = page_table.shape
    p, hkv, ps, dh = cache.k.shape
    idx = page_table.long().clamp(0, p - 1)
    bufs = _view_pair(views, (b, mp * ps, hkv, dh), dtype, cache.k.device)
    for codes, scale, buf in zip((cache.k, cache.v),
                                 (cache.k_scale, cache.v_scale), bufs):
        # (B, mp, Hkv, ps, ...) -> (B, mp, ps, Hkv, ...), strided
        _dequantize_kv(codes[idx].transpose(2, 3),
                       scale[idx].transpose(2, 3), dtype,
                       out=buf.view(b, mp, ps, hkv, dh))
    return bufs


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
                 positions: torch.Tensor, tp=None):
    """x: (..., S, D) -> q (..., S, Hq, Dh), k, v (..., S, Hkv, Dh); a
    tensor-parallel shard's normed input enters its heads' products
    through ``tp.enter`` (Megatron's f)."""
    lead = tuple(x.shape[:-1])
    hq, hkv, dh = spec.n_heads, spec.n_kv_heads, spec.d_head
    h = rms_norm(x, params.norm)
    if tp is not None:
        h = tp.enter(h)
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
                            packed: PackedSegs, impl: str,
                            views: dict) -> torch.Tensor:
    """Write every packed token's K/V (quantized: codes and scales) into its
    request's pages (position ``kv_len - q_len + i`` for token i of its
    segment; tokens outside any live segment land on the null page), then
    attend each segment against the pages it owns; a quantized pool is
    attended through its dequantized view of the whole pool, as the
    reference reads it.  Returns (T, Hq, Dh)."""
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
    for dst, new in _stores(cache, k, v):
        dst[page_ids, :, offs] = new
    ka, va = _dequantized(cache, views, q.dtype)

    nd, dq = packed.n_decode, packed.decode_q
    if 0 < nd < s_count and packed.max_q > dq:
        # static decode/prefill split: the nd decode segments run at
        # max_q=decode_q instead of dragging a chunk-wide query tile
        o_dec = kops.ragged_paged_attention(
            q[:nd * dq], ka, va, packed.page_table[:nd],
            packed.q_start[:nd], packed.q_len[:nd], packed.kv_len[:nd],
            max_q=dq, impl=impl)
        o_pre = kops.ragged_paged_attention(
            q[nd * dq:], ka, va, packed.page_table[nd:],
            packed.q_start[nd:] - nd * dq, packed.q_len[nd:],
            packed.kv_len[nd:], max_q=packed.max_q, impl=impl)
        return torch.cat([o_dec, o_pre], dim=0)
    return kops.ragged_paged_attention(
        q, ka, va, packed.page_table, packed.q_start,
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
                     impl: str, views: dict) -> torch.Tensor:
    """Paged decode step: scatter the new token's K/V (quantized: codes and
    scales) into its page (in place), then attend against the pages the
    table names: through the paged decode kernel, or, quantized, through
    flash at Sq = 1 over the slots' gathered, dequantized view (the
    reference's gather route, with the spec's window).  q: (B, 1, Hq, Dh);
    k, v: (B, 1, Hkv, Dh)."""
    if q.shape[1] != 1:
        raise ValueError("the paged layout serves single-token decode; "
                         "prefill runs on a dense scratch cache and is "
                         "paged at insert")
    quant = cache.k_scale is not None
    if spec.attn.kind == "swa" and not quant:
        # the reference's kernel route here takes no window while its
        # gather route applies one; the two part once a context passes the
        # window (ROADMAP section 3).  Quantized, it takes the gather route.
        raise NotImplementedError(
            "sliding-window attention in the paged two-dispatch decode "
            "(ROADMAP: section 3); serve it with cache_layout='dense' or "
            "the int8 KV cache")
    ps = cache.page_size
    max_pages = page_table.shape[1]
    b = q.shape[0]
    pos = lengths.long()
    # page of the token being written, clamped so a garbage slot past
    # max_seq stays in bounds (its table row points at the null page)
    page_idx = (pos // ps).clamp(max=max_pages - 1)
    page_ids = page_table.long()[torch.arange(b, device=q.device), page_idx]
    offs = pos % ps
    for dst, new in _stores(cache, k, v):
        dst[page_ids, :, offs] = new[:, 0]
    if quant:
        ka, va = _gathered(cache, page_table, views, q.dtype)
        return _attend(spec, q, ka, va, kv_len=lengths + 1, q_offset=lengths,
                       impl=impl)
    return kops.paged_decode_attention(q, cache.k, cache.v, page_table,
                                       lengths + 1, impl=impl)


def _dense_cached_attention(spec: ModelSpec, cache: AttnCache,
                            q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, lengths: torch.Tensor,
                            mask: torch.Tensor | None, impl: str,
                            views: dict) -> torch.Tensor:
    """Prefill (lengths == 0), chunked-prefill continuation and decode
    (S == 1) on the dense cache: insert the S new K/V rows (quantized:
    codes and scales) at each row's ``lengths`` (in place), then attend
    causally against the valid prefix (quantized: its dequantized view).
    ``mask`` (B,) bool selects the rows whose K/V are written (None: all):
    every row's (B, S) window at its position is gathered, selected against
    the new K/V and scattered back, so an unselected row rewrites its own
    values and every shape is fixed by S.  The unselected rows' outputs are
    unspecified."""
    b, s = q.shape[:2]
    t = cache.k.shape[1]
    dev = q.device

    def keep(new, old):  # the unselected rows keep their values
        if mask is None:
            return new
        return torch.where(mask.view((-1,) + (1,) * (new.dim() - 1)), new,
                           old)

    if s == t:  # fresh full-width prefill: static insert, attend directly
        # over the new (unquantized) K/V, as the reference does
        for dst, new in _stores(cache, k, v):
            dst.copy_(keep(new, dst))
        return _attend(spec, q, k, v, impl=impl)
    # start clamped to T - S, as dynamic_update_slice clamps it
    start = lengths.long().clamp(0, t - s)
    rows = torch.arange(b, device=dev)[:, None]
    pos = start[:, None] + torch.arange(s, device=dev)
    for dst, new in _stores(cache, k, v):
        dst[rows, pos] = keep(new, dst[rows, pos])
    ka, va = _dequantized(cache, views, q.dtype)
    return _attend(spec, q, ka, va, kv_len=lengths + s, q_offset=lengths,
                   impl=impl)


def attention_block(spec: ModelSpec, params: Attention, x: torch.Tensor,
                    positions: torch.Tensor,
                    cache: AttnCache | PagedAttnCache | None, *,
                    lengths: torch.Tensor | None = None,
                    page_table: torch.Tensor | None = None,
                    packed: PackedSegs | None = None,
                    mask: torch.Tensor | None = None,
                    views: dict,
                    impl: str = "kernel", tp=None) -> torch.Tensor:
    """The full pass (``cache`` None: :meth:`Model.forward`, attention over
    the S tokens themselves with the spec's ``causal``) and three cached
    modes, as the reference's:

      * packed unified step (PagedAttnCache + ``packed``): x is the (T, D)
        token-packed mixed decode+prefill batch; K/V go to pages and the
        ragged attention serves every segment;
      * paged decode (PagedAttnCache, x (B, 1, D)): scatter into the slot's
        current page, attend through ``page_table``;
      * dense (AttnCache, x (B, S, D)): prefill, chunked continuation or
        decode at ``lengths``, writing only the rows ``mask`` selects.

    ``views`` holds the buffers a quantized cache is dequantized into,
    shared by the layers of one cache.  ``tp`` (a tensor-parallel shard's
    communicator, :class:`~repro_torch.models.common.Shard`'s ``comm``):
    the parameters are this rank's heads, and the row-parallel ``wo``'s
    partial products are summed over the tp ranks by ``tp.exit`` (the
    reference's ``psum``).  Returns the attention output (before the
    residual add)."""
    if packed is not None and spec.attn.kind == "swa":
        raise NotImplementedError(
            "the packed unified step has no sliding-window masking, as in "
            "the reference")
    q, k, v = _project_qkv(spec, params, x, positions, tp)
    if cache is None:
        o = _attend(spec, q, k, v, impl=impl)
    elif packed is not None:
        o = _packed_paged_attention(cache, q, k, v, packed, impl, views)
    elif isinstance(cache, PagedAttnCache):
        o = _paged_attention(spec, cache, q, k, v, lengths, page_table, impl,
                             views)
    else:
        o = _dense_cached_attention(spec, cache, q, k, v, lengths, mask,
                                    impl, views)
    out = o.reshape(tuple(x.shape[:-1]) + (spec.n_heads * spec.d_head,)) \
        @ params.wo
    if tp is not None:
        out = tp.exit(out)
    return out
