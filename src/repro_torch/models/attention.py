"""Grouped-query attention on the paged KV pools, token-packed mode (the
port of ``repro.models.attention``'s unified-step path).

The serving engine packs every active slot's decode token and every
in-flight prompt's current prefill chunk into one ragged (T,) batch
(:class:`PackedSegs`).  The packed path writes each token's K/V straight
into its request's pages, then attends each segment against exactly the
pages it owns through :func:`repro_torch.kernels.ops.ragged_paged_attention`.

The pools use the resident (P, Hkv, page_size, D) layout: the head axis
ahead of the page-token axis, so one (page, head) tile is contiguous.
Unlike the reference, whose arrays are immutable, the port writes new K/V
into the pools in place (no copy of the pool per layer per step).
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
    """x: (T, D) packed tokens -> q (T, Hq, Dh), k, v (T, Hkv, Dh)."""
    t = x.shape[0]
    hq, hkv, dh = spec.n_heads, spec.n_kv_heads, spec.d_head
    h = rms_norm(x, params.norm)
    q = h @ params.wq
    k = h @ params.wk
    v = h @ params.wv
    if spec.qkv_bias:
        q = q + params.bq
        k = k + params.bk
        v = v + params.bv
    q = q.reshape(t, hq, dh)
    k = k.reshape(t, hkv, dh)
    v = v.reshape(t, hkv, dh)
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


def attention_block(spec: ModelSpec, params: Attention, x: torch.Tensor,
                    positions: torch.Tensor, cache: PagedAttnCache,
                    packed: PackedSegs, impl: str = "kernel"
                    ) -> torch.Tensor:
    """Packed unified step: x is the (T, D) token-packed mixed
    decode+prefill batch; K/V go to pages (in place) and the ragged
    attention serves every segment.  Returns the (T, D) attention output
    (before the residual add)."""
    if spec.attn.kind == "swa":
        raise NotImplementedError(
            "the packed unified step has no sliding-window masking "
            "(ROADMAP: queue 1, item 13)")
    q, k, v = _project_qkv(spec, params, x, positions)
    o = _packed_paged_attention(cache, q, k, v, packed, impl)
    return o.reshape(x.shape[0], spec.n_heads * spec.d_head) @ params.wo
