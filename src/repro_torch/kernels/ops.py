"""Public kernel API: route each call to the Hopper kernel or its plain
version (the port of ``repro.kernels.ops``).

  multi_head_attention   : attention over dense K/V (flash forward)
  paged_decode_attention : one-token decode against the paged pools
  ragged_paged_attention : token-packed mixed decode + prefill attention
                           against the paged pools
  expert_gemm            : the MoE FFN's batched per-expert GEMM
  rwkv6_scan             : the RWKV-6 WKV recurrence
  decode_attention       : one-token decode against a dense (B, T, Hkv, D)
                           cache (no model routes to it, as in the
                           reference)

``impl="kernel"`` (the default) launches the CUDA kernel for tensors on the
card and takes the plain version only for tensors on the CPU; it never
falls back from a failed launch.  ``impl="plain"`` selects the plain
version on any device, explicitly (``chip_smoke.py`` uses it to hold the
kernels' serving outputs against the plain path on the card).
"""

from __future__ import annotations

import torch

from . import ref
from .decode_attention import decode_attention_cuda
from .expert_gemm import expert_gemm_cuda
from .flash_attention import flash_attention_cuda
from .paged_decode_attention import paged_decode_attention_cuda
from .ragged_attention import ragged_paged_attention_cuda
from .rwkv6_scan import rwkv6_scan_cuda

IMPLS = ("kernel", "plain")


def _plain(impl: str, x: torch.Tensor, what: str) -> bool:
    """True when this call takes the plain version."""
    if impl not in IMPLS:
        raise ValueError(f"unknown {what} impl {impl!r}; have {IMPLS}")
    return impl == "plain" or x.device.type == "cpu"


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         sm_scale: float | None = None,
                         window: int | None = None,
                         kv_len: torch.Tensor | int | None = None,
                         q_offset: torch.Tensor | int = 0,
                         impl: str = "kernel") -> torch.Tensor:
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D).
    ``kv_len`` (scalar or (B,), default Skv) and ``q_offset`` (scalar or
    (B,)) place the queries against the keys; ``window`` is the sliding
    window (None: none)."""
    kw = dict(causal=causal, sm_scale=sm_scale, window=window,
              kv_len=kv_len, q_offset=q_offset)
    if _plain(impl, q, "attention"):
        return ref.mha_reference(q, k, v, **kw)
    return flash_attention_cuda(q, k, v, **kw)


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           lengths: torch.Tensor, *,
                           sm_scale: float | None = None,
                           impl: str = "kernel") -> torch.Tensor:
    """q: (B, 1, Hq, D); k_pool, v_pool: (P, Hkv, page_size, D) resident
    pools; page_table: (B, max_pages) int32 (page 0 = the null page);
    lengths: (B,) int32 valid KV tokens, the token just inserted included.
    Returns (B, 1, Hq, D)."""
    if _plain(impl, q, "paged decode"):
        return ref.paged_decode_reference(q, k_pool, v_pool, page_table,
                                          lengths, sm_scale=sm_scale)
    return paged_decode_attention_cuda(q, k_pool, v_pool, page_table,
                                       lengths, sm_scale=sm_scale)


def ragged_paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, seg_page_table: torch.Tensor,
                           q_start: torch.Tensor, q_len: torch.Tensor,
                           kv_len: torch.Tensor, *, max_q: int,
                           sm_scale: float | None = None,
                           impl: str = "kernel") -> torch.Tensor:
    """q: (T, Hq, D) packed queries; k_pool, v_pool: (P, Hkv, page_size, D)
    resident pools; seg_page_table: (S, max_pages) int32 per-segment page
    ids; q_start/q_len/kv_len: (S,) int32 segment table; max_q: the q_len
    bound (the engine's chunk size).  Returns (T, Hq, D)."""
    if _plain(impl, q, "ragged paged"):
        return ref.ragged_paged_reference(q, k_pool, v_pool, seg_page_table,
                                          q_start, q_len, kv_len,
                                          max_q=max_q, sm_scale=sm_scale)
    return ragged_paged_attention_cuda(q, k_pool, v_pool, seg_page_table,
                                       q_start, q_len, kv_len, max_q=max_q,
                                       sm_scale=sm_scale)


def expert_gemm(x: torch.Tensor, w: torch.Tensor, *,
                impl: str = "kernel") -> torch.Tensor:
    """Batched per-expert GEMM: x (E, C, D) @ w (E, D, F) -> (E, C, F) in
    x's dtype, accumulated in f32.  x may be one (C, D) matrix
    ``expand``-ed over the experts."""
    if _plain(impl, x, "expert gemm"):
        return ref.moe_gemm_reference(x, w)
    return expert_gemm_cuda(x, w)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, state: torch.Tensor, *,
               state_out: torch.Tensor | None = None,
               impl: str = "kernel") -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 WKV: r, k, v (B, T, H, N) in the compute dtype, w (B, T, H, N)
    float32 decays, u (H, N) float32, state (B, H, N, N) float32 ->
    (out (B, T, H, N) in r's dtype, final state float32).  The final state
    is written into ``state_out`` when given (it may be ``state``)."""
    if _plain(impl, r, "rwkv6 scan"):
        out, final = ref.rwkv6_reference(r, k, v, w, u, state)
        if state_out is None:
            return out, final
        return out, state_out.copy_(final)
    return rwkv6_scan_cuda(r, k, v, w, u, state, state_out)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     lengths: torch.Tensor, sm_scale: float | None = None,
                     impl: str = "kernel") -> torch.Tensor:
    """One-token decode against a dense cache: q (B, 1, Hq, D); k, v (B, T,
    Hkv, D); lengths (B,) int32 valid keys, the query at lengths - 1.
    Returns (B, 1, Hq, D); a row of length 0 is zeros."""
    if _plain(impl, q, "decode"):
        return ref.mha_reference(q, k, v, causal=False, sm_scale=sm_scale,
                                 kv_len=lengths,
                                 q_offset=lengths.long() - 1)
    return decode_attention_cuda(q, k, v, lengths=lengths, sm_scale=sm_scale)
