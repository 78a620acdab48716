"""Public kernel API: route each call to the Hopper kernel or its plain
version (the port of ``repro.kernels.ops``).

  multi_head_attention   : attention over dense K/V (flash forward; when
                           autograd needs a gradient, the FlashAttention
                           function: the forward with its log-sum-exp,
                           the flash backward kernel)
  paged_decode_attention : one-token decode against the paged pools
  ragged_paged_attention : token-packed mixed decode + prefill attention
                           against the paged pools
  expert_gemm            : the MoE FFN's batched per-expert GEMM
  rwkv6_scan             : the RWKV-6 WKV recurrence
  mamba_scan             : the Mamba selective scan (plain PyTorch on every
                           device: the reference's is jnp, not Pallas)
  decode_attention       : one-token decode against a dense (B, T, Hkv, D)
                           cache (no model routes to it, as in the
                           reference)

``impl="kernel"`` (the default) launches the CUDA kernel for tensors on the
card and takes the plain version only for tensors on the CPU; it never
falls back from a failed launch.  ``impl="plain"`` selects the plain
version on any device, explicitly (``chip_smoke.py`` uses it to hold the
kernels' serving outputs against the plain path on the card).

Attention, the expert GEMM and the WKV scan have a backward: when
autograd needs a gradient, each runs through its ``torch.autograd.Function``
(:class:`FlashAttention`, :class:`ExpertGemm`, :class:`RWKV6Scan`), whose
forward and backward are the CUDA kernels on the card and their plain
versions on the CPU (or with ``impl="plain"``); a gradient never takes a
plain version on the card in the kernel's place.  The Mamba scan trains
through autograd on every device, one ``torch.utils.checkpoint`` per chunk
(the reference's ``jax.checkpoint``).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from . import ref
from .decode_attention import decode_attention_cuda
from .expert_gemm import expert_gemm_bwd_cuda, expert_gemm_cuda
from .flash_attention import _per_row, flash_attention_cuda
from .flash_attention_bwd import flash_attention_bwd_cuda
from .paged_decode_attention import paged_decode_attention_cuda
from .ragged_attention import ragged_paged_attention_cuda
from .rwkv6_scan import bound_chunk, rwkv6_scan_cuda
from .rwkv6_scan_bwd import rwkv6_scan_bwd_cuda

IMPLS = ("kernel", "plain")


def _plain(impl: str, x: torch.Tensor, what: str) -> bool:
    """True when this call takes the plain version."""
    if impl not in IMPLS:
        raise ValueError(f"unknown {what} impl {impl!r}; have {IMPLS}")
    return impl == "plain" or x.device.type == "cpu"


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (the reference's ``custom_vjp``
    around the Pallas forward, ``pallas_flash_attention``): the forward
    saves q, k, v, its output and its log-sum-exp; the backward is
    FlashAttention-2's recompute.  On the card (``impl="kernel"``) both are
    the CUDA kernels; on the CPU, or with ``impl="plain"``, the blockwise
    plain versions (``ref.flash_fwd_reference`` /
    ``ref.flash_bwd_reference``).  No gradient flows to ``kv_len`` or
    ``q_offset``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, window, kv_len, q_offset,
                plain):
        kw = dict(causal=causal, sm_scale=sm_scale, window=window,
                  kv_len=kv_len, q_offset=q_offset)
        if plain:
            o, lse = ref.flash_fwd_reference(q, k, v, **kw)
        else:
            o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
        ctx.save_for_backward(q, k, v, o, lse, kv_len, q_offset)
        ctx.kw = dict(causal=causal, sm_scale=sm_scale, window=window)
        ctx.plain = plain
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, kv_len, q_offset = ctx.saved_tensors
        kw = dict(ctx.kw, kv_len=kv_len, q_offset=q_offset)
        bwd = ref.flash_bwd_reference if ctx.plain \
            else flash_attention_bwd_cuda
        dq, dk, dv = bwd(q, k, v, o, lse, do.contiguous(), **kw)
        return dq, dk, dv, None, None, None, None, None, None


class ExpertGemm(torch.autograd.Function):
    """Differentiable expert GEMM (the reference differentiates its jnp
    einsum): x (E, C, D), or one (C, D) matrix that the forward broadcasts
    over the experts, @ w (E, D, F).  The forward saves x and w; the
    backward gives ``dW_e = X_e^T dY_e`` and ``dX_e = dY_e W_e^T``, a
    broadcast x's summed over the experts in the product itself.  On the
    card (``impl="kernel"``) the forward is the expert GEMM kernel and the
    backward :func:`expert_gemm_bwd_cuda` (in bf16 a kernel of its own,
    ``csrc/expert_gemm_bwd.cu``; counted apart from the forward); on the
    CPU, or with ``impl="plain"``, ``ref.moe_gemm_reference`` and
    ``ref.expert_gemm_bwd_reference``."""

    @staticmethod
    def forward(ctx, x, w, plain):
        xe = x.expand(w.shape[0], *x.shape) if x.dim() == 2 else x
        y = ref.moe_gemm_reference(xe, w) if plain \
            else expert_gemm_cuda(xe, w)
        ctx.save_for_backward(x, w)
        ctx.plain = plain
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        bwd = ref.expert_gemm_bwd_reference if ctx.plain \
            else expert_gemm_bwd_cuda
        dx, dw = bwd(x, w, dy.contiguous(), need_x=ctx.needs_input_grad[0],
                     need_w=ctx.needs_input_grad[1])
        return dx, dw, None


class RWKV6Scan(torch.autograd.Function):
    """Differentiable WKV scan (the reference differentiates its chunked
    jnp scan).  The forward also writes the state at every chunk boundary
    (``bound_chunk`` steps); the backward walks the recurrence in reverse,
    re-running each chunk forward from its boundary.  On the card both are
    the CUDA kernels (``rwkv6_scan_cuda(return_bounds=True)``, then
    ``csrc/rwkv6_scan_bwd.cu``); on the CPU, or with ``impl="plain"``,
    ``ref.rwkv6_fwd_reference`` and ``ref.rwkv6_bwd_reference``.
    Returns (out, final state); either may go unused."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state, plain):
        ctx.set_materialize_grads(False)
        chunk = bound_chunk(r.shape[1])
        if plain:
            out, final, bounds = ref.rwkv6_fwd_reference(
                r, k, v, w, u, state, chunk=chunk)
        else:
            out, final, bounds = rwkv6_scan_cuda(r, k, v, w, u, state,
                                                 return_bounds=True)
        ctx.save_for_backward(r, k, v, w, u, bounds)
        ctx.plain, ctx.chunk = plain, chunk
        return out, final

    @staticmethod
    def backward(ctx, dout, dstate):
        r, k, v, w, u, bounds = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(r)
        bwd = ref.rwkv6_bwd_reference if ctx.plain else rwkv6_scan_bwd_cuda
        grads = bwd(r, k, v, w, u, bounds, _aligned(dout),
                    None if dstate is None else _aligned(dstate),
                    chunk=ctx.chunk)
        return (*grads, None)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x contiguous and 16-byte aligned (the kernels move rows in 16-byte
    vectors): itself when it is, else a copy."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _needs_grad(*xs: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


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
    window (None: none).  When autograd needs a gradient of q, k or v, the
    call runs through :class:`FlashAttention`."""
    plain = _plain(impl, q, "attention")
    if _needs_grad(q, k, v):
        b, skv = q.shape[0], k.shape[1]
        return FlashAttention.apply(
            q, k, v, causal, sm_scale, window,
            _per_row(skv if kv_len is None else kv_len, b, q.device),
            _per_row(q_offset, b, q.device), plain)
    kw = dict(causal=causal, sm_scale=sm_scale, window=window,
              kv_len=kv_len, q_offset=q_offset)
    if plain:
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
    x's dtype, accumulated in f32.  x may be one (C, D) matrix, broadcast
    over the experts (read through an expert stride of 0), or such a
    matrix already ``expand``-ed.  When autograd needs a gradient of x or
    w, the call runs through :class:`ExpertGemm`: give it the (C, D)
    matrix, so that its gradient is summed over the experts in the
    backward's product."""
    plain = _plain(impl, x, "expert gemm")
    if _needs_grad(x, w):
        return ExpertGemm.apply(x, w, plain)
    if x.dim() == 2:
        x = x.expand(w.shape[0], *x.shape)
    if plain:
        return ref.moe_gemm_reference(x, w)
    return expert_gemm_cuda(x, w)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, state: torch.Tensor, *,
               state_out: torch.Tensor | None = None,
               impl: str = "kernel") -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 WKV: r, k, v (B, T, H, N) in the compute dtype, w (B, T, H, N)
    float32 decays, u (H, N) float32, state (B, H, N, N) float32 ->
    (out (B, T, H, N) in r's dtype, final state float32).  The final state
    is written into ``state_out`` when given (it may be ``state``).  When
    autograd needs a gradient, the call runs through :class:`RWKV6Scan`,
    which takes no ``state_out``."""
    plain = _plain(impl, r, "rwkv6 scan")
    if _needs_grad(r, k, v, w, u, state):
        if state_out is not None:
            raise ValueError("rwkv6_scan: a differentiated scan returns "
                             "its final state (no state_out)")
        return RWKV6Scan.apply(r, k, v, w, u, state, plain)
    if plain:
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


def _chunked_recurrence(ref_fn, state: torch.Tensor,
                        time_args: tuple[torch.Tensor, ...],
                        other_args: tuple[torch.Tensor, ...], chunk: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Run a sequential recurrence chunk by chunk along axis 1, each chunk
    continuing from the last one's state: the chunks bound each chunk's
    (B, chunk, ...) buffers and, when autograd needs a gradient, each runs
    under ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``),
    so the backward keeps one state per chunk boundary and recomputes one
    chunk's steps at a time.  ``ref_fn(*chunk_args, *other_args, state)
    -> (out, state)``."""
    t = time_args[0].shape[1]
    if t <= chunk:
        return ref_fn(*time_args, *other_args, state)
    remat = _needs_grad(state, *time_args, *other_args)
    outs = []
    for s in range(0, t, chunk):
        args = (*(a[:, s:s + chunk] for a in time_args), *other_args, state)
        out, state = (checkpoint(ref_fn, *args, use_reentrant=False)
                      if remat else ref_fn(*args))
        outs.append(out)
    return torch.cat(outs, dim=1), state


def mamba_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
               state: torch.Tensor, *, chunk: int = 128
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba selective scan: x (B, T, Di) in the compute dtype, dt (B, T,
    Di) float32, a (Di, N) float32, b, c (B, T, N), d (Di,) float32, state
    (B, Di, N) float32 -> (y (B, T, Di) in x's dtype, final state float32),
    ``chunk`` steps at a time (the same numbers as one pass)."""
    def ref_reordered(x_, dt_, b_, c_, a_, d_, s_):
        return ref.mamba_scan_reference(x_, dt_, a_, b_, c_, d_, s_)

    return _chunked_recurrence(ref_reordered, state, (x, dt, b, c), (a, d),
                               chunk)
