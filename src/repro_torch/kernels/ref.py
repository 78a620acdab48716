"""Plain PyTorch versions of the kernels: the port of ``repro.kernels.ref``.

Full-precision softmax and products, no blocking, no page walk.  They are
what the CPU runs, what the tests hold against the JAX oracles, and what
``chip_smoke.py`` holds the Hopper kernels against on the card.
"""

from __future__ import annotations

import numpy as np
import torch

#: finite "minus infinity" of the kernels' online softmax (the copy of
#: ``repro.kernels.flash_jnp.NEG_INF``): a fully masked row keeps
#: ``exp(NEG_INF - NEG_INF) = 1`` for its rescale factor and a zero sum,
#: so it yields a zero output instead of a NaN
NEG_INF = -0.7 * float(np.finfo(np.float32).max)


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, sm_scale: float | None = None,
                  window: int | None = None,
                  kv_len: torch.Tensor | int | None = None,
                  q_offset: torch.Tensor | int = 0) -> torch.Tensor:
    """Naive full-softmax multi-head attention with GQA.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) with Hq a multiple of Hkv.
    ``window``: a key is visible only within ``window`` positions of its
    query (sliding-window attention).  ``kv_len``: scalar or (B,) valid
    (left-aligned) KV entries.  ``q_offset``: global position of q[0]
    relative to kv[0], a scalar or (B,).  Returns (B, Sq, Hq, D) in q's
    dtype; a row with no visible key is 0.
    """
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = sm_scale if sm_scale is not None else 1.0 / (d ** 0.5)
    dev = q.device

    qf = q.float().reshape(b, sq, hkv, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale

    qo = torch.as_tensor(q_offset, device=dev)
    qpos = qo.reshape(-1, 1) + torch.arange(sq, device=dev)  # (B|1, Sq)
    qpos = qpos.expand(b, sq)
    kpos = torch.arange(skv, device=dev)
    valid = torch.ones((b, sq, skv), dtype=torch.bool, device=dev)
    if causal:
        valid &= kpos[None, None, :] <= qpos[:, :, None]
    if window is not None:
        valid &= (qpos[:, :, None] - kpos[None, None, :]) < window
    if kv_len is not None:
        kl = torch.as_tensor(kv_len, device=dev).reshape(-1).expand(b)
        valid &= kpos[None, None, :] < kl[:, None, None]
    s = s.masked_fill(~valid[:, None, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)  # fully-masked rows
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(b, sq, hq, d).to(q.dtype)


def paged_gather(pool: torch.Tensor, page_table: torch.Tensor
                 ) -> torch.Tensor:
    """(P, Hkv, ps, ...) pool + (B, max_pages) table ->
    (B, max_pages*ps, Hkv, ...) linearized per-request view.

    The single definition of the page linearization on the port's plain
    path; out-of-range page ids clamp into the pool, as the reference's
    ``mode="clip"`` gather does."""
    b, mp = page_table.shape
    idx = page_table.reshape(-1).long().clamp(0, pool.shape[0] - 1)
    g = pool.index_select(0, idx)
    g = g.reshape((b, mp) + tuple(pool.shape[1:]))  # (B, mp, Hkv, ps, ...)
    g = g.transpose(2, 3)  # (B, mp, ps, Hkv, ...)
    return g.reshape((b, mp * pool.shape[2], pool.shape[1])
                     + tuple(pool.shape[3:]))


def paged_decode_reference(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           lengths: torch.Tensor, *,
                           sm_scale: float | None = None) -> torch.Tensor:
    """Paged decode, the plain way: gather each slot's pages into a linear
    (B, max_pages * page_size, Hkv, D) view, then masked decode attention.
    q: (B, 1, Hq, D); k_pool, v_pool: (P, Hkv, page_size, D); page_table:
    (B, max_pages) int32; lengths: (B,) valid KV tokens.  Returns
    (B, 1, Hq, D)."""
    return mha_reference(q, paged_gather(k_pool, page_table),
                         paged_gather(v_pool, page_table), causal=True,
                         sm_scale=sm_scale, kv_len=lengths,
                         q_offset=lengths.long() - 1)


def ragged_pack_indices(q_start: torch.Tensor, q_len: torch.Tensor,
                        n_tokens: int, max_q: int) -> torch.Tensor:
    """(T,) indices mapping each packed token to its row in an
    (S, max_q)-padded segment-major layout.

    ``q_start`` must be nondecreasing.  Tokens in packing gaps clamp inside
    their segment and pick up finite but unspecified values; callers mask
    by segment."""
    qs = q_start.long()
    t = torch.arange(n_tokens, device=qs.device)
    seg = torch.searchsorted(qs, t, right=True) - 1
    seg = seg.clamp(0, qs.shape[0] - 1)
    off = (t - qs[seg]).clamp(0, max_q - 1)
    return seg * max_q + off


def ragged_paged_reference(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, seg_page_table: torch.Tensor,
                           q_start: torch.Tensor, q_len: torch.Tensor,
                           kv_len: torch.Tensor, *, max_q: int,
                           sm_scale: float | None = None) -> torch.Tensor:
    """Ragged paged attention, the plain way: per segment, gather its pages
    into a linear view and run causal attention with ``kv_len`` masking and
    ``q_offset = kv_len - q_len``, then re-pack the segment outputs to the
    token-packed layout.

    q: (T, Hq, D) packed; k_pool, v_pool: (P, Hkv, page_size, D);
    seg_page_table: (S, max_pages) int32; q_start/q_len/kv_len: (S,).
    Returns (T, Hq, D)."""
    t = q.shape[0]
    s_count = seg_page_table.shape[0]
    qp = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, max_q))
    # a fixed-width window from each segment start (start clamped so the
    # window stays inside the padded batch, as a dynamic slice does)
    start = q_start.long().clamp(0, t)
    rows = start[:, None] + torch.arange(max_q, device=q.device)
    q_seg = qp[rows]  # (S, max_q, Hq, D)
    ka = paged_gather(k_pool, seg_page_table)
    va = paged_gather(v_pool, seg_page_table)
    o = mha_reference(q_seg, ka, va, causal=True, sm_scale=sm_scale,
                      kv_len=kv_len, q_offset=kv_len.long() - q_len.long())
    flat = o.reshape((s_count * max_q,) + tuple(o.shape[2:]))
    idx = ragged_pack_indices(q_start, q_len, t, max_q)
    return flat[idx].to(q.dtype)


def moe_gemm_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-expert batched GEMM: (E, C, D) @ (E, D, F) -> (E, C, F), an f32
    einsum cast back to x's dtype."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


def rwkv6_reference(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor, state: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 WKV recurrence, sequential over time in f32.

    r, k, v: (B, T, H, N); w: (B, T, H, N) data-dependent decay in (0, 1);
    u: (H, N) bonus; state: (B, H, N, N) mapping the k-dim to the v-dim.
    Returns (out (B, T, H, N) in r's dtype, final state (B, H, N, N) f32):

      out_t  = r_t . (state + u * k_t^T v_t)
      state' = diag(w_t) state + k_t^T v_t
    """
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()
    s = state.float()
    outs = []
    for t in range(r.shape[1]):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]  # (B, H, N, N)
        outs.append(torch.einsum("bhk,bhkn->bhn", rf[:, t],
                                 s + uf[:, :, None] * kv))
        s = wf[:, t, :, :, None] * s + kv
    out = torch.stack(outs, dim=1) if outs else torch.zeros_like(rf)
    return out.to(r.dtype), s
