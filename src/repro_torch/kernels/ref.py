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

    valid = attention_mask(b, sq, skv, causal=causal, window=window,
                           kv_len=kv_len, q_offset=q_offset, device=dev)
    s = s.masked_fill(~valid[:, None, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)  # fully-masked rows
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(b, sq, hq, d).to(q.dtype)


def attention_mask(b: int, sq: int, skv: int, *, causal: bool,
                   window: int | None,
                   kv_len: torch.Tensor | int | None,
                   q_offset: torch.Tensor | int,
                   device: torch.device) -> torch.Tensor:
    """(B, Sq, Skv) bool: may query i of row b (at position q_offset[b] +
    i) see key p?  p < kv_len[b]; p <= its position if causal; its
    position - p < window with a sliding window."""
    qo = torch.as_tensor(q_offset, device=device)
    qpos = qo.reshape(-1, 1) + torch.arange(sq, device=device)  # (B|1, Sq)
    qpos = qpos.expand(b, sq)
    kpos = torch.arange(skv, device=device)
    valid = torch.ones((b, sq, skv), dtype=torch.bool, device=device)
    if causal:
        valid &= kpos[None, None, :] <= qpos[:, :, None]
    if window is not None:
        valid &= (qpos[:, :, None] - kpos[None, None, :]) < window
    if kv_len is not None:
        kl = torch.as_tensor(kv_len, device=device).reshape(-1).expand(b)
        valid &= kpos[None, None, :] < kl[:, None, None]
    return valid


def _flash_operands(q, k, v, sm_scale):
    """The blockwise versions' common set-up: the compute dtype (float32,
    or float64 for float64 inputs), the scale, and q as (B, Hkv, G, Sq, D),
    k and v as (B, Hkv, Skv, D) in it."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    ct = torch.promote_types(q.dtype, torch.float32)
    scale = sm_scale if sm_scale is not None else 1.0 / (d ** 0.5)
    qf = q.to(ct).reshape(b, sq, hkv, g, d).permute(0, 2, 3, 1, 4)
    kf = k.to(ct).permute(0, 2, 1, 3)
    vf = v.to(ct).permute(0, 2, 1, 3)
    return ct, scale, qf, kf, vf


def flash_fwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        sm_scale: float | None = None,
                        window: int | None = None,
                        kv_len: torch.Tensor | int | None = None,
                        q_offset: torch.Tensor | int = 0,
                        block_kv: int = 128
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Blockwise flash forward returning the log-sum-exp: the port of
    ``flash_jnp._fwd_core``.  An online softmax over ``block_kv``-key
    blocks in float32 (float64 for float64 inputs), masked elements at the
    finite NEG_INF.  Same arguments as :func:`mha_reference`.  Returns (o
    (B, Sq, Hq, D) in q's dtype, lse (B, Hq, Sq) in the compute dtype,
    natural-log units of the scaled scores); a row with no visible key has
    o = 0 and lse = NEG_INF."""
    b, sq, hq, d = q.shape
    skv = k.shape[1]
    ct, scale, qf, kf, vf = _flash_operands(q, k, v, sm_scale)
    valid = attention_mask(b, sq, skv, causal=causal, window=window,
                           kv_len=kv_len, q_offset=q_offset,
                           device=q.device)[:, None, None]
    shape = qf.shape[:-1]  # (B, Hkv, G, Sq)
    m = torch.full(shape, NEG_INF, dtype=ct, device=q.device)
    l = torch.zeros(shape, dtype=ct, device=q.device)
    acc = torch.zeros(qf.shape, dtype=ct, device=q.device)
    for j0 in range(0, skv, block_kv):
        vm = valid[..., j0:j0 + block_kv]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf[:, :, j0:j0 + block_kv])
        s = torch.where(vm, s * scale, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None]) * vm
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqk,bhkd->bhgqd", p, vf[:, :, j0:j0 + block_kv])
        m = m_new
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = acc / l_safe[..., None]
    lse = m + torch.log(l_safe)
    o = o.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d)
    return (o.to(q.dtype).contiguous(),
            lse.reshape(b, hq, sq).contiguous())


def flash_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True,
                        sm_scale: float | None = None,
                        window: int | None = None,
                        kv_len: torch.Tensor | int | None = None,
                        q_offset: torch.Tensor | int = 0,
                        block_q: int = 128, block_kv: int = 128
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The FlashAttention-2 backward of the forward above: the port of
    ``flash_jnp._bwd_core``.  ``delta = rowsum(o do)``; P is recomputed
    from the saved ``lse`` (B, Hq, Sq); a dq sweep over query blocks
    (inner loop over key blocks) and a dk/dv sweep over key blocks (inner
    loop over query blocks), dk and dv summed over the G query heads of
    each KV head.  Returns (dq, dk, dv) in q's, k's and v's dtypes.

    A masked element's P is 0 whatever the row's lse (``where``, not the
    reference's ``exp(s - lse) * valid``), so a row with no visible key
    (lse = NEG_INF) has zero gradients where ``flash_jnp``'s product gives
    ``inf * 0 = NaN`` (ROADMAP section 3)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    ct, scale, qf, kf, vf = _flash_operands(q, k, v, sm_scale)
    of = o.to(ct).reshape(b, sq, hkv, g, d).permute(0, 2, 3, 1, 4)
    dof = do.to(ct).reshape(b, sq, hkv, g, d).permute(0, 2, 3, 1, 4)
    lsef = lse.to(ct).reshape(b, hkv, g, sq)
    delta = (of * dof).sum(dim=-1)  # (B, Hkv, G, Sq)
    valid = attention_mask(b, sq, skv, causal=causal, window=window,
                           kv_len=kv_len, q_offset=q_offset,
                           device=q.device)[:, None, None]

    def blocks(i0, j0):
        """P, dS of query block i0 against key block j0."""
        qs, ks = slice(i0, i0 + block_q), slice(j0, j0 + block_kv)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf[..., qs, :], kf[:, :, ks])
        p = torch.where(valid[..., qs, ks],
                        torch.exp(s * scale - lsef[..., qs, None]), 0.0)
        dp = torch.einsum("bhgqd,bhkd->bhgqk", dof[..., qs, :],
                          vf[:, :, ks])
        return p, p * (dp - delta[..., qs, None]) * scale

    dq = torch.zeros_like(qf)
    for i0 in range(0, sq, block_q):
        for j0 in range(0, skv, block_kv):
            _, ds = blocks(i0, j0)
            dq[..., i0:i0 + block_q, :] += torch.einsum(
                "bhgqk,bhkd->bhgqd", ds, kf[:, :, j0:j0 + block_kv])
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for j0 in range(0, skv, block_kv):
        for i0 in range(0, sq, block_q):
            p, ds = blocks(i0, j0)
            qs = slice(i0, i0 + block_q)
            dv[:, :, j0:j0 + block_kv] += torch.einsum(
                "bhgqk,bhgqd->bhkd", p, dof[..., qs, :])
            dk[:, :, j0:j0 + block_kv] += torch.einsum(
                "bhgqk,bhgqd->bhkd", ds, qf[..., qs, :])
    dq = dq.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d)
    return (dq.to(q.dtype).contiguous(),
            dk.permute(0, 2, 1, 3).to(k.dtype).contiguous(),
            dv.permute(0, 2, 1, 3).to(v.dtype).contiguous())


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


def expert_gemm_bwd_reference(x: torch.Tensor, w: torch.Tensor,
                              dy: torch.Tensor, *, need_x: bool = True,
                              need_w: bool = True
                              ) -> tuple[torch.Tensor | None,
                                         torch.Tensor | None]:
    """The gradient of :func:`moe_gemm_reference`: x (E, C, D), or one
    (C, D) matrix broadcast over the experts, w (E, D, F) and dy (E, C, F)
    -> (dx in x's shape and dtype, dw (E, D, F) in w's dtype), in f32,
    each None when not asked for.

      dW_e = X_e^T dY_e ;  dX_e = dY_e W_e^T

    A broadcast x's gradient is the sum over the experts, taken in one
    product ``[dY_1 .. dY_E] (C, E F) @ [W_1^T; ..; W_E^T] (E F, D)``."""
    dyf, wf, xf = dy.float(), w.float(), x.float()
    dx = dw = None
    if x.dim() == 2:
        e, c, f = dy.shape
        if need_x:
            dx = (dyf.permute(1, 0, 2).reshape(c, e * f)
                  @ wf.transpose(1, 2).reshape(e * f, wf.shape[1]))
        if need_w:
            dw = torch.einsum("cd,ecf->edf", xf, dyf)
    else:
        if need_x:
            dx = torch.einsum("ecf,edf->ecd", dyf, wf)
        if need_w:
            dw = torch.einsum("ecd,ecf->edf", xf, dyf)
    return (None if dx is None else dx.to(x.dtype),
            None if dw is None else dw.to(w.dtype))


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


def rwkv6_fwd_reference(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        w: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
                        *, chunk: int
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`rwkv6_reference` that also returns the state at every chunk
    boundary, as the forward kernel writes it for the backward: (out,
    final, bounds (B, ceil(T / chunk), H, N, N) f32), ``bounds[:, c]`` the
    state before step ``c * chunk``.  The same numbers as one pass."""
    outs, bounds, s = [], [], state.float()
    for t0 in range(0, r.shape[1], chunk):
        bounds.append(s)
        out, s = rwkv6_reference(*(x[:, t0:t0 + chunk] for x in (r, k, v, w)),
                                 u, s)
        outs.append(out)
    if not outs:
        return torch.zeros_like(r), s, s.new_zeros((s.shape[0], 0)
                                                   + tuple(s.shape[1:]))
    return torch.cat(outs, dim=1), s, torch.stack(bounds, dim=1)


def rwkv6_bwd_reference(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        w: torch.Tensor, u: torch.Tensor,
                        bounds: torch.Tensor, dout: torch.Tensor,
                        dstate: torch.Tensor | None, *, chunk: int
                        ) -> tuple[torch.Tensor, ...]:
    """The backward of the WKV recurrence, walked in reverse in f32 from
    the forward's chunk-boundary states (:func:`rwkv6_fwd_reference`):
    each chunk's states are recomputed forward from its boundary, never by
    dividing by a decay.  ``dout`` (B, T, H, N) is the output's gradient,
    ``dstate`` (B, H, N, N) the final state's (None: zero).  With S the
    state before step t and G the gradient of the state after it:

      dr_t[i] = sum_j dout_t[j] (S[i,j] + u_i k_t[i] v_t[j])
      dk_t[i] = r_t[i] u_i (dout_t . v_t) + sum_j G[i,j] v_t[j]
      dv_t[j] = dout_t[j] sum_i r_t[i] u_i k_t[i] + sum_i G[i,j] k_t[i]
      dw_t[i] = sum_j G[i,j] S[i,j]
      du[i]  += r_t[i] k_t[i] (dout_t . v_t)
      G       <- r_t^T dout_t + diag(w_t) G

    Returns (dr, dk, dv in r's, k's and v's dtypes; dw (B, T, H, N), du
    (H, N) and the initial state's gradient (B, H, N, N), f32)."""
    rf, kf, vf, wf, df = (x.float() for x in (r, k, v, w, dout))
    uf = u.float()
    b, _, h, n = r.shape
    g = (torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
         if dstate is None else dstate.float().clone())
    dr, dk, dv, dw = (torch.zeros_like(rf) for _ in range(4))
    du = torch.zeros_like(uf)
    for c in reversed(range(bounds.shape[1])):
        t0, t1 = c * chunk, min(r.shape[1], (c + 1) * chunk)
        states, s = [], bounds[:, c].float()
        for t in range(t0, t1):
            states.append(s)
            s = wf[:, t, :, :, None] * s \
                + kf[:, t, :, :, None] * vf[:, t, :, None, :]
        for t in reversed(range(t0, t1)):
            s = states[t - t0]
            rt, kt, vt, wt, dt = (x[:, t] for x in (rf, kf, vf, wf, df))
            dot = (dt * vt).sum(-1, keepdim=True)  # (B, H, 1)
            dr[:, t] = torch.einsum("bhij,bhj->bhi", s, dt) + uf * kt * dot
            dk[:, t] = torch.einsum("bhij,bhj->bhi", g, vt) + rt * uf * dot
            dv[:, t] = (dt * (rt * uf * kt).sum(-1, keepdim=True)
                        + torch.einsum("bhij,bhi->bhj", g, kt))
            dw[:, t] = (g * s).sum(-1)
            du += (rt * kt * dot).sum(0)
            g = rt[..., :, None] * dt[..., None, :] + wt[..., :, None] * g
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw, du, g)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` as the reference computes it,
    ``logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))`` (torch's own
    softplus switches to x above a threshold)."""
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


def mamba_scan_reference(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                         b: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
                         state: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba selective scan, sequential over time in f32.

    x, dt: (B, T, Di); a: (Di, N); b, c: (B, T, N); d: (Di,); state:
    (B, Di, N).  Discretization dA = exp(dt * A), dB = dt * B:

      h_t = dA_t * h_{t-1} + dB_t x_t ;  y_t = (C_t . h_t) + D x_t

    Returns (y (B, T, Di) in x's dtype, final state (B, Di, N) f32).  The
    discretized terms of every step are formed at once; only the
    recurrence ``h = dA_t * h + dBx_t`` steps, written in place into the
    (B, T, Di, N) buffer that held dBx, with the reference's rounding (a
    product, then a sum)."""
    xf, dtf, bf, cf = (t.float() for t in (x, dt, b, c))
    af, df = a.float(), d.float()
    da = torch.exp(dtf[..., None] * af)  # (B, T, Di, N)
    hs = (dtf * xf)[..., None] * bf[:, :, None, :]  # dBx, then h
    h = state.float()
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, a, b, c, d, state)):
        # out of place: autograd saves each step's h, which an in-place
        # step would overwrite (the same numbers: a product, then a sum)
        steps = []
        for t in range(x.shape[1]):
            h = hs[:, t] + da[:, t] * h
            steps.append(h)
        if steps:
            hs = torch.stack(steps, dim=1)
        y = torch.einsum("btdn,btn->btd", hs, cf) + df * xf
        return y.to(x.dtype), h
    for t in range(x.shape[1]):
        hs[:, t] += da[:, t] * h
        h = hs[:, t]
    y = torch.einsum("btdn,btn->btd", hs, cf) + df * xf
    return y.to(x.dtype), h.clone()
