"""State-space mixers: Mamba (the selective scan) and RWKV-6 (Finch), the
port of ``repro.models.ssm``.

Both carry constant-size state per request.  A Mamba layer's
(:class:`MambaCache`) is the last K-1 *pre-conv* inputs of its depthwise
causal conv, in the compute dtype, and the (Di, N) f32 SSM state; its
selective scan runs through :func:`repro_torch.kernels.ops.mamba_scan`
(plain PyTorch on every device: the reference's scan is jnp, not Pallas).
An RWKV-6 layer's (:class:`RWKVCache`) is the previous token's normed
features for each of its two token shifts and the (H, N, N) f32 WKV state;
its recurrence runs through :func:`repro_torch.kernels.ops.rwkv6_scan`
(the Hopper kernel on the card).

The RWKV-6 block copies the reference's, quirks included (ROADMAP section
3): ``ln_x`` is an RMSNorm over the whole width (the reference's comment
says "per-head group norm"), the token-shift mixes are static vectors with
a single decay LoRA, and the shift caches hold the *normed* last features
``h[:, -1:]`` and ``h2[:, -1:]``.  The reference's init leaves the mixes
and the bonus ``u_bonus`` at zero; tests that mean to exercise the token
shift and the bonus overwrite them with seeded draws.

Unlike the reference, whose arrays are immutable, both blocks write their
new state into the cache in place: every row, or with ``mask`` only the
rows it selects (the two-dispatch prefill's rows at other chunk widths
keep theirs bit for bit, as the reference's masked ``jnp.where`` keeps
them).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..core.modelspec import ModelSpec
from ..kernels import ops as kops
from ..kernels.ref import softplus
from .common import dense_init_, rms_norm, weight


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

@dataclass
class MambaCache:
    """Per-layer Mamba state: ``conv`` is (B, K-1, Di) in the compute
    dtype (the last pre-conv inputs), ``ssm`` is (B, Di, N) float32."""
    conv: torch.Tensor
    ssm: torch.Tensor


def _dt_rank(spec: ModelSpec) -> int:
    return max(spec.ssm.d_inner(spec.d_model) // 16, 1)


def init_mamba_cache(spec: ModelSpec, batch: int, device,
                     dtype) -> MambaCache:
    s = spec.ssm
    di = s.d_inner(spec.d_model)
    return MambaCache(
        conv=torch.zeros((batch, s.d_conv - 1, di), device=device,
                         dtype=dtype),
        ssm=torch.zeros((batch, di, s.d_state), device=device,
                        dtype=torch.float32))


class Mamba(nn.Module):
    """Mamba mixer parameters under the reference's names and inits
    (``init_mamba``), (in, out) weights.  ``a_log`` (log 1..N per channel)
    and ``d_skip`` stay float32 whatever the model's dtype, as the
    reference keeps them."""

    def __init__(self, spec: ModelSpec, device, dtype):
        super().__init__()
        s = spec.ssm
        d, di, n = spec.d_model, s.d_inner(spec.d_model), s.d_state
        dtr = _dt_rank(spec)
        self.norm = weight((d,), device, dtype, fill=1.0)
        self.in_proj = weight((d, 2 * di), device, dtype)
        self.conv_w = weight((s.d_conv, di), device, dtype)
        self.conv_b = weight((di,), device, dtype, fill=0.0)
        self.x_proj = weight((di, dtr + 2 * n), device, dtype)
        self.dt_w = weight((dtr, di), device, dtype)
        self.dt_bias = weight((di,), device, dtype, fill=-4.6)
        self.a_log = weight((di, n), device, torch.float32)
        self.d_skip = weight((di,), device, torch.float32, fill=1.0)
        self.out_proj = weight((di, d), device, dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for name in ("in_proj", "conv_w", "x_proj", "dt_w", "out_proj"):
            dense_init_(getattr(self, name), generator)
        n = self.a_log.shape[1]
        self.a_log.copy_(torch.arange(1, n + 1, dtype=torch.float32,
                                      device=self.a_log.device).log())


def _causal_conv(x: torch.Tensor, prev: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv along time, summed tap by tap in x's dtype as
    the reference sums it.  x: (B, S, Di); prev: (B, K-1, Di) -> (out
    (B, S, Di), the new K-1 last inputs)."""
    k, s = w.shape[0], x.shape[1]
    xp = torch.cat([prev.to(x.dtype), x], dim=1)  # (B, S+K-1, Di)
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    new_prev = xp[:, -(k - 1):] if k > 1 else prev
    return out + b, new_prev


def _commit_state(dst_src: list[tuple[torch.Tensor, torch.Tensor]],
                  mask: torch.Tensor | None) -> None:
    """Write each new state into its cache tensor in place: every row, or
    with the (B,) bool ``mask`` only the rows it selects (``torch.where``;
    the other rows keep theirs bit for bit)."""
    for dst, src in dst_src:
        src = src.to(dst.dtype)
        if mask is not None:
            sel = mask.reshape((-1,) + (1,) * (dst.dim() - 1))
            src = torch.where(sel, src, dst)
        dst.copy_(src)


def mamba_block(spec: ModelSpec, params: Mamba, x: torch.Tensor,
                cache: MambaCache | None = None, *,
                mask: torch.Tensor | None = None) -> torch.Tensor:
    """x: (B, T, D) continuing each row from its state in ``cache`` (None:
    a full pass from zero state, nothing kept).  Returns the mixer's
    output, before the residual add; the new conv inputs and SSM state go
    into ``cache`` for the rows ``mask`` selects (None: every row)."""
    s = spec.ssm
    b, _, d = x.shape
    di, n = s.d_inner(d), s.d_state
    dtr = _dt_rank(spec)

    h = rms_norm(x, params.norm)
    xin, z = (h @ params.in_proj).chunk(2, dim=-1)
    prev = cache.conv if cache is not None else \
        x.new_zeros((b, s.d_conv - 1, di))
    xc, new_prev = _causal_conv(xin, prev, params.conv_w, params.conv_b)
    xc = F.silu(xc)

    proj = xc @ params.x_proj
    dt_raw = proj[..., :dtr]
    bmat = proj[..., dtr:dtr + n]
    cmat = proj[..., dtr + n:]
    dt = softplus(dt_raw @ params.dt_w + params.dt_bias.float())
    a = -torch.exp(params.a_log)
    state = cache.ssm if cache is not None else \
        torch.zeros((b, di, n), device=x.device, dtype=torch.float32)
    y, new_state = kops.mamba_scan(xc, dt, a, bmat, cmat, params.d_skip,
                                   state)
    out = (y * F.silu(z)) @ params.out_proj
    if cache is not None:
        _commit_state([(cache.conv, new_prev), (cache.ssm, new_state)],
                      mask)
    return out


# ---------------------------------------------------------------------------
# RWKV-6
# ---------------------------------------------------------------------------

#: rank of the decay LoRA (the reference's ``lo``)
DECAY_LORA = 64

#: the token-shift mixes, zero in the reference's init
MIXES = ("maa_r", "maa_k", "maa_v", "maa_g", "maa_w", "cm_maa_r",
         "cm_maa_k")


@dataclass
class RWKVCache:
    """Per-layer RWKV state: ``tm_shift``/``cm_shift`` are (B, 1, D) in the
    compute dtype, ``wkv`` is (B, H, N, N) float32."""
    tm_shift: torch.Tensor
    cm_shift: torch.Tensor
    wkv: torch.Tensor


def init_rwkv_cache(spec: ModelSpec, batch: int, device,
                    dtype) -> RWKVCache:
    d, hs = spec.d_model, spec.ssm.head_size
    return RWKVCache(
        tm_shift=torch.zeros((batch, 1, d), device=device, dtype=dtype),
        cm_shift=torch.zeros((batch, 1, d), device=device, dtype=dtype),
        wkv=torch.zeros((batch, d // hs, hs, hs), device=device,
                        dtype=torch.float32))


class RWKV6(nn.Module):
    """RWKV-6 parameters under the reference's names and inits, (in, out)
    weights.  ``w_bias`` (the base decay, -2) and ``u_bonus`` stay float32
    whatever the model's dtype, as the reference keeps them, so the decay
    keeps its precision."""

    def __init__(self, spec: ModelSpec, device, dtype):
        super().__init__()
        d, ff = spec.d_model, spec.d_ff
        hs = spec.ssm.head_size
        for name in ("norm_tm", "ln_x", "norm_cm"):
            setattr(self, name, weight((d,), device, dtype, fill=1.0))
        for name in MIXES:
            setattr(self, name, weight((d,), device, dtype, fill=0.0))
        for name in ("wr", "wk", "wv", "wg", "wo", "cm_rec"):
            setattr(self, name, weight((d, d), device, dtype))
        self.w_lora1 = weight((d, DECAY_LORA), device, dtype)
        self.w_lora2 = weight((DECAY_LORA, d), device, dtype)
        self.w_bias = weight((d,), device, torch.float32, fill=-2.0)
        self.u_bonus = weight((d // hs, hs), device, torch.float32, fill=0.0)
        self.cm_key = weight((d, ff), device, dtype)
        self.cm_value = weight((ff, d), device, dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for name in ("wr", "wk", "wv", "wg", "w_lora1", "w_lora2", "wo",
                     "cm_key", "cm_rec", "cm_value"):
            dense_init_(getattr(self, name), generator)


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Previous-token features: concat(prev, x[:, :-1])."""
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)


def _commit(cache: RWKVCache, mask: torch.Tensor | None,
            tm_shift: torch.Tensor, cm_shift: torch.Tensor,
            wkv: torch.Tensor | None) -> None:
    """Write the new RWKV state into the cache's own tensors for the rows
    ``mask`` selects (None: every row).  ``wkv`` None: the scan already
    wrote the WKV state in place."""
    pairs = [(cache.tm_shift, tm_shift), (cache.cm_shift, cm_shift)]
    if wkv is not None:
        pairs.append((cache.wkv, wkv))
    _commit_state(pairs, mask)


def rwkv6_block(spec: ModelSpec, params: RWKV6, x: torch.Tensor,
                cache: RWKVCache | None = None, *,
                mask: torch.Tensor | None = None,
                impl: str = "kernel") -> torch.Tensor:
    """x: (B, T, D) continuing each row from its state in ``cache`` (None:
    a full pass from zero state, nothing kept).  Applies BOTH residuals
    itself (the channel mix is the layer's FFN) and returns the layer's
    output; the new state goes into ``cache`` for the rows the (B,) bool
    ``mask`` selects (None: every row), as the reference's masked
    ``jnp.where`` keeps the others."""
    b, t, d = x.shape
    hs = spec.ssm.head_size
    nh = d // hs
    keep = cache is not None
    if not keep:
        cache = init_rwkv_cache(spec, b, x.device, x.dtype)

    # ---- time mix -------------------------------------------------------
    h = rms_norm(x, params.norm_tm)
    sx = _token_shift(h, cache.tm_shift) - h

    def mix(m: torch.Tensor) -> torch.Tensor:
        return h + sx * m

    r = (mix(params.maa_r) @ params.wr).reshape(b, t, nh, hs)
    k = (mix(params.maa_k) @ params.wk).reshape(b, t, nh, hs)
    v = (mix(params.maa_v) @ params.wv).reshape(b, t, nh, hs)
    g = mix(params.maa_g) @ params.wg
    # data-dependent decay, in f32: low-rank per-channel
    w_dyn = torch.tanh(mix(params.maa_w) @ params.w_lora1) @ params.w_lora2
    w = torch.exp(-torch.exp(params.w_bias + w_dyn.float()))
    w = w.reshape(b, t, nh, hs)
    # unmasked, the scan writes its final state into the cache; masked, it
    # returns the new state for _commit to select; a full pass writes none
    # (autograd keeps the initial state the scan read)
    wkv, state = kops.rwkv6_scan(
        r, k, v, w, params.u_bonus, cache.wkv,
        state_out=cache.wkv if keep and mask is None else None, impl=impl)
    # the reference's ln_x: an RMSNorm over the whole width
    wkv = rms_norm(wkv.reshape(b, t, d), params.ln_x)
    x = x + (wkv * F.silu(g)) @ params.wo

    # ---- channel mix ----------------------------------------------------
    h2 = rms_norm(x, params.norm_cm)
    sx2 = _token_shift(h2, cache.cm_shift) - h2
    kx = h2 + sx2 * params.cm_maa_k
    rx = h2 + sx2 * params.cm_maa_r
    kk = F.relu(kx @ params.cm_key).square()
    y_cm = torch.sigmoid(rx @ params.cm_rec) * (kk @ params.cm_value)

    if keep:
        _commit(cache, mask, h[:, -1:], h2[:, -1:],
                None if mask is None else state)
    return x + y_cm
