"""RWKV-6 (Finch) time mix and channel mix: the RWKV half of
``repro.models.ssm``.

The block carries constant-size state per request (:class:`RWKVCache`):
the previous token's normed features for each of its two token shifts and
the (H, N, N) f32 WKV state.  The WKV recurrence runs through
:func:`repro_torch.kernels.ops.rwkv6_scan` (the Hopper kernel on the card).

The block copies the reference's, quirks included (ROADMAP section 3):
``ln_x`` is an RMSNorm over the whole width (the reference's comment says
"per-head group norm"), the token-shift mixes are static vectors with a
single decay LoRA, and the shift caches hold the *normed* last features
``h[:, -1:]`` and ``h2[:, -1:]``.  The reference's init leaves the mixes
and the bonus ``u_bonus`` at zero; tests that mean to exercise the token
shift and the bonus overwrite them with seeded draws.

Unlike the reference, whose arrays are immutable, the block writes its new
state into the cache in place.  Mamba is not ported yet (ROADMAP: queue 1,
item 13).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..core.modelspec import ModelSpec
from ..kernels import ops as kops
from .common import dense_init_, rms_norm, weight

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
    """Write the new state into the cache's own tensors: every row, or with
    ``mask`` only the rows it selects (``torch.where``; the other rows keep
    theirs bit for bit).  ``wkv`` None: the scan already wrote the WKV
    state in place."""
    pairs = [(cache.tm_shift, tm_shift), (cache.cm_shift, cm_shift)]
    if wkv is not None:
        pairs.append((cache.wkv, wkv))
    for dst, src in pairs:
        src = src.to(dst.dtype)
        if mask is not None:
            sel = mask.reshape((-1,) + (1,) * (dst.dim() - 1))
            src = torch.where(sel, src, dst)
        dst.copy_(src)


def rwkv6_block(spec: ModelSpec, params: RWKV6, x: torch.Tensor,
                cache: RWKVCache, *, mask: torch.Tensor | None = None,
                impl: str = "kernel") -> torch.Tensor:
    """x: (B, T, D) continuing each row from its state in ``cache``.
    Applies BOTH residuals itself (the channel mix is the layer's FFN) and
    returns the layer's output; the new state goes into ``cache`` for the
    rows the (B,) bool ``mask`` selects (None: every row), as the
    reference's masked ``jnp.where`` keeps the others."""
    b, t, d = x.shape
    hs = spec.ssm.head_size
    nh = d // hs

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
    # returns the new state for _commit to select
    wkv, state = kops.rwkv6_scan(
        r, k, v, w, params.u_bonus, cache.wkv,
        state_out=cache.wkv if mask is None else None, impl=impl)
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

    _commit(cache, mask, h[:, -1:], h2[:, -1:],
            None if mask is None else state)
    return x + y_cm
