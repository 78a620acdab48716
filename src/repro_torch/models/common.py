"""Shared building blocks: norms, RoPE, activations, inits (the port of
``repro.models.common``)."""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """Normalize in f32, cast back to x's dtype, then scale in that dtype
    (the reference's cast order)."""
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return y.to(dt) * scale.to(dt)


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "swiglu":  # the gate nonlinearity of SwiGLU
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":
        return lambda x: F.relu(x).square()
    raise ValueError(f"unknown activation {name!r}")


def rope_freqs(d_head: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, d_head, 2, dtype=np.float64)
                            / d_head))


@functools.lru_cache(maxsize=None)
def _inv_freqs(d_head: int, theta: float, device: torch.device
               ) -> torch.Tensor:
    """The (D/2,) f32 rotary frequencies on ``device``, uploaded once (from
    pinned memory on the card: a step that reads them copies nothing from
    the host, so it can be captured in a CUDA graph)."""
    inv = torch.from_numpy(rope_freqs(d_head, theta).astype(np.float32))
    if device.type == "cuda":
        inv = inv.pin_memory()
    return inv.to(device, non_blocking=True)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D) rotated by half-split pairs in f32; positions:
    broadcastable to x.shape[:-2] ending in S."""
    d = x.shape[-1]
    inv = _inv_freqs(d, theta, x.device)
    ang = positions[..., None].float() * inv  # (..., S, D/2)
    sin = ang.sin()[..., None, :]  # broadcast over heads
    cos = ang.cos()[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Initializers: N(0, 1) truncated to [-2, 2], scaled, drawn in f32 from an
# explicit generator (the reference's inits; not the reference's numbers —
# JAX keys and torch generators give different streams from one seed)
# ---------------------------------------------------------------------------

@torch.no_grad()
def _trunc_normal_(w: torch.Tensor, std: float,
                   generator: torch.Generator) -> None:
    tmp = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    torch.nn.init.trunc_normal_(tmp, 0.0, 1.0, -2.0, 2.0,
                                generator=generator)
    w.copy_(tmp.mul_(std))


def dense_init_(w: torch.Tensor, generator: torch.Generator,
                in_axis: int = 0) -> None:
    _trunc_normal_(w, 1.0 / float(np.sqrt(w.shape[in_axis])), generator)


def embed_init_(w: torch.Tensor, generator: torch.Generator) -> None:
    _trunc_normal_(w, 0.02, generator)


def weight(shape: tuple[int, ...], device, dtype, fill: float | None = None
           ) -> torch.nn.Parameter:
    """An inference parameter (no grad): uninitialized unless ``fill``."""
    t = torch.empty(shape, device=device, dtype=dtype)
    if fill is not None:
        t.fill_(fill)
    return torch.nn.Parameter(t, requires_grad=False)
