"""Shared building blocks: norms, RoPE, activations, inits (the port of
``repro.models.common``), and the tensor/pipeline-parallel geometry of one
rank's shard (:class:`Shard`, :func:`local_spec`, :data:`TP_SHARD_DIM`)."""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

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
    """Draw the whole tensor ``w`` is (or is a tensor-parallel slice of,
    see :func:`full_shape`) on the generator's device and keep ``w``'s
    slice: a shard draws what the unsharded model draws from the same
    generator, so both hold the same weights.  A ``meta`` tensor keeps
    nothing (a pipeline stage's draw of another stage's layer)."""
    tmp = torch.empty(full_shape(w), dtype=torch.float32,
                      device=generator.device)
    torch.nn.init.trunc_normal_(tmp, 0.0, 1.0, -2.0, 2.0,
                                generator=generator)
    if w.is_meta:
        return
    shard = getattr(w, "tp_shard", None)
    if shard is not None:
        dim, _, rank = shard
        tmp = tmp.narrow(dim, rank * w.shape[dim], w.shape[dim])
    w.copy_(tmp.mul_(std))


def dense_init_(w: torch.Tensor, generator: torch.Generator,
                in_axis: int = 0) -> None:
    _trunc_normal_(w, 1.0 / float(np.sqrt(full_shape(w)[in_axis])),
                   generator)


def embed_init_(w: torch.Tensor, generator: torch.Generator) -> None:
    _trunc_normal_(w, 0.02, generator)


def weight(shape: tuple[int, ...], device, dtype, fill: float | None = None
           ) -> torch.nn.Parameter:
    """An inference parameter (no grad): uninitialized unless ``fill``."""
    t = torch.empty(shape, device=device, dtype=dtype)
    if fill is not None:
        t.fill_(fill)
    return torch.nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------------------
# Tensor/pipeline-parallel shards (Megatron's plan, the reference's
# ``serving/sharded.py`` rules): column-parallel q/k/v and up/gate
# projections, row-parallel wo and w_down, a vocab-parallel untied head,
# the embedding and every norm replicated, contiguous layers per stage
# ---------------------------------------------------------------------------

#: parameter leaf name -> the axis tp splits it on (every other leaf is
#: replicated).  Heads are contiguous column blocks of d_head, so a rank's
#: columns are whole heads, and its kv heads are the ones its query
#: heads' groups read.
TP_SHARD_DIM = {"wq": 1, "wk": 1, "wv": 1, "bq": 0, "bk": 0, "bv": 0,
                "wo": 0, "w_up": 1, "w_gate": 1, "w_down": 0, "lm_head": 1}


@dataclasses.dataclass(frozen=True)
class Shard:
    """One rank's place in a (pp, tp) mesh of ``tp * pp`` ranks: rank
    ``pp_rank * tp + tp_rank`` holds tp slice ``tp_rank`` of the layers of
    pipeline stage ``pp_rank``.  ``comm`` runs the shard's collectives
    (:class:`repro_torch.serving.sharded.EngineMesh`: ``all_reduce_``,
    ``all_gather_last`` over the stage's tp ranks and ``pp_ring`` over the
    stages); None for a shard that is only built or loaded, never run."""
    tp: int = 1
    pp: int = 1
    tp_rank: int = 0
    pp_rank: int = 0
    comm: Any = None

    def stage_layers(self, n_layers: int) -> range:
        """The global indices of the layers this rank's stage holds."""
        per = n_layers // self.pp
        return range(self.pp_rank * per, (self.pp_rank + 1) * per)


def local_spec(spec, tp: int):
    """The per-rank model geometry a tp rank computes with (the
    reference's ``sharded.local_spec``): heads, kv heads and FFN width
    over tp."""
    if tp == 1:
        return spec
    return dataclasses.replace(spec, n_heads=spec.n_heads // tp,
                               n_kv_heads=spec.n_kv_heads // tp,
                               d_ff=spec.d_ff // tp)


def tag_tp_shards(module: torch.nn.Module, tp: int, tp_rank: int) -> None:
    """Mark every tp-sliced parameter of ``module`` with ``tp_shard = (dim,
    tp, tp_rank)``, which :func:`full_shape` and the inits read."""
    if tp == 1:
        return
    for name, p in module.named_parameters():
        dim = TP_SHARD_DIM.get(name.rsplit(".", 1)[-1])
        if dim is not None:
            p.tp_shard = (dim, tp, tp_rank)


def full_shape(w: torch.Tensor) -> tuple[int, ...]:
    """The unsharded shape of ``w`` (its own shape unless it is a tp
    slice)."""
    shape = list(w.shape)
    shard = getattr(w, "tp_shard", None)
    if shard is not None:
        dim, tp, _ = shard
        shape[dim] *= tp
    return tuple(shape)
