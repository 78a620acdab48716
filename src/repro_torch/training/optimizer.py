"""AdamW with global-norm clipping and a warmup + cosine schedule (the port
of ``repro.training.optimizer``).

The state mirrors the parameters: ``{"m": {name: f32}, "v": {name: f32},
"step": int}``, m and v in float32 whatever the parameter's dtype.  The
reference's semantics, exactly:

  * the step count starts at 1 for the first update;
  * the learning rate warms up linearly over ``warmup_steps``, then falls
    on a cosine to ``min_lr_frac`` of ``lr`` at ``total_steps``;
  * every gradient is scaled by ``min(1, grad_clip / (norm + 1e-9))`` of
    the global norm of all of them (in float32);
  * bias-corrected moments, and weight decay decoupled from them, only on
    parameters of two or more dimensions in the reference's layout
    (:func:`reference_decay`: a layer's vectors count the stack's axis);
  * the update is applied in float32 and cast back to the parameter's
    dtype.

Unlike the reference, whose arrays are immutable, ``update`` writes the
parameters, m and v in place (no second copy of the model and its state)
and returns them.  Nothing in it reads a value back to the host: the
clip scale stays a device tensor, and the learning rate is a function of
the host's step count alone.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


@dataclass(frozen=True)
class Optimizer:
    config: AdamWConfig
    init: Callable[[dict[str, torch.Tensor]], dict[str, Any]]
    update: Callable[..., tuple[dict[str, torch.Tensor], dict[str, Any]]]


def _schedule(cfg: AdamWConfig, step: int) -> float:
    """The learning rate of update ``step`` (from 1), in float32 as the
    reference computes it."""
    f32 = np.float32
    warm = np.minimum(f32(step) / f32(max(cfg.warmup_steps, 1)), f32(1.0))
    prog = np.clip((f32(step) - f32(cfg.warmup_steps))
                   / f32(max(cfg.total_steps - cfg.warmup_steps, 1)),
                   f32(0.0), f32(1.0))
    cos = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * prog))
    frac = f32(cfg.min_lr_frac) + (f32(1) - f32(cfg.min_lr_frac)) * cos
    return float(f32(cfg.lr) * warm * frac)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in float32 (a device
    scalar)."""
    leaves = list(tensors.values()) if isinstance(tensors, dict) \
        else list(tensors)
    sums = torch.stack([x.float().square().sum() for x in leaves])
    return sums.sum().sqrt()


def reference_decay(params: dict[str, torch.Tensor]) -> dict[str, bool]:
    """Which parameters the reference's AdamW decays: ``ndim >= 2`` in the
    reference's layout, where every parameter of a model's layer (named
    ``layers.*`` in the port) carries the stack's leading ``repeats`` axis
    (``init_stack`` stacks them even for one repeat).  So a layer's norm
    scales and biases are decayed as well, and only the model's top-level
    vectors (the final norm) are exempt (ROADMAP section 3)."""
    return {n: p.dim() + n.startswith("layers.") >= 2
            for n, p in params.items()}


#: elements of a leaf updated at once: a larger leaf is updated in blocks
#: of rows, so the update's f32 temporaries stay small (jamba-v0.1-52b's
#: expert matrices hold 940 M elements, 3.8 GB each temporary in f32)
UPDATE_BLOCK = 1 << 26


def _row_blocks(p: torch.Tensor) -> list:
    """Index blocks along ``p``'s first axis of at most UPDATE_BLOCK
    elements each (one row at least; the whole leaf when it is small or
    a scalar).  The update is elementwise, so the blocks give the same
    numbers as one pass."""
    if p.dim() == 0 or p.numel() <= UPDATE_BLOCK:
        return [...]
    rows = max(1, UPDATE_BLOCK // (p.numel() // p.shape[0]))
    return [slice(i, i + rows) for i in range(0, p.shape[0], rows)]


def adamw(config: AdamWConfig = AdamWConfig()) -> Optimizer:
    def init(params: dict[str, torch.Tensor]) -> dict[str, Any]:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32,
                               device=p.device)
        return {"m": {n: zeros(p) for n, p in params.items()},
                "v": {n: zeros(p) for n, p in params.items()},
                "step": 0}

    @torch.no_grad()
    def update(grads: dict[str, torch.Tensor], state: dict[str, Any],
               params: dict[str, torch.Tensor], norm: Callable | None = None
               ) -> tuple[dict[str, torch.Tensor], dict[str, Any]]:
        """``norm``: the gradients' global norm as a function of them
        (default :func:`global_norm`; a mesh rank's gradients are slices,
        whose squares the trainer sums over the ranks)."""
        step = state["step"] + 1
        lr = _schedule(config, step)
        total = (norm or global_norm)(grads)
        scale = torch.clamp(config.grad_clip / (total + 1e-9), max=1.0)
        b1, b2 = config.b1, config.b2
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(step))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(step))
        decay = reference_decay(params)
        for name, p in params.items():
            for rows in _row_blocks(p):
                m, v = state["m"][name][rows], state["v"][name][rows]
                g = grads[name][rows].float() * scale
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).add_(g.square(), alpha=1 - b2)
                delta = (m / bc1) / ((v / bc2).sqrt() + config.eps)
                pf = p[rows].float()
                if decay[name]:  # matrices only (norms/bias exempt)
                    delta = delta + config.weight_decay * pf
                p[rows] = pf - lr * delta
        state["step"] = step
        return params, state

    return Optimizer(config=config, init=init, update=update)
