"""Gradient compression, the single-device part (the port of
``repro.training.compression``): int8 chunk quantization with an f32 scale
per chunk (~3.9x fewer bytes on the wire), the quantize-dequantize round
trip, and error feedback (the quantization residual is added back into
the next step's gradient, 1-bit Adam style).

The reference's ``compressed_psum_grads``, the int8 all-reduce over the
data-parallel mesh axes, needs ranks and a mesh: it waits for
``DeviceMesh`` (ROADMAP item 15).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class CompressionConfig:
    chunk: int = 1024
    enabled: bool = True
    error_feedback: bool = True


def quantize_int8(x: torch.Tensor, chunk: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (flat) -> (int8 values (n_chunks, chunk), per-chunk f32 scales):
    absmax / 127 per chunk (0 maps to 1.0), values rounded half to even and
    clamped to [-127, 127], as the reference's."""
    n = x.shape[0]
    pad = (-n) % chunk
    xp = torch.nn.functional.pad(x, (0, pad)).reshape(-1, chunk)
    scale = xp.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.where(scale == 0, 1.0, scale)
    q = torch.round(xp / scale).clamp(-127, 127).to(torch.int8)
    return q, scale[:, 0]


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    n: int) -> torch.Tensor:
    x = q.float() * scale[:, None]
    return x.reshape(-1)[:n]


def compress_roundtrip(x: torch.Tensor, chunk: int = 1024) -> torch.Tensor:
    """Quantize + dequantize (what the wire sees); for error analysis."""
    flat = x.reshape(-1).float()
    q, s = quantize_int8(flat, chunk)
    return dequantize_int8(q, s, flat.shape[0]).reshape(x.shape)


class ErrorFeedback:
    """Residual accumulator over a dict of gradients:
    g_compressed = Q(g + e);  e += g - g_compressed."""

    def __init__(self, cfg: CompressionConfig = CompressionConfig()):
        self.cfg = cfg
        self.residual: dict[str, torch.Tensor] | None = None

    def __call__(self, grads: dict[str, torch.Tensor]
                 ) -> dict[str, torch.Tensor]:
        if not self.cfg.enabled:
            return grads
        if self.residual is None:
            self.residual = {n: torch.zeros_like(g, dtype=torch.float32)
                             for n, g in grads.items()}
        sent = {}
        for name, g in grads.items():
            corrected = g.float() + self.residual[name]
            out = compress_roundtrip(corrected, self.cfg.chunk)
            self.residual[name] = (corrected - out if self.cfg.error_feedback
                                   else torch.zeros_like(corrected))
            sent[name] = out.to(g.dtype)
        return sent
