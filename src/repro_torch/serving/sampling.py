"""Token sampling: greedy / temperature / top-k / top-p (the port of
``repro.serving.sampling``).

  ``sample``       — one SamplingConfig for the whole batch.
  ``sample_slots`` — per-row sampling parameters as tensors, so one call
                     samples every engine segment even when requests mix
                     greedy and stochastic configs.

Greedy rows take the first maximal index, as the reference's argmax does.
Stochastic rows draw from an explicit ``torch.Generator`` (the engine owns
one); a generator and a JAX key give different streams, so only greedy
rows can equal the reference's token for token.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0  # 0 => disabled
    top_p: float = 1.0


def _categorical(lf: torch.Tensor, generator: torch.Generator | None
                 ) -> torch.Tensor:
    """One draw per row from softmax(lf) (Gumbel-max; -inf rows entries
    are never drawn)."""
    u = torch.rand(lf.shape, generator=generator, device=lf.device)
    gumbel = -torch.log(-torch.log(u.clamp_(min=1e-20)))
    return (lf + gumbel).argmax(dim=-1).to(torch.int32)


def sample(logits: torch.Tensor, cfg: SamplingConfig,
           generator: torch.Generator | None = None) -> torch.Tensor:
    """logits: (B, V) -> (B,) int32 token ids."""
    b = logits.shape[0]
    dev = logits.device
    return sample_slots(
        logits, torch.full((b,), cfg.temperature, device=dev),
        torch.full((b,), cfg.top_k, dtype=torch.int32, device=dev),
        torch.full((b,), cfg.top_p, device=dev), generator)


def sample_slots(logits: torch.Tensor, temperature: torch.Tensor,
                 top_k: torch.Tensor, top_p: torch.Tensor,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """Per-row sampling, one independent config per row.

    logits: (B, V); temperature/top_p: (B,) f32; top_k: (B,) int (0
    disables).  Returns (B,) int32.  Rows with temperature <= 0 are the
    greedy argmax."""
    v = logits.shape[-1]
    greedy = logits.argmax(dim=-1).to(torch.int32)

    lf = logits.float() / temperature.float().clamp(min=1e-8)[:, None]
    # top-k: kth-largest threshold per row (rows with top_k <= 0 keep all)
    desc = lf.sort(dim=-1, descending=True).values
    k_idx = (top_k.long() - 1).clamp(0, v - 1)
    kth = desc.gather(-1, k_idx[:, None])
    lf = lf.masked_fill((top_k[:, None] > 0) & (lf < kth), float("-inf"))
    # top-p (nucleus) over the top-k-filtered distribution
    desc = lf.sort(dim=-1, descending=True).values
    cum = torch.softmax(desc, dim=-1).cumsum(dim=-1)
    cutoff_idx = (cum < top_p[:, None]).sum(dim=-1).clamp(max=v - 1)
    cutoff = desc.gather(-1, cutoff_idx[:, None])
    lf = lf.masked_fill((top_p[:, None] < 1.0) & (lf < cutoff), float("-inf"))

    stochastic = _categorical(lf, generator)
    return torch.where(temperature <= 0.0, greedy, stochastic)
