"""Public kernel API: route each call to the Hopper kernel or its plain
version (the port of ``repro.kernels.ops``).

  ragged_paged_attention : token-packed mixed decode + prefill attention
                           against the paged pools

``impl="kernel"`` (the default) launches the CUDA kernel for tensors on the
card and takes the plain version only for tensors on the CPU; it never
falls back from a failed launch.  ``impl="plain"`` selects the plain
version on any device, explicitly (``chip_smoke.py`` uses it to hold the
kernel's serving outputs against the plain path on the card).
"""

from __future__ import annotations

import torch

from . import ref
from .ragged_attention import ragged_paged_attention_cuda

IMPLS = ("kernel", "plain")


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
    if impl not in IMPLS:
        raise ValueError(f"unknown ragged paged impl {impl!r}; have {IMPLS}")
    if impl == "plain" or q.device.type == "cpu":
        return ref.ragged_paged_reference(q, k_pool, v_pool, seg_page_table,
                                          q_start, q_len, kv_len,
                                          max_q=max_q, sm_scale=sm_scale)
    return ragged_paged_attention_cuda(q, k_pool, v_pool, seg_page_table,
                                       q_start, q_len, kv_len, max_q=max_q,
                                       sm_scale=sm_scale)
