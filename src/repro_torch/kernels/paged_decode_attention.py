"""Paged decode attention on Hopper: the wrapper of
``csrc/paged_decode_attention.cu``.

Replaces the Pallas TPU kernel ``_paged_decode_kernel`` behind
``pallas_paged_decode_attention`` (``src/repro/kernels/decode_attention.py``
:141 and :190), the two-dispatch engine's paged decode attention: one
query per slot against the pages its table row names.

What bounds it on the H100: bytes, every live page's K and V once per
step.  What the design does about it: the page walk of each (slot, KV
head) is split over blocks of ``SPLIT_KEYS`` key positions, so a decode
step of 8 slots fills the card instead of 64 blocks; each block writes a
partial (m, l, acc) into f32 scratch this wrapper allocates, and a second
small kernel combines them.  Blocks past a slot's length return at once.

``launches`` counts calls that reach the card (the split and the combine
kernel are one call); ``chip_smoke.py`` reads it.  A CPU tensor is
refused here: :mod:`repro_torch.kernels.ops` routes CPU tensors to the
plain version.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

SOURCE = "src/repro_torch/csrc/paged_decode_attention.cu"
REPLACES = "src/repro/kernels/decode_attention.py:141"  # _paged_decode_kernel

#: key positions one block of the split walks (a multiple of the kernel's
#: 32-key tile)
SPLIT_KEYS = 128

#: kernel calls since import (or since a caller reset it to 0)
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ((ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 9
             + (ctypes.c_float, ctypes.c_void_p))


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_decode_attention (CUDA): {msg}")


def paged_decode_attention_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor,
                                page_table: torch.Tensor,
                                lengths: torch.Tensor, *,
                                sm_scale: float | None = None
                                ) -> torch.Tensor:
    """q: (B, 1, Hq, D); k_pool, v_pool: the resident (P, Hkv, page_size, D)
    pools; page_table: (B, max_pages) int32 (0 = the null page); lengths:
    (B,) int32 valid KV tokens per slot, the token just written included.
    Returns (B, 1, Hq, D); a slot with length 0 gets zeros."""
    global launches
    tensors = (q, k_pool, v_pool, page_table, lengths)
    _check(all(t.device.type == "cuda" for t in tensors),
           "every tensor must lie on the card (the CPU takes the plain "
           "version through repro_torch.kernels.ops)")
    _check(all(t.device == q.device for t in tensors),
           "tensors on different devices")
    _check(q.dtype in _DTYPES, f"dtype {q.dtype} (float32 or bfloat16)")
    _check(k_pool.dtype == q.dtype and v_pool.dtype == q.dtype,
           "q, k_pool and v_pool must share one dtype")
    _check(q.dim() == 4 and q.shape[1] == 1 and k_pool.dim() == 4,
           "q (B,1,Hq,D), pools (P,Hkv,ps,D)")
    b, _, hq, d = q.shape
    n_pool, hkv, ps, dk = k_pool.shape
    _check(tuple(v_pool.shape) == tuple(k_pool.shape), "k/v pool shapes")
    _check(dk == d and hq % hkv == 0, "head dims / GQA grouping")
    _check(hq // hkv <= 16, f"{hq // hkv} query heads per KV head (<= 16)")
    _check(d % 8 == 0 and d <= 256, f"head dim {d} (a multiple of 8, <= 256)")
    _check(page_table.dim() == 2 and page_table.shape[0] == b,
           "page_table (B, max_pages)")
    _check(tuple(lengths.shape) == (b,), "lengths must be (B,)")
    _check(page_table.dtype == torch.int32 and lengths.dtype == torch.int32,
           "page_table and lengths must be int32")
    _check(all(t.is_contiguous() for t in tensors), "contiguous tensors")
    _check(q.data_ptr() % 16 == 0 and k_pool.data_ptr() % 16 == 0
           and v_pool.data_ptr() % 16 == 0, "16-byte aligned q and pools")
    scale = sm_scale if sm_scale is not None else 1.0 / (d ** 0.5)
    max_pages = page_table.shape[1]
    n_split = -(-(max_pages * ps) // SPLIT_KEYS)
    g = hq // hkv

    out = torch.empty_like(q)
    part = (b * hkv * n_split * g,)
    m_part = torch.empty(part, dtype=torch.float32, device=q.device)
    l_part = torch.empty(part, dtype=torch.float32, device=q.device)
    acc_part = torch.empty((part[0] * d,), dtype=torch.float32,
                           device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        fn = build.entry("paged_decode_attention",
                         "paged_decode_attention_launch", _ARGTYPES)
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 out.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
                 m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(),
                 b, hq, hkv, d, n_pool, ps, max_pages, SPLIT_KEYS,
                 _DTYPES[q.dtype], scale, stream)
        launches += 1
    if err != 0:
        raise RuntimeError(f"paged_decode_attention launch failed: CUDA "
                           f"error {err}")
    return out
