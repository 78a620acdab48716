"""Ragged paged attention on Hopper: the wrapper of
``csrc/ragged_paged_attention.cu``.

Replaces the Pallas TPU kernel ``_ragged_kernel`` behind
``pallas_ragged_paged_attention`` (``src/repro/kernels/ragged_attention.py``
:52 and :116), the unified serving step's attention over token-packed
mixed decode + prefill segments.

What bounds it on the H100: bytes.  The least the card can move is every
valid page's K and V (``kv_len`` tokens x Hkv x D per segment, both
pools) plus q and the output, against 3.35 TB/s; the attention's
operations (4 x D per query-key pair per query head) are far below the
989 TFLOP/s bf16 line at decode shapes.  What the design does about it:
each block walks only the pages below its causal bound, shares each staged
K/V tile across the G query heads of its KV head, and writes packed rows
straight into the output (no padded ``(S, max_q)`` buffer, no repack).
The rest is for later work: tensor-core products, double-buffered loads,
and a split over the key axis so decode segments fill all 132 SMs.

``launches`` counts kernel launches (one per call that reaches the card);
``chip_smoke.py`` reads it to show the main path went through the kernel.
A CPU tensor is refused here: the plain version lives in
:mod:`repro_torch.kernels.ref` and :mod:`repro_torch.kernels.ops` routes to
it only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

SOURCE = "src/repro_torch/csrc/ragged_paged_attention.cu"
REPLACES = "src/repro/kernels/ragged_attention.py:52"  # _ragged_kernel

#: kernel launches since import (or since a caller reset it to 0)
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ((ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 10
             + (ctypes.c_float, ctypes.c_void_p))


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ragged_paged_attention (CUDA): {msg}")


def ragged_paged_attention_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor,
                                seg_page_table: torch.Tensor,
                                q_start: torch.Tensor, q_len: torch.Tensor,
                                kv_len: torch.Tensor, *, max_q: int,
                                sm_scale: float | None = None
                                ) -> torch.Tensor:
    """q: (T, Hq, D) token-packed queries; k_pool, v_pool: the resident
    (P, Hkv, page_size, D) pools; seg_page_table: (S, max_pages) int32;
    q_start/q_len/kv_len: (S,) int32 segment table (q_start
    nondecreasing, kv_len counting this step's tokens); max_q: the widest
    segment.  Returns (T, Hq, D); rows outside every live segment are 0.
    """
    global launches
    tensors = (q, k_pool, v_pool, seg_page_table, q_start, q_len, kv_len)
    _check(all(t.device.type == "cuda" for t in tensors),
           "every tensor must lie on the card (the CPU takes the plain "
           "version through repro_torch.kernels.ops)")
    _check(all(t.device == q.device for t in tensors),
           "tensors on different devices")
    _check(q.dtype in _DTYPES, f"dtype {q.dtype} (float32 or bfloat16)")
    _check(k_pool.dtype == q.dtype and v_pool.dtype == q.dtype,
           "q, k_pool and v_pool must share one dtype")
    _check(q.dim() == 3 and k_pool.dim() == 4, "q (T,Hq,D), pools (P,Hkv,ps,D)")
    t, hq, d = q.shape
    n_pool, hkv, ps, dk = k_pool.shape
    _check(tuple(v_pool.shape) == tuple(k_pool.shape), "k/v pool shapes")
    _check(dk == d and hq % hkv == 0, "head dims / GQA grouping")
    _check(d % 8 == 0 and d <= 256, f"head dim {d} (a multiple of 8, <= 256)")
    _check(seg_page_table.dim() == 2, "seg_page_table (S, max_pages)")
    s_count, max_pages = seg_page_table.shape
    for name, x in (("seg_page_table", seg_page_table), ("q_start", q_start),
                    ("q_len", q_len), ("kv_len", kv_len)):
        _check(x.dtype == torch.int32, f"{name} must be int32")
    for name, x in (("q_start", q_start), ("q_len", q_len),
                    ("kv_len", kv_len)):
        _check(tuple(x.shape) == (s_count,), f"{name} must be (S,)")
    _check(all(x.is_contiguous() for x in tensors), "contiguous tensors")
    _check(max_q >= 1, "max_q >= 1")
    _check(q.data_ptr() % 16 == 0 and k_pool.data_ptr() % 16 == 0
           and v_pool.data_ptr() % 16 == 0, "16-byte aligned q and pools")
    scale = sm_scale if sm_scale is not None else 1.0 / (d ** 0.5)

    out = torch.zeros_like(q)
    if t == 0 or s_count == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        fn = build.entry("ragged_paged_attention",
                         "ragged_paged_attention_launch", _ARGTYPES)
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 out.data_ptr(), seg_page_table.data_ptr(),
                 q_start.data_ptr(), q_len.data_ptr(), kv_len.data_ptr(), t,
                 s_count, hq, hkv, d, n_pool, ps, max_pages, max_q,
                 _DTYPES[q.dtype], scale, stream)
        launches += 1
    if err != 0:
        raise RuntimeError(f"ragged_paged_attention launch failed: CUDA "
                           f"error {err}")
    return out
