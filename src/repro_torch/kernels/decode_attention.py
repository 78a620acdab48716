"""Dense decode attention on Hopper: the wrapper of
``csrc/decode_attention.cu``.

Replaces the Pallas TPU kernel ``_decode_kernel`` behind
``pallas_decode_attention`` (``src/repro/kernels/decode_attention.py`` :42
and :87): one query per row against a contiguous (B, T, Hkv, D) cache,
keys at or past ``lengths[b]`` masked.  As in the JAX package, no model
routes to it; :func:`repro_torch.kernels.ops.decode_attention` is its
entry point.

What bounds it on the H100: bytes, every row's valid K and V once.  What
the design does about it: the split-KV walk of the paged decode kernel,
with contiguous addressing: each (row, KV head) is split over blocks of
``SPLIT_KEYS`` key positions, so 8 rows fill the card instead of 64
blocks; each block writes a partial (m, l, acc) into f32 scratch this
wrapper allocates, and a second small kernel combines them.  Blocks past a
row's length return at once.

``launches`` counts calls that reach the card (the split and the combine
kernel are one call); ``chip_smoke.py`` reads it.  A CPU tensor is refused
here: :mod:`repro_torch.kernels.ops` routes CPU tensors to the plain
version.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

SOURCE = "src/repro_torch/csrc/decode_attention.cu"
REPLACES = "src/repro/kernels/decode_attention.py:42"  # _decode_kernel

#: key positions one block of the split walks (a multiple of the kernel's
#: 32-key tile)
SPLIT_KEYS = 128

#: kernel calls since import (or since a caller reset it to 0)
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ((ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 7
             + (ctypes.c_float, ctypes.c_void_p))


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"decode_attention (CUDA): {msg}")


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, lengths: torch.Tensor,
                          sm_scale: float | None = None) -> torch.Tensor:
    """q: (B, 1, Hq, D); k, v: (B, T, Hkv, D); lengths: (B,) int32 valid
    keys per row, the query's own included (it sits at lengths - 1).
    Returns (B, 1, Hq, D); a row with length 0 gets zeros."""
    global launches
    tensors = (q, k, v, lengths)
    _check(all(t.device.type == "cuda" for t in tensors),
           "every tensor must lie on the card (the CPU takes the plain "
           "version through repro_torch.kernels.ops)")
    _check(all(t.device == q.device for t in tensors),
           "tensors on different devices")
    _check(q.dtype in _DTYPES, f"dtype {q.dtype} (float32 or bfloat16)")
    _check(k.dtype == q.dtype and v.dtype == q.dtype,
           "q, k and v must share one dtype")
    _check(q.dim() == 4 and q.shape[1] == 1 and k.dim() == 4,
           "q (B,1,Hq,D), k and v (B,T,Hkv,D)")
    b, _, hq, d = q.shape
    _, t, hkv, dk = k.shape
    _check(tuple(v.shape) == tuple(k.shape) and k.shape[0] == b,
           "k/v shapes")
    _check(dk == d and hq % hkv == 0, "head dims / GQA grouping")
    _check(hq // hkv <= 16, f"{hq // hkv} query heads per KV head (<= 16)")
    _check(d % 8 == 0 and d <= 256, f"head dim {d} (a multiple of 8, <= 256)")
    _check(t > 0, "an empty cache")
    _check(tuple(lengths.shape) == (b,) and lengths.dtype == torch.int32,
           "lengths must be (B,) int32")
    _check(all(x.is_contiguous() for x in tensors), "contiguous tensors")
    _check(q.data_ptr() % 16 == 0 and k.data_ptr() % 16 == 0
           and v.data_ptr() % 16 == 0, "16-byte aligned q, k and v")
    scale = sm_scale if sm_scale is not None else 1.0 / (d ** 0.5)
    n_split = -(-t // SPLIT_KEYS)
    g = hq // hkv

    out = torch.empty_like(q)
    part = (b * hkv * n_split * g,)
    m_part = torch.empty(part, dtype=torch.float32, device=q.device)
    l_part = torch.empty(part, dtype=torch.float32, device=q.device)
    acc_part = torch.empty((part[0] * d,), dtype=torch.float32,
                           device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        fn = build.entry("decode_attention", "decode_attention_launch",
                         _ARGTYPES)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lengths.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
                 acc_part.data_ptr(), b, hq, hkv, d, t, SPLIT_KEYS,
                 _DTYPES[q.dtype], scale, stream)
        launches += 1
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: CUDA error "
                           f"{err}")
    return out
