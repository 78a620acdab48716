"""Batched per-expert GEMM on Hopper: the wrapper of ``csrc/expert_gemm.cu``.

Replaces the Pallas TPU kernel ``_gemm_kernel`` behind
``pallas_expert_gemm`` (``src/repro/kernels/moe_gemm.py`` :27 and :35),
the MoE FFN's hot loop: ``(E, C, D) @ (E, D, F) -> (E, C, F)`` with f32
accumulation and the output in x's dtype.

What bounds it on the H100: bytes.  At deepseek-moe-16b's serving shapes
every launch streams all 64 experts' (2048, 1408) matrices, 369 MB in
bf16, and does at most 97 GFLOP (a mixed step's 264 packed tokens).  What
the design does about it: each expert's weights stream from device memory
in 16-byte loads started one depth slab ahead of the products, and the
broadcast x of the single-device MoE is read from its one copy through an
expert stride of 0 (no (E, C, D) copy).  In bf16 the products run on the
tensor cores (``mma.sync``); in f32 on the CUDA cores.  wgmma, TMA and a
deeper pipeline are later work.

``launches`` counts calls that reach the card; ``chip_smoke.py`` reads it.
A CPU tensor is refused here: :mod:`repro_torch.kernels.ops` routes CPU
tensors to the plain version, :func:`repro_torch.kernels.ref
.moe_gemm_reference`.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

SOURCE = "src/repro_torch/csrc/expert_gemm.cu"
REPLACES = "src/repro/kernels/moe_gemm.py:27"  # _gemm_kernel

#: kernel calls since import (or since a caller reset it to 0)
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ((ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 4
             + (ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p))


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"expert_gemm (CUDA): {msg}")


def expert_gemm_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, D), contiguous or one (C, D) matrix ``expand``-ed over the
    experts (expert stride 0); w: (E, D, F) contiguous, x's dtype; D and F
    multiples of 8.  Returns (E, C, F) in x's dtype."""
    global launches
    _check(x.device.type == "cuda" and w.device.type == "cuda",
           "x and w must lie on the card (the CPU takes the plain version "
           "through repro_torch.kernels.ops)")
    _check(x.device == w.device, "x and w on different devices")
    _check(x.dtype in _DTYPES, f"dtype {x.dtype} (float32 or bfloat16)")
    _check(w.dtype == x.dtype, "x and w must share one dtype")
    _check(x.dim() == 3 and w.dim() == 3, "x (E, C, D), w (E, D, F)")
    e, c, d = x.shape
    _check(w.shape[0] == e and w.shape[1] == d,
           f"w {tuple(w.shape)} does not match x {tuple(x.shape)}")
    f = w.shape[2]
    _check(d % 8 == 0 and f % 8 == 0, f"D={d} and F={f} (multiples of 8)")
    _check(x.stride(2) == 1 and x.stride(1) == d
           and x.stride(0) in (0, c * d),
           f"x strides {x.stride()}: rows of D contiguous, expert stride "
           "C*D or 0 (broadcast)")
    _check(w.is_contiguous(), "w must be contiguous")
    _check(x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0,
           "16-byte aligned x and w")
    _check(e <= 65535 and -(-c // 64) <= 65535, "grid too large")
    out = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        fn = build.entry("expert_gemm", "expert_gemm_launch", _ARGTYPES)
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, d, f,
                 x.stride(0), _DTYPES[x.dtype], stream)
        launches += 1
    if err != 0:
        raise RuntimeError(f"expert_gemm launch failed: CUDA error {err}")
    return out
