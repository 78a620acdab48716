"""Flash attention forward on Hopper: the wrapper of
``csrc/flash_attention.cu``.

Replaces the forward of the Pallas TPU kernel ``_flash_kernel`` behind
``_pallas_fwd`` / ``pallas_flash_attention``
(``src/repro/kernels/flash_attention.py`` :38, :104 and :137): blockwise
attention over dense K/V with ``kv_len``, ``q_offset``, causal or
bidirectional masking, a sliding ``window`` and GQA.  The two-dispatch
engine runs it for the chunked prefill on its scratch rows and for the
dense-layout decode (Sq = 1, no padding to a block of queries).  There is
no backward: the serving path needs none.

What bounds it on the H100: bytes at decode shapes (every valid key's K
and V once); at a prefill chunk the CUDA-core f32 arithmetic.  What the
design does about it: the G query heads of a KV head share each staged
32-key tile, tiles above the causal bound and below the window are never
read, and a decode row block keeps every warp on one head.

``launches`` counts calls that reach the card; ``chip_smoke.py`` reads
it.  A CPU tensor is refused here: :mod:`repro_torch.kernels.ops` routes
CPU tensors to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

SOURCE = "src/repro_torch/csrc/flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention.py:38"  # _flash_kernel

#: kernel launches since import (or since a caller reset it to 0)
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ((ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 9
             + (ctypes.c_float, ctypes.c_void_p))


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention (CUDA): {msg}")


def _per_row(x: torch.Tensor | int, b: int, dev: torch.device
             ) -> torch.Tensor:
    """A scalar or (B,) bound as a contiguous (B,) int32 tensor on ``dev``
    (a device tensor stays on the device: no host round trip)."""
    if isinstance(x, torch.Tensor):
        _check(x.device == dev, "kv_len / q_offset on another device")
        return x.to(torch.int32).reshape(-1).expand(b).contiguous()
    return torch.full((b,), int(x), dtype=torch.int32, device=dev)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         sm_scale: float | None = None,
                         window: int | None = None,
                         kv_len: torch.Tensor | int | None = None,
                         q_offset: torch.Tensor | int = 0) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D); kv_len (default Skv) and
    q_offset: scalars or (B,).  Returns (B, Sq, Hq, D); a row with no
    visible key is 0."""
    global launches
    tensors = (q, k, v)
    _check(all(t.device.type == "cuda" for t in tensors),
           "every tensor must lie on the card (the CPU takes the plain "
           "version through repro_torch.kernels.ops)")
    _check(all(t.device == q.device for t in tensors),
           "tensors on different devices")
    _check(q.dtype in _DTYPES, f"dtype {q.dtype} (float32 or bfloat16)")
    _check(k.dtype == q.dtype and v.dtype == q.dtype,
           "q, k and v must share one dtype")
    _check(q.dim() == 4 and k.dim() == 4, "q (B,Sq,Hq,D), k/v (B,Skv,Hkv,D)")
    b, sq, hq, d = q.shape
    _, skv, hkv, dk = k.shape
    _check(tuple(v.shape) == tuple(k.shape) and k.shape[0] == b,
           "k/v shapes")
    _check(dk == d and hq % hkv == 0, "head dims / GQA grouping")
    _check(d % 8 == 0 and d <= 256, f"head dim {d} (a multiple of 8, <= 256)")
    _check(window is None or window >= 1, f"window {window} (>= 1 or None)")
    _check(all(t.is_contiguous() for t in tensors), "contiguous tensors")
    _check(all(t.data_ptr() % 16 == 0 for t in tensors),
           "16-byte aligned q, k and v")
    scale = sm_scale if sm_scale is not None else 1.0 / (d ** 0.5)
    kl = _per_row(skv if kv_len is None else kv_len, b, q.device)
    qo = _per_row(q_offset, b, q.device)

    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        fn = build.entry("flash_attention", "flash_attention_launch",
                         _ARGTYPES)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 kl.data_ptr(), qo.data_ptr(), b, sq, skv, hq, hkv, d,
                 int(causal), window or 0, _DTYPES[q.dtype], scale, stream)
        launches += 1
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error "
                           f"{err}")
    return out
