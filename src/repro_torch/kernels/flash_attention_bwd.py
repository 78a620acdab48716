"""Flash attention backward on Hopper: the wrapper of
``csrc/flash_attention_bwd.cu``.

Replaces the backward of the Pallas TPU kernel's ``custom_vjp``,
``flash_jnp._bwd_core`` (``src/repro/kernels/flash_jnp.py:114``), which
``pallas_flash_attention`` runs as its backward: FlashAttention-2's
recompute scheme from the forward's output and log-sum-exp, with
``kv_len``, ``q_offset``, causal or bidirectional masking, a sliding
``window`` and GQA (dk and dv summed over the G query heads of each KV
head).  Training reaches it through ``kernels.ops``'s ``FlashAttention``
autograd function, once per attention layer per micro-batch.

What bounds it on the H100: the operations, 10 D per visible query-key
pair and query head.  The design: two deterministic passes with no
atomics, a dq pass (a block per 64 query rows, walking the keys they can
see; it also writes ``delta = rowsum(o do)``) and a dk/dv pass (a block
per 64 keys of a KV head, walking the query rows of all G heads that can
see them).  Two routes, from the dtype and D alone (the forward's rule,
``attention_tc.tensor_core_route``):

* ``"tensor_core"`` (bf16, D % 16 == 0, D <= 128): mma.sync products on
  bf16 tiles staged by cp.async, S and dP in registers, P and dS fed
  back to the tensor cores as a bf16 high and low part;
* ``"cuda_core"`` (f32, and bf16 at any other D): f32 tiles in shared
  memory and 4 x 4 products per thread on the CUDA cores.

Tiles outside the causal and window bounds are never read.

``launches`` counts calls that reach the card (the two passes are one
call) and ``routes`` the calls of each route; ``chip_smoke.py`` reads
both.  A CPU tensor is refused here: :mod:`repro_torch.kernels.ops`
routes CPU tensors to the plain version (``ref.flash_bwd_reference``).
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .attention_tc import tensor_core_route
from .flash_attention import _per_row

SOURCE = "src/repro_torch/csrc/flash_attention_bwd.cu"
REPLACES = "src/repro/kernels/flash_jnp.py:114"  # _bwd_core

#: kernel calls since import (or since a caller reset it to 0)
launches = 0
#: calls of each route since import (or since a caller reset them)
routes = {"tensor_core": 0, "cuda_core": 0}
#: the route of the last call (``chip_smoke.py`` prints it)
last_route: str | None = None

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ((ctypes.c_void_p,) * 12 + (ctypes.c_int,) * 9
             + (ctypes.c_float, ctypes.c_void_p))


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention_bwd (CUDA): {msg}")


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True,
                             sm_scale: float | None = None,
                             window: int | None = None,
                             kv_len: torch.Tensor | int | None = None,
                             q_offset: torch.Tensor | int = 0
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """q, o, do: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D); lse: (B, Hq, Sq)
    f32 from the forward (``flash_attention_cuda(..., return_lse=True)``);
    kv_len (default Skv) and q_offset: scalars or (B,).  Returns (dq, dk,
    dv) in the inputs' dtype; a row with no visible key, and a key no query
    sees, gets 0."""
    global launches, last_route
    tensors = (q, k, v, o, do)
    _check(all(t.device.type == "cuda" for t in tensors + (lse,)),
           "every tensor must lie on the card (the CPU takes the plain "
           "version through repro_torch.kernels.ops)")
    _check(all(t.device == q.device for t in tensors + (lse,)),
           "tensors on different devices")
    _check(q.dtype in _DTYPES, f"dtype {q.dtype} (float32 or bfloat16)")
    _check(all(t.dtype == q.dtype for t in tensors),
           "q, k, v, o and do must share one dtype")
    _check(lse.dtype == torch.float32, "lse must be float32")
    _check(q.dim() == 4 and k.dim() == 4, "q (B,Sq,Hq,D), k/v (B,Skv,Hkv,D)")
    b, sq, hq, d = q.shape
    _, skv, hkv, dk_ = k.shape
    _check(tuple(v.shape) == tuple(k.shape) and k.shape[0] == b,
           "k/v shapes")
    _check(tuple(o.shape) == tuple(q.shape)
           and tuple(do.shape) == tuple(q.shape), "o/do shapes")
    _check(tuple(lse.shape) == (b, hq, sq), "lse shape (B, Hq, Sq)")
    _check(dk_ == d and hq % hkv == 0, "head dims / GQA grouping")
    _check(d % 8 == 0 and d <= 128, f"head dim {d} (a multiple of 8, <= 128)")
    _check(window is None or window >= 1, f"window {window} (>= 1 or None)")
    _check(all(t.is_contiguous() for t in tensors + (lse,)),
           "contiguous tensors")
    _check(all(t.data_ptr() % 16 == 0 for t in tensors),
           "16-byte aligned q, k, v, o and do")
    scale = sm_scale if sm_scale is not None else 1.0 / (d ** 0.5)
    kl = _per_row(skv if kv_len is None else kv_len, b, q.device)
    qo = _per_row(q_offset, b, q.device)

    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        fn = build.entry("flash_attention_bwd", "flash_attention_bwd_launch",
                         _ARGTYPES)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), kl.data_ptr(),
                 qo.data_ptr(), b, sq, skv, hq, hkv, d, int(causal),
                 window or 0, _DTYPES[q.dtype], scale, stream)
        route = ("tensor_core" if tensor_core_route(q.dtype, d)
                 else "cuda_core")
        launches += 1
        routes[route] += 1
        last_route = route
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error "
                           f"{err}")
    return dq, dk, dv
