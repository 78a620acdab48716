"""Flash attention forward on Hopper: the wrapper of
``csrc/flash_attention.cu``.

Replaces the forward of the Pallas TPU kernel ``_flash_kernel`` behind
``_pallas_fwd`` / ``pallas_flash_attention``
(``src/repro/kernels/flash_attention.py`` :38, :104 and :137): blockwise
attention over dense K/V with ``kv_len``, ``q_offset``, causal or
bidirectional masking, a sliding ``window`` and GQA.  The two-dispatch
engine runs it for the chunked prefill on its scratch rows and for the
dense-layout decode (Sq = 1, no padding to a block of queries).  With
``return_lse=True`` it also returns each row's log-sum-exp (B, Hq, Sq)
f32, the residual of the backward (``flash_attention_bwd``), which
training takes through ``kernels.ops``'s ``FlashAttention`` function.

What bounds it on the H100: bytes at decode shapes (every valid key's K
and V once); at a prefill chunk the tensor-core operations (4 D per
visible query-key pair and head).  What the design does about it, by
route (``_plan`` picks one from the dtype and D alone):

* ``"tensor_core"`` (bf16, D % 16 == 0, D <= 128): mma.sync products on
  bf16 K/V tiles that cp.async stages in a ring, so loads overlap the
  products; the G query heads of a KV head share each tile; 64-row blocks
  for a prefill chunk, 16-row blocks with the warps splitting the keys
  for a decode; and a split of each block's key range over ``n_split``
  blocks (f32 partials in scratch this wrapper allocates, then a combine
  pass) when the grid would leave the card's SMs short.
* ``"cuda_core"`` (f32, and bf16 at any other D): the CUDA-core walk over
  32-key tiles widened to f32, which the f32 checks hold exactly.

Tiles above the causal bound and below the window are never read on
either route.

``launches`` counts calls that reach the card (the split and the combine
pass are one call) and ``routes`` the calls of each route;
``chip_smoke.py`` reads both.  A CPU tensor is refused here:
:mod:`repro_torch.kernels.ops` routes CPU tensors to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from . import attention_tc, build
# MAX_SPLIT stays importable from here beside the plan
from .attention_tc import (MAX_SPLIT, Plan, scratch,  # noqa: F401
                           sm_count, tensor_core_route)

SOURCE = "src/repro_torch/csrc/flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention.py:38"  # _flash_kernel

#: kernel calls since import (or since a caller reset it to 0)
launches = 0
#: calls of each route since import (or since a caller reset them)
routes = {"tensor_core": 0, "cuda_core": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ((ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 11
             + (ctypes.c_float, ctypes.c_void_p))

#: the flash forward's launch plan: the shared walk's, as it stands
_plan = attention_tc.plan

#: the plan of the last call (``chip_smoke.py`` prints its route)
last_plan: Plan | None = None


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
                         q_offset: torch.Tensor | int = 0,
                         return_lse: bool = False
                         ) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D); kv_len (default Skv) and
    q_offset: scalars or (B,).  Returns (B, Sq, Hq, D); a row with no
    visible key is 0.  With ``return_lse``, (out, lse): lse (B, Hq, Sq)
    f32, each row's log-sum-exp of its scaled scores (NEG_INF for a row
    with no visible key)."""
    global launches, last_plan
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

    plan = _plan(b, sq, skv, hq, hkv, d, q.dtype, sm_count(q.device.index))

    out = torch.empty_like(q)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    _buf, m_part, l_part, acc_part = scratch(plan.part_rows, d, q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        fn = build.entry("flash_attention", "flash_attention_launch",
                         _ARGTYPES)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 kl.data_ptr(), qo.data_ptr(), m_part, l_part, acc_part,
                 0 if lse is None else lse.data_ptr(), b, sq, skv, hq, hkv,
                 d, int(causal), window or 0, _DTYPES[q.dtype],
                 plan.block_rows, plan.n_split, scale, stream)
        launches += 1
        routes[plan.route] += 1
        last_plan = plan
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error "
                           f"{err}")
    return out if lse is None else (out, lse)
