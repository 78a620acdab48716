"""Dense decode attention on Hopper: the wrapper of
``csrc/decode_attention.cu``.

Replaces the Pallas TPU kernel ``_decode_kernel`` behind
``pallas_decode_attention`` (``src/repro/kernels/decode_attention.py`` :42
and :87): one query per row against a contiguous (B, T, Hkv, D) cache,
keys at or past ``lengths[b]`` masked.  As in the JAX package, no model
routes to it; :func:`repro_torch.kernels.ops.decode_attention` is its
entry point.

What bounds it on the H100: bytes, every row's valid K and V once.  What
the design does about it: each (row, KV head) is split over ``n_split``
blocks, which ``_plan`` sizes from B Hkv and T so that 8 rows fill the card
instead of 64 blocks; each block writes a partial (m, l, acc) into f32
scratch this wrapper allocates, and a second small kernel combines them.
Blocks past a row's length return at once.  The split pass runs one of two
routes, chosen from the dtype and D:

* ``"tensor_core"`` (bf16, D % 16 == 0, D <= 128): the flash forward's
  tensor-core walk (``csrc/attention_tc.cuh``) at Sq = 1, with the flash
  forward's plan, so at most ``MAX_SPLIT`` splits: the G query heads as
  one 16-row tile, bf16 K/V tiles staged by cp.async in a ring, so a
  block keeps its next tiles' bytes in flight while it computes, and the
  4 warps each take their own keys of every tile.  Each split takes a
  tile-aligned share of its row's own length, read on the card.
* ``"cuda_core"`` (f32 and every other D): fixed shares of
  ``split_keys`` cache positions, walked in 32-key tiles widened to f32,
  products on the CUDA cores.

``launches`` counts calls that reach the card (the split and the combine
kernel are one call) and ``routes`` the calls of each route;
``chip_smoke.py`` reads both.  A CPU tensor is refused here:
:mod:`repro_torch.kernels.ops` routes CPU tensors to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from . import attention_tc, build
from .attention_tc import (NARROW_BLOCKS_PER_SM, TILE_KEYS, Plan, scratch,
                           sm_count, tensor_core_route)

SOURCE = "src/repro_torch/csrc/decode_attention.cu"
REPLACES = "src/repro/kernels/decode_attention.py:42"  # _decode_kernel

#: kernel calls since import (or since a caller reset it to 0)
launches = 0
#: calls of each route since import (or since a caller reset them)
routes = {"tensor_core": 0, "cuda_core": 0}


def _plan(b: int, t: int, hq: int, hkv: int, d: int, dtype: torch.dtype,
          n_sm: int) -> Plan:
    """The launch plan from the shapes, the dtype and the SM count alone,
    never from ``lengths`` (it lies on the card).  The tensor-core route
    is the flash forward's plan at Sq = 1: one 16-row block per (row, KV
    head), split up to ``MAX_SPLIT`` ways, written without the combine
    when there is one split.  The CUDA-core route splits the cache into
    fixed shares of whole 64-key tiles towards the same blocks per SM,
    under 2 blocks per SM, and always combines its G rows."""
    if tensor_core_route(dtype, d):
        return attention_tc.plan(b, 1, t, hq, hkv, d, dtype, n_sm)
    base = b * hkv
    n_split = 1
    if base < 2 * n_sm:
        target = NARROW_BLOCKS_PER_SM * n_sm
        n_split = max(1, min(-(-target // max(base, 1)),
                             -(-t // TILE_KEYS)))
    split_keys = -(-t // n_split)
    split_keys = -(-split_keys // TILE_KEYS) * TILE_KEYS
    n_split = -(-t // split_keys)
    return Plan("cuda_core", 0, 0, n_split, base * n_split * (hq // hkv),
                split_keys)


#: the plan of the last call (``chip_smoke.py`` prints its route)
last_plan: Plan | None = None

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ((ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 8
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
    global launches, last_plan
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
    plan = _plan(b, t, hq, hkv, d, q.dtype, sm_count(q.device.index))

    out = torch.empty_like(q)
    _buf, m_part, l_part, acc_part = scratch(plan.part_rows, d, q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        fn = build.entry("decode_attention", "decode_attention_launch",
                         _ARGTYPES)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lengths.data_ptr(), m_part, l_part, acc_part, b, hq, hkv, d,
                 t, plan.split_keys, plan.n_split, _DTYPES[q.dtype], scale,
                 stream)
        launches += 1
        routes[plan.route] += 1
        last_plan = plan
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: CUDA error "
                           f"{err}")
    return out
