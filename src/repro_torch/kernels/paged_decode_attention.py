"""Paged decode attention on Hopper: the wrapper of
``csrc/paged_decode_attention.cu``.

Replaces the Pallas TPU kernel ``_paged_decode_kernel`` behind
``pallas_paged_decode_attention`` (``src/repro/kernels/decode_attention.py``
:141 and :190), the two-dispatch engine's paged decode attention: one
query per slot against the pages its table row names.

What bounds it on the H100: bytes, every live page's K and V once per
step.  Its function is the ragged kernel's with every segment's q_len = 1
(``kv_len = lengths``), and it runs on the same walk.  Each (slot, KV
head) is split over ``n_split`` blocks, which ``_plan`` sizes from B Hkv
and the table's ``max_pages x page_size`` keys so that 8 slots fill the
card instead of 64 blocks; each block writes a partial (m, l, acc) into
f32 scratch this wrapper allocates, and a second small kernel combines
them.  Blocks past a slot's length return at once.  The split pass runs
one of two routes, chosen from the dtype and D:

* ``"tensor_core"`` (bf16, D % 16 == 0, D <= 128): the tile walk of
  ``csrc/attention_tc.cuh`` with its paged addressing, at Sq = 1 and with
  the shared plan (``kernels/attention_tc.py``), so at most ``MAX_SPLIT``
  splits: the G query heads as one 16-row tile, bf16 K/V tiles that
  cp.async copies from the pages into a ring, the 4 warps each taking
  their own keys of every tile; each split takes a tile-aligned share of
  its slot's own length, read on the card.  What bounds it now: each
  block's short chain of dependent tiles and the combine's second launch.
* ``"cuda_core"`` (f32 and every other D): fixed shares of ``SPLIT_KEYS``
  key positions, walked in 32-key tiles widened to f32, products on the
  CUDA cores.

``launches`` counts calls that reach the card (the split and the combine
kernel are one call) and ``routes`` the calls of each route;
``chip_smoke.py`` reads both.  A CPU tensor is refused here:
:mod:`repro_torch.kernels.ops` routes CPU tensors to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from . import attention_tc, build
from .attention_tc import Plan, scratch, sm_count, tensor_core_route

SOURCE = "src/repro_torch/csrc/paged_decode_attention.cu"
REPLACES = "src/repro/kernels/decode_attention.py:141"  # _paged_decode_kernel

#: key positions one block of the CUDA-core route's split walks (a
#: multiple of its 32-key tile)
SPLIT_KEYS = 128

#: kernel calls since import (or since a caller reset it to 0)
launches = 0
#: calls of each route since import (or since a caller reset them)
routes = {"tensor_core": 0, "cuda_core": 0}
#: the plan of the last call (``chip_smoke.py`` prints its route)
last_plan: Plan | None = None

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ((ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 10
             + (ctypes.c_float, ctypes.c_void_p))


def _plan(b: int, max_pages: int, ps: int, hq: int, hkv: int, d: int,
          dtype: torch.dtype, n_sm: int) -> Plan:
    """The launch plan from the shapes, the dtype and the SM count alone,
    never from ``lengths`` (it lies on the card).  The tensor-core route
    is the shared walk's plan at B slots of Sq = 1 query against Skv =
    max_pages x ps keys: the ragged kernel's plan at max_q = 1.  The
    CUDA-core route cuts the table's keys into shares of SPLIT_KEYS and
    always combines its G rows."""
    skv = max_pages * ps
    if tensor_core_route(dtype, d):
        return attention_tc.plan(b, 1, skv, hq, hkv, d, dtype, n_sm)
    n_split = -(-skv // SPLIT_KEYS)
    return Plan("cuda_core", 0, 0, n_split, b * hkv * n_split * (hq // hkv),
                SPLIT_KEYS)


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
    global launches, last_plan
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
    _check(max_pages >= 1, "page_table needs a column")
    plan = _plan(b, max_pages, ps, hq, hkv, d, q.dtype,
                 sm_count(q.device.index))

    out = torch.empty_like(q)
    _buf, m_part, l_part, acc_part = scratch(plan.part_rows, d, q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        fn = build.entry("paged_decode_attention",
                         "paged_decode_attention_launch", _ARGTYPES)
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 out.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
                 m_part, l_part, acc_part, b, hq, hkv, d, n_pool, ps,
                 max_pages, plan.split_keys, plan.n_split, _DTYPES[q.dtype],
                 scale, stream)
        launches += 1
        routes[plan.route] += 1
        last_plan = plan
    if err != 0:
        raise RuntimeError(f"paged_decode_attention launch failed: CUDA "
                           f"error {err}")
    return out
