"""Ragged paged attention on Hopper: the wrapper of
``csrc/ragged_paged_attention.cu``.

Replaces the Pallas TPU kernel ``_ragged_kernel`` behind
``pallas_ragged_paged_attention`` (``src/repro/kernels/ragged_attention.py``
:52 and :116), the unified serving step's attention over token-packed
mixed decode + prefill segments.

What bounds it on the H100: bytes at a decode segment (every valid page's
K and V once, ``kv_len`` tokens x Hkv x D per segment and pool); at a
128-query prefill chunk the tensor-core operations (4 D per visible
query-key pair and query head).  What the design does about it, by route
(``_plan`` picks one from the dtype and D alone):

* ``"tensor_core"`` (bf16, D % 16 == 0, D <= 128): the tile walk of
  ``csrc/attention_tc.cuh`` that the flash forward runs, with paged
  addressing and packed rows.  mma.sync products on bf16 64-key tiles
  that cp.async copies from the pages into a ring, each block's page ids
  staged once; the G query heads of a KV head share each tile; 16-row
  blocks whose warps split the keys for a decode sub-batch, 64-row blocks
  for a prefill one; and a split of each block's visible keys over
  ``n_split`` blocks (f32 partials in scratch this wrapper allocates, then
  a combine pass) when the grid would leave the card's SMs short.  What
  bounds it now: at decode each block's short chain of dependent tiles
  and the combine's second launch; at prefill one causal block's chain of
  tiles on mma.sync.
* ``"cuda_core"`` (f32, and bf16 at any other D): the CUDA-core walk over
  32-key tiles widened to f32, which the f32 checks hold exactly.

Pages past a block's causal bound are never read on either route, and
packed rows go straight into the output (no padded ``(S, max_q)`` buffer,
no repack); rows outside every live segment stay zero.

``launches`` counts calls that reach the card (the split and the combine
pass are one call) and ``routes`` the calls of each route;
``chip_smoke.py`` reads both.  A CPU tensor is refused here: the plain
version lives in :mod:`repro_torch.kernels.ref` and
:mod:`repro_torch.kernels.ops` routes to it only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from . import attention_tc, build
# chip_smoke.py asks each wrapper for tensor_core_route
from .attention_tc import (Plan, scratch, sm_count,  # noqa: F401
                           tensor_core_route)

SOURCE = "src/repro_torch/csrc/ragged_paged_attention.cu"
REPLACES = "src/repro/kernels/ragged_attention.py:52"  # _ragged_kernel

#: kernel calls since import (or since a caller reset it to 0)
launches = 0
#: calls of each route since import (or since a caller reset them)
routes = {"tensor_core": 0, "cuda_core": 0}
#: the plan of the last call (``chip_smoke.py`` prints its route)
last_plan: Plan | None = None

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ((ctypes.c_void_p,) * 11 + (ctypes.c_int,) * 12
             + (ctypes.c_float, ctypes.c_void_p))


def _plan(s: int, max_q: int, max_pages: int, ps: int, hq: int, hkv: int,
          d: int, dtype: torch.dtype, n_sm: int) -> Plan:
    """The shared walk's plan at B = S segments of Sq = max_q queries
    against Skv = max_pages x ps key positions, from the shapes alone
    (never from q_len or kv_len, which lie on the card).  The CUDA-core
    route is unsplit."""
    return attention_tc.plan(s, max_q, max_pages * ps, hq, hkv, d, dtype,
                             n_sm)


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
    global launches, last_plan
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
    _check(max_pages >= 1, "seg_page_table needs a column")
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
    plan = _plan(s_count, max_q, max_pages, ps, hq, hkv, d, q.dtype,
                 sm_count(q.device.index))
    _buf, m_part, l_part, acc_part = scratch(plan.part_rows, d, q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        fn = build.entry("ragged_paged_attention",
                         "ragged_paged_attention_launch", _ARGTYPES)
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 out.data_ptr(), seg_page_table.data_ptr(),
                 q_start.data_ptr(), q_len.data_ptr(), kv_len.data_ptr(),
                 m_part, l_part, acc_part, t, s_count, hq, hkv, d, n_pool,
                 ps, max_pages, max_q, _DTYPES[q.dtype], plan.block_rows,
                 plan.n_split, scale, stream)
        launches += 1
        routes[plan.route] += 1
        last_plan = plan
    if err != 0:
        raise RuntimeError(f"ragged_paged_attention launch failed: CUDA "
                           f"error {err}")
    return out
