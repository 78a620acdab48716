"""The backward of the RWKV-6 WKV recurrence on Hopper: the wrapper of
``csrc/rwkv6_scan_bwd.cu``.

Replaces no Pallas kernel: the reference differentiates its chunked jnp
scan (``rwkv6_scan``, ``src/repro/kernels/ops.py:153``), each chunk of
128 steps under ``jax.checkpoint``.  Training reaches this kernel through
``kernels.ops``'s ``RWKV6Scan`` autograd function, once per RWKV layer and
micro-batch, after the forward kernel has written the state before every
chunk of ``rwkv6_scan.bound_chunk(T)`` steps.

What bounds it on the H100: the f32 work on the CUDA cores, about 14 N^2
operations a step, row and head, and the shared memory and shuffles that
feed it; the bytes are small.  Only the state gradient G is serial over
the whole sequence, and across a chunk it is affine, G_in = L_c + P_c G_out
(L_c the chunk's walk from a zero gradient, P_c its decays' product a
row), so one call is three stages that each fill the card: ``local``
(a block per (row, head, chunk): L_c as one product of prefix-scaled r
and dout, P_c, the chunk's share of du), ``carry`` (a thread per
CARRY_VEC state elements, serial over the chunks only; it also adds du's
shares), and ``walk`` (a block per (row, head, chunk) over the whole
state, of the shape ``WALK`` gives: the chunk re-run forward from the
forward's boundary state, the state every ``seg`` steps kept in
registers, each ``sub``-step sub-chunk's states re-run into shared memory
and walked back from the carried gradient; row sums by shuffles, column
sums by warp partials, both inside the block).  The three launches are
chained by programmatic dependent launch, each waiting for the one
before only where it reads that one's output.  It never divides by a
decay (w = exp(-exp(x)) reaches 0), and every sum has a fixed order with
no atomics, so two launches on the same inputs agree bit for bit.

``launches`` counts calls that reach the card and ``last_plan`` holds the
plan of the last one; ``chip_smoke.py`` reads both.  A CPU tensor is
refused here: :mod:`repro_torch.kernels.ops` routes CPU tensors to the
plain version, :func:`repro_torch.kernels.ref.rwkv6_bwd_reference`.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import build
from .rwkv6_scan import CHUNK, HEAD_SIZES, bound_chunk

SOURCE = "src/repro_torch/csrc/rwkv6_scan_bwd.cu"
REPLACES = "src/repro/kernels/ops.py:153"  # rwkv6_scan, differentiated

# the source's constants (tests/test_torch_wkv_bwd_plan.py compares them)
LANES = 16  # threads across a row of the state (kLanes)
LOCAL_THREADS = 256  # a block of the local stage (kLocalThreads)
CARRY_THREADS = 256  # a block of the carry stage (kCarryThreads)
CARRY_VEC = 4  # adjacent state elements a carry thread (kCarryVec)
#: the walk's block of each head size, as the source's Walk<N> fixes it:
#: (rows a thread holds, threads, sub-chunk steps kept in shared memory,
#: steps between the states kept in registers, blocks an SM); a thread
#: holds n / LANES adjacent columns of each of its rows
WALK = {16: (1, 256, 8, 8, 1), 32: (2, 256, 8, 8, 1), 64: (4, 256, 4, 8, 2)}

#: kernel calls since import (or since a caller reset it to 0)
launches = 0


@dataclass(frozen=True)
class Plan:
    """How one call runs: the forward's ``chunk`` and the ``chunks`` of
    the call; the local stage's ``local_grid`` blocks of LOCAL_THREADS
    with ``local_smem`` bytes of dynamic shared memory; the carry's
    ``carry_grid`` blocks of CARRY_THREADS; the walk's ``walk_grid``
    blocks of ``walk_threads``, each thread ``rows`` x ``cols`` of the
    state, ``sub``-step sub-chunks of states in ``walk_smem`` bytes of
    shared memory, the states every ``seg`` steps in registers,
    ``walk_blocks_per_sm`` blocks an SM; and the f32 scratch the wrapper
    allocates (L_c, then G_out(c), a chunk; P_c and du's shares),
    ``scratch_bytes`` in all."""
    chunk: int
    chunks: int
    local_grid: int
    local_smem: int
    carry_grid: int
    walk_grid: int
    walk_threads: int
    rows: int
    cols: int
    sub: int
    seg: int
    walk_smem: int
    walk_blocks_per_sm: int
    scratch_bytes: int


def _plan(b: int, t: int, h: int, n: int) -> Plan:
    """The launch plan from the shapes alone, as the source computes it:
    a block per (row, head, chunk) in the local and walk stages, a thread
    per CARRY_VEC state elements (and per (head, i) for du) in the carry; shared
    memory for CHUNK steps of r, k, w, v and dout in f32, and in the walk
    the sub-chunk's states [sub][n][n], the warps' dv partials
    [sub][warps][n], u and two sums a step."""
    rows, threads, sub, seg, per_sm = WALK[n]
    chunk = bound_chunk(t)
    chunks = -(-t // chunk)
    items = b * h * chunks
    local_smem = 4 * (5 * CHUNK * n + CHUNK)
    walk_smem = 4 * (5 * CHUNK * n + sub * n * n + sub * (threads // 32) * n
                     + n + 2 * CHUNK)
    carry_grid = (-(-(b * h * n * n) // (CARRY_THREADS * CARRY_VEC))
                  + -(-(h * n) // CARRY_THREADS))
    scratch = 4 * (items * n * n + 2 * items * n)
    return Plan(chunk, chunks, items, local_smem, carry_grid, items, threads,
                rows, n // LANES, sub, seg, walk_smem, per_sm, scratch)


#: the plan of the last call (``chip_smoke.py`` prints it)
last_plan: Plan | None = None

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ((ctypes.c_void_p,) * 17 + (ctypes.c_int,) * 8
             + (ctypes.c_void_p,))


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"rwkv6_scan_bwd (CUDA): {msg}")


def rwkv6_scan_bwd_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        w: torch.Tensor, u: torch.Tensor,
                        bounds: torch.Tensor, dout: torch.Tensor,
                        dstate: torch.Tensor | None, *, chunk: int
                        ) -> tuple[torch.Tensor, ...]:
    """r, k, v, dout: (B, T, H, N) in one dtype (float32 or bfloat16); w:
    (B, T, H, N) float32; u: (H, N) float32; bounds: (B, C, H, N, N)
    float32, the forward's state before each chunk of ``chunk`` steps
    (``rwkv6_scan_cuda(return_bounds=True)``); dstate: (B, H, N, N)
    float32, the final state's gradient, or None (zero).  All contiguous
    on the card, N one of ``HEAD_SIZES``.  Returns (dr, dk, dv in r's
    dtype; dw (B, T, H, N), du (H, N), the initial state's gradient (B, H,
    N, N), float32)."""
    global launches, last_plan
    given = [x for x in (r, k, v, w, u, bounds, dout, dstate)
             if x is not None]
    _check(all(x.device.type == "cuda" for x in given),
           "every tensor must lie on the card (the CPU takes the plain "
           "version through repro_torch.kernels.ops)")
    _check(all(x.device == r.device for x in given),
           "tensors on different devices")
    _check(r.dtype in _DTYPES, f"dtype {r.dtype} (float32 or bfloat16)")
    _check(k.dtype == v.dtype == dout.dtype == r.dtype,
           "r, k, v and dout must share one dtype")
    _check(all(x.dtype == torch.float32 for x in (w, u, bounds)
               + ((dstate,) if dstate is not None else ())),
           "w, u, bounds and dstate must be float32")
    _check(r.dim() == 4, "r (B, T, H, N)")
    b, t, h, n = r.shape
    _check(all(tuple(x.shape) == (b, t, h, n) for x in (k, v, w, dout)),
           "r, k, v, w and dout must share one (B, T, H, N) shape")
    _check(tuple(u.shape) == (h, n), f"u {tuple(u.shape)}, want {(h, n)}")
    _check(n in HEAD_SIZES, f"head size {n} (the kernel is built for "
           f"{HEAD_SIZES})")
    _check(chunk == bound_chunk(t), f"chunk {chunk}: the forward's is "
           f"{bound_chunk(t)}")
    _check(tuple(bounds.shape) == (b, -(-t // chunk), h, n, n),
           f"bounds {tuple(bounds.shape)}, want "
           f"{(b, -(-t // chunk), h, n, n)}")
    _check(dstate is None or tuple(dstate.shape) == (b, h, n, n),
           f"dstate {None if dstate is None else tuple(dstate.shape)}")
    _check(all(x.is_contiguous() for x in given), "contiguous tensors")
    _check(all(x.data_ptr() % 16 == 0 for x in given),
           "16-byte aligned tensors (rows and the state move in vectors)")
    plan = _plan(b, t, h, n)
    _check(plan.walk_grid <= 2 ** 31 - 1 and plan.carry_grid <= 2 ** 31 - 1,
           "grid too large")
    f32 = dict(dtype=torch.float32, device=r.device)
    carry = torch.empty((b, plan.chunks, h, n, n), **f32)
    decay = torch.empty((b, plan.chunks, h, n), **f32)
    du_part = torch.empty((b, plan.chunks, h, n), **f32)
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dw = torch.empty_like(w)
    du = torch.empty_like(u)
    dstate0 = torch.empty((b, h, n, n), **f32)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        fn = build.entry("rwkv6_scan_bwd", "rwkv6_scan_bwd_launch",
                         _ARGTYPES)
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), bounds.data_ptr(), dout.data_ptr(),
                 None if dstate is None else dstate.data_ptr(),
                 carry.data_ptr(), decay.data_ptr(), du_part.data_ptr(),
                 dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
                 du.data_ptr(), dstate0.data_ptr(), b, t, h, n,
                 _DTYPES[r.dtype], chunk, plan.local_smem, plan.walk_smem,
                 stream)
        launches += 1
        last_plan = plan
    if err != 0:
        raise RuntimeError(f"rwkv6_scan_bwd launch failed: CUDA error {err}")
    return dr, dk, dv, dw, du, dstate0
