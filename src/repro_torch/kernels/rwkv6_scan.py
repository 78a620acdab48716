"""The RWKV-6 WKV recurrence on Hopper: the wrapper of
``csrc/rwkv6_scan.cu``.

Replaces the Pallas TPU kernel ``_wkv_kernel`` behind ``pallas_rwkv6_scan``
(``src/repro/kernels/ssm_scan.py`` :29 and :56): the time mix of every
RWKV-6 layer, sequential over time for each (batch row, head) with an
N x N f32 state.

What bounds it on the H100: at prefill (2 rows x 128 steps of 40 heads of
64) the shared memory's bandwidth and the f32 issue rate, 3 instructions
per state element and step, with every thread reading its rows' r, k and
w each step; at decode (8 rows x 1 step) the bytes, about 10.5 MB, mostly
the state read and written once.  Only the state update is serial over
time.  What the design does about it: the columns of the state are
independent, so each block takes ``cols`` columns of one (row, head);
``row_groups`` groups of threads split the rows, each thread keeping its
rows of ``cpt`` adjacent columns in registers for the whole sequence (one
read of a row's r, k and w serves ``cpt`` columns); each step's output
sums go into shared-memory partials that the block reduces once per
chunk, off the recurrence's chain; and a two-slot ``cp.async`` ring
stages the next chunk of r, k, v and w while the current one computes.
The initial state is loaded into the registers at t = 0 instead of folded
in afterwards as the TPU wrapper does.  Built for head sizes 16, 32 and
64; :func:`_plan` picks the launch from the shapes alone.

``launches`` counts calls that reach the card and ``last_plan`` holds the
plan of the last one; ``chip_smoke.py`` reads both.  A CPU tensor is
refused here: :mod:`repro_torch.kernels.ops` routes CPU tensors to the
plain version, :func:`repro_torch.kernels.ref.rwkv6_reference`.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import build
from .attention_tc import sm_count

SOURCE = "src/repro_torch/csrc/rwkv6_scan.cu"
REPLACES = "src/repro/kernels/ssm_scan.py:29"  # _wkv_kernel

#: the head sizes the kernel is built for (64 is rwkv6-3b's)
HEAD_SIZES = (16, 32, 64)
#: the block of each head size, as the source's Shape<N> fixes it:
#: (columns per block, columns per thread, row groups); each row group
#: holds n / row_groups rows (a multiple of 4) of every column of the block
SHAPES = {16: (16, 2, 4), 32: (32, 4, 8), 64: (32, 4, 8)}
CHUNK = 32  # time steps per ring slot, at most


def bound_chunk(t: int) -> int:
    """Steps per chunk of a T-step call: the interval of the boundary
    states the forward writes for the backward (``return_bounds``)."""
    return max(1, min(CHUNK, t))

#: kernel calls since import (or since a caller reset it to 0)
launches = 0


@dataclass(frozen=True)
class Plan:
    """How one call runs: ``cols`` state columns per block (``n / cols``
    blocks per (row, head)), ``cpt`` of them per thread, ``row_groups``
    groups of ``cols / cpt`` threads splitting the rows, ``chunk`` time
    steps per ring slot, ``ring`` slots (2 when T spans more than one
    chunk), and the grid, threads and dynamic shared memory of the
    launch."""
    cols: int
    cpt: int
    row_groups: int
    chunk: int
    ring: int
    grid: int
    threads: int
    smem: int


def _plan(b: int, t: int, h: int, n: int, dtype: torch.dtype,
          n_sm: int) -> Plan:
    """The launch plan from the shapes and the dtype alone: the block of
    ``SHAPES[n]``, chunks of ``CHUNK`` steps (T itself when shorter), and
    the shared memory as the source's ``layout`` computes it: ``ring``
    slots of r, k [chunk][n] and v [chunk][cols] in the compute dtype and
    w [chunk][n] f32, a bonus per step, the output partials
    [chunk][row_groups][cols] f32 and 2 rows of slack for the prefetch
    past a chunk's end.  ``n_sm`` does not change the plan: the grid is
    ``b * h * n / cols`` on any card, and one larger than the card queues
    its blocks at the same chunk."""
    cols, cpt, row_groups = SHAPES[n]
    itemsize = 2 if dtype == torch.bfloat16 else 4
    chunk = bound_chunk(t)
    ring = 2 if t > chunk else 1
    slot = -(-(chunk * (2 * n * itemsize + 4 * n + cols * itemsize))
             // 16) * 16
    smem = (ring * slot + -(-4 * chunk // 16) * 16
            + 4 * chunk * row_groups * cols + 8 * n)
    return Plan(cols, cpt, row_groups, chunk, ring, b * h * (n // cols),
                row_groups * cols // cpt, smem)


#: the plan of the last call (``chip_smoke.py`` prints it)
last_plan: Plan | None = None

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ((ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 8
             + (ctypes.c_void_p,))


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"rwkv6_scan (CUDA): {msg}")


def rwkv6_scan_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
                    state_out: torch.Tensor | None = None, *,
                    return_bounds: bool = False) -> tuple[torch.Tensor, ...]:
    """r, k, v: (B, T, H, N) in one dtype (float32 or bfloat16); w: (B, T,
    H, N) float32 decays; u: (H, N) float32; state: (B, H, N, N) float32;
    all contiguous and 16-byte aligned, N one of ``HEAD_SIZES``.  Returns
    (out (B, T, H, N) in r's dtype, final state (B, H, N, N) float32).
    The final state is written into ``state_out`` when given (it may be
    ``state`` itself).  ``return_bounds`` (training) also returns the
    state before every chunk of ``bound_chunk(T)`` steps, (B, C, H, N, N)
    float32, C = ceil(T / chunk), which the backward
    (``rwkv6_scan_bwd``) re-runs each chunk from; serving writes none."""
    global launches, last_plan
    final = torch.empty_like(state) if state_out is None else state_out
    tensors = (r, k, v, w, u, state, final)
    _check(all(t.device.type == "cuda" for t in tensors),
           "every tensor must lie on the card (the CPU takes the plain "
           "version through repro_torch.kernels.ops)")
    _check(all(t.device == r.device for t in tensors),
           "tensors on different devices")
    _check(r.dtype in _DTYPES, f"dtype {r.dtype} (float32 or bfloat16)")
    _check(k.dtype == r.dtype and v.dtype == r.dtype,
           "r, k and v must share one dtype")
    _check(w.dtype == u.dtype == state.dtype == torch.float32,
           "w, u and state must be float32")
    _check(r.dim() == 4, "r (B, T, H, N)")
    b, t, h, n = r.shape
    _check(all(tuple(x.shape) == (b, t, h, n) for x in (k, v, w)),
           "r, k, v and w must share one (B, T, H, N) shape")
    _check(tuple(u.shape) == (h, n), f"u {tuple(u.shape)}, want {(h, n)}")
    _check(tuple(state.shape) == tuple(final.shape) == (b, h, n, n),
           f"state {tuple(state.shape)} / state_out {tuple(final.shape)}, "
           f"want {(b, h, n, n)}")
    _check(final.dtype == torch.float32, "state_out must be float32")
    _check(n in HEAD_SIZES, f"head size {n} (the kernel is built for "
           f"{HEAD_SIZES})")
    _check(all(x.is_contiguous() for x in tensors), "contiguous tensors")
    _check(all(x.data_ptr() % 16 == 0 for x in tensors),
           "16-byte aligned tensors (the ring copies 16 bytes, and u and "
           "the state move in vectors)")
    plan = _plan(b, t, h, n, r.dtype, sm_count(r.device.index))
    _check(plan.grid <= 2 ** 31 - 1, "grid too large")
    out = torch.empty_like(r)
    bounds = (torch.empty((b, -(-t // plan.chunk), h, n, n),
                          dtype=torch.float32, device=r.device)
              if return_bounds else None)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        fn = build.entry("rwkv6_scan", "rwkv6_scan_launch", _ARGTYPES)
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), state.data_ptr(), out.data_ptr(),
                 final.data_ptr(),
                 None if bounds is None else bounds.data_ptr(), b, t, h, n,
                 _DTYPES[r.dtype], plan.chunk, plan.ring, plan.smem, stream)
        launches += 1
        last_plan = plan
    if err != 0:
        raise RuntimeError(f"rwkv6_scan launch failed: CUDA error {err}")
    return (out, final, bounds) if return_bounds else (out, final)
