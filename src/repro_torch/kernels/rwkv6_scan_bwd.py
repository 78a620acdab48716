"""The backward of the RWKV-6 WKV recurrence on Hopper: the wrapper of
``csrc/rwkv6_scan_bwd.cu``.

Replaces no Pallas kernel: the reference differentiates its chunked jnp
scan (``rwkv6_scan``, ``src/repro/kernels/ops.py:153``), each chunk of
128 steps under ``jax.checkpoint``.  Training reaches this kernel through
``kernels.ops``'s ``RWKV6Scan`` autograd function, once per RWKV layer and
micro-batch, after the forward kernel has written the state before every
chunk of ``rwkv6_scan.bound_chunk(T)`` steps.

What bounds it on the H100: the f32 issue rate of a walk that is serial
over time, about 7 instructions per state element and step (the
recompute's update, four gradient sums and the update of the state's
gradient G), with the row sums of dr, dk and dw across lanes.  The design:
the forward's block (``rwkv6_scan.SHAPES``: ``cols`` columns of one (row,
head), G's columns in registers); each chunk, last first, re-runs forward
from its boundary state into a per-thread scratch (never inverting the
decays); dv sums over the block's rows in shared memory; dr, dk and dw,
which sum over all N columns and so across the blocks of a head, and du,
which sums over B and T, go through partials and two more passes in a
fixed order (no atomics).  Three launches make one call.

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
from .rwkv6_scan import CHUNK, HEAD_SIZES, SHAPES, bound_chunk

SOURCE = "src/repro_torch/csrc/rwkv6_scan_bwd.cu"
REPLACES = "src/repro/kernels/ops.py:153"  # rwkv6_scan, differentiated

TILE = 32  # steps per block of the combine pass (the source's kTile)

#: kernel calls since import (or since a caller reset it to 0)
launches = 0


@dataclass(frozen=True)
class Plan:
    """How one call runs: the walk's ``grid`` blocks of ``threads``
    (``cols`` columns of one (row, head) each) with ``smem`` bytes of
    dynamic shared memory over chunks of ``chunk`` steps; the combine
    pass's ``tiles`` blocks of TILE steps per (row, head); and the f32
    scratch the wrapper allocates, ``scratch_bytes`` in all."""
    chunk: int
    cols: int
    grid: int
    threads: int
    smem: int
    tiles: int
    scratch_bytes: int


def _plan(b: int, t: int, h: int, n: int) -> Plan:
    """The launch plan from the shapes alone, as the source computes it:
    shared memory for CHUNK steps of r, k, w (whole rows) and v, dout (the
    block's columns) in f32, a bonus per step and the dv partials
    [chunk][row_groups][cols]."""
    cols, cpt, row_groups = SHAPES[n]
    grid = b * h * (n // cols)
    tiles = -(-t // TILE)
    smem = 4 * CHUNK * (3 * n + 2 * cols + 1 + row_groups * cols)
    scratch = 4 * (grid * CHUNK * n * cols + 3 * (n // cols) * b * t * h * n
                   + b * tiles * h * n)
    return Plan(bound_chunk(t), cols, grid, row_groups * cols // cpt, smem,
                tiles, scratch)


#: the plan of the last call (``chip_smoke.py`` prints it)
last_plan: Plan | None = None

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ((ctypes.c_void_p,) * 17 + (ctypes.c_int,) * 7
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
    plan = _plan(b, t, h, n)
    _check(plan.grid <= 2 ** 31 - 1 and b * h * plan.tiles <= 2 ** 31 - 1,
           "grid too large")
    f32 = dict(dtype=torch.float32, device=r.device)
    hist = torch.empty((plan.grid * CHUNK * n * plan.cols,), **f32)
    part = torch.empty((3 * (n // plan.cols) * b * t * h * n,), **f32)
    du_part = torch.empty((b * plan.tiles * h * n,), **f32)
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
                 hist.data_ptr(), part.data_ptr(), du_part.data_ptr(),
                 dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
                 du.data_ptr(), dstate0.data_ptr(), b, t, h, n,
                 _DTYPES[r.dtype], chunk, plan.smem, stream)
        launches += 1
        last_plan = plan
    if err != 0:
        raise RuntimeError(f"rwkv6_scan_bwd launch failed: CUDA error {err}")
    return dr, dk, dv, dw, du, dstate0
