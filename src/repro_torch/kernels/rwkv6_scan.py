"""The RWKV-6 WKV recurrence on Hopper: the wrapper of
``csrc/rwkv6_scan.cu``.

Replaces the Pallas TPU kernel ``_wkv_kernel`` behind ``pallas_rwkv6_scan``
(``src/repro/kernels/ssm_scan.py`` :29 and :56): the time mix of every
RWKV-6 layer, sequential over time for each (batch row, head) with an
N x N f32 state.

What bounds it on the H100: neither bytes nor operations but the serial
chain over time.  A decode step moves about 10.5 MB (8 rows x 40 heads,
mostly the state read and written once); a prefill chunk of 2 x 128 steps
does 5 N^2 + 5 N f32 operations per step and head.  What the design does
about it: one block of N threads per (row, head), thread j keeping column
j of the state in registers for the whole sequence (the columns are
independent), time steps staged in shared memory a chunk at a time with
the bonus sum reduced once per step, and the initial state loaded into
the registers at t = 0 instead of folded in afterwards as the TPU wrapper
does.  Built for head sizes 16, 32 and 64.

``launches`` counts calls that reach the card; ``chip_smoke.py`` reads it.
A CPU tensor is refused here: :mod:`repro_torch.kernels.ops` routes CPU
tensors to the plain version, :func:`repro_torch.kernels.ref
.rwkv6_reference`.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

SOURCE = "src/repro_torch/csrc/rwkv6_scan.cu"
REPLACES = "src/repro/kernels/ssm_scan.py:29"  # _wkv_kernel

#: the head sizes the kernel is built for (one thread per state column;
#: 64 is rwkv6-3b's)
HEAD_SIZES = (16, 32, 64)

#: kernel calls since import (or since a caller reset it to 0)
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ((ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 5
             + (ctypes.c_void_p,))


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"rwkv6_scan (CUDA): {msg}")


def rwkv6_scan_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
                    state_out: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, v: (B, T, H, N) in one dtype (float32 or bfloat16); w: (B, T,
    H, N) float32 decays; u: (H, N) float32; state: (B, H, N, N) float32;
    all contiguous, N one of ``HEAD_SIZES``.  Returns (out (B, T, H, N) in
    r's dtype, final state (B, H, N, N) float32).  The final state is
    written into ``state_out`` when given (it may be ``state`` itself)."""
    global launches
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
    _check(b * h <= 2 ** 31 - 1, "grid too large")
    out = torch.empty_like(r)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        fn = build.entry("rwkv6_scan", "rwkv6_scan_launch", _ARGTYPES)
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), state.data_ptr(), out.data_ptr(),
                 final.data_ptr(), b, t, h, n, _DTYPES[r.dtype], stream)
        launches += 1
    if err != 0:
        raise RuntimeError(f"rwkv6_scan launch failed: CUDA error {err}")
    return out, final
