"""Batched per-expert GEMM on Hopper: the wrapper of ``csrc/expert_gemm.cu``.

Replaces the Pallas TPU kernel ``_gemm_kernel`` behind
``pallas_expert_gemm`` (``src/repro/kernels/moe_gemm.py`` :27 and :35),
the MoE FFN's hot loop: ``(E, C, D) @ (E, D, F) -> (E, C, F)`` with f32
accumulation and the output in x's dtype.

What bounds it on the H100: bytes.  At deepseek-moe-16b's serving shapes
every launch streams all 64 experts' (2048, 1408) matrices, 369 MB in
bf16, and does at most 97 GFLOP (a mixed step's 264 packed tokens).  What
the design does about it: in bf16 (route ``wgmma``) the product runs
transposed, F as wgmma's 64-row M and C as its N, and one block owns an
(expert, F tile) pair for a whole tile of C, so each expert's weights
enter the SMs once per launch; TMA feeds a ring of 64-deep slabs that one
producer warp keeps in flight while one consumer warpgroup per 64 rows of
F issues the products.  The broadcast x of the single-device MoE is read
from its one copy through an expert stride of 0 (no (E, C, D) copy).  In
f32 (route ``cuda_core``) the products run on the CUDA cores.

Training's backward (:func:`expert_gemm_bwd_cuda`) runs this same kernel
on transposed contiguous operands, one launch a gradient; the reference
differentiates its jnp einsum, so no Pallas backward is replaced.

:func:`plan` picks the launch from the shapes, the dtype and the SM count
alone, so a call never reads the card and stays capturable in a CUDA
graph.  ``launches`` counts the forward's calls that reach the card,
``bwd_launches`` the backward's, ``routes`` / ``bwd_routes`` the calls of
each route and ``last_plan`` holds the plan of the last one;
``chip_smoke.py`` reads them all.  A CPU tensor is refused here:
:mod:`repro_torch.kernels.ops` routes CPU tensors to the plain version,
:func:`repro_torch.kernels.ref.moe_gemm_reference`.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import build
from .attention_tc import sm_count

SOURCE = "src/repro_torch/csrc/expert_gemm.cu"
REPLACES = "src/repro/kernels/moe_gemm.py:27"  # _gemm_kernel

# the source's constants (csrc/expert_gemm.cu)
SLAB = 64  # depth of one ring slot: one 128-byte swizzled row of bf16
C_CAP = 272  # widest C tile: 136 f32 accumulators a consumer thread
#: wgmma N of a C tile's binary split, widest first; a tile past 256 takes
#: two products, C tile - 128 (136 or 144) and 128
WGMMA_WIDTHS = (256, 128, 64, 32, 16, 8)
MAX_STAGES = 8
SMEM_LIMIT = 232_448  # a block's shared memory on the H100
ALIGN = 1024  # slack to align the ring to the 128-byte swizzle's atom
#: a 128-row F tile (two consumer warpgroups) when its grid gives each SM
#: at least this many blocks; else 64 rows, twice the blocks (on the H100
#: granite-moe-3b-a800m's up/gate, 160 blocks of 128 rows, ran faster than
#: 320 of 64: x crosses into the SMs once per F tile)
WIDE_F_BLOCKS_PER_SM = 1

#: kernel calls of the forward since import (or since a caller reset it
#: to 0)
launches = 0
#: forward calls of each route
routes = {"wgmma": 0, "cuda_core": 0}
#: kernel calls of the backward (:func:`expert_gemm_bwd_cuda`: one a
#: gradient, dX or dW), and of each route
bwd_launches = 0
bwd_routes = {"wgmma": 0, "cuda_core": 0}


@dataclass(frozen=True)
class Plan:
    """How one call runs.  ``wgmma``: blocks of ``block_f`` rows of F
    (one consumer warpgroup per 64, plus the producer's) by ``c_tile``
    columns of C (wgmma's N, a multiple of 8, split into the widths
    ``n_splits``), ``c_tiles`` of them along C, a ring of ``stages``
    slots and ``smem`` bytes of dynamic shared memory; ``grid`` is (C
    tiles, F tiles, E).  ``cluster`` is 1: no thread block cluster shares
    x (a cluster of 2 that multicast each half of x's slab to both CTAs
    made the mixed step's launches no faster on an H100: they are not
    bound by L2's feed; see PERF.md).  ``cuda_core``: the float32
    kernel's fixed 64 x 128 tiles, grid (F tiles, C tiles, E), static
    shared memory."""
    route: str
    block_f: int
    c_tile: int
    c_tiles: int
    n_splits: tuple[int, ...]
    stages: int
    cluster: int
    smem: int
    grid: tuple[int, int, int]
    threads: int


def x_box_rows(c_tile: int) -> int:
    """Rows of x per TMA box: the whole tile up to the box's 256-row
    limit, else two boxes of a multiple of 8 rows each."""
    return -(-c_tile // 16) * 8 if c_tile > 256 else c_tile


def slot_bytes(block_f: int, c_tile: int) -> int:
    """One ring slot: a SLAB-deep slab of w (block_f x SLAB) and of x
    (the x boxes' rows x SLAB), bf16."""
    boxes = 2 if c_tile > 256 else 1
    return (block_f + boxes * x_box_rows(c_tile)) * SLAB * 2


def plan(e: int, c: int, d: int, f: int, dtype: torch.dtype,
         n_sm: int) -> Plan:
    """The launch plan of (E, C, D) @ (E, D, F) from the shapes, the dtype
    and the SM count alone.

    bf16: C in ``ceil(C / C_CAP)`` tiles of equal width rounded up to 8;
    the F tile 128 when the grid then has WIDE_F_BLOCKS_PER_SM blocks per
    SM (x crosses into the SMs once per F tile, so wider tiles read it
    less), else 64; as many ring slots as fit the shared memory, up to
    MAX_STAGES.  D does not change the plan: the ring walks it in
    SLAB-deep slots."""
    if dtype != torch.bfloat16:
        grid = (-(-f // 128), -(-c // 64), e)
        return Plan("cuda_core", 128, 64, grid[1], (), 0, 1, 0, grid, 256)
    c_tiles = max(1, -(-c // C_CAP))
    c_tile = -(-(-(-max(c, 1) // c_tiles)) // 8) * 8
    wide = e * -(-f // 128) * c_tiles >= WIDE_F_BLOCKS_PER_SM * n_sm
    block_f = 128 if wide else 64
    slot = slot_bytes(block_f, c_tile) + 16  # + its two mbarriers
    stages = min(MAX_STAGES, (SMEM_LIMIT - ALIGN) // slot)
    splits = ((c_tile - 128, 128) if c_tile > 256 else
              tuple(w for w in WGMMA_WIDTHS if (c_tile // 8) & (w // 8)))
    return Plan("wgmma", block_f, c_tile, c_tiles, splits, stages, 1,
                ALIGN + stages * slot, (c_tiles, -(-f // block_f), e),
                128 * (block_f // 64 + 1))


#: the plan of the last call (``chip_smoke.py`` prints it)
last_plan: Plan | None = None

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ((ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 4
             + (ctypes.c_longlong,) + (ctypes.c_int,) * 6
             + (ctypes.c_void_p,))


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"expert_gemm (CUDA): {msg}")


def expert_gemm_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, D), contiguous or one (C, D) matrix ``expand``-ed over the
    experts (expert stride 0); w: (E, D, F) contiguous, x's dtype; D and F
    multiples of 8.  Returns (E, C, F) in x's dtype."""
    global launches
    out, p = _launch(x, w)
    launches += 1
    routes[p.route] += 1
    return out


def _pad_rows(a: torch.Tensor, rows: int) -> torch.Tensor:
    """``a`` (..., R, X) with zero rows appended up to ``rows``."""
    if a.shape[-2] == rows:
        return a
    pad = a.new_zeros(a.shape[:-2] + (rows - a.shape[-2], a.shape[-1]))
    return torch.cat([a, pad], dim=-2)


def expert_gemm_bwd_cuda(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                         *, need_x: bool = True, need_w: bool = True
                         ) -> tuple[torch.Tensor | None,
                                    torch.Tensor | None]:
    """The backward of :func:`expert_gemm_cuda` on the same kernel, on
    transposed contiguous operands: x (E, C, D), or one (C, D) matrix
    broadcast over the experts; w (E, D, F); dy (E, C, F) contiguous, all
    one dtype.  Returns (dx in x's shape, dw (E, D, F)), each None when
    not asked for, in x's dtype, accumulated in f32:

      dW_e = X_e^T dY_e : X^T (E, D, C) @ dY (E, C, F), C padded with zero
                          rows to a multiple of 8 (the kernel's depth);
                          a broadcast x's X^T is one (D, C) matrix read
                          through an expert stride of 0
      dX_e = dY_e W_e^T : dY (E, C, F) @ W^T (E, F, D)
      broadcast dX      : [dY_1 .. dY_E] (1, C, E F) @ [W_1^T; ..; W_E^T]
                          (1, E F, D): the sum over the experts runs in
                          the product's f32 accumulator, and no (E, C, D)
                          gradient exists

    Each product is one launch, counted in ``bwd_launches``."""
    global bwd_launches
    _check(dy.dim() == 3 and dy.is_contiguous(), "dy (E, C, F) contiguous")
    e, c, f = dy.shape
    d = w.shape[1]
    _check(tuple(w.shape) == (e, d, f),
           f"w {tuple(w.shape)} does not match dy {tuple(dy.shape)}")
    _check(tuple(x.shape) in ((c, d), (e, c, d)),
           f"x {tuple(x.shape)}: ({c}, {d}) or ({e}, {c}, {d})")
    dx = dw = None
    if need_w:
        cp = -(-c // 8) * 8
        if x.dim() == 2:  # one (D, C) matrix for every expert
            xt = _pad_rows(x, cp).T.contiguous().expand(e, d, cp)
        else:
            xt = _pad_rows(x, cp).transpose(1, 2).contiguous()
        dw, p = _launch(xt, _pad_rows(dy, cp))
        bwd_launches += 1
        bwd_routes[p.route] += 1
    if need_x:
        wt = w.transpose(1, 2)
        if x.dim() == 2:
            y2 = dy.permute(1, 0, 2).reshape(1, c, e * f)
            dx, p = _launch(y2, wt.reshape(1, e * f, d))
            dx = dx.view(c, d)
        else:
            dx, p = _launch(dy, wt.contiguous())
        bwd_launches += 1
        bwd_routes[p.route] += 1
    return dx, dw


def _launch(x: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, Plan]:
    """One launch of the kernel, checked; not counted."""
    global last_plan
    _check(x.dtype in _DTYPES, f"dtype {x.dtype} (float32 or bfloat16)")
    _check(w.dtype == x.dtype, "x and w must share one dtype")
    _check(x.dim() == 3 and w.dim() == 3, "x (E, C, D), w (E, D, F)")
    e, c, d = x.shape
    _check(w.shape[0] == e and w.shape[1] == d,
           f"w {tuple(w.shape)} does not match x {tuple(x.shape)}")
    f = w.shape[2]
    _check(d % 8 == 0 and f % 8 == 0, f"D={d} and F={f} (multiples of 8)")
    _check(x.stride(2) == 1 and x.stride(1) == d
           and x.stride(0) in (0, c * d),
           f"x strides {x.stride()}: rows of D contiguous, expert stride "
           "C*D or 0 (broadcast)")
    _check(w.is_contiguous(), "w must be contiguous")
    _check(x.device.type == "cuda" and w.device.type == "cuda",
           "x and w must lie on the card (the CPU takes the plain version "
           "through repro_torch.kernels.ops)")
    _check(x.device == w.device, "x and w on different devices")
    _check(x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0,
           "16-byte aligned x and w")
    p = plan(e, c, d, f, x.dtype, sm_count(x.device.index))
    _check(e <= 65535 and p.grid[1] <= 65535, "grid too large")
    out = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        fn = build.entry("expert_gemm", "expert_gemm_launch", _ARGTYPES)
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, d, f,
                 x.stride(0), _DTYPES[x.dtype], p.block_f, p.c_tile,
                 p.c_tiles, p.stages, p.smem, stream)
        last_plan = p
    if err != 0:
        raise RuntimeError(f"expert_gemm launch failed: CUDA error {err}")
    return out, p
