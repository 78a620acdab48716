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

Training's backward (:func:`expert_gemm_bwd_cuda`) has a kernel of its own
in bf16, ``csrc/expert_gemm_bwd.cu``: every operand read where it lies
(:func:`bwd_products` describes the views, strides and transpose flags it
hands the launch), a launch that fills the card (:func:`bwd_plan`: the
summed dX of a broadcast x splits its depth into shares) and one wgmma
group in flight.  In f32 it runs the forward's CUDA-core kernel on
transposed contiguous copies.  The reference differentiates its jnp
einsum, so no Pallas backward is replaced.

:func:`plan` and :func:`bwd_plan` pick the launch from the shapes, the
dtype and the SM count alone, so a call never reads the card and stays
capturable in a CUDA graph.  ``launches`` counts the forward's calls that
reach the card, ``bwd_launches`` the backward's (one a gradient, whatever
number of kernels it runs), ``routes`` / ``bwd_routes`` the calls of each
route and ``last_plan`` holds the plan of the last one (``last_bwd_plans``
the backward's of each gradient); ``chip_smoke.py`` reads them all.  A
CPU tensor is refused here: :mod:`repro_torch.kernels.ops` routes CPU
tensors to the plain versions, :func:`repro_torch.kernels.ref.
moe_gemm_reference` and ``expert_gemm_bwd_reference``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import build
from .attention_tc import sm_count

SOURCE = "src/repro_torch/csrc/expert_gemm.cu"
REPLACES = "src/repro/kernels/moe_gemm.py:27"  # _gemm_kernel
BWD_SOURCE = "src/repro_torch/csrc/expert_gemm_bwd.cu"

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
#: calls of the backward (:func:`expert_gemm_bwd_cuda`: one a gradient,
#: dX or dW, whatever number of kernels it runs), and of each route
bwd_launches = 0
bwd_routes = {"wgmma": 0, "cuda_core": 0}

# the backward's source's constants (csrc/expert_gemm_bwd.cu)
BWD_TILE_M = 128  # rows of M a block: two consumer warpgroups of 64
#: wgmma N of a block's tile, widest first
BWD_WIDTHS = (256, 128, 64)
BWD_MAX_STAGES = 8
BWD_THREADS = 384  # two consumer warpgroups and the producer's
#: most shares of the summed dX's depth (each writes an f32 partial of
#: the whole (C, D) output)
BWD_MAX_SHARES = 16
#: the cost model of :func:`bwd_plan`, in seconds on an H100.  A block's
#: 64-deep slab of a 128 x 256 tile at a sustained 5.2 TFLOP/s an SM;
#: narrower tiles cost more a column (their B slab feeds fewer products
#: per byte of A: at granite's training shapes on an H100, 128-wide tiles
#: took 1.03-1.09x and 64-wide ones 1.5-1.7x the 256-wide time); the
#: shares' partials are written and read once at 3.35 TB/s and summed by a
#: second launch
BWD_SM_FLOPS = 5.2e12
BWD_WIDTH_COST = {256: 1.0, 128: 1.15, 64: 1.7}
BWD_HBM_BYTES = 3.35e12
BWD_SUM_LAUNCH_S = 4e-6


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


@dataclass(frozen=True)
class BwdPlan:
    """How one gradient runs on the bf16 route.  A tile is BWD_TILE_M rows
    of M by ``block_n`` columns of N (wgmma's N) over a range of (expert,
    64-deep slab) pairs, walked through a ring of ``stages`` slots; the
    ``tiles`` are N tiles x M tiles x ``shares``: one a expert for the
    per-expert products, else the shares of the summed dX's E * K / 64
    pairs (share s walks pairs [s P / S, (s + 1) P / S)), whose f32
    partials a second kernel adds in share order.  ``grid`` is (blocks,
    1, 1), one block an SM (fewer when there are fewer tiles): block b
    takes tiles b, b + blocks, ..., and its producer loads the next
    tile's slabs while the consumers store the last one's (on an H100 6-9%
    faster than one block a tile at granite's per-expert gradients)."""
    route: str
    product: str  # "dx", "dw" or "dx_sum"
    block_n: int
    m_tiles: int
    n_tiles: int
    shares: int
    pairs: int
    tiles: int
    stages: int
    smem: int
    grid: tuple[int, int, int]
    threads: int


def bwd_stage_bytes(block_n: int) -> int:
    """One ring slot: a 64-deep slab of A (BWD_TILE_M rows) and of B
    (``block_n`` rows), bf16."""
    return (BWD_TILE_M + block_n) * SLAB * 2


def bwd_plan(product: str, e: int, m: int, n: int, k: int,
             n_sm: int) -> BwdPlan:
    """The bf16 launch of one backward product, out^T (M x N) over a depth
    of K per expert, from the shapes and the SM count alone.

    ``dx`` / ``dw`` (per expert: E shares, one an expert): the tile width
    whose tiles cost least, ``ceil(tiles / n_sm)`` waves of a tile's width
    times its BWD_WIDTH_COST, so a last wave that is mostly idle counts
    as whole.
    ``dx_sum`` (a broadcast x's dX, summed over the experts): the width and
    the shares S of the E * ceil(K / 64) pairs whose modelled time, the
    waves times the longest share's slabs plus the partials' traffic, is
    least."""
    if product not in ("dx", "dw", "dx_sum"):
        raise ValueError(f"unknown backward product {product!r}")
    m_tiles = -(-m // BWD_TILE_M)
    pairs = e * -(-k // SLAB)
    best = None
    for bn in BWD_WIDTHS:
        tiles = m_tiles * -(-n // bn)
        slab_s = (2 * BWD_TILE_M * bn * SLAB / BWD_SM_FLOPS
                  * BWD_WIDTH_COST[bn])
        if product == "dx_sum":
            options = range(1, max(1, min(BWD_MAX_SHARES, pairs)) + 1)
        else:
            options = (e,)
        for shares in options:
            waves = -(-tiles * shares // n_sm)
            cost = waves * -(-max(pairs, 1) // shares) * slab_s
            if product == "dx_sum" and shares > 1:
                cost += (BWD_SUM_LAUNCH_S
                         + shares * 8 * m * n / BWD_HBM_BYTES)
            if best is None or cost < best[0]:
                best = (cost, bn, shares)
    _, bn, shares = best
    slot = bwd_stage_bytes(bn) + 16  # + its two mbarriers
    stages = min(BWD_MAX_STAGES, (SMEM_LIMIT - ALIGN) // slot)
    n_tiles = -(-n // bn)
    tiles = n_tiles * m_tiles * shares
    return BwdPlan("wgmma", product, bn, m_tiles, n_tiles, shares, pairs,
                   tiles, stages, ALIGN + stages * slot,
                   (min(tiles, n_sm), 1, 1), BWD_THREADS)


@dataclass(frozen=True)
class Operand:
    """One operand of a backward product as the kernel reads it: the
    caller's own ``tensor`` (never a copy) through a 3-D TMA map of
    ``dims`` (innermost first, the experts last) whose outer two dims lie
    ``strides`` elements apart; ``mn_major``: the product reads it with
    its M (or N) axis contiguous, wgmma's transpose flag."""
    tensor: torch.Tensor
    dims: tuple[int, int, int]
    strides: tuple[int, int]
    mn_major: bool


@dataclass(frozen=True)
class Product:
    """One gradient on the bf16 route: out^T (m x n) = A (m x k) B (k x n)
    per expert, into ``out_shape`` (rows of n, each m contiguous), or
    summed over the experts (``product == "dx_sum"``)."""
    grad: str  # "dx" or "dw"
    product: str  # "dx", "dw" or "dx_sum"
    a: Operand
    b: Operand
    e: int
    m: int
    n: int
    k: int
    out_shape: tuple[int, ...]


def _operand(t: torch.Tensor, mn_major: bool) -> Operand:
    """``t`` (E, R, X) or (R, X), X contiguous, as a 3-D map (X, R, E)."""
    if t.dim() == 2:
        return Operand(t, (t.shape[1], t.shape[0], 1),
                       (t.stride(0), t.stride(0) * t.shape[0]), mn_major)
    return Operand(t, (t.shape[2], t.shape[1], t.shape[0]),
                   (t.stride(1), t.stride(0)), mn_major)


def bwd_products(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, *,
                 need_x: bool = True, need_w: bool = True) -> list[Product]:
    """The bf16 route's products, dW first, each read from x, w and dy as
    they lie (every operand's ``tensor`` is one of the three):

      dW_e: out^T (F x D) = dY_e^T X_e: A dY (E, C, F) MN-major, B X
            (E, C, D) or one (C, D) for every expert MN-major; k = C
      dX_e: out^T (D x C) = W_e dY_e^T: A W (E, D, F) K-major, B dY K-major;
            k = F; summed over the experts for a broadcast (C, D) x"""
    e, c, f = dy.shape
    d = w.shape[1]
    out = []
    if need_w:
        out.append(Product("dw", "dw", _operand(dy, True),
                           _operand(x, True), e, f, d, c, (e, d, f)))
    if need_x:
        summed = x.dim() == 2
        out.append(Product("dx", "dx_sum" if summed else "dx",
                           _operand(w, False), _operand(dy, False), e, d, c,
                           f, tuple(x.shape)))
    return out


#: the backward's plan of each gradient in the last bf16 call
last_bwd_plans: dict[str, BwdPlan] = {}


def expert_gemm_bwd_cuda(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                         *, need_x: bool = True, need_w: bool = True
                         ) -> tuple[torch.Tensor | None,
                                    torch.Tensor | None]:
    """The backward of :func:`expert_gemm_cuda`: x (E, C, D), or one (C, D)
    matrix broadcast over the experts; w (E, D, F); dy (E, C, F), all one
    dtype, each with its last axis contiguous.  Returns (dx in x's shape,
    dw (E, D, F)), each None when not asked for, in x's dtype, accumulated
    in f32:

      dW_e = X_e^T dY_e,  dX_e = dY_e W_e^T,
      broadcast dX = sum_e dY_e W_e^T (no (E, C, D) gradient exists)

    bf16 (route ``wgmma``): ``csrc/expert_gemm_bwd.cu`` on the operands as
    they lie (:func:`bwd_products`), planned by :func:`bwd_plan`.  f32
    (route ``cuda_core``): the forward's kernel on transposed contiguous
    copies, C zero-padded to a multiple of 8 for dW and the broadcast dX
    as one (1, C, E F) @ (1, E F, D) product.  Each gradient is one call,
    counted in ``bwd_launches``."""
    global bwd_launches, last_plan
    _check(dy.dim() == 3, "dy (E, C, F)")
    e, c, f = dy.shape
    d = w.shape[1]
    _check(w.dim() == 3 and tuple(w.shape) == (e, d, f),
           f"w {tuple(w.shape)} does not match dy {tuple(dy.shape)}")
    _check(tuple(x.shape) in ((c, d), (e, c, d)),
           f"x {tuple(x.shape)}: ({c}, {d}) or ({e}, {c}, {d})")
    _check(x.dtype in _DTYPES, f"dtype {x.dtype} (float32 or bfloat16)")
    _check(w.dtype == x.dtype == dy.dtype, "x, w and dy must share one dtype")
    _check(d % 8 == 0 and f % 8 == 0, f"D={d} and F={f} (multiples of 8)")
    dx = dw = None
    if x.dtype == torch.bfloat16:
        last_bwd_plans.clear()
        for prod in bwd_products(x, w, dy, need_x=need_x, need_w=need_w):
            got, p = _launch_bwd(prod)
            last_bwd_plans[prod.grad] = last_plan = p
            if prod.grad == "dx":
                dx = got
            else:
                dw = got
            bwd_launches += 1
            bwd_routes[p.route] += 1
        return dx, dw
    _check(dy.is_contiguous(), "dy (E, C, F) contiguous")
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


_BWD_ARGTYPES = ((ctypes.c_void_p,) + (ctypes.c_longlong,) * 5
                 + (ctypes.c_void_p,) + (ctypes.c_longlong,) * 5
                 + (ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 12
                 + (ctypes.c_void_p,))


def _check_operand(name: str, op: Operand) -> None:
    t = op.tensor
    _check(t.stride(-1) == 1,
           f"{name}: its last axis must be contiguous (strides "
           f"{t.stride()})")
    _check(all(s % 8 == 0 for s in op.strides),
           f"{name}: strides {t.stride()} must be multiples of 8 elements "
           "(16 bytes, TMA's rule)")


def _launch_bwd(prod: Product, p: BwdPlan | None = None
                ) -> tuple[torch.Tensor, BwdPlan]:
    """One bf16 gradient on the card, checked; not counted; on ``p``, or
    on :func:`bwd_plan`'s plan.  The summed dX with shares takes an f32
    scratch for the partials."""
    a, b = prod.a, prod.b
    _check_operand("A", a)
    _check_operand("B", b)
    dev = a.tensor.device
    _check(dev.type == "cuda" and b.tensor.device == dev,
           "x, w and dy must lie on the card (the CPU takes the plain "
           "version through repro_torch.kernels.ops)")
    _check(a.tensor.data_ptr() % 16 == 0 and b.tensor.data_ptr() % 16 == 0,
           "16-byte aligned x, w and dy")
    p = p or bwd_plan(prod.product, prod.e, prod.m, prod.n, prod.k,
                      sm_count(dev.index))
    _check(p.tiles < 2 ** 31, "too many tiles")
    out = torch.empty(prod.out_shape, dtype=torch.bfloat16, device=dev)
    part = (torch.empty((p.shares, prod.n, prod.m), dtype=torch.float32,
                        device=dev)
            if prod.product == "dx_sum" and p.shares > 1 else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        fn = build.entry("expert_gemm_bwd", "expert_gemm_bwd_launch",
                         _BWD_ARGTYPES)
        err = fn(a.tensor.data_ptr(), *a.dims, *a.strides,
                 b.tensor.data_ptr(), *b.dims, *b.strides, out.data_ptr(),
                 None if part is None else part.data_ptr(), prod.m, prod.n,
                 prod.k, prod.e, int(a.mn_major), p.block_n, p.m_tiles,
                 p.n_tiles, p.shares, p.grid[0], p.stages, p.smem, stream)
    if err != 0:
        raise RuntimeError(f"expert_gemm_bwd launch failed: CUDA error {err}")
    return out, p


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
