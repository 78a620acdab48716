"""The expert GEMM's launch plan and its wrapper's refusals, on the CPU.

The bf16 route (``csrc/expert_gemm.cu``, wgmma on a TMA ring) runs only on
the card; what surrounds it is Python that these tests reach: the plan
that :func:`repro_torch.kernels.expert_gemm.plan` derives from the shapes,
the dtype and the SM count alone, and the checks the wrapper makes before
it launches.  Pure Python, no kernel and no JAX: a few seconds in all.
"""

import ctypes
import dataclasses
import re

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.kernels import build, expert_gemm, ref
from repro_torch.kernels.expert_gemm import plan

N_SM = 132  # the H100's SMs
REPO_CSRC = build.CSRC


def _moe_shapes(arch, reduced, cs):
    """(E, C, D, F) of the up/gate and down products at each C."""
    spec = (registry.get_reduced if reduced else registry.get_spec)(arch)
    e, d, f = spec.moe.num_experts, spec.d_model, spec.moe.d_ff_expert
    return [s for c in cs for s in ((e, c, d, f), (e, c, f, d))]


# deepseek-moe-16b's four timed shapes (a mixed step's 264 packed tokens,
# a decode-only step's 8), granite-moe-3b-a800m's, the reduced configs'
# (C up to the CPU tests' packed steps), the ragged kernel_check cases and
# jamba-v0.1-52b's two-dispatch shapes
SHAPES = (_moe_shapes("deepseek-moe-16b", False, (264, 8))
          + _moe_shapes("granite-moe-3b-a800m", False, (264, 8))
          + _moe_shapes("deepseek-moe-16b", True, (1, 13, 40))
          + _moe_shapes("granite-moe-3b-a800m", True, (1, 13, 40))
          + [(3, 37, 200, 136), (5, 70, 72, 200), (64, 600, 2048, 1408)]
          # jamba-v0.1-52b's: a prefill chunk's 2 x 128 tokens and a
          # decode step's 8, D 4,096 <-> F 14,336 (a 14,336-deep down)
          + _moe_shapes("jamba-v0.1-52b", False, (256, 8)))


def _coverage(p, c, f):
    """How often the grid's blocks store each (C row, F column) of one
    expert: a block stores its tile clipped at the C and F edges."""
    hits = np.zeros((c, f), dtype=np.int32)
    for ct in range(p.grid[0]):
        for ft in range(p.grid[1]):
            hits[ct * p.c_tile:(ct + 1) * p.c_tile,
                 ft * p.block_f:(ft + 1) * p.block_f] += 1
    return hits


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plan_tiles_every_output_once_within_the_card(shape):
    e, c, d, f = shape
    p = plan(e, c, d, f, torch.bfloat16, N_SM)
    assert p.route == "wgmma" and p.grid[2] == e and p.cluster == 1
    assert (_coverage(p, c, f) == 1).all()
    # wgmma: M 64 rows of F per consumer warpgroup; N a multiple of 8, at
    # most 256 an instruction, the widths summing to the C tile
    assert p.block_f in (64, 128)
    assert p.threads == 128 * (p.block_f // 64 + 1)
    assert p.c_tile % 8 == 0 and 8 <= p.c_tile <= expert_gemm.C_CAP
    assert sum(p.n_splits) == p.c_tile
    assert all(n % 8 == 0 and n <= 256 for n in p.n_splits)
    assert len(set(p.n_splits)) == len(p.n_splits)
    # the source's wrappers: the powers of two, and 136 / 144 past 256
    src = (build.CSRC / "mma_ptx.cuh").read_text()
    assert all(f"N == {n})" in src for n in p.n_splits)
    # the ring and its barriers fit a block's shared memory, with at least
    # two slots; the drained ring holds the epilogue's padded bf16 tile
    slot = expert_gemm.slot_bytes(p.block_f, p.c_tile)
    assert 2 <= p.stages <= expert_gemm.MAX_STAGES
    assert p.smem == expert_gemm.ALIGN + p.stages * (slot + 16)
    assert p.smem <= expert_gemm.SMEM_LIMIT == 232_448
    assert p.c_tile * (p.block_f + 8) * 2 <= p.stages * slot


def test_plan_at_the_serving_shapes():
    """deepseek-moe-16b: 128-row F tiles (704 and 1,024 blocks), N = 264
    as 136 + 128 in 4 slots of 50 KB, N = 8 in 8 slots; granite-moe-3b-
    a800m's up/gate (F = 512) still fills the card with 160 blocks of 128
    rows; the ragged case's 6 blocks of 128 rows would not, so it takes 64
    (12 blocks)."""
    mixed = plan(64, 264, 2048, 1408, torch.bfloat16, N_SM)
    assert (mixed.block_f, mixed.c_tile, mixed.n_splits, mixed.stages,
            mixed.grid) == (128, 264, (136, 128), 4, (1, 11, 64))
    assert plan(64, 264, 1408, 2048, torch.bfloat16, N_SM).grid \
        == (1, 16, 64)
    decode = plan(64, 8, 2048, 1408, torch.bfloat16, N_SM)
    assert (decode.block_f, decode.c_tile, decode.n_splits, decode.stages) \
        == (128, 8, (8,), 8)
    granite = plan(40, 264, 1536, 512, torch.bfloat16, N_SM)
    assert (granite.block_f, granite.grid) == (128, (1, 4, 40))
    ragged = plan(3, 37, 200, 136, torch.bfloat16, N_SM)
    assert (ragged.block_f, ragged.c_tile, ragged.grid) == (64, 40, (1, 3, 3))
    f32 = plan(64, 264, 2048, 1408, torch.float32, N_SM)
    assert (f32.route, f32.grid, f32.threads) == ("cuda_core", (11, 5, 64),
                                                  256)


def test_plan_depends_on_shapes_only_and_tiles_wide_c(monkeypatch):
    """C = 1..600 at D = 2048, F = 1408: the plan never asks the card, the
    same shapes give the same plan, and a C past the cap takes more C
    tiles of one launch, none of them empty."""
    def no_card(*a, **k):
        raise AssertionError("the plan asked the card")
    for name in ("get_device_properties", "current_device", "synchronize",
                 "is_available"):
        monkeypatch.setattr(torch.cuda, name, no_card)
    cap = expert_gemm.C_CAP
    for c in range(1, 601):
        p = plan(64, c, 2048, 1408, torch.bfloat16, N_SM)
        assert p == plan(64, c, 2048, 1408, torch.bfloat16, N_SM)
        assert p.c_tiles == -(-c // cap) == p.grid[0]
        assert (p.c_tiles - 1) * p.c_tile < c <= p.c_tiles * p.c_tile
        assert p.c_tile - -(-c // p.c_tiles) < 8
        assert p.grid[1:] == (-(-1408 // p.block_f), 64)


def test_plan_constants_match_the_source():
    """The plan's constants are the CUDA source's, and both split x's
    rows into TMA boxes alike (one box up to 256 rows, else two of a
    multiple of 8)."""
    src = (build.CSRC / "expert_gemm.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert const("kSlab") == expert_gemm.SLAB
    assert const("kCCap") == expert_gemm.C_CAP
    assert const("kMaxStages") == expert_gemm.MAX_STAGES
    assert const("kSmemLimit") == expert_gemm.SMEM_LIMIT
    assert const("kAlign") == expert_gemm.ALIGN
    assert "return nt > 256 ? 2 : 1;" in src
    assert "return x_loads(nt) == 2 ? (nt / 2 + 7) / 8 * 8 : nt;" in src
    for nt in range(8, expert_gemm.C_CAP + 1, 8):
        two = nt > 256
        want = (nt // 2 + 7) // 8 * 8 if two else nt
        assert expert_gemm.x_box_rows(nt) == want
        assert expert_gemm.slot_bytes(64, nt) \
            == (64 + (2 if two else 1) * want) * expert_gemm.SLAB * 2


@pytest.mark.parametrize("case,match", [
    ("d_not_8", "multiples of 8"),
    ("f_not_8", "multiples of 8"),
    ("expert_stride", "strides"),
    ("rows_not_contiguous", "strides"),
    ("w_transposed", "contiguous"),
    ("mixed_dtypes", "share one dtype"),
])
def test_wrapper_refuses_what_the_contract_refuses(case, match):
    """The contract's refusals come before the device check, so they show
    on the CPU; nothing is launched."""
    e, c, d, f = 3, 5, 16, 24
    x = torch.zeros((e, c, d), dtype=torch.bfloat16)
    w = torch.zeros((e, d, f), dtype=torch.bfloat16)
    if case == "d_not_8":
        x, w = x[..., :12].contiguous(), w[:, :12].contiguous()
    elif case == "f_not_8":
        w = w[..., :20].contiguous()
    elif case == "expert_stride":  # every other (C, D) block of a larger x
        x = torch.zeros((2 * e, c, d), dtype=torch.bfloat16)[::2]
    elif case == "rows_not_contiguous":
        x = torch.zeros((e, d, c), dtype=torch.bfloat16).transpose(1, 2)
    elif case == "w_transposed":
        w = torch.zeros((e, f, d), dtype=torch.bfloat16).transpose(1, 2)
    else:
        w = w.float()
    before, routes = expert_gemm.launches, dict(expert_gemm.routes)
    with pytest.raises(ValueError, match=match):
        expert_gemm.expert_gemm_cuda(x, w)
    assert expert_gemm.launches == before and expert_gemm.routes == routes


# ---------------------------------------------------------------------------
# the backward (csrc/expert_gemm_bwd.cu): its plan and its operands
# ---------------------------------------------------------------------------

def _bwd_shapes(arch, reduced, c):
    """(product, E, M, N, K) of the four gradients of an MoE layer's up /
    gate product (x broadcast: the summed dX and dW) and of its down
    product (per expert) at C tokens."""
    spec = (registry.get_reduced if reduced else registry.get_spec)(arch)
    e, d, f = spec.moe.num_experts, spec.d_model, spec.moe.d_ff_expert
    return [("dx_sum", e, d, c, f), ("dw", e, f, d, c),  # up / gate
            ("dx", e, f, c, d), ("dw", e, d, f, c)]  # down: D <-> F


# granite-moe-3b-a800m's and deepseek-moe-16b's training micro-batch of
# 1,024 tokens, the reduced configs' (C of the CPU tests), the ragged
# kernel_check cases (C 37, F 136 and 200) and chip_smoke's untimed C =
# 1,000 at F = 200
BWD_SHAPES = (_bwd_shapes("granite-moe-3b-a800m", False, 1024)
              + _bwd_shapes("deepseek-moe-16b", False, 1024)
              + _bwd_shapes("jamba-v0.1-52b", False, 1024)
              + _bwd_shapes("granite-moe-3b-a800m", True, 13)
              + _bwd_shapes("deepseek-moe-16b", True, 40)
              + [("dx_sum", 5, 72, 37, 200), ("dw", 5, 200, 72, 37),
                 ("dx", 3, 200, 37, 136), ("dw", 3, 136, 200, 37),
                 ("dx_sum", 8, 512, 1000, 200), ("dw", 8, 200, 512, 1000),
                 ("dx", 4, 256, 1000, 384), ("dw", 4, 384, 256, 1000)])


def _share_ranges(p):
    """The pairs [j0, j1) of each grid z, as the kernel computes them."""
    return [(z * p.pairs // p.shares, (z + 1) * p.pairs // p.shares)
            for z in range(p.shares)]


@pytest.mark.parametrize("shape", BWD_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_bwd_plan_tiles_and_walks_the_depth_once(shape):
    """Every output element has one tile; the shares' pair ranges cover
    the E * ceil(K / 64) (expert, slab) pairs exactly once, in order, and
    a per-expert product's z walks exactly its expert's slabs; the ring
    fits a block with at least two slots, which hold the staged tile."""
    product, e, m, n, k = shape
    p = expert_gemm.bwd_plan(product, e, m, n, k, N_SM)
    slabs = -(-k // expert_gemm.SLAB)
    assert p.route == "wgmma" and p.product == product
    assert p.block_n in expert_gemm.BWD_WIDTHS
    assert p.m_tiles == -(-m // expert_gemm.BWD_TILE_M)
    assert p.n_tiles == -(-n // p.block_n)
    assert p.tiles == p.n_tiles * p.m_tiles * p.shares
    assert p.grid == (min(p.tiles, N_SM), 1, 1)
    assert p.threads == expert_gemm.BWD_THREADS == 384
    assert p.pairs == e * slabs
    ranges = _share_ranges(p)
    assert ranges[0][0] == 0 and ranges[-1][1] == p.pairs
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(j1 > j0 for j0, j1 in ranges)
    if product == "dx_sum":
        assert 1 <= p.shares <= min(expert_gemm.BWD_MAX_SHARES, p.pairs)
    else:
        assert p.shares == e
        assert ranges == [(z * slabs, (z + 1) * slabs) for z in range(e)]
    slot = expert_gemm.bwd_stage_bytes(p.block_n)
    assert 2 <= p.stages <= expert_gemm.BWD_MAX_STAGES
    assert p.smem == expert_gemm.ALIGN + p.stages * (slot + 16)
    assert p.smem <= expert_gemm.SMEM_LIMIT


def test_bwd_plan_fills_the_card_at_granites_training_shapes():
    """granite-moe-3b-a800m (E 40, D 1,536 <-> F 512, 1,024 tokens): the
    summed dX, 12 x 4 tiles of 128 x 256 deep 320 slabs, splits its depth
    into 5 shares, so that its 240 tiles cover the 132 SMs (unsplit, 48
    tiles would leave most idle; on an H100 5 shares ran fastest of 1-16);
    the other three take 128 x 256 tiles, 640-960 of them, and every
    product one persistent block an SM."""
    (dxs, dwb, dxd, dwd) = _bwd_shapes("granite-moe-3b-a800m", False, 1024)
    p = expert_gemm.bwd_plan(*dxs, N_SM)
    assert p.pairs == 40 * 8 and p.shares > 1
    assert p.n_tiles * p.m_tiles * p.shares >= N_SM
    assert (p.block_n, p.n_tiles, p.m_tiles, p.shares) == (256, 4, 12, 5)

    def tiles(shape):
        q = expert_gemm.bwd_plan(*shape, N_SM)
        return q.block_n, q.n_tiles, q.m_tiles, q.shares
    assert tiles(dwb) == (256, 6, 4, 40)
    assert tiles(dxd) == (256, 4, 4, 40)
    assert tiles(dwd) == (256, 2, 12, 40)
    for shape in (dxs, dwb, dxd, dwd):
        assert expert_gemm.bwd_plan(*shape, N_SM).grid == (N_SM, 1, 1)
    # fewer SMs: the same work splits less
    assert expert_gemm.bwd_plan(*dxs, 16).shares \
        <= expert_gemm.bwd_plan(*dxs, N_SM).shares


def test_bwd_plan_depends_on_its_arguments_alone(monkeypatch):
    """The plan never asks the card, and the same arguments give the same
    plan (so a call stays capturable in a CUDA graph)."""
    def no_card(*a, **k):
        raise AssertionError("the plan asked the card")
    for name in ("get_device_properties", "current_device", "synchronize",
                 "is_available"):
        monkeypatch.setattr(torch.cuda, name, no_card)
    for shape in BWD_SHAPES:
        for n_sm in (16, 114, N_SM):
            p = expert_gemm.bwd_plan(*shape, n_sm)
            assert p == expert_gemm.bwd_plan(*shape, n_sm)
    with pytest.raises(ValueError, match="unknown backward product"):
        expert_gemm.bwd_plan("dy", 1, 8, 8, 8, N_SM)


def test_bwd_constants_and_entry_point_match_the_source():
    """The backward's plan constants are its source's, and the wrapper
    binds the C entry point with one ctypes type per C parameter."""
    src = (REPO_CSRC / "expert_gemm_bwd.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert const("kSlab") == expert_gemm.SLAB
    assert const("kTileM") == expert_gemm.BWD_TILE_M
    assert const("kMaxStages") == expert_gemm.BWD_MAX_STAGES
    assert const("kSmemLimit") == expert_gemm.SMEM_LIMIT
    assert const("kAlign") == expert_gemm.ALIGN
    assert const("kThreads") == expert_gemm.BWD_THREADS
    assert "bn == 64 ? 0 : bn == 128 ? 1 : bn == 256 ? 2 : -1" in src
    assert sorted(expert_gemm.BWD_WIDTHS) == [64, 128, 256]
    head = 'extern "C" int expert_gemm_bwd_launch('
    params = src[src.index(head) + len(head):].split(")")[0].split(",")
    types = {"int": ctypes.c_int, "long long": ctypes.c_longlong}
    want = [ctypes.c_void_p if "*" in prm else
            types[" ".join(prm.replace("const ", "").split()[:-1])]
            for prm in params]
    assert list(expert_gemm._BWD_ARGTYPES) == want
    assert (REPO_CSRC.parents[2] / expert_gemm.BWD_SOURCE).is_file()


def _bwd_case(broadcast, c, e=3, d=16, f=24, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((c, d) if broadcast else (e, c, d), generator=gen)
    w = torch.randn((e, d, f), generator=gen)
    dy = torch.randn((e, c, f), generator=gen)
    return tuple(t.to(torch.bfloat16) for t in (x, w, dy))


@pytest.mark.parametrize("broadcast", [False, True],
                         ids=["per_expert", "broadcast"])
@pytest.mark.parametrize("c", [1024, 37])
def test_bwd_operands_are_the_inputs_in_place(broadcast, c):
    """Every bf16 operand of the three products is the caller's own
    tensor (the same object, so no new allocation and the same data_ptr
    and storage), read through 3-D maps of its own dims and strides, with
    the transpose flags of each product: dW reads dY and X MN-major, dX W
    and dY K-major."""
    x, w, dy = _bwd_case(broadcast, c)
    e, _, f = dy.shape
    d = w.shape[1]
    dw, dx = expert_gemm.bwd_products(x, w, dy)
    for prod, (a, b) in ((dw, (dy, x)), (dx, (w, dy))):
        for op, src in ((prod.a, a), (prod.b, b)):
            assert op.tensor is src
            assert op.tensor.data_ptr() == src.data_ptr()
            assert op.tensor.untyped_storage().data_ptr() \
                == src.untyped_storage().data_ptr()
    assert (dw.grad, dw.product, dw.e, dw.m, dw.n, dw.k, dw.out_shape) \
        == ("dw", "dw", e, f, d, c, (e, d, f))
    assert dw.a.mn_major and dw.b.mn_major
    assert (dw.a.dims, dw.a.strides) == ((f, c, e), (f, c * f))
    assert (dw.b.dims, dw.b.strides) == (
        ((d, c, 1), (d, c * d)) if broadcast else ((d, c, e), (d, c * d)))
    assert (dx.grad, dx.product, dx.m, dx.n, dx.k, dx.out_shape) == (
        "dx", "dx_sum" if broadcast else "dx", d, c, f, tuple(x.shape))
    assert not dx.a.mn_major and not dx.b.mn_major
    assert (dx.a.dims, dx.a.strides) == ((f, d, e), (f, d * f))
    assert (dx.b.dims, dx.b.strides) == ((f, c, e), (f, c * f))
    assert [p.grad for p in expert_gemm.bwd_products(
        x, w, dy, need_x=False)] == ["dw"]
    assert [p.grad for p in expert_gemm.bwd_products(
        x, w, dy, need_w=False)] == ["dx"]


def _map_view(op):
    """The (experts, rows, inner) tensor a 3-D map of ``op`` reads."""
    t = op.tensor
    return torch.as_strided(t, (op.dims[2], op.dims[1], op.dims[0]),
                            (op.strides[1], op.strides[0], 1),
                            t.storage_offset())


def _emulate(prod, p):
    """The kernel's arithmetic from the operand description and the plan:
    A (M x K) and B (K x N) per expert read through the maps (transposed
    where the flag says MN-major), each grid z's pairs of (expert, 64-deep
    slab) summed in f32, the shares' partials added in share order, out^T
    written as rows of N."""
    a, b = _map_view(prod.a).float(), _map_view(prod.b).float()
    a = a.transpose(1, 2) if prod.a.mn_major else a  # (E, M, K)
    b = b if prod.b.mn_major else b.transpose(1, 2)  # (E|1, K, N)
    slabs = -(-prod.k // expert_gemm.SLAB)
    outs = []
    for j0, j1 in _share_ranges(p):
        acc = torch.zeros((prod.m, prod.n))
        for j in range(j0, j1):
            ex, k0 = j // slabs, (j % slabs) * expert_gemm.SLAB
            bj = b[ex if b.shape[0] > 1 else 0]
            acc += a[ex, :, k0:k0 + expert_gemm.SLAB] \
                @ bj[k0:k0 + expert_gemm.SLAB]
        outs.append(acc)
    if prod.product == "dx_sum":
        total = outs[0]
        for part in outs[1:]:
            total = total + part
        outs = [total]
    out = torch.stack([o.T for o in outs]).to(torch.bfloat16)
    return out.reshape(prod.out_shape), p


@pytest.mark.parametrize("broadcast", [False, True],
                         ids=["per_expert", "broadcast"])
@pytest.mark.parametrize("c", [1024, 37])
def test_bwd_wrapper_on_the_emulated_kernel(monkeypatch, broadcast, c):
    """The bf16 route of ``expert_gemm_bwd_cuda`` with the launch swapped
    for :func:`_emulate` (the plan the card would get, the operands as
    described): its gradients equal the plain backward's on the same bf16
    values within one bf16 rounding, one counted call a gradient on the
    wgmma route.  F = 200 cuts the summed dX's last slab of each expert at
    its end; the summed dX's depth is split into 5 shares, whose bounds
    fall inside an expert's slabs (the plan would not split so small a
    product)."""
    x, w, dy = _bwd_case(broadcast, c, d=24, f=200, seed=1)
    plans = []

    def launch(prod):
        p = expert_gemm.bwd_plan(prod.product, prod.e, prod.m, prod.n,
                                 prod.k, N_SM)
        if prod.product == "dx_sum":
            tiles = p.n_tiles * p.m_tiles * 5
            p = dataclasses.replace(p, shares=5, tiles=tiles,
                                    grid=(min(tiles, N_SM), 1, 1))
        plans.append(p)
        return _emulate(prod, p)

    monkeypatch.setattr(expert_gemm, "_launch_bwd", launch)
    monkeypatch.setattr(expert_gemm, "bwd_routes",
                        {"wgmma": 0, "cuda_core": 0})
    n0 = expert_gemm.bwd_launches
    dx, dw = expert_gemm.expert_gemm_bwd_cuda(x, w, dy)
    want_dx, want_dw = ref.expert_gemm_bwd_reference(x.float(), w.float(),
                                                     dy.float())
    for got, want in ((dx, want_dx), (dw, want_dw)):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        scale = max(1.0, float(want.abs().max()))
        err = (got.float() - want).abs()
        assert (err <= 2.0 ** -8 * want.abs() + 1e-5 * scale).all()
    assert expert_gemm.bwd_launches - n0 == 2
    assert expert_gemm.bwd_routes == {"wgmma": 2, "cuda_core": 0}
    assert expert_gemm.last_bwd_plans == {"dw": plans[0], "dx": plans[1]}
    if broadcast:
        assert plans[1].product == "dx_sum"
        assert [j0 % 4 for j0, _ in _share_ranges(plans[1])] \
            == [0, 2, 0, 3, 1]  # 4 slabs an expert


@pytest.mark.parametrize("case,match", [
    ("dy_last_axis_strided", "last axis must be contiguous"),
    ("dy_stride_off_16_bytes", "multiples of 8 elements"),
    ("d_not_8", "multiples of 8"),
    ("mixed_dtypes", "share one dtype"),
    ("cpu", "must lie on the card"),
])
def test_bwd_wrapper_refuses_what_the_contract_refuses(case, match):
    """The bf16 route's refusals; nothing is counted."""
    x, w, dy = _bwd_case(False, 5, d=16, f=24)
    if case == "dy_last_axis_strided":
        dy = torch.zeros((3, 5, 48), dtype=torch.bfloat16)[..., ::2]
    elif case == "dy_stride_off_16_bytes":  # rows 28 apart: 56 bytes
        dy = torch.zeros((3, 5, 28), dtype=torch.bfloat16)[..., :24]
    elif case == "d_not_8":
        x, w = x[..., :12].contiguous(), w[:, :12].contiguous()
    elif case == "mixed_dtypes":
        dy = dy.float()
    before = expert_gemm.bwd_launches, dict(expert_gemm.bwd_routes)
    with pytest.raises(ValueError, match=match):
        expert_gemm.expert_gemm_bwd_cuda(x, w, dy)
    assert (expert_gemm.bwd_launches, expert_gemm.bwd_routes) == before
