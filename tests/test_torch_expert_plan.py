"""The expert GEMM's launch plan and its wrapper's refusals, on the CPU.

The bf16 route (``csrc/expert_gemm.cu``, wgmma on a TMA ring) runs only on
the card; what surrounds it is Python that these tests reach: the plan
that :func:`repro_torch.kernels.expert_gemm.plan` derives from the shapes,
the dtype and the SM count alone, and the checks the wrapper makes before
it launches.  Pure Python, no kernel and no JAX: a few seconds in all.
"""

import re

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.kernels import build, expert_gemm
from repro_torch.kernels.expert_gemm import plan

N_SM = 132  # the H100's SMs


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
