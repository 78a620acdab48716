"""The launch plan of the bf16 tensor-core tile walk
(``csrc/attention_tc.cuh``), which four wrappers share: the flash forward,
the dense decode, the ragged paged attention and the paged decode.

Which route a call takes, how its rows fall into blocks, how far its keys
are split and how much f32 scratch the split needs all follow from the
shapes, the dtype and the SM count alone, never from ``kv_len``,
``q_offset``, ``lengths`` or ``q_len``: those lie on the card, and reading
them would cost a host sync per call (and would bar capturing the call in
a CUDA graph).  Pure Python: the CPU tests check it at the main path's
shapes.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

TILE_KEYS = 64  # keys per staged tile of the tensor-core walk
MAX_SPLIT = 32  # the combine pass's bound on n_split
#: blocks per SM a key split aims at, for 16-row (decode) and 64-row
#: (prefill) blocks
NARROW_BLOCKS_PER_SM = 8
WIDE_BLOCKS_PER_SM = 4


@dataclass(frozen=True)
class Plan:
    """How one call runs: its route, rows per block, row blocks per
    (batch row, KV head), key splits, and the f32 scratch (m and l hold
    ``part_rows`` floats each, acc ``part_rows * D``; 0 without a split).
    The CUDA-core routes of the dense and the paged decode cut their keys
    into fixed shares of ``split_keys`` positions; everywhere else it is 0,
    since the tensor-core walk cuts each block's visible keys on the
    card."""
    route: str
    block_rows: int
    row_blocks: int
    n_split: int
    part_rows: int
    split_keys: int = 0

    @property
    def blocks(self) -> int:
        """Blocks per (batch row, KV head) of the split pass."""
        return self.row_blocks * self.n_split


def tensor_core_route(dtype: torch.dtype, d: int) -> bool:
    """bf16 heads of D % 16 == 0 up to 128 take the tensor-core walk."""
    return dtype == torch.bfloat16 and d % 16 == 0 and 16 <= d <= 128


def plan(b: int, sq: int, skv: int, hq: int, hkv: int, d: int,
          dtype: torch.dtype, n_sm: int) -> Plan:
    """The launch plan of B batch rows (or segments) of Sq queries (or
    max_q packed ones) against Skv key positions (max_pages x page_size
    for the pools), from the shapes, the dtype and the SM count alone.
    Off the tensor-core route it is the unsplit CUDA-core walk.

    The tensor-core route puts the Sq G flattened rows of a (batch row, KV
    head) in blocks of 64 (4 warps x 16 rows; a decode with Sq G <= 16
    takes one 16-row block whose warps split the keys).  It splits the key
    range when the grid is short of the card: a decode-shaped grid under
    2 blocks per SM, or a prefill-shaped one (64-row blocks, each with a
    whole chunk of tensor-core work) under 1 block per 2 SMs.  The split
    then aims at NARROW_BLOCKS_PER_SM blocks per SM for 16-row blocks and
    WIDE_BLOCKS_PER_SM for 64-row ones (whose partials are 4 times
    larger), at most one split per 64-key tile and MAX_SPLIT in all: a
    block walks its keys as a chain of dependent tiles, so shorter chains
    on more SMs pay until the partials and the combine cost more."""
    if not tensor_core_route(dtype, d):
        return Plan("cuda_core", 0, 0, 1, 0)
    rows = sq * (hq // hkv)
    block_rows = 16 if rows <= 16 else 64
    row_blocks = -(-rows // block_rows)
    base = b * hkv * row_blocks
    narrow = block_rows == 16
    short = (base < 2 * n_sm) if narrow else (2 * base <= n_sm)
    n_split = 1
    if short:
        target = n_sm * (NARROW_BLOCKS_PER_SM if narrow
                         else WIDE_BLOCKS_PER_SM)
        n_split = max(1, min(-(-target // max(base, 1)),
                             -(-skv // TILE_KEYS), MAX_SPLIT))
    part_rows = base * n_split * block_rows if n_split > 1 else 0
    return Plan("tensor_core", block_rows, row_blocks, n_split, part_rows)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of card ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def scratch(part_rows: int, d: int, dev: torch.device
             ) -> tuple[torch.Tensor | None, int, int, int]:
    """The split's f32 scratch in one allocation, and pointers to its m
    (part_rows), l (part_rows) and acc (part_rows x D, 16-byte aligned);
    nulls when there is no split.  The caller holds the tensor until its
    launch is enqueued."""
    if part_rows == 0:
        return None, 0, 0, 0
    span = -(-part_rows // 4) * 4  # floats per region, a multiple of 16 B
    buf = torch.empty((2 * span + part_rows * d,), dtype=torch.float32,
                      device=dev)
    base = buf.data_ptr()
    return buf, base, base + 4 * span, base + 8 * span


