"""Operator-level workload description (paper §III-A/III-B).

GenZ analyzes a model *operator by operator*: for each operator we record the
compute (``flops``), the memory traffic split into activation and weight
bytes (``M_op = bytes_in + bytes_out + bytes_weight``), and optionally the
collective communication it triggers.  ``repro_torch.core.roofline``
prices these with Eq. (1); ``repro_torch.core.stages`` aggregates them
into TTFT / TPOT / throughput / energy.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from .hardware import DTYPE_BYTES
from .network import Collective


@dataclass(frozen=True)
class Optimizations:
    """Model- and system-level serving optimizations (paper Table V)."""

    weight_dtype: str = "bf16"  # quantization (lossy)
    act_dtype: str = "bf16"
    kv_dtype: str = "bf16"
    compute_dtype: str | None = None  # mixed precision: defaults to act dtype
    flash_attention: bool = True  # kernel fusion: no S^2 round-trip to HBM
    kv_window: int | None = None  # sliding-window / segment KV override
    kv_prune: float = 0.0  # fraction of cached tokens pruned (lossy)
    #: paged KV cache (PagedAttention family): capacity scales with tokens
    #: used instead of slots reserved; internal fragmentation is bounded by
    #: one page per request (lossless — changes capacity, not math)
    paged_kv: bool = False
    kv_page_size: int = 16  # tokens per page when paged_kv is set
    #: fraction of prompt tokens served from a shared radix-tree prefix
    #: cache (system prompts / few-shot templates / multi-turn history):
    #: prefill computes only the (1 - hit) uncached suffix, and the hit
    #: fraction's KV is stored ONCE across concurrent requests instead of
    #: once per request (requires ``paged_kv`` — pages are the sharing
    #: unit; lossless, greedy outputs are unchanged)
    prefix_hit_rate: float = 0.0
    weight_sparsity: float = 0.0  # fraction of weights removed (lossy)
    beam: int = 1  # beam width S_b
    allreduce_decomposed: bool = False  # AR -> RS + AG (paper §III-C)
    overlap_comm: bool = False  # overlap collectives with compute
    moe_load_balance: float = 1.0  # 1.0 = perfectly balanced (paper §IV-C);
    #   0.0 = all tokens to one expert (worst case)

    @property
    def eff_compute_dtype(self) -> str:
        return self.compute_dtype or self.act_dtype

    def wbytes(self) -> float:
        return DTYPE_BYTES[self.weight_dtype] * (1.0 - self.weight_sparsity)

    def abytes(self) -> float:
        return DTYPE_BYTES[self.act_dtype]

    def kvbytes(self) -> float:
        return DTYPE_BYTES[self.kv_dtype]


@dataclass(frozen=True)
class CollectiveCall:
    kind: Collective
    size_bytes: float  # full payload (see network.collective_time_1d)
    participants: int
    inner_skip: int = 1  # stride of the group in the physical NPU ordering


@dataclass(frozen=True)
class Operator:
    """One operator on one NPU (shapes already divided by parallelism)."""

    name: str
    kind: str  # gemm | attn | scan | elementwise | embed | collective
    flops: float = 0.0
    bytes_in: float = 0.0  # activation reads
    bytes_out: float = 0.0  # activation writes
    bytes_weight: float = 0.0  # weight reads (streamed once per pass)
    count: float = 1.0  # how many times this op runs in the pass
    collective: CollectiveCall | None = None

    @property
    def mem_bytes(self) -> float:
        return self.bytes_in + self.bytes_out + self.bytes_weight

    def times(self, n: float) -> "Operator":
        return replace(self, count=self.count * n)


def gemm(name: str, m: float, k: float, n: float, opt: Optimizations,
         *, weight: bool = True, count: float = 1.0,
         out_bytes: float | None = None) -> Operator:
    """A (m x k) @ (k x n) GEMM: 2mkn FLOPs; reads A and (optionally) weight
    B, writes C."""
    ab = opt.abytes()
    return Operator(
        name=name, kind="gemm",
        flops=2.0 * m * k * n,
        bytes_in=m * k * ab,
        bytes_out=(m * n * ab) if out_bytes is None else out_bytes,
        bytes_weight=(k * n * opt.wbytes()) if weight else k * n * ab,
        count=count,
    )


def elementwise(name: str, elems: float, opt: Optimizations,
                flops_per_elem: float = 1.0, reads: float = 1.0,
                writes: float = 1.0, count: float = 1.0) -> Operator:
    ab = opt.abytes()
    return Operator(
        name=name, kind="elementwise",
        flops=flops_per_elem * elems,
        bytes_in=reads * elems * ab,
        bytes_out=writes * elems * ab,
        count=count,
    )


def collective(name: str, kind: Collective, size_bytes: float,
               participants: int, inner_skip: int = 1,
               count: float = 1.0) -> Operator:
    return Operator(
        name=name, kind="collective", count=count,
        collective=CollectiveCall(kind, size_bytes, participants, inner_skip),
    )
