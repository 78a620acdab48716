"""Platform characterizer: multi-dimensional interconnect + collectives
(paper §III-C).

A *platform* is a set of NPUs joined by a multi-dimensional interconnection
network (ICN).  Each dimension has a link latency ``T_link``, a per-NPU link
bandwidth ``BW_link`` and a link efficiency ``Eff_link`` (the paper measured
~75% for NVLink).  Dimension 0 is the innermost/fastest (scale-up, e.g. the
high-bandwidth domain), later dimensions are scale-out.

Collective cost model
---------------------
GenZ generates, for each degree of parallelism, the collective pattern it
needs (paper: AllReduce for TP & EP-combine, All-to-All for EP dispatch,
Send-Recv for PP, AllGather for SP & TP, ReduceScatter for TP) and prices it
with topology-aware alpha-beta models:

  ring    :  AR = 2 (n-1)/n * S / bw + 2 (n-1) * lat
             AG = RS = (n-1)/n * S / bw + (n-1) * lat
             A2A = (n-1)/n * S / bw + (n-1) * lat
  switch  :  same bandwidth terms (each NPU still moves (n-1)/n of the data
             through its single uplink) but hop-count latency: 2 hops per
             phase.
  fc      :  fully connected; n-1 parallel links, one hop.

AllReduce may be decomposed into ReduceScatter + AllGather (paper §III-C);
``allreduce_decomposed`` exposes that knob.  Multi-dimension collectives are
priced hierarchically (RS inner -> AR outer -> AG inner), the same structure
ASTRA-sim's system layer uses for topology-aware algorithms.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from enum import Enum
from typing import Sequence

from .hardware import NPU, PowerModel


class Collective(str, Enum):
    ALL_REDUCE = "all_reduce"
    ALL_GATHER = "all_gather"
    REDUCE_SCATTER = "reduce_scatter"
    ALL_TO_ALL = "all_to_all"
    SEND_RECV = "send_recv"


@dataclass(frozen=True)
class NetworkDim:
    """One dimension of the interconnection network."""

    name: str
    size: int  # NPUs along this dimension
    bw: float  # bytes/s per NPU along this dim (per-direction)
    latency: float  # seconds per hop (T_link)
    efficiency: float = 1.0  # Eff_link
    topology: str = "ring"  # ring | switch | fc

    @property
    def effective_bw(self) -> float:
        return self.bw * self.efficiency

    def scaled(self, *, bw_mult: float = 1.0, latency_mult: float = 1.0) -> "NetworkDim":
        return dataclasses.replace(self, bw=self.bw * bw_mult,
                                   latency=self.latency * latency_mult)


def _hops(dim: NetworkDim, phases: int) -> float:
    """Latency term: number of serialized link traversals for one phase of a
    collective spanning the dimension."""
    n = dim.size
    if n <= 1:
        return 0.0
    if dim.topology == "ring":
        return (n - 1) * phases * dim.latency
    if dim.topology == "switch":
        return 2.0 * phases * dim.latency  # up + down through the switch
    if dim.topology == "fc":
        return 1.0 * phases * dim.latency
    raise ValueError(f"unknown topology {dim.topology!r}")


def _bw_term(dim: NetworkDim, bytes_on_wire: float) -> float:
    if dim.size <= 1 or bytes_on_wire <= 0:
        return 0.0
    bw = dim.effective_bw
    if dim.topology == "fc":
        # n-1 parallel point-to-point links; data is spread across them.
        bw = bw  # bw is already the aggregate per-NPU injection bandwidth
    return bytes_on_wire / bw


def collective_time_1d(kind: Collective, size_bytes: float, dim: NetworkDim) -> float:
    """Time for a collective over a single network dimension.

    ``size_bytes`` is the *full* (unsharded) payload per NPU: for AllGather it
    is the gathered result size, for ReduceScatter the input size, for
    AllReduce the tensor size, for All-to-All the per-NPU send buffer.
    """
    n = dim.size
    if n <= 1:
        return 0.0
    frac = (n - 1) / n
    if kind == Collective.ALL_REDUCE:
        return _bw_term(dim, 2.0 * frac * size_bytes) + _hops(dim, 2)
    if kind in (Collective.ALL_GATHER, Collective.REDUCE_SCATTER):
        return _bw_term(dim, frac * size_bytes) + _hops(dim, 1)
    if kind == Collective.ALL_TO_ALL:
        return _bw_term(dim, frac * size_bytes) + _hops(dim, 1)
    if kind == Collective.SEND_RECV:
        return _bw_term(dim, size_bytes) + dim.latency
    raise ValueError(kind)


def collective_time(kind: Collective, size_bytes: float,
                    dims: Sequence[NetworkDim]) -> float:
    """Hierarchical collective across one or more network dimensions.

    dims[0] is the innermost (fastest) dimension.  AllReduce over k dims is
    priced as RS(inner) ... -> AR(outermost, shrunk payload) -> ... AG(inner),
    which matches ring/tree hierarchical algorithms.
    """
    dims = [d for d in dims if d.size > 1]
    if not dims:
        return 0.0
    if len(dims) == 1:
        return collective_time_1d(kind, size_bytes, dims[0])

    inner, rest = dims[0], dims[1:]
    n = inner.size
    if kind == Collective.ALL_REDUCE:
        t = collective_time_1d(Collective.REDUCE_SCATTER, size_bytes, inner)
        t += collective_time(Collective.ALL_REDUCE, size_bytes / n, rest)
        t += collective_time_1d(Collective.ALL_GATHER, size_bytes, inner)
        return t
    if kind == Collective.ALL_GATHER:
        # Gather across outer dims on the shard, then inner on the full size.
        t = collective_time(Collective.ALL_GATHER, size_bytes / n, rest)
        t += collective_time_1d(Collective.ALL_GATHER, size_bytes, inner)
        return t
    if kind == Collective.REDUCE_SCATTER:
        t = collective_time_1d(Collective.REDUCE_SCATTER, size_bytes, inner)
        t += collective_time(Collective.REDUCE_SCATTER, size_bytes / n, rest)
        return t
    if kind == Collective.ALL_TO_ALL:
        # Hierarchical A2A: exchange within inner dim, then across outer.
        t = collective_time_1d(Collective.ALL_TO_ALL, size_bytes, inner)
        t += collective_time(Collective.ALL_TO_ALL, size_bytes, rest)
        return t
    if kind == Collective.SEND_RECV:
        # Point-to-point across the outermost dimension only.
        return collective_time_1d(Collective.SEND_RECV, size_bytes, dims[-1])
    raise ValueError(kind)


@dataclass(frozen=True)
class Platform:
    """An inference platform: ``npus`` identical NPUs + a multi-dim ICN."""

    npu: NPU
    dims: tuple[NetworkDim, ...]
    power: PowerModel | None = None
    name: str = "platform"

    @property
    def num_npus(self) -> int:
        n = 1
        for d in self.dims:
            n *= d.size
        return max(n, 1)

    @property
    def total_mem_capacity(self) -> float:
        return self.npu.mem.capacity * self.num_npus

    @property
    def total_flops(self) -> float:
        return self.npu.flops * self.num_npus

    def dims_for(self, count: int) -> list[NetworkDim]:
        """Innermost network dims spanning ``count`` NPUs.

        Parallelism groups are mapped innermost-first (paper: order TP:EP:PP,
        TP NPUs physically closest).  If a group spans a fraction of a
        dimension the dimension is split.
        """
        out: list[NetworkDim] = []
        remaining = count
        for d in self.dims:
            if remaining <= 1:
                break
            take = min(d.size, remaining)
            out.append(dataclasses.replace(d, size=take))
            remaining = -(-remaining // d.size)  # ceil div
        if remaining > 1:
            raise ValueError(
                f"parallelism degree {count} exceeds platform size {self.num_npus}")
        return out

    def dims_between(self, inner_skip: int, count: int) -> list[NetworkDim]:
        """Network dims for a group of ``count`` NPUs whose members are
        ``inner_skip`` NPUs apart (i.e. the group sits *outside* an inner
        parallelism group of that size)."""
        out: list[NetworkDim] = []
        skip = inner_skip
        need = count
        for d in self.dims:
            if need <= 1:
                break
            if skip >= d.size:
                skip = -(-skip // d.size)
                continue
            if skip > 1:
                # group occupies the remainder of this dim
                avail = d.size // skip
                take = min(avail, need)
                skip = 1
            else:
                take = min(d.size, need)
            if take > 1:
                out.append(dataclasses.replace(d, size=take))
                need = -(-need // take)
        if need > 1:
            raise ValueError(
                f"group of {count} with stride {inner_skip} exceeds platform")
        return out

    def collective(self, kind: Collective, size_bytes: float,
                   participants: int, inner_skip: int = 1) -> float:
        if participants <= 1:
            return 0.0
        dims = self.dims_between(inner_skip, participants)
        return collective_time(kind, size_bytes, dims)


def make_platform(npu: NPU, dims: Sequence[NetworkDim],
                  peak_power: float | None = None, name: str = "platform") -> Platform:
    power = PowerModel(peak_power) if peak_power is not None else None
    return Platform(npu=npu, dims=tuple(dims), power=power, name=name)
