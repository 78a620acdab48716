"""Roofline-based operator timing (paper Eq. (1)) + energy (Eq. (2)).

    T_op = max( C_op / (FLOPS * Eff_C),  M_op / (BW_mem * Eff_mem) )

Collectives are priced by the platform characterizer.  The paper's default is
*non-overlapping* communication (matching SOTA serving frameworks); setting
``Optimizations.overlap_comm`` hides collective time under the surrounding
compute instead.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .hardware import NPU
from .network import Platform, collective_time
from .operators import Operator, Optimizations


@dataclass(frozen=True)
class OpTiming:
    op: Operator
    t_compute: float
    t_memory: float
    t_network: float

    @property
    def t(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_network)

    @property
    def t_total(self) -> float:
        return self.t * self.op.count

    @property
    def bound(self) -> str:
        if self.t_network >= max(self.t_compute, self.t_memory):
            return "network"
        return "compute" if self.t_compute >= self.t_memory else "memory"


@dataclass
class PassTiming:
    ops: list[OpTiming] = field(default_factory=list)

    @property
    def total(self) -> float:
        return sum(o.t_total for o in self.ops)

    @property
    def compute_time(self) -> float:
        return sum(o.t_total for o in self.ops if o.bound == "compute")

    @property
    def memory_time(self) -> float:
        return sum(o.t_total for o in self.ops if o.bound == "memory")

    @property
    def network_time(self) -> float:
        return sum(o.t_total for o in self.ops if o.bound == "network")

    @property
    def flops(self) -> float:
        return sum(o.op.flops * o.op.count for o in self.ops)

    @property
    def bytes(self) -> float:
        return sum(o.op.mem_bytes * o.op.count for o in self.ops)

    @property
    def collective_bytes(self) -> float:
        return sum(o.op.collective.size_bytes * o.op.count for o in self.ops
                   if o.op.collective is not None)

    def breakdown(self, prefixes: dict[str, tuple[str, ...]] | None = None
                  ) -> dict[str, float]:
        """Aggregate op times by name prefix (for runtime-breakdown plots
        like paper Fig. 9)."""
        prefixes = prefixes or {
            "attention": ("attn.flash", "attn.logit", "attn.softmax",
                          "attn.attend", "attn.kv"),
            "linear": ("attn.qkv", "attn.out", "mlp.", "moe.", "head.proj",
                       "rwkv.", "ssm."),
            "embed": ("embed.",),
            "collective": (),
            "other": (),
        }
        out = {k: 0.0 for k in prefixes}
        for ot in self.ops:
            if ot.op.kind == "collective":
                out["collective"] += ot.t_total
                continue
            for key, pres in prefixes.items():
                if any(ot.op.name.startswith(p) for p in pres):
                    out[key] += ot.t_total
                    break
            else:
                out["other"] += ot.t_total
        return out


def _mem_level_for(npu: NPU, resident_bytes: float):
    """Pick the memory level weights stream from: the large on-chip SRAM
    when everything fits (wafer/chiplet platforms), else the fast external
    memory.  (``npu.mem`` already *is* SRAM for SRAM-only parts.)"""
    if npu.sram is not None and resident_bytes <= npu.sram.capacity:
        return npu.sram
    return npu.mem


def time_op(op: Operator, platform: Platform, opt: Optimizations,
            resident_bytes: float = float("inf")) -> OpTiming:
    npu = platform.npu
    if op.collective is not None:
        c = op.collective
        t_net = platform.collective(c.kind, c.size_bytes, c.participants,
                                    c.inner_skip)
        return OpTiming(op=op, t_compute=0.0, t_memory=0.0, t_network=t_net)
    mem = _mem_level_for(npu, resident_bytes)
    flops_rate = npu.effective_flops(opt.eff_compute_dtype)
    t_c = op.flops / flops_rate if op.flops else 0.0
    t_m = op.mem_bytes / mem.effective_bw if op.mem_bytes else 0.0
    return OpTiming(op=op, t_compute=t_c, t_memory=t_m, t_network=0.0)


def time_pass(ops: list[Operator], platform: Platform, opt: Optimizations,
              resident_bytes: float = float("inf")) -> PassTiming:
    timed = [time_op(op, platform, opt, resident_bytes) for op in ops]
    if opt.overlap_comm:
        # Hide network time under the compute/memory time of the pass.
        compute_total = sum(t.t_total for t in timed
                            if t.op.collective is None)
        net_total = sum(t.t_total for t in timed
                        if t.op.collective is not None)
        if net_total <= compute_total:
            timed = [t for t in timed if t.op.collective is None]
    return PassTiming(ops=timed)


def pass_energy(pt: PassTiming, platform: Platform,
                opt: Optimizations) -> float:
    """Energy for one pass on the whole platform (paper Eq. (2))."""
    if platform.power is None:
        return 0.0
    pw = platform.power
    npu = platform.npu
    total = 0.0
    for ot in pt.ops:
        t = ot.t
        if t <= 0:
            continue
        if ot.op.collective is not None:
            u_c = u_m = 0.0
            u_i = 1.0
        else:
            flops_rate = npu.effective_flops(opt.eff_compute_dtype)
            u_c = (ot.op.flops / flops_rate) / t if t else 0.0
            u_m = ot.t_memory / t if t else 0.0
            u_i = 0.0
        total += pw.op_energy(t, u_c, u_m, u_i) * ot.op.count
    return total
