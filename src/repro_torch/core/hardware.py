"""NPU characterizer (paper §III-B).

The smallest hardware unit in GenZ is the *NPU* (accelerator).  Each NPU has

  * a peak compute rate ``flops`` (FLOP/s at the reference dtype, bf16) and an
    empirical efficiency factor ``eff_compute`` accounting for software /
    synchronization inefficiency,
  * a fast external memory (HBM or the main SRAM for SRAM-only chips) with
    capacity, bandwidth and a bandwidth-efficiency factor,
  * optionally a large on-chip SRAM level (wafer-scale / chiplet designs),
  * optionally a slow *offload* memory (PCIe-attached CPU DRAM / CXL flash)
    used for weight or KV-cache offload (paper §VII-D system C).

All quantities are SI: FLOP/s, bytes, bytes/s, seconds, watts.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


KIB, MIB, GIB, TIB = 1024.0, 1024.0**2, 1024.0**3, 1024.0**4
KB, MB, GB, TB, PB = 1e3, 1e6, 1e9, 1e12, 1e15
TFLOP, PFLOP = 1e12, 1e15

#: Bytes per element for the dtypes GenZ models (paper Table V: quantization /
#: mixed precision scale compute and memory proportionally).
DTYPE_BYTES = {
    "fp32": 4.0,
    "tf32": 4.0,
    "bf16": 2.0,
    "fp16": 2.0,
    "fp8": 1.0,
    "int8": 1.0,
    "int4": 0.5,
}

#: Compute-throughput multiplier relative to the bf16 peak.  Most NPUs double
#: matmul throughput per halving of operand width.
DTYPE_FLOPS_SCALE = {
    "fp32": 0.5,
    "tf32": 0.5,
    "bf16": 1.0,
    "fp16": 1.0,
    "fp8": 2.0,
    "int8": 2.0,
    "int4": 4.0,
}


@dataclass(frozen=True)
class MemoryLevel:
    """One level of the (external) memory hierarchy of an NPU."""

    name: str
    capacity: float  # bytes
    bw: float  # bytes / second (peak)
    efficiency: float = 1.0  # Eff_mem in Eq. (1)

    @property
    def effective_bw(self) -> float:
        return self.bw * self.efficiency

    def scaled(self, *, capacity: float | None = None, bw: float | None = None,
               efficiency: float | None = None) -> "MemoryLevel":
        return dataclasses.replace(
            self,
            capacity=self.capacity if capacity is None else capacity,
            bw=self.bw if bw is None else bw,
            efficiency=self.efficiency if efficiency is None else efficiency,
        )


@dataclass(frozen=True)
class NPU:
    """A single accelerator (GPU / TPU / ASIC / SRAM chip / wafer)."""

    name: str
    flops: float  # peak FLOP/s at bf16
    mem: MemoryLevel  # fast memory (HBM, or main SRAM for SRAM-only parts)
    eff_compute: float = 1.0  # Eff_C in Eq. (1)
    sram: MemoryLevel | None = None  # optional large on-chip SRAM level
    offload: MemoryLevel | None = None  # optional slow memory (CPU DRAM / CXL)
    dtype_flops_scale: dict = field(default_factory=lambda: dict(DTYPE_FLOPS_SCALE))

    def peak_flops(self, dtype: str = "bf16") -> float:
        return self.flops * self.dtype_flops_scale.get(dtype, 1.0)

    def effective_flops(self, dtype: str = "bf16") -> float:
        return self.peak_flops(dtype) * self.eff_compute

    def scaled(self, *, flops_mult: float = 1.0, mem_bw_mult: float = 1.0,
               mem_cap_mult: float = 1.0) -> "NPU":
        """Isolated scaling of HW characteristics (paper §VII-A)."""
        return dataclasses.replace(
            self,
            flops=self.flops * flops_mult,
            mem=self.mem.scaled(capacity=self.mem.capacity * mem_cap_mult,
                                bw=self.mem.bw * mem_bw_mult),
        )


@dataclass(frozen=True)
class PowerModel:
    """Linear utilization-based energy model (paper Eq. (2)).

    ``E_op = T_op * (P_static + P_c*U_c + P_mem*U_mem + P_icn*U_icn)``

    The paper uses the ratio P_static : P_c : P_mem : P_icn :: 3 : 4 : 2 : 1,
    normalized so the components sum to the platform peak power.
    """

    peak_power: float  # watts, whole platform
    ratio_static: float = 3.0
    ratio_compute: float = 4.0
    ratio_mem: float = 2.0
    ratio_icn: float = 1.0

    def _norm(self) -> float:
        return (self.ratio_static + self.ratio_compute + self.ratio_mem
                + self.ratio_icn)

    @property
    def p_static(self) -> float:
        return self.peak_power * self.ratio_static / self._norm()

    @property
    def p_compute(self) -> float:
        return self.peak_power * self.ratio_compute / self._norm()

    @property
    def p_mem(self) -> float:
        return self.peak_power * self.ratio_mem / self._norm()

    @property
    def p_icn(self) -> float:
        return self.peak_power * self.ratio_icn / self._norm()

    def op_energy(self, t_op: float, u_compute: float, u_mem: float,
                  u_icn: float) -> float:
        """Energy (J) for one operator of duration ``t_op`` seconds."""
        return t_op * (self.p_static + self.p_compute * min(u_compute, 1.0)
                       + self.p_mem * min(u_mem, 1.0)
                       + self.p_icn * min(u_icn, 1.0))


# ---------------------------------------------------------------------------
# NPU presets.
# ---------------------------------------------------------------------------

def tpu_v5e() -> NPU:
    """The roofline target of this repository (see EXPERIMENTS.md).

    197 TFLOP/s bf16, 16 GB HBM @ 819 GB/s; ICI modeled at the platform level
    (~50 GB/s per link).
    """
    return NPU(
        name="tpu-v5e",
        flops=197 * TFLOP,
        eff_compute=1.0,
        mem=MemoryLevel("hbm", 16 * GIB, 819 * GB),
    )


def h100_sxm() -> NPU:
    """NVIDIA H100 SXM (80 GB).  990 TFLOP/s bf16 dense, 3.35 TB/s HBM3."""
    return NPU(
        name="h100-sxm",
        flops=990 * TFLOP,
        eff_compute=0.55,  # paper-validated single-GPU efficiency factor
        mem=MemoryLevel("hbm3", 80 * GIB, 3.35 * TB),
    )


def a100_80g() -> NPU:
    return NPU(
        name="a100-80g",
        flops=312 * TFLOP,
        eff_compute=0.40,
        mem=MemoryLevel("hbm2e", 80 * GIB, 2.0 * TB),
    )


def gb200_like() -> NPU:
    """Paper Table VII row 1: 4.5 PFLOPS, 192GB @ 8 TB/s, 128MB @ 40 TB/s."""
    return NPU(
        name="gb200-like",
        flops=4.5 * PFLOP,
        eff_compute=0.75,
        mem=MemoryLevel("hbm3e", 192 * GIB, 8 * TB),
        sram=MemoryLevel("l2", 128 * MIB, 40 * TB),
    )


def cs3_like() -> NPU:
    """Paper Table VII row 2 (wafer-scale): 125 PFLOPS, 44GB SRAM @ 21 PB/s,
    12 TB external @ 14.6 TB/s.  The wafer's main working memory is the SRAM,
    so ``mem`` is the SRAM and ``offload`` the external DRAM."""
    return NPU(
        name="cs3-like",
        flops=125 * PFLOP,
        eff_compute=0.5,
        mem=MemoryLevel("wafer-sram", 44 * GIB, 21 * PB),
        offload=MemoryLevel("memx", 12 * TIB, 14.6 * TB),
    )


def groqchip_like() -> NPU:
    """Paper Table VII row 3 (SRAM chiplet): 0.75 PFLOPS, 256MB @ 80 TB/s,
    no backing memory."""
    return NPU(
        name="groqchip-like",
        flops=0.75 * PFLOP,
        eff_compute=0.9,
        mem=MemoryLevel("sram", 256 * MIB, 80 * TB),
    )


def soho_like() -> NPU:
    """Paper Table VII row 4 (transformer ASIC): 45 PFLOPS, 256MB SRAM @
    80 TB/s + 192GB HBM @ 8 TB/s."""
    return NPU(
        name="soho-like",
        flops=45 * PFLOP,
        eff_compute=0.8,
        mem=MemoryLevel("hbm3e", 192 * GIB, 8 * TB),
        sram=MemoryLevel("sram", 256 * MIB, 80 * TB),
    )


NPU_PRESETS = {
    "tpu-v5e": tpu_v5e,
    "h100-sxm": h100_sxm,
    "a100-80g": a100_80g,
    "gb200-like": gb200_like,
    "cs3-like": cs3_like,
    "groqchip-like": groqchip_like,
    "soho-like": soho_like,
}


def get_npu(name: str) -> NPU:
    try:
        return NPU_PRESETS[name]()
    except KeyError:
        raise KeyError(f"unknown NPU preset {name!r}; have {sorted(NPU_PRESETS)}")
