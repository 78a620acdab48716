"""SCALE-sim-lite: analytical systolic-array utilization (paper §VII-D).

GenZ plugs external microarchitecture simulators (SCALE-sim, Timeloop) in
for high-fidelity NPU modeling; this module reimplements SCALE-sim's
weight-stationary analytical mode so case study IV runs self-contained:

  For a GEMM (M x K) @ (K x N) on an R x C weight-stationary array:
    folds   = ceil(K / R) * ceil(N / C)
    cycles  = folds * (M + R + C - 2)        (pipeline fill + drain per fold)
    util    = (M * K * N) / (cycles * R * C)

Multi-core chips run folds across cores in parallel.  The CPU-offload
variant (system C) moves logit/softmax/attend to the host: attention time =
flops / CPU_TOPS + KV traffic over PCIe.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class SystolicConfig:
    rows: int
    cols: int
    cores: int = 1
    freq: float = 1e9  # Hz

    @property
    def macs(self) -> int:
        return self.rows * self.cols * self.cores

    def gemm_cycles(self, m: float, k: float, n: float) -> float:
        folds = math.ceil(k / self.rows) * math.ceil(n / self.cols)
        folds_per_core = math.ceil(folds / self.cores)
        return folds_per_core * (m + self.rows + self.cols - 2)

    def gemm_time(self, m: float, k: float, n: float) -> float:
        return self.gemm_cycles(m, k, n) / self.freq

    def gemm_utilization(self, m: float, k: float, n: float) -> float:
        cyc = self.gemm_cycles(m, k, n) * self.cores
        return (m * k * n) / (cyc * self.rows * self.cols)


@dataclass(frozen=True)
class OffloadConfig:
    cpu_tops: float = 8e12
    link_bw: float = 128e9  # PCIe GB/s

    def attention_time(self, flops: float, kv_bytes: float) -> float:
        return flops / self.cpu_tops + kv_bytes / self.link_bw


def prefill_latency(spec, ctx_len: int, sys_cfg: SystolicConfig,
                    mem_bw: float = 1.2e12,
                    offload: OffloadConfig | None = None,
                    dtype_bytes: float = 2.0) -> dict:
    """LLaMA-style prefill latency under a given microarchitecture
    (paper Fig. 19: identical platform, different NPU internals)."""
    d, hq, hkv, dh = spec.d_model, spec.n_heads, spec.n_kv_heads, spec.d_head
    ff = spec.d_ff
    m = ctx_len
    t_gemm = (sys_cfg.gemm_time(m, d, (hq + 2 * hkv) * dh)
              + sys_cfg.gemm_time(m, hq * dh, d)
              + 3 * sys_cfg.gemm_time(m, d, ff))
    attn_flops = 2 * 2 * hq * dh * ctx_len * (ctx_len + 1) / 2
    kv_bytes = 2 * ctx_len * hkv * dh * dtype_bytes
    if offload is not None:
        t_attn = offload.attention_time(attn_flops, kv_bytes)
    else:
        # logit + attend as batched GEMMs per head on the array
        t_attn = 2 * hq * sys_cfg.gemm_time(m, dh, m)
    # weight streaming bound
    w_bytes = (d * (hq + 2 * hkv) * dh + hq * dh * d + 3 * d * ff) \
        * dtype_bytes
    t_mem = w_bytes / mem_bw
    per_layer = max(t_gemm + t_attn, t_mem)
    return {
        "per_layer_s": per_layer,
        "total_s": per_layer * spec.n_layers,
        "gemm_util": sys_cfg.gemm_utilization(m, d, ff),
        "attn_s": t_attn,
    }
