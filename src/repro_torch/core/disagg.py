"""Disaggregated prefill/decode serving planner (paper §IX future work).

Splits a fleet of N NPUs into a prefill pool and a decode pool (DistServe /
Splitwise style), sizes each against the use-case SLOs, and accounts for
the KV-cache transfer between pools — the piece colocated serving doesn't
pay.  Built entirely from the GenZ primitives, so every candidate split is
priced by the same roofline + collective models as the rest of the paper.

For each candidate (tp_p, tp_d, pool split):

  prefill capacity  : requests/s one prefill group sustains = 1 / TTFT
  decode capacity   : requests/s one decode group sustains =
                      B_max / (tau_d [output tokens] * TPOT(B_max) [s/tok]),
                      B_max bounded by HBM
  kv transfer       : KV(tau_p) bytes / inter-pool BW, added to TTFT
  goodput           : min(prefill_rate, decode_rate) subject to both SLOs

The planner returns the best split and the colocated (chunked) baseline so
the crossover the literature reports (long prompts + tight TPOT favor
disaggregation) is visible in the numbers.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

from .modelspec import ModelSpec
from .network import Platform
from .operators import Optimizations
from .parallelism import ParallelismConfig
from .stages import Workload, chunked, decode, prefill


@dataclass(frozen=True)
class DisaggPlan:
    tp_prefill: int
    tp_decode: int
    n_prefill_groups: int
    n_decode_groups: int
    goodput_rps: float  # sustained requests/second
    ttft: float  # incl. KV transfer
    tpot: float
    decode_batch: int
    kv_transfer_s: float
    meets_slo: bool

    @property
    def total_npus(self) -> int:
        return (self.tp_prefill * self.n_prefill_groups
                + self.tp_decode * self.n_decode_groups)


def _max_decode_batch(spec: ModelSpec, platform: Platform, tp: int,
                      opt: Optimizations, ctx: int) -> int:
    cap = platform.npu.mem.capacity * 0.9
    weights = spec.param_count() * opt.wbytes() / tp
    per_req = spec.kv_cache_bytes(1, ctx, 0, dtype=opt.kv_dtype) / tp
    if weights >= cap or per_req <= 0:
        return 0
    return max(int((cap - weights) / per_req), 0)


def plan_disaggregated(spec: ModelSpec, platform: Platform, wl: Workload,
                       opt: Optimizations | None = None,
                       total_npus: int | None = None,
                       inter_pool_bw: float = 100e9,
                       tp_options: tuple[int, ...] = (1, 2, 4, 8, 16, 32),
                       ) -> list[DisaggPlan]:
    """Enumerate splits; return plans sorted by goodput (best first)."""
    opt = opt or Optimizations()
    n_total = total_npus or platform.num_npus
    ctx = wl.tau_p + wl.tau_d
    plans: list[DisaggPlan] = []
    for tp_p in tp_options:
        if tp_p > n_total:
            continue
        try:
            pre = prefill(spec, platform, ParallelismConfig(tp=tp_p), opt,
                          dataclasses.replace(wl, batch=1))
        except ValueError:
            continue
        if not pre.memory.fits:
            continue
        kv_bytes = spec.kv_cache_bytes(1, wl.tau_p, 0, dtype=opt.kv_dtype)
        t_xfer = kv_bytes / inter_pool_bw
        ttft = pre.time + t_xfer
        for tp_d in tp_options:
            if tp_p + tp_d > n_total:
                continue
            bmax = _max_decode_batch(spec, platform, tp_d, opt, ctx)
            if bmax < 1:
                continue
            # largest batch meeting the TPOT SLO (decode batching is ~free
            # until the KV reads dominate, then TPOT climbs)
            b, tpot = None, None
            for cand in sorted({min(bmax, 2 ** i) for i in range(9)},
                               reverse=True):
                try:
                    dec = decode(spec, platform,
                                 ParallelismConfig(tp=tp_d), opt,
                                 dataclasses.replace(wl, batch=cand))
                except ValueError:
                    continue
                t = dec.meta["tpot"]
                if wl.tpot_slo is None or t <= wl.tpot_slo or cand == 1:
                    b, tpot = cand, t
                    break
            if b is None:
                continue
            # group-level service rates (requests/s)
            rate_p_group = 1.0 / max(pre.time, 1e-9)
            rate_d_group = b / max(wl.tau_d * tpot, 1e-9)
            # best integer split of the fleet between pools
            best = None
            for n_p in range(1, n_total // tp_p + 1):
                rem = n_total - n_p * tp_p
                n_d = rem // tp_d
                if n_d < 1:
                    continue
                good = min(n_p * rate_p_group, n_d * rate_d_group)
                if best is None or good > best[0]:
                    best = (good, n_p, n_d)
            if best is None:
                continue
            good, n_p, n_d = best
            meets = True
            if wl.ttft_slo is not None:
                meets &= ttft <= wl.ttft_slo
            if wl.tpot_slo is not None:
                meets &= tpot <= wl.tpot_slo
            plans.append(DisaggPlan(
                tp_prefill=tp_p, tp_decode=tp_d, n_prefill_groups=n_p,
                n_decode_groups=n_d, goodput_rps=good, ttft=ttft, tpot=tpot,
                decode_batch=b, kv_transfer_s=t_xfer, meets_slo=meets))
    plans.sort(key=lambda p: (-p.meets_slo, -p.goodput_rps))
    return plans


def plan_scenario(scenario) -> list[DisaggPlan]:
    """Disaggregation plans for a declarative
    :class:`repro_torch.scenario.Scenario` with ``mode='disaggregated'`` (any
    mode is accepted; the DisaggSpec defaults apply when absent)."""
    d = scenario.disaggregated
    kw = {}
    if d is not None:
        kw = dict(total_npus=d.total_npus, inter_pool_bw=d.inter_pool_bw,
                  tp_options=d.tp_options)
    return plan_disaggregated(scenario.resolve_model(),
                              scenario.resolve_platform(),
                              scenario.workload, scenario.opt, **kw)


def plan_with_baseline(spec: ModelSpec, platform: Platform, wl: Workload,
                       opt: Optimizations | None = None,
                       total_npus: int | None = None,
                       inter_pool_bw: float = 100e9,
                       tp_options: tuple[int, ...] = (1, 2, 4, 8, 16, 32),
                       colocated_tp: int = 8, colocated_chunk: int = 512,
                       ) -> tuple[list[DisaggPlan], dict]:
    """One call returning both sides of the crossover the module docstring
    promises: the ranked disaggregation plans *and* the colocated chunked
    baseline on the same fleet — so callers (the engine lowering, the
    bench) never recompute the baseline out-of-band."""
    plans = plan_disaggregated(spec, platform, wl, opt,
                               total_npus=total_npus,
                               inter_pool_bw=inter_pool_bw,
                               tp_options=tp_options)
    co = colocated_goodput(spec, platform, wl, opt, total_npus=total_npus,
                           tp=colocated_tp, chunk=colocated_chunk)
    return plans, co


def colocated_goodput(spec: ModelSpec, platform: Platform, wl: Workload,
                      opt: Optimizations | None = None,
                      total_npus: int | None = None,
                      tp: int = 8, chunk: int = 512) -> dict:
    """Chunked-prefill colocated baseline: every group interleaves prefill
    chunks with decode (paper §IV-A); TTFT inflates by the interleave."""
    opt = opt or Optimizations()
    n_total = total_npus or platform.num_npus
    ctx = wl.tau_p + wl.tau_d
    b = min(_max_decode_batch(spec, platform, tp, opt, ctx), 256)
    if b < 1:
        return {"goodput_rps": 0.0, "reason": "OOM"}
    it = chunked(spec, platform, ParallelismConfig(tp=tp), opt, wl, chunk, b)
    iter_t = it.time
    # one request needs tau_p/chunk prefill-chunk iterations + tau_d decodes
    iters_per_req = wl.tau_p / max(chunk - b, 1) + wl.tau_d
    rate_group = b / (iters_per_req * iter_t)
    n_groups = n_total // tp
    tpot_eff = iter_t  # each decode token waits one fused iteration
    meets = wl.tpot_slo is None or tpot_eff <= wl.tpot_slo
    return {"goodput_rps": n_groups * rate_group, "tpot": tpot_eff,
            "iter_time": iter_t, "decode_batch": b, "meets_slo": meets}
