"""Analytical backend: price a Scenario with the GenZ core.

This is the facade the old ``GenZ`` methods now live behind: the existing
stage models (:mod:`repro_torch.core.stages`), the disaggregation planner
(:mod:`repro_torch.core.disagg`) and the §VI requirement estimator
(:mod:`repro_torch.core.requirements`) are the implementation; every mode of the
Scenario union routes to them and the results land in one unified
:class:`~repro_torch.scenario.report.Report`.

``evaluate_detailed`` additionally returns the rich per-stage objects
(``StageResult`` / ``InferenceReport`` / ``DisaggPlan``) for callers that
need them (the deprecated ``GenZ`` shims, notebooks); ``evaluate`` returns
just the JSON-able Report and is what the sweep runner parallelizes.
"""

from __future__ import annotations

import dataclasses

from ..core.stages import (StageResult, chunked, estimate, max_concurrency,
                           speculative_decode)
from .report import Report
from .scenario import Scenario


def _stage_dict(sr: StageResult) -> dict:
    """StageResult -> JSON-able detail for Report.extra."""
    d = {"name": sr.name, "time_s": sr.time, "energy_j": sr.energy,
         "fits": sr.memory.fits,
         "weights_per_npu": sr.memory.weights_per_npu,
         "kv_per_npu": sr.memory.kv_per_npu,
         "mem_capacity": sr.memory.capacity,
         "breakdown": dict(sr.timing.breakdown()),
         "compute_time_s": sr.timing.compute_time,
         "memory_time_s": sr.timing.memory_time,
         "network_time_s": sr.timing.network_time}
    d.update(sr.meta)
    return d


def _requirements_dict(sc: Scenario, spec) -> dict | None:
    """§VI platform requirements, when the workload defines both SLOs."""
    wl = sc.workload
    if not (wl.ttft_slo and wl.tpot_slo):
        return None
    from ..core.requirements import platform_requirements
    req = platform_requirements(spec, wl, sc.opt)
    return {"mem_capacity": req.mem_capacity,
            "weights_bytes": req.weights_bytes, "kv_bytes": req.kv_bytes,
            "compute": req.compute, "mem_bw": req.mem_bw,
            "mem_capacity_gb": req.mem_capacity_gb,
            "compute_pflops": req.compute_pflops,
            "mem_bw_tbps": req.mem_bw_tbps}


def _meets(sc: Scenario, ttft: float | None, tpot: float | None) -> bool | None:
    wl = sc.workload
    if wl.ttft_slo is None and wl.tpot_slo is None:
        return None
    ok = True
    if wl.ttft_slo is not None and ttft is not None:
        ok &= ttft <= wl.ttft_slo
    if wl.tpot_slo is not None and tpot is not None:
        ok &= tpot <= wl.tpot_slo
    return ok


def evaluate(sc: Scenario) -> Report:
    """Scenario -> Report (analytical prediction)."""
    return evaluate_detailed(sc)[0]


def evaluate_detailed(sc: Scenario) -> tuple[Report, dict]:
    """Scenario -> (Report, rich stage objects keyed by role)."""
    try:
        spec = sc.resolve_model()
        plat = sc.resolve_platform()
    except (ValueError, TypeError) as e:
        return Report(scenario=sc, backend="analytical", status="error",
                      error=str(e)), {}
    fn = _MODE_HANDLERS[sc.mode]
    try:
        return fn(sc, spec, plat)
    except ValueError as e:
        # parallelism/platform validation failures: the point is infeasible
        return Report(scenario=sc, backend="analytical", status="infeasible",
                      error=str(e)), {}
    except Exception as e:  # noqa: BLE001 - sweeps must survive bad cells
        return Report(scenario=sc, backend="analytical", status="error",
                      error=f"{type(e).__name__}: {e}"), {}


# -- mode handlers -----------------------------------------------------------

def _max_concurrency(sc: Scenario, spec, plat) -> int:
    return max_concurrency(spec, plat, sc.parallelism, sc.opt, sc.workload)


def _monolithic(sc: Scenario, spec, plat) -> tuple[Report, dict]:
    wl = sc.workload
    inf = estimate(spec, plat, sc.parallelism, sc.opt, wl,
                   context=sc.context)
    pre, dec = inf.prefill, inf.decode
    extra = {"prefill": _stage_dict(pre), "decode": _stage_dict(dec)}
    req = _requirements_dict(sc, spec)
    if req is not None:
        extra["requirements"] = req
    rep = Report(
        scenario=sc, backend="analytical",
        status="ok" if dec.memory.fits else "oom",
        ttft_s=inf.ttft, tpot_s=inf.tpot, latency_s=inf.latency,
        throughput_tok_s=inf.throughput, energy_j=inf.energy,
        energy_per_token_j=inf.energy_per_token,
        max_concurrency=_max_concurrency(sc, spec, plat),
        fits_memory=dec.memory.fits,
        meets_slo=_meets(sc, inf.ttft, inf.tpot), extra=extra)
    return rep, {"prefill": pre, "decode": dec, "report": inf}


def _chunked(sc: Scenario, spec, plat) -> tuple[Report, dict]:
    c = sc.chunked
    sr = chunked(spec, plat, sc.parallelism, sc.opt, sc.workload,
                 c.chunk, c.decode_batch, c.decode_ctx)
    iter_t = sr.meta["iter_time"]
    thr = sr.meta["decode_tokens_per_s"]
    e_tok = sr.energy / max(c.decode_batch, 1)
    # the two-dispatch baseline (decode pass + separate prefill pass):
    # recorded alongside so predicted-vs-measured TPOT can be compared
    # against either engine implementation
    sr2 = chunked(spec, plat, sc.parallelism, sc.opt, sc.workload,
                  c.chunk, c.decode_batch, c.decode_ctx, fused=False)
    rep = Report(
        scenario=sc, backend="analytical",
        status="ok" if sr.memory.fits else "oom",
        tpot_s=iter_t,  # each decode token waits one fused iteration
        throughput_tok_s=thr, energy_j=sr.energy, energy_per_token_j=e_tok,
        max_concurrency=_max_concurrency(sc, spec, plat),
        fits_memory=sr.memory.fits, meets_slo=_meets(sc, None, iter_t),
        extra={"chunked": _stage_dict(sr),
               "chunked_two_dispatch": {
                   "iter_time": sr2.meta["iter_time"],
                   "tpot": sr2.meta["tpot"],
                   "dispatches_per_iter": sr2.meta["dispatches_per_iter"]}})
    return rep, {"stage": sr}


def _speculative(sc: Scenario, spec, plat) -> tuple[Report, dict]:
    sp = sc.speculative
    from .platforms import resolve_model
    draft = resolve_model(sp.draft)
    sr = speculative_decode(spec, draft, plat, sc.parallelism, sc.opt,
                            sc.workload, sp.n, sp.gamma)
    thr = sr.meta["tokens_per_s"]
    tpot = sc.workload.batch / thr if thr else None
    e_tok = (sr.energy / (sc.workload.batch * sr.meta["e_tokens"])
             if sr.meta["e_tokens"] else None)
    rep = Report(
        scenario=sc, backend="analytical",
        status="ok" if sr.memory.fits else "oom",
        tpot_s=tpot, throughput_tok_s=thr, energy_j=sr.energy,
        energy_per_token_j=e_tok, fits_memory=sr.memory.fits,
        meets_slo=_meets(sc, None, tpot),
        extra={"speculative": _stage_dict(sr)})
    return rep, {"stage": sr}


def _disaggregated(sc: Scenario, spec, plat) -> tuple[Report, dict]:
    from ..core.disagg import plan_with_baseline
    d = sc.disaggregated
    plans, co = plan_with_baseline(spec, plat, sc.workload, sc.opt,
                                   total_npus=d.total_npus,
                                   inter_pool_bw=d.inter_pool_bw,
                                   tp_options=d.tp_options,
                                   colocated_tp=d.colocated_tp,
                                   colocated_chunk=d.colocated_chunk)
    if not plans:
        rep = Report(scenario=sc, backend="analytical", status="infeasible",
                     error="no feasible disaggregated split",
                     extra={"colocated": co})
        return rep, {"plans": [], "colocated": co}
    best = plans[0]
    wl = sc.workload
    throughput = best.goodput_rps * wl.tau_d  # sustained output tokens/s
    rep = Report(
        scenario=sc, backend="analytical", status="ok",
        ttft_s=best.ttft, tpot_s=best.tpot,
        latency_s=best.ttft + best.tpot * wl.tau_d,
        throughput_tok_s=throughput,
        fits_memory=True, meets_slo=best.meets_slo,
        extra={"plan": dataclasses.asdict(best),
               "goodput_rps": best.goodput_rps,
               "kv_transfer_s": best.kv_transfer_s,
               "n_plans": len(plans), "colocated": co})
    return rep, {"plans": plans, "colocated": co}


_MODE_HANDLERS = {
    "monolithic": _monolithic,
    "chunked": _chunked,
    "speculative": _speculative,
    "disaggregated": _disaggregated,
}
