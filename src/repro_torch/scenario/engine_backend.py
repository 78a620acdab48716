"""Engine backend: lower a Scenario onto the port's engines (the port of
``repro.scenario.engine_backend``).

The same :class:`~repro_torch.scenario.Scenario` that the analytical
backend prices is lowered to a continuous-batching run of the port's
:class:`~repro_torch.serving.ServeEngine` or
:class:`~repro_torch.serving.DisaggCluster`, on the card by default, and
the measured :class:`~repro_torch.serving.EngineMetrics` are harvested
into the same :class:`~repro_torch.scenario.report.Report` schema, so
predicted against measured is ``compare(analytical, engine)``.

Lowering rules, the reference's:

  * ``model``: an inline ``ModelSpec`` is built as-is (at its full width);
    a registry arch id resolves to its *reduced* config
    (``registry.get_reduced``).  Paper Table-IV models have no runnable
    config and are refused.  Weights are random, drawn from
    ``engine_kw["seed"]`` on ``engine_kw["device"]`` in
    ``engine_kw["dtype"]``.
  * the workload's ``tau_p`` / ``tau_d`` / ``batch`` are clamped to the
    engine geometry (``max_prompt`` / ``max_new`` / ``max_seq``); the
    clamps are recorded under ``Report.extra["lowering"]``.
  * ``mode``: monolithic runs each prompt as one prefill chunk; chunked
    uses ``ChunkedSpec.chunk`` as the engine's chunk; speculative runs
    the unified engine with ``n_spec = SpeculativeSpec.n`` and the draft
    built beside the target; disaggregated runs a ``DisaggCluster`` (a
    unified prefill engine, a paged decode engine, a link priced at the
    DisaggSpec's ``inter_pool_bw``) whose prefill-rows : decode-slots
    split is the analytical planner's best xPU:yPU ratio over
    ``max_slots`` (override: ``engine_kw["disagg_split"]``); its TTFT
    includes the simulated migration time.
  * ``engine_kw["unified"]=True`` lowers to the unified token-packed step
    (forces the paged layout); ``engine_kw["prefix_cache"]=True`` or
    ``opt.prefix_hit_rate > 0`` to the prefix-cache engine with a
    multi-tenant shared-template request mix; ``opt.paged_kv`` to the
    paged layout, its pool sized from an HBM budget with the §VI-A
    per-token bytes the analytical backend prices.

Differences from the reference, each because the port runs on one card:
``engine_kw`` takes ``device`` (None: the card, raising without one) and
``dtype`` (None: float32, what the reference builds).  A
``ParallelismConfig`` with tp or pp > 1 lowers, as the reference's, to the
unified engine sharded over ``tp * pp`` ranks
(:mod:`repro_torch.serving.sharded`): every rank of a process group of
that size lowers and serves the same Scenario, and outside one the Report
is the engine's error naming the ranks it needs (on the card its steps
are captured, so the group's backend must be nccl).  The lowering is split
from the serve, so that a caller can warm what :func:`lower` built before
the measured :func:`serve`.  :func:`evaluate`
is ``lower`` → ``serve`` → the Report, cold, as the reference measures.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field

from .report import Report
from .scenario import Scenario

#: Scenario modes this backend can lower to a live run.  Refusal paths
#: quote this list so an unsupported-mode Report is self-explanatory.
LOWERABLE_MODES = ("monolithic", "chunked", "speculative", "disaggregated")

#: engine-lowering defaults, overridable via ``run(..., engine_kw=...)``
DEFAULTS = dict(max_slots=8, max_seq=256, prefill_rows=2, max_prompt=64,
                max_new=32, n_requests=None, seed=0, temperature=0.0,
                cache_layout=None, page_size=None, n_pages=None,
                kv_budget_bytes=None, unified=False, prefix_cache=False,
                # -- mesh-sharding overrides (None: take the Scenario's
                # ParallelismConfig tp/pp degrees) ---------------------------
                tp=None, pp=None,
                # -- disaggregated-mode knobs --------------------------------
                disagg_split=None,  # (prefill_rows, decode_slots) override
                prefill_slots=1, decode_prefill_rows=1,
                prefill_pages=None, decode_pages=None,
                link_latency_s=0.0, link_time_scale=0.0,
                # -- the port's: where and in what the model is built --------
                device=None, dtype=None)


class Refused(ValueError):
    """A lowering the backend refuses; :func:`evaluate` reports its
    message as it stands, without the exception's name."""


@dataclass
class Lowered:
    """What :func:`lower` built for one Scenario: the engine (``kind``
    ``"engine"``) or cluster (``"cluster"``), its requests, the clamped
    geometry and the lowering's record (``extra``: engine config, plan)."""

    scenario: Scenario
    kind: str
    spec: object
    runner: object
    requests: list
    geometry: dict
    extra: dict = field(default_factory=dict)


def lower_model(ref, *, device=None, dtype=None, seed: int = 0):
    """Model ref -> (spec, model) built on ``device`` (None: the card) in
    ``dtype`` (None: float32), random weights from ``seed``."""
    import torch
    from ..core.modelspec import PAPER_MODELS, ModelSpec
    from ..models import build_model

    if isinstance(ref, ModelSpec):
        spec = ref
    elif isinstance(ref, str):
        if ref in PAPER_MODELS:
            raise ValueError(
                f"paper model {ref!r} has no runnable reduced config; the "
                "engine backend needs an inline ModelSpec or a registry "
                "arch id (repro_torch.configs.registry.ARCH_IDS)")
        from ..configs import registry
        spec = registry.get_reduced(ref)
    else:
        raise TypeError(f"model ref must be str or ModelSpec, got "
                        f"{type(ref).__name__}")
    model = build_model(spec, device, dtype or torch.float32, seed=seed)
    return spec, model


def _geometry(sc: Scenario, kw: dict) -> dict:
    """Clamp the workload to a runnable engine geometry."""
    wl = sc.workload
    max_seq = int(kw["max_seq"])
    prompt_len = max(1, min(wl.tau_p, int(kw["max_prompt"]), max_seq // 2))
    max_new = max(1, min(wl.tau_d, int(kw["max_new"]),
                         max_seq - prompt_len - 2))
    n_requests = int(kw["n_requests"] or wl.batch)
    return {"prompt_len": prompt_len, "max_new": max_new,
            "n_requests": n_requests, "max_seq": max_seq,
            "clamped": (prompt_len < wl.tau_p or max_new < wl.tau_d)}


def _model_kw(kw: dict) -> dict:
    return {"device": kw["device"], "dtype": kw["dtype"],
            "seed": int(kw["seed"])}


def lower(sc: Scenario, **engine_kw) -> Lowered:
    """Build what ``sc`` lowers to (model, engine or cluster, requests),
    serving nothing; raises where :func:`evaluate` reports an error."""
    kw = dict(DEFAULTS)
    kw.update(engine_kw)
    if sc.mode not in LOWERABLE_MODES:
        raise ValueError(f"scenario mode {sc.mode!r} has no engine "
                         "lowering; lowerable modes are "
                         f"{', '.join(LOWERABLE_MODES)}")
    spec, model = lower_model(sc.model, **_model_kw(kw))
    return _lower(sc, spec, model, kw)


def _lower(sc: Scenario, spec, model, kw: dict) -> Lowered:
    if sc.mode == "speculative":
        return _lower_speculative(sc, spec, model, kw)
    if sc.mode == "disaggregated":
        return _lower_disaggregated(sc, spec, model, kw)
    return _lower_engine(sc, spec, model, kw)


def serve(low: Lowered) -> Lowered:
    """Serve the lowered requests to completion."""
    low.runner.serve(low.requests)
    return low


def evaluate(sc: Scenario, **engine_kw) -> Report:
    """Scenario -> Report (measured on the port's engine)."""
    kw = dict(DEFAULTS)
    kw.update(engine_kw)
    if sc.mode not in LOWERABLE_MODES:
        return Report(
            scenario=sc, backend="engine", status="unsupported",
            error=f"scenario mode {sc.mode!r} has no engine lowering; "
                  f"lowerable modes are {', '.join(LOWERABLE_MODES)}")
    try:
        spec, model = lower_model(sc.model, **_model_kw(kw))
    except (ValueError, TypeError) as e:
        return Report(scenario=sc, backend="engine", status="error",
                      error=str(e))
    try:
        return report(serve(_lower(sc, spec, model, kw)))
    except Refused as e:
        return Report(scenario=sc, backend="engine", status="error",
                      error=str(e))
    except Exception as e:  # noqa: BLE001 - sweeps must survive bad cells
        return Report(scenario=sc, backend="engine", status="error",
                      error=f"{type(e).__name__}: {e}")


def _make_requests(sc: Scenario, spec, geo: dict, kw: dict,
                   prefix: bool = False):
    import numpy as np
    from ..serving import Request
    from ..serving.sampling import SamplingConfig

    rng = np.random.default_rng(int(kw["seed"]))
    sampling = SamplingConfig(temperature=float(kw["temperature"]))
    if not prefix:
        return [
            Request(prompt=[int(t) for t in
                            rng.integers(0, spec.vocab, geo["prompt_len"])],
                    max_new_tokens=geo["max_new"], sampling=sampling)
            for _ in range(geo["n_requests"])
        ]
    # multi-tenant shared-template mix: each tenant's requests share a
    # fixed prompt template whose length tracks opt.prefix_hit_rate, so
    # the measured hit rate is comparable to the analytical discount
    frac = sc.opt.prefix_hit_rate if sc.opt.prefix_hit_rate > 0 else 0.75
    frac = min(max(frac, 0.05), 0.95)
    tmpl_len = max(1, min(geo["prompt_len"] - 1,
                          round(geo["prompt_len"] * frac)))
    tenants = {
        f"tenant{t}": [int(x) for x in
                       rng.integers(0, spec.vocab, tmpl_len)]
        for t in range(2)
    }
    names = list(tenants)
    out = []
    for i in range(geo["n_requests"]):
        tenant = names[i % len(names)]
        suffix = [int(x) for x in rng.integers(
            0, spec.vocab, geo["prompt_len"] - tmpl_len)]
        out.append(Request(prompt=tenants[tenant] + suffix,
                           max_new_tokens=geo["max_new"], sampling=sampling,
                           tenant=tenant, template_id=f"{tenant}/tmpl0"))
    return out


def _paged_lowering(sc: Scenario, spec, geo: dict, kw: dict) -> dict:
    """Paged-KV engine knobs: layout, page size and the page-pool size.

    The pool is sized from an HBM budget with the same §VI-A per-token
    byte formula the analytical backend prices (``kv_bytes_per_token`` at
    ``opt.kv_dtype``), so a Scenario with an inline toy Platform yields an
    engine whose measured max concurrency is directly comparable to the
    analytical prediction.  The pool is clamped to the dense-equivalent
    reservation (pages beyond max_slots x max_seq can never be used).
    """
    paged = kw["cache_layout"] == "paged" or (
        kw["cache_layout"] is None and sc.opt.paged_kv) or kw["unified"]
    if not paged:  # unified=True forces paged: the packed step writes
        return {"cache_layout": "dense"}  # prefill K/V straight to pages
    ps = int(kw["page_size"] or sc.opt.kv_page_size)
    max_seq = geo["max_seq"]
    if max_seq % ps:  # keep the lowering runnable for any page size
        ps = max(1, math.gcd(max_seq, ps))
    max_pages_total = int(kw["max_slots"]) * (max_seq // ps)
    n_pages = kw["n_pages"]
    if n_pages is None:
        budget = kw["kv_budget_bytes"]
        if budget is None:
            # mirror stages.max_concurrency's sharded §VI-A budget:
            # (capacity - weights/shards) per NPU, times the tp*pp shards
            # that split the KV
            from ..core.stages import _platform_capacity
            par = sc.parallelism
            shards = par.tp * par.ep * par.pp
            plat = sc.resolve_platform()
            weights = spec.param_count() * sc.opt.wbytes() / shards
            budget = max(_platform_capacity(plat) - weights, 0.0) \
                * par.tp * par.pp
        # the engine's recurrent states are dense per slot and live outside
        # the page pool: take them off the budget before dividing it
        budget -= int(kw["max_slots"]) * spec.ssm_state_bytes(
            sc.opt.kv_dtype)
        per_page = spec.kv_bytes_per_token(sc.opt.kv_dtype) * ps
        n_pages = int(max(budget, 0.0) // per_page) + 1 if per_page > 0 \
            else 2
    n_pages = max(2, min(int(n_pages), max_pages_total + 1))
    return {"cache_layout": "paged", "page_size": ps, "n_pages": n_pages}


def _parallelism_lowering(sc: Scenario, kw: dict) -> tuple[int, int]:
    """Scenario ``ParallelismConfig`` -> the (tp, pp) degrees the live
    engine shards over.  Axes the engine cannot lower refuse loudly:
    silently measuring a tp=pp=1 run against an ep>1 prediction would
    corrupt every ``compare()`` cell built on it."""
    from ..serving.sharded import SUPPORTED_AXES

    par = sc.parallelism
    bad = [(ax, par.degree(ax)) for ax in ("ep", "dp", "sp")
           if par.degree(ax) > 1]
    if bad:
        named = ", ".join(f"{ax}={v}" for ax, v in bad)
        raise ValueError(
            f"engine backend cannot lower parallelism axis {named}: the "
            "live ServeEngine shards tensor (tp: kv-heads/FFN) and "
            "pipeline (pp: layers) only — supported axes: "
            f"{', '.join(SUPPORTED_AXES)}; ep/dp/sp grids run on the "
            "analytical backend")
    tp = int(kw["tp"]) if kw.get("tp") is not None else par.tp
    pp = int(kw["pp"]) if kw.get("pp") is not None else par.pp
    return tp, pp


def _engine_config(cfg) -> dict:
    return {"max_slots": cfg.max_slots, "max_seq": cfg.max_seq,
            "chunk_size": cfg.chunk_size, "prefill_rows": cfg.prefill_rows,
            "unified": cfg.unified, "prefix_cache": cfg.prefix_cache}


def _lower_engine(sc: Scenario, spec, model, kw: dict) -> Lowered:
    from ..serving import EngineConfig, ServeEngine

    geo = _geometry(sc, kw)
    if sc.mode == "chunked":
        chunk = max(1, min(sc.chunked.chunk, geo["prompt_len"]))
    else:  # monolithic: the whole prompt in one prefill chunk
        chunk = geo["prompt_len"]
    tp, pp = _parallelism_lowering(sc, kw)
    prefix = bool(kw["prefix_cache"]) or sc.opt.prefix_hit_rate > 0
    # prefix + mesh sharding both ride the unified paged step
    kw["unified"] = bool(kw["unified"]) or prefix or tp * pp > 1
    paging = _paged_lowering(sc, spec, geo, kw)
    cfg = EngineConfig(max_slots=int(kw["max_slots"]), max_seq=geo["max_seq"],
                       chunk_size=chunk, prefill_rows=int(kw["prefill_rows"]),
                       unified=bool(kw["unified"]), prefix_cache=prefix,
                       tp=tp, pp=pp, **paging)
    eng = ServeEngine(model, cfg, device=kw["device"], seed=int(kw["seed"]))
    reqs = _make_requests(sc, spec, geo, kw, prefix=prefix)
    return Lowered(sc, "engine", spec, eng, reqs, geo, extra={
        "engine_config": {**_engine_config(cfg), "tp": cfg.tp,
                          "pp": cfg.pp, **paging, **_where(model)},
        "model": spec.name})


def _where(model) -> dict:
    """The port-only part of an engine config: device and dtype."""
    return {"device": str(model.device),
            "dtype": str(model.dtype).removeprefix("torch.")}


def _lower_disaggregated(sc: Scenario, spec, model, kw: dict) -> Lowered:
    """Lower ``mode='disaggregated'`` to a live
    :class:`~repro_torch.serving.DisaggCluster` on one card.

    The analytical planner runs first, on the *clamped* workload, so its
    KV-transfer term prices the same tokens the cluster migrates; its best
    xPU:yPU ratio picks the prefill-rows : decode-slots split of the
    ``max_slots`` engine-unit budget.  The simulated link runs at the
    DisaggSpec's ``inter_pool_bw``.  Configurations the cluster cannot run
    raise a ValueError naming the missing knob."""
    from ..core.disagg import plan_with_baseline
    from ..serving.cluster import (DisaggCluster, DisaggClusterConfig,
                                   MigrationLink, pool_split_from_plan)
    from .scenario import DisaggSpec

    if sc.parallelism.total > 1 or sc.parallelism.sp > 1:
        raise ValueError(
            f"mode 'disaggregated' cannot lower parallelism "
            f"[{sc.parallelism.describe()}]: mesh sharding (tp/pp) is "
            "wired to the unified single-engine step only — supported "
            "axes for the engine backend: tp, pp under mode "
            "'monolithic'/'chunked'")
    geo = _geometry(sc, kw)
    budget = int(kw["max_slots"])
    if budget < 2:
        raise ValueError(
            "mode 'disaggregated' needs engine_kw['max_slots'] >= 2: the "
            "pool split assigns at least one engine unit to each pool "
            f"(got max_slots={budget})")
    if any(k == "ssm" for k in spec.layer_kinds()):
        raise ValueError(
            f"mode 'disaggregated' cannot lower {spec.name!r}: the "
            "prefill engine needs unified=True (direct-to-page K/V "
            "writes feed the migration channel) and the packed step "
            "supports attention-only stacks — SSM layers have no "
            "packed-segment forward; use an attention-only model or "
            "mode='chunked' with cache_layout='dense'")
    if spec.attn.kind == "swa":
        raise ValueError(
            f"mode 'disaggregated' cannot lower {spec.name!r}: the "
            "unified prefill step has no sliding-window masking in the "
            "ragged kernel yet; use a full-attention model")
    d = sc.disaggregated if sc.disaggregated is not None else DisaggSpec()
    wl = dataclasses.replace(sc.workload, tau_p=geo["prompt_len"],
                             tau_d=geo["max_new"])
    plans, co = plan_with_baseline(spec, sc.resolve_platform(), wl, sc.opt,
                                   total_npus=d.total_npus,
                                   inter_pool_bw=d.inter_pool_bw,
                                   tp_options=d.tp_options,
                                   colocated_tp=d.colocated_tp,
                                   colocated_chunk=d.colocated_chunk)
    best = plans[0] if plans else None
    if kw["disagg_split"] is not None:
        rows, slots = (int(x) for x in kw["disagg_split"])
        if rows < 1 or slots < 1:
            raise ValueError(
                f"engine_kw['disagg_split'] needs both sides >= 1, got "
                f"({rows}, {slots})")
    else:
        rows, slots = pool_split_from_plan(best, budget)
    chunk = max(1, min(sc.chunked.chunk if sc.chunked is not None else 16,
                       geo["prompt_len"]))
    paging = _paged_lowering(sc, spec, geo, dict(kw, unified=True))
    decode_pages = kw["decode_pages"]
    if decode_pages is None:
        # the §VI-A HBM-budget pool, clamped to what `slots` can address
        decode_pages = min(paging["n_pages"],
                           slots * (geo["max_seq"] // paging["page_size"])
                           + 1)
    link = MigrationLink(bandwidth=d.inter_pool_bw,
                         latency_s=float(kw["link_latency_s"]),
                         time_scale=float(kw["link_time_scale"]))
    ccfg = DisaggClusterConfig(
        max_seq=geo["max_seq"], page_size=paging["page_size"],
        chunk_size=chunk, prefill_rows=rows,
        prefill_slots=int(kw["prefill_slots"]),
        prefill_pages=kw["prefill_pages"], decode_slots=slots,
        decode_prefill_rows=int(kw["decode_prefill_rows"]),
        decode_pages=decode_pages, link=link)
    cluster = DisaggCluster(model, ccfg, device=kw["device"],
                            seed=int(kw["seed"]))
    reqs = _make_requests(sc, spec, geo, kw)
    return Lowered(sc, "cluster", spec, cluster, reqs, geo, extra={
        "engine_config": {
            "budget_slots": budget, "prefill_rows": rows,
            "decode_slots": slots, "chunk_size": chunk,
            "max_seq": geo["max_seq"], "decode_pages": decode_pages,
            "decode_unified": ccfg.decode_unified,
            "link_bandwidth": d.inter_pool_bw,
            "link_latency_s": link.latency_s,
            "link_time_scale": link.time_scale, **paging, **_where(model)},
        "plan": dataclasses.asdict(best) if best else None,
        "colocated": co,
        "predicted_kv_transfer_s": best.kv_transfer_s if best else None,
        "model": spec.name})


def _lower_speculative(sc: Scenario, spec, model, kw: dict) -> Lowered:
    """Lower ``mode='speculative'`` to the unified engine with
    ``n_spec = K``: every decode slot runs a K+1-token verify window
    through the packed step (``PackedSpeculator``), so the measured TPOT
    and tokens/s are the continuous-batching counterparts of
    ``core.stages.speculative_decode``'s pricing, and the measured
    acceptance rate compares with the scenario's ``gamma``."""
    from ..serving import EngineConfig, ServeEngine

    if sc.parallelism.total > 1 or sc.parallelism.sp > 1:
        raise ValueError(
            f"mode 'speculative' cannot lower parallelism "
            f"[{sc.parallelism.describe()}]: the fused draft/verify step "
            "runs single-device (serving/sharded.py refuses n_spec under "
            "tp/pp) — supported axes for the engine backend: tp, pp "
            "under mode 'monolithic'/'chunked'")

    d_spec, d_model = lower_model(sc.speculative.draft, **_model_kw(kw))
    if d_spec.vocab != spec.vocab:
        raise Refused(f"draft vocab {d_spec.vocab} != target vocab "
                      f"{spec.vocab}")
    geo = _geometry(sc, kw)
    chunk = max(1, min(sc.chunked.chunk if sc.chunked is not None else 16,
                       geo["prompt_len"]))
    prefix = bool(kw["prefix_cache"]) or sc.opt.prefix_hit_rate > 0
    # speculative verify segments ride the unified paged step, always
    kw = dict(kw, unified=True)
    paging = _paged_lowering(sc, spec, geo, kw)
    cfg = EngineConfig(max_slots=int(kw["max_slots"]),
                       max_seq=geo["max_seq"], chunk_size=chunk,
                       prefill_rows=int(kw["prefill_rows"]), unified=True,
                       prefix_cache=prefix, n_spec=int(sc.speculative.n),
                       **paging)
    eng = ServeEngine(model, cfg, device=kw["device"], seed=int(kw["seed"]),
                      draft_model=d_model)
    reqs = _make_requests(sc, spec, geo, kw, prefix=prefix)
    return Lowered(sc, "engine", spec, eng, reqs, geo, extra={
        "engine_config": {**_engine_config(cfg), "n_spec": cfg.n_spec,
                          **paging, **_where(model)},
        "model": spec.name, "draft": d_spec.name})


def _json_keys(obj):
    """``obj`` with every dict key a str (the engine's per-slot tallies
    are keyed by slot), so that the Report's JSON round trip is exact."""
    if isinstance(obj, dict):
        return {str(k): _json_keys(v) for k, v in obj.items()}
    return obj


def report(low: Lowered) -> Report:
    """The Report of a lowered run that :func:`serve` has served."""
    sc, reqs = low.scenario, low.requests
    done = [r for r in reqs if r.state == "done"]
    latency = (sum(r.finish_t - r.submit_t for r in done) / len(done)
               if done else None)
    extra = {"lowering": low.geometry, **low.extra}
    if low.kind == "cluster":
        cluster = low.runner
        summary = _json_keys(cluster.summary(
            reqs, ttft_slo_s=sc.workload.ttft_slo,
            tpot_slo_s=sc.workload.tpot_slo))
        # client-observed TTFT includes the simulated migration time — the
        # measured counterpart of the analytical prefill + kv_transfer term
        ttft = summary.get("ttft_incl_migration_s_mean")
        tpot = summary.get("tpot_s_mean")
        extra.update(engine=summary, kv=cluster.kv_stats(),
                     goodput_tok_s=summary["goodput_tok_s"],
                     measured_kv_transfer_s=summary[
                         "migration_transfer_s_mean"])
        return Report(
            scenario=sc, backend="engine", status="ok",
            ttft_s=ttft, tpot_s=tpot, latency_s=latency,
            throughput_tok_s=summary["tokens_per_s"],
            max_concurrency=summary["decode"].get("peak_active"),
            fits_memory=True,
            meets_slo=_meets(sc, {"ttft_s_mean": ttft, "tpot_s_mean": tpot}),
            extra=extra)
    eng = low.runner
    summary = _json_keys(eng.metrics.summary(reqs))
    extra.update(engine=summary, kv=eng.kv_stats())
    if eng.cfg.n_spec:
        extra.update(
            acceptance_rate=summary.get("spec_acceptance_rate", 0.0),
            tokens_per_pass=summary.get("spec_tokens_per_round", 0.0),
            target_passes=summary.get("spec_slot_rounds",
                                      eng.metrics.spec_slot_rounds))
    return Report(
        scenario=sc, backend="engine", status="ok",
        ttft_s=summary.get("ttft_s_mean"), tpot_s=summary.get("tpot_s_mean"),
        latency_s=latency, throughput_tok_s=summary["tokens_per_s"],
        max_concurrency=summary.get("peak_active"),
        fits_memory=True, meets_slo=_meets(sc, summary), extra=extra)


def _meets(sc: Scenario, summary: dict) -> bool | None:
    wl = sc.workload
    if wl.ttft_slo is None and wl.tpot_slo is None:
        return None
    ok = True
    if wl.ttft_slo is not None and summary.get("ttft_s_mean") is not None:
        ok &= summary["ttft_s_mean"] <= wl.ttft_slo
    if wl.tpot_slo is not None and summary.get("tpot_s_mean") is not None:
        ok &= summary["tpot_s_mean"] <= wl.tpot_slo
    return ok
