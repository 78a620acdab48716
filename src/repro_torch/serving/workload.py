"""Seeded trace-replay workload generator (bursty, multi-tenant, multi-turn).

The port's own copy of ``repro.serving.workload``: the same
:class:`TraceConfig` gives the same trace in both packages, and a JSON
trace written by either loads in the other.  :func:`replay` drives the
port's :class:`~repro_torch.serving.engine.ServeEngine`.

The paper's serving numbers assume steady open-loop Poisson arrivals; real
platform traffic is burstier and *structured*: tenants share few-shot
templates, and conversations come back with their whole history as prompt.
That structure is exactly what the prefix cache (:mod:`.prefix_cache`)
exploits, so the generator models it explicitly:

- **Arrivals** follow a two-state on/off modulated Poisson process: an ON
  phase at ``rate * burst_factor`` alternating with an OFF phase at
  ``rate / burst_factor`` (exponential dwell times), degenerating to plain
  Poisson at ``burst_factor=1``.
- **Prompts** are drawn per tenant as ``template + fresh suffix``: each
  tenant owns a handful of fixed token templates (system prompt / few-shot
  block) shared across its requests.
- **Multi-turn**: with probability ``multi_turn_p`` a finished request
  spawns a continuation whose prompt is the *new* turn's tokens only; the
  replayer resolves the full prompt as ``parent prompt + parent output +
  new tokens`` once the parent is done (so traces stay valid under any
  sampling).

Traces round-trip through JSON (:func:`trace_to_json` /
:func:`trace_from_json`) and everything is driven by one seed.

:func:`replay` feeds a trace into a live ``ServeEngine`` with real
inter-arrival sleeps and returns SLO attainment + goodput on top of the
engine's own metrics — goodput counts only the tokens of requests that met
*both* their TTFT and TPOT SLOs, the paper's headline serving criterion.
"""

from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass, field, replace

import numpy as np

from .engine import Request, ServeEngine

TRACE_VERSION = 1


@dataclass(frozen=True)
class TraceRequest:
    """One arrival in a trace.

    ``prompt`` holds only this turn's *new* tokens; for continuations
    (``parent`` is the trace index of the previous turn) the full prompt is
    parent-prompt + parent-output + ``prompt``, resolved at replay time.
    """

    arrival_s: float
    prompt: tuple[int, ...]
    max_new_tokens: int
    tenant: str = "t0"
    template_id: str | None = None
    parent: int | None = None
    turn: int = 0


@dataclass(frozen=True)
class TraceConfig:
    """Knobs of the generator; one seed fixes the whole trace."""

    n_requests: int = 32          # root arrivals (continuations come on top)
    seed: int = 0
    vocab: int = 256
    rate_req_s: float = 24.0      # mean arrival rate across phases
    burst_factor: float = 4.0     # ON rate multiplier (1 = plain Poisson)
    on_s: float = 0.4             # mean ON dwell
    off_s: float = 0.4            # mean OFF dwell
    n_tenants: int = 3
    templates_per_tenant: int = 2
    template_tokens: tuple[int, int] = (16, 33)   # [lo, hi) template length
    suffix_tokens: tuple[int, int] = (4, 13)      # [lo, hi) fresh suffix
    max_new_tokens: tuple[int, int] = (4, 9)      # [lo, hi) decode budget
    multi_turn_p: float = 0.4     # P(a request gets a follow-up turn)
    max_turns: int = 3
    think_s: float = 0.05         # user think time before a follow-up


def _tenant_templates(cfg: TraceConfig, rng: np.random.Generator
                      ) -> dict[str, dict[str, list[int]]]:
    """Fixed per-tenant shared prompt templates, e.g. system prompts."""
    lo, hi = cfg.template_tokens
    out: dict[str, dict[str, list[int]]] = {}
    for t in range(cfg.n_tenants):
        tenant = f"tenant{t}"
        out[tenant] = {
            f"{tenant}/tmpl{k}":
                rng.integers(1, cfg.vocab, size=int(rng.integers(lo, hi)))
                .tolist()
            for k in range(cfg.templates_per_tenant)
        }
    return out


def _arrivals(cfg: TraceConfig, rng: np.random.Generator) -> list[float]:
    """On/off modulated Poisson arrival times for the root requests."""
    times: list[float] = []
    now, on = 0.0, True
    phase_end = rng.exponential(cfg.on_s)
    while len(times) < cfg.n_requests:
        rate = cfg.rate_req_s * (cfg.burst_factor if on
                                 else 1.0 / cfg.burst_factor)
        gap = rng.exponential(1.0 / rate)
        if now + gap > phase_end and cfg.burst_factor != 1.0:
            now = phase_end
            on = not on
            phase_end = now + rng.exponential(cfg.on_s if on else cfg.off_s)
            continue
        now += gap
        times.append(now)
    return times


def generate_trace(cfg: TraceConfig) -> list[TraceRequest]:
    """Deterministic trace: same config -> same arrivals, prompts, turns."""
    rng = np.random.default_rng(cfg.seed)
    templates = _tenant_templates(cfg, rng)
    tenants = list(templates)
    trace: list[TraceRequest] = []
    lo_s, hi_s = cfg.suffix_tokens
    lo_n, hi_n = cfg.max_new_tokens
    for arrival in _arrivals(cfg, rng):
        tenant = tenants[int(rng.integers(len(tenants)))]
        tmpl_id = list(templates[tenant])[
            int(rng.integers(len(templates[tenant])))]
        suffix = rng.integers(1, cfg.vocab,
                              size=int(rng.integers(lo_s, hi_s))).tolist()
        trace.append(TraceRequest(
            arrival_s=round(arrival, 6),
            prompt=tuple(templates[tenant][tmpl_id] + suffix),
            max_new_tokens=int(rng.integers(lo_n, hi_n)),
            tenant=tenant, template_id=tmpl_id))
    # Follow-up turns: each lands after its parent with some think time.
    frontier = list(range(len(trace)))
    for turn in range(1, cfg.max_turns):
        nxt: list[int] = []
        for idx in frontier:
            if rng.random() >= cfg.multi_turn_p:
                continue
            parent = trace[idx]
            suffix = rng.integers(1, cfg.vocab,
                                  size=int(rng.integers(lo_s, hi_s))).tolist()
            trace.append(TraceRequest(
                arrival_s=round(parent.arrival_s
                                + rng.exponential(cfg.think_s), 6),
                prompt=tuple(suffix),
                max_new_tokens=int(rng.integers(lo_n, hi_n)),
                tenant=parent.tenant, template_id=parent.template_id,
                parent=idx, turn=turn))
            nxt.append(len(trace) - 1)
        frontier = nxt
    return trace


# -- JSON round trip ---------------------------------------------------------
def trace_to_json(trace: list[TraceRequest],
                  cfg: TraceConfig | None = None) -> str:
    doc = {"version": TRACE_VERSION,
           "requests": [asdict(r) for r in trace]}
    if cfg is not None:
        doc["config"] = asdict(cfg)
    return json.dumps(doc, indent=1)


def trace_from_json(text: str) -> list[TraceRequest]:
    doc = json.loads(text)
    if doc.get("version") != TRACE_VERSION:
        raise ValueError(f"unsupported trace version {doc.get('version')!r}")
    out = []
    for r in doc["requests"]:
        r = dict(r)
        r["prompt"] = tuple(r["prompt"])
        out.append(TraceRequest(**r))
    return out


# -- replay ------------------------------------------------------------------
@dataclass
class ReplaySummary:
    """SLO/goodput view of one replayed trace (plus the engine summary)."""

    n_requests: int
    wall_s: float
    throughput_tok_s: float
    goodput_tok_s: float          # tokens of SLO-attaining requests / wall
    slo_attainment: float         # fraction of requests meeting both SLOs
    ttft_mean_s: float
    tpot_mean_s: float
    ttft_slo_s: float | None
    tpot_slo_s: float | None
    engine: dict = field(default_factory=dict)
    by_tenant: dict[str, dict[str, float]] = field(default_factory=dict)


def replay(eng: ServeEngine, trace: list[TraceRequest], *,
           ttft_slo_s: float | None = None, tpot_slo_s: float | None = None,
           time_scale: float = 1.0,
           ) -> tuple[ReplaySummary, list[Request]]:
    """Drive ``eng`` with ``trace`` arrivals; returns (summary, requests).

    Continuations are submitted only once their parent finished (their full
    prompt needs the parent's output) and their arrival time has passed —
    whichever is later.  ``time_scale`` compresses the trace clock for
    smoke runs.
    """
    order = sorted(range(len(trace)), key=lambda i: trace[i].arrival_s)
    reqs: dict[int, Request] = {}
    waiting = set(order)
    start = time.perf_counter()

    def ready(i: int) -> bool:
        tr = trace[i]
        if (time.perf_counter() - start) < tr.arrival_s * time_scale:
            return False
        return tr.parent is None or (
            tr.parent in reqs and reqs[tr.parent].state == "done")

    while waiting or eng.busy:
        submitted = False
        for i in [i for i in order if i in waiting]:
            if not ready(i):
                continue
            tr = trace[i]
            prompt = list(tr.prompt)
            if tr.parent is not None:
                par = reqs[tr.parent]
                prompt = list(par.prompt) + list(par.output) + prompt
            reqs[i] = Request(prompt=prompt, max_new_tokens=tr.max_new_tokens,
                              tenant=tr.tenant, template_id=tr.template_id)
            eng.submit(reqs[i])
            waiting.discard(i)
            submitted = True
        if eng.busy:
            eng.step()
        elif not submitted:
            time.sleep(0.0005)  # idle: next arrival not due yet
    wall = time.perf_counter() - start

    req_list = [reqs[i] for i in sorted(reqs)]
    out_tokens = sum(len(r.output) for r in req_list)

    def attains(r: Request) -> bool:
        if r.state != "done":
            return False
        if ttft_slo_s is not None and r.ttft_s > ttft_slo_s:
            return False
        if tpot_slo_s is not None and r.tpot_s > tpot_slo_s:
            return False
        return True

    good = [r for r in req_list if attains(r)]
    ttfts = [r.ttft_s for r in req_list if r.state == "done"]
    tpots = [r.tpot_s for r in req_list if r.tpot_s > 0]
    by_tenant: dict[str, dict[str, float]] = {}
    for i, r in sorted(reqs.items()):
        t = by_tenant.setdefault(trace[i].tenant,
                                 {"requests": 0, "attained": 0, "tokens": 0})
        t["requests"] += 1
        t["attained"] += attains(r)
        t["tokens"] += len(r.output)

    summary = ReplaySummary(
        n_requests=len(req_list), wall_s=wall,
        throughput_tok_s=out_tokens / wall if wall else 0.0,
        goodput_tok_s=sum(len(r.output) for r in good) / wall if wall else 0.0,
        slo_attainment=len(good) / len(req_list) if req_list else 1.0,
        ttft_mean_s=float(np.mean(ttfts)) if ttfts else 0.0,
        tpot_mean_s=float(np.mean(tpots)) if tpots else 0.0,
        ttft_slo_s=ttft_slo_s, tpot_slo_s=tpot_slo_s,
        engine=eng.metrics.summary(req_list), by_tenant=by_tenant)
    return summary, req_list


def smoke_config(cfg: TraceConfig | None = None) -> TraceConfig:
    """Shrink a trace config for CI smoke runs (fast, still multi-tenant)."""
    base = cfg or TraceConfig()
    return replace(base, n_requests=8, n_tenants=2, templates_per_tenant=1,
                   template_tokens=(16, 17), suffix_tokens=(3, 7),
                   max_new_tokens=(3, 6), rate_req_s=200.0, think_s=0.01,
                   on_s=0.05, off_s=0.05)
