"""End-to-end inference stage models (paper §II-B, §II-C, §IV).

Builds on the profiler + roofline to produce the four serving metrics:

  TTFT       : one forward pass over the full prompt (prefill),
  TPOT       : one autoregressive forward pass (decode),
  latency    : TTFT + TPOT * tau_d,
  throughput : B / TPOT output tokens per second,

plus the serving optimizations the paper studies: chunked prefill (§IV-A),
speculative decoding (§IV-B) and beam search (§II-B), and the memory-capacity
feasibility check used to mark configurations "OOM" (Fig. 17).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from .modelspec import ModelSpec
from .network import Platform
from .operators import Optimizations
from .parallelism import ParallelismConfig, validate
from .profiler import PassSpec, model_ops
from .roofline import PassTiming, pass_energy, time_pass


@dataclass(frozen=True)
class Workload:
    """One serving scenario (paper Table III row)."""
    batch: int = 1
    tau_p: int = 1024  # input tokens
    tau_d: int = 256  # output tokens
    beam: int = 1  # S_b
    ttft_slo: float | None = None  # seconds
    tpot_slo: float | None = None  # seconds
    name: str = "workload"


@dataclass
class MemoryCheck:
    weights_per_npu: float
    kv_per_npu: float
    capacity: float
    fits: bool

    @property
    def total_per_npu(self) -> float:
        return self.weights_per_npu + self.kv_per_npu


@dataclass
class StageResult:
    name: str
    timing: PassTiming
    time: float  # seconds for the stage step
    energy: float  # joules
    memory: MemoryCheck
    meta: dict = field(default_factory=dict)


def _page_round(tokens: float, opt: Optimizations) -> float:
    """Paged KV (PagedAttention family): per-request KV occupancy rounds up
    to whole pages — internal fragmentation <= one page per request."""
    if not opt.paged_kv:
        return tokens
    ps = max(opt.kv_page_size, 1)
    return math.ceil(tokens / ps) * ps


def _platform_capacity(platform: Platform) -> float:
    cap = platform.npu.mem.capacity
    if platform.npu.sram and platform.npu.sram.capacity > cap:
        cap = platform.npu.sram.capacity
    return cap


def memory_check(spec: ModelSpec, platform: Platform, par: ParallelismConfig,
                 opt: Optimizations, wl: Workload,
                 context: int | None = None) -> MemoryCheck:
    """Paper §VI-A: weights + KV cache must fit the fast memory."""
    shards = par.tp * par.ep * par.pp  # model sharded over these
    weights = spec.param_count() * opt.wbytes() / shards
    ctx = context if context is not None else wl.tau_p + wl.beam * wl.tau_d
    if opt.kv_window:
        ctx = min(ctx, opt.kv_window)
    kv_total = spec.kv_cache_bytes(wl.batch, _page_round(ctx, opt), 0,
                                   beam=1, dtype=opt.kv_dtype)
    kv = kv_total * (1.0 - opt.kv_prune) / (par.tp * par.pp)
    cap = _platform_capacity(platform)
    return MemoryCheck(weights_per_npu=weights, kv_per_npu=kv, capacity=cap,
                       fits=(weights + kv) <= cap)


def kv_bytes_per_request(spec: ModelSpec, opt: Optimizations,
                         tokens: float) -> float:
    """Device bytes one request's KV holds at ``tokens`` context, honoring
    the kv dtype / window / prune / paging optimizations."""
    if opt.kv_window:
        tokens = min(tokens, opt.kv_window)
    return (spec.kv_cache_bytes(1, _page_round(tokens, opt), 0,
                                dtype=opt.kv_dtype)
            * (1.0 - opt.kv_prune))


def _hit_rate(opt: Optimizations) -> float:
    """Effective prefix-cache hit rate: pages are the sharing unit, so the
    rate only applies under ``paged_kv``; clamped to [0, 1]."""
    if not opt.paged_kv:
        return 0.0
    return min(max(opt.prefix_hit_rate, 0.0), 1.0)


def concurrency_from_kv_budget(spec: ModelSpec, opt: Optimizations,
                               wl: Workload, kv_budget_bytes: float,
                               reserved_ctx: int | None = None) -> int:
    """Shared core of the §VI-A inversion: concurrent requests a KV byte
    budget supports.  A dense engine reserves ``reserved_ctx`` tokens per
    slot up front (its ``max_seq``); a paged engine (``opt.paged_kv``)
    holds only the pages the actual context needs, rounded up.

    With a prefix cache, the hit fraction of every prompt is ONE shared
    copy: its bytes are charged once against the budget, and each request
    is charged only its private suffix + decode tokens (plus at least one
    page — the copy-on-write fork a full hit forks its tail into).
    """
    ctx = wl.tau_p + wl.beam * wl.tau_d
    if not opt.paged_kv and reserved_ctx is not None:
        ctx = max(ctx, reserved_ctx)
    per_req = kv_bytes_per_request(spec, opt, ctx)
    budget = max(kv_budget_bytes, 0.0)
    hit = _hit_rate(opt)
    if hit > 0.0:
        shared = kv_bytes_per_request(spec, opt, wl.tau_p * hit)
        budget -= shared
        per_req = max(per_req - shared, kv_bytes_per_request(spec, opt, 1))
    if per_req <= 0:
        return 0
    return int(max(budget, 0.0) // per_req)


def max_concurrency(spec: ModelSpec, platform: Platform,
                    par: ParallelismConfig, opt: Optimizations, wl: Workload,
                    *, reserved_ctx: int | None = None) -> int:
    """Paper §VI-A inverted: the largest number of concurrent requests
    whose KV fits beside the weights — the capacity question paging
    answers.

    A **dense** engine reserves ``reserved_ctx`` tokens per slot up front
    (its ``max_seq``; defaults to the workload's full tau_p + S_b tau_d),
    whether or not a request ever grows that long.  A **paged** engine
    (``opt.paged_kv``) holds only the pages the request's actual context
    needs, rounded up to whole pages — so mixed / short requests stop
    stranding capacity and max concurrency rises.
    """
    shards = par.tp * par.ep * par.pp
    weights = spec.param_count() * opt.wbytes() / shards
    cap = _platform_capacity(platform)
    kv_room = max(cap - weights, 0.0) * par.tp * par.pp
    return concurrency_from_kv_budget(spec, opt, wl, kv_room,
                                      reserved_ctx=reserved_ctx)


def _resident_bytes(spec: ModelSpec, par: ParallelismConfig,
                    opt: Optimizations, wl: Workload, context: int) -> float:
    shards = par.tp * par.ep * par.pp
    return (spec.param_count() * opt.wbytes() / shards
            + spec.kv_cache_bytes(wl.batch, context, 0, dtype=opt.kv_dtype)
            / (par.tp * par.pp))


def _pipeline_time(per_stage: float, par: ParallelismConfig,
                   sendrecv: float) -> float:
    """Latency of one pass through a PP-staged model (GPipe-style): with m
    microbatches the pass costs (pp + m - 1) stage-steps of 1/m each."""
    if par.pp <= 1:
        return per_stage
    m = max(par.micro_batches, 1)
    stage = per_stage / m
    return stage * (par.pp + m - 1) + sendrecv * (par.pp - 1)


def prefill(spec: ModelSpec, platform: Platform, par: ParallelismConfig,
            opt: Optimizations, wl: Workload) -> StageResult:
    """TTFT: full forward pass over tau_p tokens (compute-bound, §II-B).

    With a prefix cache (``opt.prefix_hit_rate`` under ``paged_kv``), only
    the uncached suffix of each prompt is computed: q_len drops to
    ``tau_p * (1 - hit)`` (never below the one recomputed last token) while
    kv_len stays ``tau_p`` — the suffix still attends the shared pages.
    """
    validate(par, platform.num_npus, spec.n_layers,
             spec.moe.num_experts if spec.moe else None)
    hit = _hit_rate(opt)
    q_len = max(wl.tau_p * (1.0 - hit), 1.0) if hit > 0.0 else wl.tau_p
    # causal_square halves attention FLOPs for the q==kv triangle; a cached
    # suffix sits at the END of the context and attends nearly all of it
    fwd = PassSpec(batch=wl.batch / par.dp, q_len=q_len, kv_len=wl.tau_p,
                   causal_square=(hit == 0.0))
    resident = _resident_bytes(spec, par, opt, wl, wl.tau_p)
    # Prefill needs logits only for the last position of each request.
    ops = model_ops(spec, fwd, par, opt,
                    head_q_len=1 if spec.decoder else None)
    pt = time_pass(ops, platform, opt, resident)
    # one-stage time = all layers / pp stages
    per_stage = pt.total / par.pp if par.pp > 1 else pt.total
    t = _pipeline_time(per_stage * par.pp, par, 0.0) if par.pp > 1 else pt.total
    mem = memory_check(spec, platform, par, opt, wl, context=wl.tau_p)
    return StageResult("prefill", pt, t, pass_energy(pt, platform, opt), mem,
                       meta={"ttft": t})


def decode(spec: ModelSpec, platform: Platform, par: ParallelismConfig,
           opt: Optimizations, wl: Workload,
           context: int | None = None) -> StageResult:
    """TPOT: one token per pass, reading the whole KV cache (§II-B).

    ``context`` defaults to tau_p + tau_d/2 (mid-generation average).
    Beam search multiplies the decode batch by S_b (beams share the prefill
    KV but each appends its own suffix)."""
    validate(par, platform.num_npus, spec.n_layers,
             spec.moe.num_experts if spec.moe else None)
    ctx = context if context is not None else wl.tau_p + wl.tau_d // 2
    batch = wl.batch * max(wl.beam, 1) / par.dp
    fwd = PassSpec(batch=batch, q_len=1, kv_len=ctx, causal_square=False)
    resident = _resident_bytes(spec, par, opt, wl, ctx)
    ops = model_ops(spec, fwd, par, opt)
    pt = time_pass(ops, platform, opt, resident)
    t_latency = pt.total  # all stages traversed for one token
    t_throughput = pt.total / par.pp  # steady-state pipelined decode
    mem = memory_check(spec, platform, par, opt, wl, context=ctx)
    thr = wl.batch * par.dp / t_throughput if t_throughput > 0 else 0.0
    return StageResult("decode", pt, t_latency,
                       pass_energy(pt, platform, opt), mem,
                       meta={"tpot": t_latency, "tpot_throughput": t_throughput,
                             "tokens_per_s": thr})


def chunked(spec: ModelSpec, platform: Platform, par: ParallelismConfig,
            opt: Optimizations, wl: Workload, chunk: int,
            decode_batch: int, decode_ctx: int | None = None, *,
            fused: bool = True) -> StageResult:
    """One chunked-prefill iteration (paper §IV-A / SplitFuse / Sarathi).

    The forward pass carries ``chunk`` tokens: ``decode_batch`` of them are
    decode tokens (one per in-flight request, each attending to its own KV
    cache) and the rest are a slice of an outstanding prefill.  Linear layers
    see a fixed ``chunk``-token batch; only logit/attend grow with context.

    ``fused`` selects which engine implementation is being priced:

      * True  — the unified token-packed step: decode tokens and the
        prefill slice ride ONE dispatch, so the linear layers stream the
        weights once for the whole chunk (``ServeEngine(unified=True)``).
      * False — the two-dispatch baseline: a decode pass plus a separate
        prefill-chunk pass, each streaming the weights (and paying a
        dispatch) on its own — the gap chunking exists to close.

    Attention work is identical under both (each token attends to its own
    request's KV either way); only the linear-layer accounting differs.
    """
    ctx = decode_ctx if decode_ctx is not None else wl.tau_p + wl.tau_d // 2
    prefill_tokens = max(chunk - decode_batch, 0)

    attn_prefixes = ("attn.flash", "attn.logit", "attn.softmax",
                     "attn.attend", "attn.kv_append")
    if fused:
        # Linear/MoE/embed ops for the full fused chunk: profiled with
        # attention stripped out (kv_len=0 adds no logit/attend flops).
        fused_pass = PassSpec(batch=1, q_len=chunk, kv_len=0,
                              causal_square=False)
        ops = [o for o in model_ops(spec, fused_pass, par, opt)
               if not o.name.startswith(attn_prefixes)]
    else:
        # Two dispatches: the decode batch and the prefill slice each run
        # their linear layers (weights stream twice per iteration).
        ops = []
        if decode_batch > 0:
            dec_lin = PassSpec(batch=decode_batch, q_len=1, kv_len=0,
                               causal_square=False)
            ops += [o for o in model_ops(spec, dec_lin, par, opt)
                    if not o.name.startswith(attn_prefixes)]
        if prefill_tokens > 0:
            pre_lin = PassSpec(batch=1, q_len=prefill_tokens, kv_len=0,
                               causal_square=False)
            ops += [o for o in model_ops(spec, pre_lin, par, opt)
                    if not o.name.startswith(attn_prefixes)]
    # Attention for the decode tokens: decode_batch requests, 1 query each.
    if decode_batch > 0:
        dec = PassSpec(batch=decode_batch, q_len=1, kv_len=ctx,
                       causal_square=False)
        dec_ops = model_ops(spec, dec, par, opt, include_embed_head=False)
        ops += [o for o in dec_ops if o.name.startswith(
            ("attn.flash", "attn.logit", "attn.softmax", "attn.attend",
             "attn.kv_append"))]
    # Attention for the prefill slice: queries attend to the prefix processed
    # so far (average tau_p/2 for a mid-prefill chunk).
    if prefill_tokens > 0:
        pre = PassSpec(batch=1, q_len=prefill_tokens, kv_len=wl.tau_p / 2,
                       causal_square=False)
        pre_ops = model_ops(spec, pre, par, opt, include_embed_head=False)
        ops += [o for o in pre_ops if o.name.startswith(
            ("attn.flash", "attn.logit", "attn.softmax", "attn.attend",
             "attn.kv_append"))]

    resident = _resident_bytes(spec, par, opt,
                               Workload(batch=decode_batch or 1,
                                        tau_p=int(ctx), tau_d=0), int(ctx))
    pt = time_pass(ops, platform, opt, resident)
    mem = memory_check(spec, platform, par, opt,
                       Workload(batch=decode_batch or 1, tau_p=int(ctx),
                                tau_d=0), context=int(ctx))
    t = pt.total
    thr = decode_batch / t if t > 0 else 0.0
    return StageResult("chunked", pt, t, pass_energy(pt, platform, opt), mem,
                       meta={"iter_time": t, "tpot": t,
                             "decode_tokens_per_s": thr, "chunk": chunk,
                             "decode_batch": decode_batch, "fused": fused,
                             "dispatches_per_iter": 1 if fused else 2})


def expected_tokens_per_cycle(n: int, gamma: float) -> float:
    """Speculative decoding expected accepted tokens per target pass
    (paper §IV-B):  E[T] = sum_{i=1}^{N-1} i gamma^i (1-gamma) + N gamma^N."""
    return (sum(i * gamma**i * (1 - gamma) for i in range(1, n))
            + n * gamma**n)


def speculative_decode(target: ModelSpec, draft: ModelSpec,
                       platform: Platform, par: ParallelismConfig,
                       opt: Optimizations, wl: Workload, n_spec: int,
                       gamma: float,
                       draft_par: ParallelismConfig | None = None
                       ) -> StageResult:
    """Throughput of speculative decoding (paper §IV-B, Fig. 11).

    One cycle = N autoregressive draft passes + 1 target pass verifying N+1
    tokens in parallel; it yields E[T] accepted tokens (+1 from the target's
    own sample is intentionally *not* counted, matching the paper's E[T])."""
    ctx = wl.tau_p + wl.tau_d // 2
    dpar = draft_par or par
    d_ops = model_ops(draft, PassSpec(wl.batch, 1, ctx, False), dpar, opt)
    d_pt = time_pass(d_ops, platform, opt)
    t_ops = model_ops(target, PassSpec(wl.batch, n_spec + 1, ctx, False), par,
                      opt)
    t_pt = time_pass(t_ops, platform, opt)
    cycle = n_spec * d_pt.total + t_pt.total
    e_tokens = expected_tokens_per_cycle(n_spec, gamma)
    thr = wl.batch * max(e_tokens, 1e-9) / cycle

    # Memory: both models + both KV caches resident (paper's 24-28% overhead
    # observation).
    mem_t = memory_check(target, platform, par, opt, wl, context=ctx)
    kv_d = draft.kv_cache_bytes(wl.batch, ctx, 0, dtype=opt.kv_dtype) / (
        dpar.tp * dpar.pp)
    w_d = draft.param_count() * opt.wbytes() / (dpar.tp * dpar.ep * dpar.pp)
    mem = MemoryCheck(
        weights_per_npu=mem_t.weights_per_npu + w_d,
        kv_per_npu=mem_t.kv_per_npu + kv_d,
        capacity=mem_t.capacity,
        fits=(mem_t.total_per_npu + w_d + kv_d) <= mem_t.capacity)
    combined = PassTiming(ops=d_pt.ops + t_pt.ops)
    return StageResult("speculative", combined, cycle,
                       pass_energy(d_pt, platform, opt) * n_spec
                       + pass_energy(t_pt, platform, opt), mem,
                       meta={"tokens_per_s": thr, "e_tokens": e_tokens,
                             "cycle": cycle, "n": n_spec, "gamma": gamma})


@dataclass
class InferenceReport:
    """Full-request metrics (paper §II-C)."""
    ttft: float
    tpot: float
    latency: float
    throughput: float  # output tokens / s
    prefill: StageResult
    decode: StageResult
    energy: float
    energy_per_token: float

    def meets(self, wl: Workload) -> bool:
        ok = True
        if wl.ttft_slo is not None:
            ok &= self.ttft <= wl.ttft_slo
        if wl.tpot_slo is not None:
            ok &= self.tpot <= wl.tpot_slo
        return ok


def estimate(spec: ModelSpec, platform: Platform, par: ParallelismConfig,
             opt: Optimizations, wl: Workload,
             context: int | None = None) -> InferenceReport:
    """End-to-end request estimate: T_lat = TTFT + TPOT * tau_d."""
    pre = prefill(spec, platform, par, opt, wl)
    dec = decode(spec, platform, par, opt, wl, context=context)
    ttft = pre.time
    tpot = dec.meta["tpot"]
    latency = ttft + tpot * wl.tau_d
    thr_t = dec.meta["tpot_throughput"]
    thr = wl.batch / thr_t if thr_t else 0.0
    total_energy = pre.energy + dec.energy * wl.tau_d
    e_per_tok = total_energy / max(wl.batch * wl.tau_d, 1)
    return InferenceReport(ttft=ttft, tpot=tpot, latency=latency,
                           throughput=thr, prefill=pre, decode=dec,
                           energy=total_energy, energy_per_token=e_per_tok)
