"""Continuous-batching serving engine (the port of
``repro.serving.engine``).

Slot-based continuous batching: a fixed pool of ``max_slots`` decode slots;
prompts are prefilled in ``chunk_size`` pieces by up to ``prefill_rows``
concurrent prefill rows.  Two engines, as in the reference:

* **Unified** (``cache_layout="paged", unified=True``): every step packs
  all active slots' decode tokens and every in-flight prompt's current
  chunk into one fixed ragged layout (slot s's token at offset s, prefill
  row r's chunk at ``max_slots + r * chunk_size``), runs one forward that
  writes prefill K/V straight into their pages, samples every segment on
  the device and copies the sampled tokens to the host once.  Two packed
  profiles: mixed decode+prefill, and decode-only (T = max_slots) when no
  prefill is in flight.
* **Two-dispatch** (``unified=False``, either layout; the default
  ``EngineConfig()`` is the dense one): prefill runs on a dense scratch
  cache of ``prefill_rows`` rows, one batched chunk call per chunk width
  (rows at other widths keep their state), and a completed prompt is copied
  into its decode slot (the dense layout) or scattered into its pages (the
  paged layout).  Decode is one ``decode_step`` over every slot and one
  sample, in ``decode_priority`` order with the prefill.

A stack with state-carrying layers (the jamba hybrid's Mamba layers, an
attention-free RWKV-6 stack) serves through the two-dispatch engine in
either layout: its per-slot state is reset, advanced and inserted as K/V
rows are (paging never applies to state), and the paged layout's page
accounting runs unchanged, as the reference's does.  The unified step
refuses it (``ValueError``, as the reference).

In the paged layout pages are allocated on append and freed on finish;
when the pool runs dry the youngest active request is preempted back to
the queue (recompute-style, so greedy outputs are unchanged).

With ``prefix_cache=True`` (unified only, as the reference) the unified
engine shares KV pages across requests through the radix tree of
:mod:`.prefix_cache`: an admitted request maps its longest cached
page-prefix read-only and prefills only the rest; a full hit forks its
tail page copy-on-write (one eager page copy, outside the captured step);
finished prefills and released requests insert their full pages; the
pool evicts cold cached pages before it preempts.  A hit changes only the
host-side lengths, positions and page-table rows the step stages, so it
never causes a capture.

With ``n_spec=K`` (unified only, and a ``draft_model``, as the reference)
every step is one speculative round of :mod:`.speculative`'s
``PackedSpeculator``: each decode slot verifies a K+1-token window (its
committed token and K draft proposals) and commits the accepted prefix
plus one resampled or bonus token, one at a time under the plain decode's
stop conditions.  The draft's KV pool mirrors the target's page ids, so a
copy-on-write fork copies the page in both pools.

A model built with ``kv_quant=True`` serves from int8 K/V with f32 scales
in every mode (:mod:`repro_torch.models.attention`): the scales ride with
the codes through every row reset, insert, copy-on-write fork and the
draft's pool, and ``kv_stats`` counts them.  Quantized, the paged
two-dispatch decode takes the reference's gather route, which applies the
sliding window, so that layout serves sliding-window models too.

With ``tp * pp > 1`` (unified only, attention-only dense stacks, as the
reference) the unified engine serves across ``tp * pp`` torch.distributed
ranks (:mod:`.sharded`): every rank builds the same engine over the same
requests and runs the same scheduler, holds its shard of the weights (the
engine cuts it from a full model, or is given the rank's shard) and of the
paged pools (its kv heads / tp of its stage's layers over the full page
axis; the page table and lengths replicated, so host page ids hold on
every rank), and its packed step runs the shard's collectives, which
``EngineMetrics.collectives``/``collective_bytes`` count with the
reference's analytical ``collective_stats`` once a step.  Every rank
samples the same tokens and copies them to its host once a step.

Under P/D disaggregation (:mod:`.cluster`) a unified engine with an
``export_fn`` hands each completed prefill to that hook instead of a local
decode slot (its pages stay owned by the request until the migration
channel has copied them out), and a paged engine takes migrated requests
through :meth:`ServeEngine.reserve_imported` and
:meth:`ServeEngine.install_imported`: a page-table row, the host mirrors
and, in the two-dispatch engine, the slot's length written into the
cache's own lengths tensor, which the captured decode reads.

The scheduler is pure Python over host mirrors (numpy), identical to the
reference's, and ``EngineMetrics.dispatches``/``transfers_d2h`` count
exactly where the reference counts them, so the port's step, preemption
and dispatch counts equal the reference engine's for the same requests.

Every step runs through
:class:`~repro_torch.serving.step_graph.StepGraph`, as the reference jits
them: the unified engine's two packed profiles, and the two-dispatch
engine's decode, row reset, insert, first-token sample and one prefill
profile per chunk width (registered at the first chunk of that width, as
the reference's ``_jit_prefill`` traces once per width).  On the card each
is one CUDA-graph replay (captured at its first use), so there a
"dispatch" is one replay; only a copy-on-write fork stays an eager copy.
Every tensor such a step reads or writes keeps one address for the
engine's lifetime: the engine's one ``ModelCache`` and one prefill
scratch (with their dequantize buffers), the profiles' static inputs
(uploaded with one non-blocking copy from pinned memory) and their static
outputs (samples, and the prefill chunks' (prefill_rows, V) logits, which
the first-token sample reads).  With
``debug_guards`` the step runs under ``torch.cuda.set_sync_debug_mode(
"error")`` (the engine's one device->host copy per dispatch exempt), a
profile captured twice raises, and the paged layout's allocator is audited
after every step.
"""

from __future__ import annotations

import contextlib
import itertools
import time
from collections import deque
from dataclasses import dataclass, field, fields

import numpy as np
import torch

from ..device import resolve_device
from ..models.attention import (AttnCache, PackedSegs, PagedAttnCache,
                                kv_tensors, paged_insert_rows)
from ..models.model import Model
from .paging import PageAllocator
from .prefix_cache import PrefixCache
from .sampling import SamplingConfig, sample_slots
from .sharded import (collective_stats, make_engine_mesh, shard_model,
                      validate_engine_sharding)
from .speculative import PackedSpeculator
from .step_graph import Staged, StepGraph, sync_mode


@dataclass
class Request:
    prompt: list[int]
    max_new_tokens: int = 32
    eos_id: int | None = None
    sampling: SamplingConfig = field(default_factory=SamplingConfig)
    rid: int = -1
    tenant: str | None = None
    template_id: str | None = None
    # filled by the engine:
    output: list[int] = field(default_factory=list)
    state: str = "queued"  # queued | prefill | decode | done
    slot: int = -1
    n_cached: int = 0  # prompt tokens served from shared prefix-cache pages
    ttft_steps: int = 0
    tpot_steps: int = 0
    submit_t: float = 0.0  # wall-clock timestamps (perf_counter)
    first_token_t: float = 0.0
    finish_t: float = 0.0

    @property
    def ttft_s(self) -> float:
        return max(self.first_token_t - self.submit_t, 0.0)

    @property
    def tpot_s(self) -> float:
        n = len(self.output) - 1
        if n <= 0 or self.finish_t <= self.first_token_t:
            return 0.0
        return (self.finish_t - self.first_token_t) / n


@dataclass(frozen=True)
class EngineConfig:
    """The reference's fields and defaults.  The port serves the unified
    paged engine and the two-dispatch engine in both layouts; the other
    modes are refused by name (see :class:`ServeEngine`)."""
    max_slots: int = 8
    max_seq: int = 512
    chunk_size: int = 128
    decode_priority: bool = True
    prefill_rows: int = 2
    record_step_log: bool = False
    cache_layout: str = "dense"
    page_size: int = 16
    n_pages: int | None = None
    unified: bool = False
    prefix_cache: bool = False
    debug_guards: bool = False
    tp: int = 1
    pp: int = 1
    n_spec: int = 0


@dataclass
class EngineMetrics:
    """Wall-clock + step-level serving metrics (the reference's names)."""

    decode_steps: int = 0
    prefill_calls: int = 0
    prefill_tokens: int = 0
    generated_tokens: int = 0
    dispatches: int = 0  # forward + sample per step
    transfers_d2h: int = 0  # sampled-token copies to the host
    start_t: float = 0.0
    end_t: float = 0.0
    occupancy_sum: float = 0.0
    steps: int = 0
    step_log: list = field(default_factory=list)
    peak_active: int = 0
    peak_inflight: int = 0
    kv_util_sum: float = 0.0
    kv_used_tokens_peak: int = 0
    preemptions: int = 0
    capacity_stops: int = 0
    pages_in_use_peak: int = 0
    # -- P/D disaggregation counters (zero outside a DisaggCluster) ----------
    exports: int = 0  # prefill completions handed off to a decode pool
    imports: int = 0  # migrated requests installed into a decode slot
    # -- mesh-sharded counters (zero at tp=pp=1) ------------------------------
    collectives: int = 0  # all-reduce/send/broadcast/all_gather per rank
    collective_bytes: int = 0  # estimated all-reduce/ring bytes moved
    # -- prefix-cache counters (mirrors of PrefixCacheStats + engine-side) --
    prefix_lookups: int = 0
    prefix_hits: int = 0  # admissions whose source matched >= 1 cached page
    prefix_lookup_tokens: int = 0
    prefix_hit_tokens: int = 0  # tokens matched at admission
    prefix_cached_tokens: int = 0  # prefill tokens actually skipped
    prefix_cow_forks: int = 0  # full-hit tail pages forked copy-on-write
    prefix_inserted_pages: int = 0
    prefix_evicted_pages: int = 0
    prefix_shared_pages_peak: int = 0  # peak pages mapped by > 1 holder
    #: tenant -> [hit_tokens, lookup_tokens] (per-tenant hit attribution)
    prefix_by_tenant: dict = field(default_factory=dict)
    # -- speculative-decoding counters (zero unless n_spec > 0) --------------
    spec_rounds: int = 0  # engine steps that ran a draft/verify round
    spec_slot_rounds: int = 0  # per-slot verify windows executed
    spec_proposed: int = 0  # draft tokens offered for verification
    spec_accepted: int = 0  # draft tokens the target accepted
    spec_bonus: int = 0  # fully-accepted windows (earned a bonus token)
    spec_emitted: int = 0  # tokens committed by speculative rounds
    #: slot -> [accepted, proposed] (per-slot acceptance attribution)
    spec_by_slot: dict = field(default_factory=dict)

    @property
    def prefix_hit_rate(self) -> float:
        """Token-weighted admission-time hit rate."""
        return (self.prefix_hit_tokens / self.prefix_lookup_tokens
                if self.prefix_lookup_tokens else 0.0)

    @property
    def spec_acceptance_rate(self) -> float:
        """Fraction of offered draft tokens the target accepted."""
        return (self.spec_accepted / self.spec_proposed
                if self.spec_proposed else 0.0)

    @property
    def spec_tokens_per_round(self) -> float:
        """Tokens committed per per-slot verify window (1.0 is the
        non-speculative baseline)."""
        return (self.spec_emitted / self.spec_slot_rounds
                if self.spec_slot_rounds else 0.0)

    @property
    def wall_s(self) -> float:
        return max(self.end_t - self.start_t, 0.0)

    @property
    def tokens_per_s(self) -> float:
        return self.generated_tokens / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def mean_occupancy(self) -> float:
        return self.occupancy_sum / self.steps if self.steps else 0.0

    @property
    def mean_kv_utilization(self) -> float:
        return self.kv_util_sum / self.steps if self.steps else 0.0

    def summary(self, requests=None) -> dict:
        out = {
            "steps": self.steps,
            "decode_steps": self.decode_steps,
            "prefill_calls": self.prefill_calls,
            "prefill_tokens": self.prefill_tokens,
            "generated_tokens": self.generated_tokens,
            "dispatches": self.dispatches,
            "transfers_d2h": self.transfers_d2h,
            "dispatches_per_step": (self.dispatches / self.steps
                                    if self.steps else 0.0),
            "transfers_per_step": (self.transfers_d2h / self.steps
                                   if self.steps else 0.0),
            "wall_s": self.wall_s,
            "tokens_per_s": self.tokens_per_s,
            "mean_slot_occupancy": self.mean_occupancy,
            "peak_active": self.peak_active,
            "peak_inflight": self.peak_inflight,
            "kv_utilization_mean": self.mean_kv_utilization,
            "preemptions": self.preemptions,
            "capacity_stops": self.capacity_stops,
            "pages_in_use_peak": self.pages_in_use_peak,
            "kv_used_tokens_peak": self.kv_used_tokens_peak,
        }
        if self.exports or self.imports:  # only under P/D disaggregation
            out["exports"] = self.exports
            out["imports"] = self.imports
        if self.collectives:  # only on a >1-rank mesh
            out["collectives"] = self.collectives
            out["collective_bytes"] = self.collective_bytes
            out["collectives_per_step"] = (self.collectives / self.steps
                                           if self.steps else 0.0)
            out["collective_bytes_per_step"] = (
                self.collective_bytes / self.steps if self.steps else 0.0)
        if self.spec_rounds:  # only with speculative decoding on
            out.update(
                spec_rounds=self.spec_rounds,
                spec_proposed=self.spec_proposed,
                spec_accepted=self.spec_accepted,
                spec_bonus=self.spec_bonus,
                spec_emitted=self.spec_emitted,
                spec_acceptance_rate=self.spec_acceptance_rate,
                spec_tokens_per_round=self.spec_tokens_per_round,
                tokens_per_dispatch=(self.generated_tokens / self.dispatches
                                     if self.dispatches else 0.0),
                spec_by_slot={s: {"accepted": a, "proposed": p,
                                  "acceptance_rate": a / p if p else 0.0}
                              for s, (a, p)
                              in sorted(self.spec_by_slot.items())})
        if self.prefix_lookups:  # keep cache-off summaries unchanged
            out.update(
                prefix_hit_rate=self.prefix_hit_rate,
                prefix_lookups=self.prefix_lookups,
                prefix_hits=self.prefix_hits,
                prefix_hit_tokens=self.prefix_hit_tokens,
                prefix_lookup_tokens=self.prefix_lookup_tokens,
                prefix_cached_tokens=self.prefix_cached_tokens,
                prefix_cow_forks=self.prefix_cow_forks,
                prefix_inserted_pages=self.prefix_inserted_pages,
                prefix_evicted_pages=self.prefix_evicted_pages,
                prefix_shared_pages_peak=self.prefix_shared_pages_peak,
                prefix_by_tenant={t: {"hit_tokens": h, "lookup_tokens": n,
                                      "hit_rate": h / n if n else 0.0}
                                  for t, (h, n)
                                  in sorted(self.prefix_by_tenant.items())})
        done = [r for r in (requests or []) if r.state == "done"]
        if done:
            ttfts = sorted(r.ttft_s for r in done)
            tpots = [r.tpot_s for r in done if r.tpot_s > 0]
            out["requests_done"] = len(done)
            out["ttft_s_mean"] = sum(ttfts) / len(ttfts)
            out["ttft_s_p50"] = ttfts[len(ttfts) // 2]
            out["ttft_s_p95"] = ttfts[min(int(len(ttfts) * 0.95),
                                          len(ttfts) - 1)]
            out["tpot_s_mean"] = (sum(tpots) / len(tpots)) if tpots else 0.0
        return out


def _tensors(layer_cache) -> list[torch.Tensor]:
    """Every tensor of one layer's cache (K/V and, quantized, their scales,
    or a Mamba or RWKV layer's state), each with the batch (or page) axis
    first."""
    return [t for f in fields(layer_cache)
            if (t := getattr(layer_cache, f.name)) is not None]


class ServeEngine:
    """The serving engine.  ``device`` defaults to the card (raises without
    one) and must be where ``model`` lives; ``seed`` seeds the engine's
    generator for stochastic sampling.  ``graphs=False`` runs the captured
    steps eagerly on the same static tensors (the counterpart of
    ``jax.disable_jit``; the CPU always does).  ``draft_model`` (with
    ``n_spec > 0``) proposes the speculative rounds' tokens; it carries its
    weights, lives on the engine's device, and may be ``model`` itself (a
    self-draft, with its own mirrored KV pool).  With ``tp * pp > 1``
    every rank of a process group of that size builds the engine, on the
    full ``model`` (cut to the rank's shard here) or on the rank's shard
    (``build_model(..., shard=make_engine_mesh(tp, pp, device).shard)``);
    a card engine over gloo needs ``graphs=False`` (gloo's collectives
    cannot be captured)."""

    def __init__(self, model: Model, config: EngineConfig, *,
                 device: str | torch.device | None = None, seed: int = 0,
                 graphs: bool = True, draft_model: Model | None = None):
        if config.max_slots < 1:
            raise ValueError("EngineConfig.max_slots must be >= 1")
        if config.prefill_rows < 1:
            raise ValueError("EngineConfig.prefill_rows must be >= 1")
        if config.chunk_size < 1:
            raise ValueError("EngineConfig.chunk_size must be >= 1")
        if config.cache_layout not in ("dense", "paged"):
            raise ValueError(f"unknown cache_layout {config.cache_layout!r}")
        if config.n_spec < 0:
            raise ValueError("EngineConfig.n_spec must be >= 0")
        if config.unified and config.cache_layout != "paged":
            raise ValueError(
                "unified=True needs cache_layout='paged': the packed step "
                "writes prefill K/V directly into KV pages")
        spec = model.spec
        if config.unified and any(k == "ssm" for k in spec.layer_kinds()):
            raise ValueError(
                "unified=True supports attention-only stacks; "
                f"{spec.name!r} has SSM layers whose sequential state has "
                "no packed-segment forward")
        if config.prefix_cache and not config.unified:
            raise ValueError(
                "prefix_cache=True requires unified=True: shared pages are "
                "read in place by the packed step's ragged attention; the "
                "dense-scratch prefill path cannot map them")
        if config.n_spec:
            if not config.unified:
                raise ValueError(
                    "n_spec > 0 requires unified=True: speculative verify "
                    "segments ride the packed ragged dispatch")
            if draft_model is None:
                raise ValueError(
                    "n_spec > 0 needs draft_model: the draft proposes the K "
                    "tokens the target verifies")
        elif draft_model is not None:
            raise ValueError(
                "draft_model given but n_spec == 0: set EngineConfig."
                "n_spec=K to enable speculative decoding")
        validate_engine_sharding(model.full_spec, config)
        self.unified = config.unified
        self.paged = config.cache_layout == "paged"
        if spec.attn.kind == "swa" and self.unified:
            raise NotImplementedError(
                f"sliding-window attention ({spec.name!r}): the unified "
                "step has no sliding-window masking, as in the reference; "
                "serve it with cache_layout='dense'")
        if spec.attn.kind == "swa" and self.paged and not model.kv_quant:
            raise NotImplementedError(
                f"sliding-window attention ({spec.name!r}) in the paged "
                "two-dispatch decode (ROADMAP: section 3, the reference's "
                "kernel and gather routes disagree there); serve it with "
                "cache_layout='dense' or the int8 KV cache (kv_quant)")
        if self.paged and config.max_seq % config.page_size:
            raise ValueError("paged layout needs max_seq to be a multiple "
                             "of page_size")
        self.device = resolve_device(device)
        for what, m in (("model", model), ("draft_model", draft_model)):
            if m is not None and m.device != self.device:
                raise ValueError(f"{what} lives on {m.device}, engine on "
                                 f"{self.device}")
        # -- mesh-sharded serving (tp/pp > 1): this rank's shard of the
        # weights (its pools follow from its spec below) and the per-profile
        # collective counts, static functions of the packed geometry
        self.tp, self.pp = config.tp, config.pp
        self.mesh = None
        self._coll_mixed = self._coll_decode = (0, 0)
        if self.tp * self.pp > 1:
            model = self._shard(model)
            self.mesh = model.shard.comm
            if graphs and self.device.type == "cuda" \
                    and self.mesh.backend == "gloo":
                raise ValueError(
                    "graphs=True with a gloo process group: gloo's "
                    "collectives cannot be captured in a CUDA graph; pass "
                    "graphs=False (or use nccl, one card per rank)")
        self.model = model
        self.cfg = config
        self.debug_guards = config.debug_guards
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._ids = itertools.count()
        self.queue: deque[Request] = deque()
        self.active: dict[int, Request] = {}  # slot -> request
        self.free_slots = list(range(config.max_slots))
        self.finished: list[Request] = []
        # P/D disaggregation hook (set after construction by DisaggCluster):
        # called as export_fn(req, src_len, done, now) when a prefill
        # completes, instead of promoting it into a local decode slot.  The
        # request's pages stay owned by its rid until the migration channel
        # releases them after the cross-pool copy.
        self.export_fn = None
        self.steps = 0
        self.metrics = EngineMetrics()

        self.max_pages = config.max_seq // config.page_size
        self.pager: PageAllocator | None = None
        self._ptab = None  # host mirror of the slot page table
        self._ptab_dirty = False
        if self.paged:
            n_pages = config.n_pages
            if n_pages is None:  # capacity-equivalent to dense (+ null page)
                n_pages = config.max_slots * self.max_pages + 1
            self.pager = PageAllocator(n_pages=n_pages,
                                       page_size=config.page_size)
            self._ptab = np.zeros((config.max_slots, self.max_pages),
                                  np.int32)
            self.cache = model.init_cache(config.max_slots, config.max_seq,
                                          layout="paged",
                                          page_size=config.page_size,
                                          n_pages=n_pages)
        else:
            self.cache = model.init_cache(config.max_slots, config.max_seq,
                                          layout="dense")
        # radix-tree prefix cache: shares pages across requests through the
        # refcounted allocator; `_attached` tracks which queued/admitted
        # rids already hold their shared-prefix references
        self.prefix = PrefixCache(self.pager) if config.prefix_cache \
            else None
        self._attached: set[int] = set()
        # speculative decoding: the draft's page-id-mirrored pool (the slot
        # page-table rows address both), its host frontier and the round
        self.speculator = None if not config.n_spec else PackedSpeculator(
            model, draft_model, n_spec=config.n_spec,
            max_slots=config.max_slots, max_seq=config.max_seq,
            chunk_size=config.chunk_size, prefill_rows=config.prefill_rows,
            page_size=config.page_size, n_pages=self.pager.n_pages)
        # two-dispatch prefill runs on dense scratch rows (the unified step
        # writes prefill K/V straight into pages and has none)
        self.scratch = None if self.unified else model.init_cache(
            config.prefill_rows, config.max_seq, layout="dense")
        # prefill bookkeeping: prefill row -> in-flight request / position
        self._prefills: dict[int, Request] = {}
        self._prefill_pos: dict[int, int] = {}
        self._free_rows = list(range(config.prefill_rows))

        # fixed packed layout: decode slot s's token at offset s, prefill
        # row r's chunk at max_slots + r * chunk_size
        self.n_segs = config.max_slots + config.prefill_rows
        self.t_pack = config.max_slots + config.prefill_rows \
            * config.chunk_size
        if self.mesh is not None:
            nbytes = model.dtype.itemsize
            self._coll_mixed = collective_stats(
                model.full_spec, self.tp, self.pp, self.t_pack, self.n_segs,
                nbytes)
            self._coll_decode = collective_stats(
                model.full_spec, self.tp, self.pp, config.max_slots,
                config.max_slots, nbytes)
        seg_start = np.concatenate([
            np.arange(config.max_slots, dtype=np.int32),
            config.max_slots + np.arange(config.prefill_rows, dtype=np.int32)
            * config.chunk_size])
        # the layouts are static: keep their device copies resident
        self._seg_start_dev = self._up(seg_start)
        self._seg_start_decode_dev = self._up(seg_start[:config.max_slots])

        # host mirrors: next-token feed, per-slot sampling params, lengths
        self._tokens = np.zeros((config.max_slots, 1), np.int32)
        self._temps = np.zeros((config.max_slots,), np.float32)
        self._topks = np.zeros((config.max_slots,), np.int32)
        self._topps = np.ones((config.max_slots,), np.float32)
        self._lengths = np.zeros((config.max_slots,), np.int64)
        # two-dispatch: the decode profile's feed and sampling parameters
        # change on the host only on slot churn; between churns the feed is
        # the previous decode's samples, which the step writes on the device
        self._feed_stale = True

        # the static-shape steps, one profile per key
        self._graphs = StepGraph(self.device, self.generator, graphs=graphs)
        nslots, mp = config.max_slots, self.max_pages
        i32, f32 = torch.int32, torch.float32
        if self.speculator is not None:
            for key, mixed in (("spec/mixed", True), ("spec/decode", False)):
                inputs = Staged(self.speculator.staged_fields(mixed),
                                self.device)
                self._graphs.add(key, inputs, self.speculator.n_out(mixed),
                                 self.speculator.step_fn(
                                     self.cache, inputs.dev, self.generator,
                                     mixed=mixed))
        elif self.unified:
            for key, t, s, max_q, n_dec, starts in (
                    ("unified/mixed", self.t_pack, self.n_segs,
                     config.chunk_size, nslots, self._seg_start_dev),
                    ("unified/decode", nslots, nslots, 1, 0,
                     self._seg_start_decode_dev)):
                inputs = Staged({
                    "tokens": ((t,), i32), "positions": ((t,), i32),
                    "q_len": ((s,), i32), "kv_len": ((s,), i32),
                    "seg_ptab": ((s, mp), i32), "temps": ((s,), f32),
                    "topks": ((s,), i32), "topps": ((s,), f32)},
                    self.device)
                self._graphs.add(key, inputs, s, self._unified_fn(
                    inputs.dev, starts, max_q=max_q, n_decode=n_dec))
        else:
            inputs = Staged({"feed": ((nslots, 1), i32),
                             "temps": ((nslots,), f32),
                             "topks": ((nslots,), i32),
                             "topps": ((nslots,), f32)}, self.device)
            self._decode_key = f"decode/{config.cache_layout}"
            self._graphs.add(self._decode_key, inputs, nslots,
                             self._decode_fn(inputs.dev))
            self._add_two_dispatch_profiles()

    def _shard(self, model: Model) -> Model:
        """The rank's shard: ``model`` itself when it is one of this
        (tp, pp) mesh, else cut from the full ``model`` over a new mesh of
        the default process group."""
        if model.shard is None:
            return shard_model(model, make_engine_mesh(self.tp, self.pp,
                                                       self.device))
        if (model.shard.tp, model.shard.pp) != (self.tp, self.pp) \
                or model.shard.comm is None:
            raise ValueError(
                f"model is a tp={model.shard.tp} pp={model.shard.pp} shard "
                f"without the engine's tp={self.tp} pp={self.pp} mesh")
        return model

    def _up(self, x: np.ndarray) -> torch.Tensor:
        """Host -> device copy of an eager step's input (always a copy: the
        host mirrors keep changing after the upload); on the card from
        pinned memory, non-blocking, so that it never synchronises."""
        if self.device.type == "cuda":
            return torch.from_numpy(np.ascontiguousarray(x)).pin_memory().to(
                self.device, non_blocking=True)
        return torch.tensor(x)

    def _pull(self, sampled: torch.Tensor) -> np.ndarray:
        """The dispatch's one device->host copy: its sampled tokens.  The
        debug guard exempts it, as the reference's transfer guard exempts
        its explicit ``device_get``."""
        with sync_mode(self.device, 0):
            return sampled.to("cpu", copy=True).numpy()

    # -- debug guards -----------------------------------------------------
    def _step_guard(self):
        """With ``debug_guards`` on a card engine, the step runs under
        ``torch.cuda.set_sync_debug_mode("error")``: any synchronising call
        (a ``.item()``, a pageable upload, a blocking copy) raises, except
        :meth:`_pull` and a capture's own synchronisation.  A no-op on the
        CPU."""
        if self.debug_guards:
            return sync_mode(self.device, "error")
        return contextlib.nullcontext()

    # -- public API -------------------------------------------------------
    def submit(self, req: Request) -> int:
        req.rid = next(self._ids)
        if self.paged:
            need = self.pager.pages_for(len(req.prompt) + 1)
            limit = min(self.max_pages, self.pager.usable_pages)
            if need > limit:
                cap = limit * self.cfg.page_size
                raise ValueError(
                    f"request {req.rid}: prompt of {len(req.prompt)} tokens "
                    f"needs {need} KV pages but per-request capacity is "
                    f"{limit} pages = {cap} tokens (max_pages="
                    f"{self.max_pages} x page_size={self.cfg.page_size}, "
                    f"usable pool={self.pager.usable_pages})")
        if self.prefix is not None:
            # submit-time lookup: a read-only peek recorded in the cache's
            # own stats (what was cached at arrival); the engine counts its
            # hits at admission, where shared pages are actually mapped
            self.prefix.lookup(req.prompt)
        req.state = "queued"
        req.submit_t = time.perf_counter()
        self.queue.append(req)
        return req.rid

    @staticmethod
    def _src(req: Request) -> list[int]:
        """Prefill token source: prompt + everything generated so far for
        a request resuming after preemption."""
        return req.prompt + req.output if req.output else req.prompt

    # -- scheduling -------------------------------------------------------
    def _admit(self) -> None:
        """Every free prefill row takes a queued prompt, as long as a decode
        slot is guaranteed at completion and, in the paged layout, the pool
        has pages for the prompt plus one token of headroom (reserved up
        front).  A two-dispatch row is zeroed for its new prompt.  An
        exporting engine (P/D disaggregation) never promotes into a local
        decode slot, so the slot guarantee is waived and admission is
        bounded by prefill rows and pool pages alone."""
        while (self.queue and self._free_rows
               and (self.export_fn is not None
                    or len(self.active) + len(self._prefills)
                    < self.cfg.max_slots)):
            req = self.queue[0]
            if self.paged:
                if self.prefix is not None and req.rid not in self._attached:
                    self._prefix_attach(req)
                if not self._ensure_or_evict(req.rid,
                                             len(self._src(req)) + 1):
                    break  # pool dry: wait for frees (decode keeps running)
            self.queue.popleft()
            row = self._free_rows.pop()
            self._prefills[row] = req
            self._prefill_pos[row] = req.n_cached
            req.state = "prefill"
            if not self.unified:
                self._stage_and_run("reset", row=row)
                self.metrics.dispatches += 1

    # -- prefix cache -----------------------------------------------------
    def _prefix_attach(self, req: Request) -> None:
        """Map the longest cached page-prefix of the request's source tokens
        read-only into its page list (one refcount per page, charged nothing
        else).  On a full hit the tail page would be written by the
        recomputed last token (its logits are needed to sample), so that
        page is forked copy-on-write: a fresh page, charged to the request,
        gets a device copy of the shared one and replaces it in the
        request's list; the shared original is never written."""
        src = self._src(req)
        self._attached.add(req.rid)
        pages = self.prefix.acquire(req.rid, src)
        n_cached = len(pages) * self.cfg.page_size
        m = self.metrics
        m.prefix_lookups += 1
        m.prefix_hits += bool(pages)
        m.prefix_lookup_tokens += len(src)
        m.prefix_hit_tokens += min(n_cached, len(src))
        tally = m.prefix_by_tenant.setdefault(req.tenant or "-", [0, 0])
        tally[0] += min(n_cached, len(src))
        tally[1] += len(src)
        if pages and n_cached >= len(src):
            shared_tail = pages[-1]
            self.pager.release_one(req.rid, shared_tail)
            if self.pager.ensure(req.rid, n_cached):  # one fresh fork page
                self._copy_page(shared_tail, self.pager.owned(req.rid)[-1])
                m.dispatches += 1
                m.prefix_cow_forks += 1
                n_cached = len(src) - 1
            else:  # pool too tight to fork: cache one page less instead
                n_cached -= self.cfg.page_size
        req.n_cached = min(n_cached, max(len(src) - 1, 0))
        m.prefix_cached_tokens += req.n_cached

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy-on-write fork: page ``src`` into page ``dst`` in every
        layer's pools (page axis first), and in the draft's mirrored pools
        when speculating.  Python-int ids: an eager device-to-device copy
        on the current stream, which orders it before the next step's reads
        and never synchronises."""
        drafts = [self.speculator.d_cache] if self.speculator else []
        for cache in (self.cache, *drafts):
            for layer in cache.layers:
                for t in _tensors(layer):
                    t[dst].copy_(t[src])

    def _prefix_insert(self, req: Request, processed: int) -> None:
        """Register every full page of the request's ``processed`` tokens in
        the radix tree (pages matched at attach time are already there:
        first writer wins).  Called on prefill completion and again when
        the request leaves its slot (finish or preemption), so decoded turns
        become hittable history for multi-turn continuations."""
        ps = self.cfg.page_size
        n_full = (processed // ps) * ps
        if n_full:
            self.metrics.prefix_inserted_pages += self.prefix.insert(
                self._src(req)[:n_full], self.pager.owned(req.rid))

    def _ensure_or_evict(self, rid: int, n_tokens: int) -> bool:
        """``pager.ensure`` that evicts cold prefix-cache entries (LRU
        refcount-1 leaves) before reporting shortage: clean frees beat
        preempting a live request."""
        if self.pager.ensure(rid, n_tokens):
            return True
        if self.prefix is not None:
            short = (self.pager.pages_for(n_tokens)
                     - len(self.pager.owned(rid)) - self.pager.free_pages)
            if short > 0:
                freed = self.prefix.evict(short)
                self.metrics.prefix_evicted_pages += freed
                if freed >= short:
                    return self.pager.ensure(rid, n_tokens)
        return False

    def _ptab_row(self, rid: int) -> np.ndarray:
        """One (max_pages,) page-table row of ``rid``'s pages, in token
        order, null-page-0 padded."""
        row = np.zeros((self.max_pages,), np.int32)
        held = self.pager.owned(rid)
        row[:len(held)] = held
        return row

    # -- P/D import hooks (decode side of a DisaggCluster) ----------------
    def reserve_imported(self, rid: int, n_tokens: int) -> bool:
        """Reserve admission for a request whose KV pages arrive from
        another engine's pool: allocate pages for ``n_tokens`` under ``rid``
        (evicting cold prefix entries if needed) and report whether a decode
        slot is free to install into.  Pure reservation:
        :meth:`install_imported` completes the hand-off after the
        cross-pool page copy."""
        if not self.paged:
            raise ValueError(
                "imported-page installs need cache_layout='paged'")
        if self.speculator is not None:
            raise ValueError(
                "speculative decoding (n_spec > 0) cannot accept imported "
                "pages: the migration channel fills only the target pool, "
                "so the mirrored draft pool would read garbage")
        if not self.free_slots:
            return False
        return self._ensure_or_evict(rid, n_tokens)

    def install_imported(self, req: Request, kv_len: int) -> int:
        """Install a migrated request into a decode slot.  Its pages,
        already filled under ``req.rid`` by the cross-pool copy, become the
        slot's page-table row, and decode resumes from the request's last
        sampled token.  Host bookkeeping, plus (two-dispatch) the slot's
        length written into the cache's own lengths tensor in place, on the
        current stream: the captured decode reads it there."""
        if not req.output:
            raise ValueError(f"request {req.rid}: importing with no "
                             "sampled first token (nothing to decode from)")
        slot = self.free_slots.pop()
        req.slot = slot
        req.state = "decode"
        self.active[slot] = req
        self._ptab[slot] = self._ptab_row(req.rid)
        self._ptab_dirty = True
        self._lengths[slot] = kv_len
        if not self.unified:
            # the two-dispatch decode reads its write position from the
            # device-side lengths (the unified step packs the host lengths
            # every step); a fill on the current stream, never a sync
            self.cache.lengths.narrow(0, slot, 1).fill_(kv_len)
        self._tokens[slot, 0] = req.output[-1]
        self._temps[slot] = req.sampling.temperature
        self._topks[slot] = req.sampling.top_k
        self._topps[slot] = req.sampling.top_p
        self._feed_stale = True  # slot churn
        self.metrics.imports += 1
        return slot

    def _release_slot(self, slot: int, req: Request) -> None:
        """Free-on-finish: the slot and (paged) every page the request
        holds; the slot's table row falls back to the null page, so the
        now idle decode row writes somewhere harmless."""
        self.free_slots.append(slot)
        if self.paged:
            if self.prefix is not None:
                # full pages of what the request processed stay hittable
                # (multi-turn history, cheap resumption after preemption):
                # the cache's refcounts keep them alive past the release
                self._prefix_insert(req, int(self._lengths[slot]))
                self._attached.discard(req.rid)
            self.pager.release(req.rid)
            self._ptab[slot] = 0
            self._ptab_dirty = True
        if self.speculator is not None:
            self.speculator.release_slot(slot)

    def _preempt(self, slot: int) -> None:
        """Push an active request back to the queue head and free its
        pages; on re-admission its prompt + generated tokens re-prefill."""
        req = self.active.pop(slot)
        self._release_slot(slot, req)
        req.state = "queued"
        req.slot = -1
        self.queue.appendleft(req)
        self.metrics.preemptions += 1

    def _grow_pages(self) -> None:
        """Allocate-on-append: every active slot needs a page for the
        position this step writes.  When the pool runs dry, evict the
        youngest other active request and retry; with no victim left the
        request preempts itself, or is force-finished if its context can
        never fit the pool."""
        for slot in sorted(self.active, key=lambda s: self.active[s].rid):
            req = self.active.get(slot)
            if req is None:
                continue
            need = int(self._lengths[slot]) + 1
            if self.speculator is not None:
                # a verify window writes up to K positions past the
                # committed frontier: reserve the whole window up front so
                # rejected proposals never allocate mid-round
                need = min(need + self.speculator.k, self.cfg.max_seq)
            while not self._ensure_or_evict(req.rid, need):
                victims = [s for s, r in self.active.items()
                           if r.rid != req.rid]
                if not victims:
                    if self.pager.pages_for(need) > self.pager.usable_pages:
                        req.state = "done"
                        req.finish_t = time.perf_counter()
                        del self.active[slot]
                        self._release_slot(slot, req)
                        self.finished.append(req)
                        self.metrics.capacity_stops += 1
                    else:
                        self._preempt(slot)
                    break
                self._preempt(max(victims, key=lambda s: self.active[s].rid))
            else:
                held = len(self.pager.owned(req.rid))
                if held != int(np.count_nonzero(self._ptab[slot])):
                    self._ptab[slot] = self._ptab_row(req.rid)
                    self._ptab_dirty = True

    def _finish_decode_slots(self, toks: np.ndarray, now: float) -> None:
        """Append each active slot's sampled token, advance lengths, exit
        on max_new / eos / max_seq, free on finish."""
        for slot, req in list(self.active.items()):
            tok = int(toks[slot])
            req.output.append(tok)
            req.tpot_steps += 1
            self._lengths[slot] += 1
            self.metrics.generated_tokens += 1
            done = (len(req.output) >= req.max_new_tokens
                    or (req.eos_id is not None and tok == req.eos_id)
                    or self._lengths[slot] >= self.cfg.max_seq - 1)
            if done:
                req.state = "done"
                req.finish_t = now
                del self.active[slot]
                self._release_slot(slot, req)
                self.finished.append(req)
            else:
                self._tokens[slot, 0] = tok

    def _promote_prefill(self, row: int, tok: int, now: float,
                         install) -> None:
        """Record the first token and move the request from its prefill row
        into a decode slot.  ``install(req, slot, row)`` puts the request's
        KV where the slot will read it (a device insert on the two-dispatch
        path; a host page-table row on the unified path, whose pages
        already hold it).  An exporting engine hands the request to its
        ``export_fn`` instead."""
        req = self._prefills.pop(row)
        del self._prefill_pos[row]
        src_len = len(self._src(req))
        if not req.output:  # resumed requests keep their original TTFT
            req.ttft_steps = self.steps
            req.first_token_t = now
        req.output.append(tok)
        self.metrics.generated_tokens += 1
        if self.export_fn is not None:
            # P/D hand-off: the request leaves this engine at prefill
            # completion.  Its pages stay owned by its rid (the migration
            # channel copies them out and releases them); the prefill row
            # frees at once so that the next prompt can start.
            if not self.unified:
                raise ValueError(
                    "export_fn needs unified=True: only the packed step "
                    "writes prefill K/V directly into pages — the dense-"
                    "scratch path has nothing page-resident to migrate")
            self._free_rows.append(row)
            if self.prefix is not None:
                self._prefix_insert(req, src_len)
                self._attached.discard(req.rid)
            self.metrics.exports += 1
            done = (len(req.output) >= req.max_new_tokens
                    or (req.eos_id is not None and tok == req.eos_id))
            self.export_fn(req, src_len, done, now)
            return
        slot = self.free_slots.pop()
        req.slot = slot
        install(req, slot, row)
        self._free_rows.append(row)
        self._lengths[slot] = src_len
        if self.prefix is not None:
            # every full page of the prompt becomes hittable while this
            # request is still decoding
            self._prefix_insert(req, src_len)
        if (len(req.output) >= req.max_new_tokens
                or (req.eos_id is not None and tok == req.eos_id)):
            req.state = "done"
            req.finish_t = now
            self._release_slot(slot, req)
            self.finished.append(req)
            return
        req.state = "decode"
        self.active[slot] = req
        self._tokens[slot, 0] = tok
        self._temps[slot] = req.sampling.temperature
        self._topks[slot] = req.sampling.top_k
        self._topps[slot] = req.sampling.top_p
        self._feed_stale = True  # slot churn

    # -- two-dispatch device work -----------------------------------------
    def _add_two_dispatch_profiles(self) -> None:
        """The row reset, the insert of the engine's layout and the
        first-token sample, each with its staged indices or sampling
        parameters, and the static (prefill_rows, V) logits that every
        prefill chunk writes and the sample reads.  The prefill profiles
        are added per chunk width at first use (:meth:`_prefill_key`)."""
        nrows, i32, f32 = self.cfg.prefill_rows, torch.int32, torch.float32
        self._prefill_logits = torch.zeros(
            (nrows, self.model.spec.vocab), dtype=self.model.dtype,
            device=self.device)
        inputs = Staged({"row": ((1,), i32)}, self.device)
        self._graphs.add("reset", inputs, None, self._reset_fn(inputs.dev))
        fields = {"slot": ((1,), i32), "row": ((1,), i32)}
        if self.paged:
            fields["pages"] = ((self.max_pages,), i32)
        inputs = Staged(fields, self.device)
        self._insert_key = f"insert/{self.cfg.cache_layout}"
        self._graphs.add(self._insert_key, inputs, None,
                         self._insert_fn(inputs.dev))
        inputs = Staged({"temps": ((nrows,), f32), "topks": ((nrows,), i32),
                         "topps": ((nrows,), f32)}, self.device)
        self._graphs.add("sample/first", inputs, nrows,
                         self._sample_first_fn(inputs.dev))

    def _stage_and_run(self, key: str, **values) -> torch.Tensor | None:
        """Write ``values`` into profile ``key``'s staged host views (each
        field whole), upload them and run the profile; returns its static
        output."""
        inputs = self._graphs.profiles[key].inputs
        h = inputs.write()
        for name, value in values.items():
            h[name][...] = value
        inputs.upload()
        return self._graphs.run(key)

    def _reset_fn(self, inp: dict[str, torch.Tensor]):
        """The reset profile's step: zero scratch row ``row`` (claimed by a
        newly admitted prompt): its K/V, or a Mamba or RWKV layer's state,
        and its length."""
        def step() -> None:
            row = inp["row"].long()
            for layer in self.scratch.layers:
                for t in _tensors(layer):
                    t.index_fill_(0, row, 0)
            self.scratch.lengths.index_fill_(0, row, 0)
        return step

    def _prefill_key(self, w: int) -> str:
        """Profile ``prefill/<w>``, registered at the first chunk of width
        ``w``: its staged (prefill_rows, w) tokens and (prefill_rows,) row
        mask; it writes the static logits."""
        key = f"prefill/{w}"
        if key not in self._graphs.profiles:
            inputs = Staged({"tokens": ((self.cfg.prefill_rows, w),
                                        torch.int32),
                             "mask": ((self.cfg.prefill_rows,), torch.int32)},
                            self.device)
            self._graphs.add(key, inputs, self._prefill_logits,
                             self._prefill_fn(inputs.dev))
        return key

    def _prefill_fn(self, inp: dict[str, torch.Tensor]):
        """A prefill profile's step: one batched chunk over all scratch
        rows; only the masked rows advance (the others, idle or mid-prefill
        at another width, keep their K/V and lengths).  Returns the
        (prefill_rows, V) last-position logits."""
        def step() -> torch.Tensor:
            logits, _ = self.model.prefill_chunk(self.scratch, inp["tokens"],
                                                 mask=inp["mask"] != 0)
            return logits
        return step

    def _insert_fn(self, inp: dict[str, torch.Tensor]):
        """The insert profile's step: copy scratch row ``row`` (K/V or
        Mamba or RWKV state, and length) into decode slot ``slot``.  In the
        paged layout the attention layers' K/V are scattered into the pool
        pages named by ``pages`` instead (paging never applies to state),
        and the slot's page-table row is installed on the device, so the
        table needs no separate upload."""
        def step() -> None:
            slot, row = inp["slot"].long(), inp["row"].long()
            for big, small in zip(self.cache.layers, self.scratch.layers):
                if isinstance(big, PagedAttnCache):
                    paged_insert_rows(big, small, row, inp["pages"])
                    continue
                for b, s in zip(_tensors(big), _tensors(small)):
                    b.index_copy_(0, slot, s.index_select(0, row))
            self.cache.lengths.index_copy_(
                0, slot, self.scratch.lengths.index_select(0, row))
            if self.paged:
                self.cache.page_table.index_copy_(0, slot,
                                                  inp["pages"][None])
        return step

    def _sample_first_fn(self, inp: dict[str, torch.Tensor]):
        """The first-token sample's step: per-row sampling of the static
        prefill logits."""
        def step() -> torch.Tensor:
            return sample_slots(self._prefill_logits, inp["temps"],
                                inp["topks"], inp["topps"], self.generator)
        return step

    def _sync_page_table(self) -> None:
        """Copy the host page table into the cache's one table tensor."""
        if self._ptab_dirty:
            self.cache.page_table.copy_(self._up(self._ptab))
            self._ptab_dirty = False

    # -- two-dispatch prefill ---------------------------------------------
    def _prefill_step(self) -> None:
        """Advance every in-flight prefill by one chunk.  Rows are grouped
        by this step's chunk width (the final chunk runs at its exact
        width, no padding); each group advances in one batched call."""
        if not self._prefills:
            return
        groups: dict[int, list[int]] = {}
        for row in sorted(self._prefills):
            req = self._prefills[row]
            w = min(self.cfg.chunk_size,
                    len(self._src(req)) - self._prefill_pos[row])
            groups.setdefault(w, []).append(row)
        for w in sorted(groups):
            self._prefill_chunk_group(w, groups[w])

    def _prefill_chunk_group(self, w: int, rows: list[int]) -> None:
        """One replay of ``prefill/<w>`` with the group's rows masked in."""
        toks = np.zeros((self.cfg.prefill_rows, w), np.int32)
        mask = np.zeros((self.cfg.prefill_rows,), np.int32)
        for row in rows:
            lo = self._prefill_pos[row]
            toks[row] = self._src(self._prefills[row])[lo:lo + w]
            mask[row] = 1
        self._stage_and_run(self._prefill_key(w), tokens=toks, mask=mask)
        self.metrics.prefill_calls += 1
        self.metrics.prefill_tokens += w * len(rows)
        self.metrics.dispatches += 1
        finishing = []
        for row in rows:
            self._prefill_pos[row] += w
            if self._prefill_pos[row] >= len(self._src(self._prefills[row])):
                finishing.append(row)
        if finishing:
            self._finish_prefills(finishing)

    def _finish_prefills(self, rows: list[int]) -> None:
        """Sample first tokens for the completing prompts from the static
        prefill logits (one replay, one transfer) and move them into decode
        slots."""
        nrows = self.cfg.prefill_rows
        temps = np.zeros((nrows,), np.float32)
        topks = np.zeros((nrows,), np.int32)
        topps = np.ones((nrows,), np.float32)
        for row in rows:
            s = self._prefills[row].sampling
            temps[row] = s.temperature
            topks[row] = s.top_k
            topps[row] = s.top_p
        first = self._pull(self._stage_and_run(
            "sample/first", temps=temps, topks=topks, topps=topps))
        self.metrics.dispatches += 1
        self.metrics.transfers_d2h += 1
        now = time.perf_counter()

        def install(req, slot, row):
            """Device insert: copy the scratch row into the decode cache
            (scattered into the request's pages in the paged layout)."""
            values = dict(slot=slot, row=row)
            if self.paged:
                values["pages"] = self._ptab[slot] = self._ptab_row(req.rid)
            self._stage_and_run(self._insert_key, **values)
            self.metrics.dispatches += 1

        for row in rows:
            # repro-lint: disable=RPL202 — `first` is the host copy above
            self._promote_prefill(row, int(first[row]), now, install)

    # -- two-dispatch decode ----------------------------------------------
    def _decode_fn(self, inp: dict[str, torch.Tensor]):
        """The decode profile's step: every slot's decode (lengths advance
        in the cache's own tensor) and per-slot sampling; the samples are
        written into the feed as the next step's tokens."""
        def step() -> torch.Tensor:
            logits, _ = self.model.decode_step(self.cache, inp["feed"])
            sampled = sample_slots(logits, inp["temps"], inp["topks"],
                                   inp["topps"], self.generator)
            inp["feed"].copy_(sampled[:, None])
            return sampled
        return step

    def _decode_step(self) -> None:
        """All slots: one decode step + per-slot sampling (one replay on the
        card), one device->host copy of the sampled tokens.  The samples
        stay on the device as the next step's feed; only slot churn
        uploads the host mirrors."""
        if not self.active:
            return
        if self.paged:
            self._grow_pages()
            self._sync_page_table()
            if not self.active:
                return
        if self._feed_stale:
            self._feed_stale = False
            toks = self._pull(self._stage_and_run(
                self._decode_key, feed=self._tokens, temps=self._temps,
                topks=self._topks, topps=self._topps))
        else:
            toks = self._pull(self._graphs.run(self._decode_key))
        self.metrics.decode_steps += 1
        self.metrics.dispatches += 1
        self.metrics.transfers_d2h += 1
        self._finish_decode_slots(toks, time.perf_counter())

    # -- unified token-packed step ---------------------------------------
    def _pack_guard(self, req: Request, src_len: int) -> None:
        cap = self.max_pages * self.cfg.page_size
        if src_len + 1 > cap:
            raise ValueError(
                f"request {req.rid}: packing a {src_len}-token context "
                f"exceeds the per-request KV capacity of {cap} tokens "
                f"(max_pages={self.max_pages} x page_size="
                f"{self.cfg.page_size})")

    def _unified_fn(self, inp: dict[str, torch.Tensor],
                    seg_start: torch.Tensor, *, max_q: int, n_decode: int):
        """A packed profile's step: the packed forward (K/V straight to
        pages, slot lengths written in the cache's own tensor) and
        per-segment sampling.  Returns the (S,) sampled tokens."""
        packed = PackedSegs(q_start=seg_start, q_len=inp["q_len"],
                            kv_len=inp["kv_len"], page_table=inp["seg_ptab"],
                            max_q=max_q, n_decode=n_decode)

        def step() -> torch.Tensor:
            logits, _ = self.model.unified_step(self.cache, inp["tokens"],
                                                inp["positions"], packed)
            return sample_slots(logits, inp["temps"], inp["topks"],
                                inp["topps"], self.generator)
        return step

    def _unified_step(self) -> None:
        """One step: all active slots' decode tokens and all in-flight
        prompts' current chunks in the fixed ragged layout, one forward +
        sample (one replay on the card), one device->host copy of the
        sampled tokens."""
        self._grow_pages()
        if not (self.active or self._prefills):
            return
        nslots, csize = self.cfg.max_slots, self.cfg.chunk_size
        key = "unified/mixed" if self._prefills else "unified/decode"
        inputs = self._graphs.profiles[key].inputs
        h = inputs.write()
        for a in h.values():
            a.fill(0)
        h["topps"].fill(1.0)
        h["tokens"][:nslots] = self._tokens[:, 0]
        h["seg_ptab"][:nslots] = self._ptab
        h["temps"][:nslots] = self._temps
        h["topks"][:nslots] = self._topks
        h["topps"][:nslots] = self._topps
        for slot in self.active:
            h["positions"][slot] = self._lengths[slot]
            h["q_len"][slot] = 1
            h["kv_len"][slot] = self._lengths[slot] + 1
        widths: dict[int, int] = {}
        for row, req in self._prefills.items():
            src = self._src(req)
            self._pack_guard(req, len(src))
            lo = self._prefill_pos[row]
            w = min(csize, len(src) - lo)
            seg, qs = nslots + row, nslots + row * csize
            h["tokens"][qs:qs + w] = src[lo:lo + w]
            h["positions"][qs:qs + w] = np.arange(lo, lo + w)
            h["q_len"][seg] = w
            h["kv_len"][seg] = lo + w
            h["seg_ptab"][seg] = self._ptab_row(req.rid)
            widths[row] = w
            if lo + w >= len(src):  # completes: sample with its config
                s = req.sampling
                h["temps"][seg] = s.temperature
                h["topks"][seg] = s.top_k
                h["topps"][seg] = s.top_p
        inputs.upload()
        # the step's only device->host copy: the (S,) sampled tokens
        toks = self._pull(self._graphs.run(key))
        self.metrics.dispatches += 1
        self.metrics.transfers_d2h += 1
        coll, coll_bytes = (self._coll_mixed if key == "unified/mixed"
                            else self._coll_decode)
        self.metrics.collectives += coll
        self.metrics.collective_bytes += coll_bytes
        now = time.perf_counter()
        if self.active:
            self.metrics.decode_steps += 1
        self._finish_decode_slots(toks, now)

        def install(req, slot, row):
            """The pages already hold the prompt's KV: "inserting" into a
            decode slot is host bookkeeping."""
            self._ptab[slot] = self._ptab_row(req.rid)

        self._advance_prefills(widths, toks[nslots:], now, install)

    def _advance_prefills(self, widths: dict[int, int], first: np.ndarray,
                          now: float, install) -> None:
        """After a packed step: count the prefill chunks, advance every
        in-flight prompt by its chunk ``widths[row]`` and promote the rows
        whose prompt completed, with ``first[row]`` as the first token."""
        if widths:
            self.metrics.prefill_calls += 1
            self.metrics.prefill_tokens += sum(widths.values())
        finishing = [row for row, w in widths.items()
                     if self._prefill_pos[row] + w
                     >= len(self._src(self._prefills[row]))]
        for row, w in widths.items():
            self._prefill_pos[row] += w
        for row in finishing:
            self._promote_prefill(row, int(first[row]), now, install)

    # -- speculative token-packed step -------------------------------------
    def _spec_step(self) -> None:
        """The unified step with speculation: every active slot packs a
        K+1-token verify window (committed feed + the draft's K proposals);
        the draft catch-up, the K-1 proposal sub-steps, the target verify,
        device-side accept/reject and the prefill chunks are one profile
        run (one replay on the card), and the accepted tokens, per-slot
        counts and first tokens come back in the step's one device->host
        copy.  Rollback of rejected tokens is length bookkeeping on the
        host mirrors and, inside the round, on both caches' lengths."""
        self._grow_pages()
        if not (self.active or self._prefills):
            return
        spec = self.speculator
        nslots, csize = self.cfg.max_slots, self.cfg.chunk_size
        key = "spec/mixed" if self._prefills else "spec/decode"
        inputs = self._graphs.profiles[key].inputs
        h = inputs.write()
        for a in h.values():
            a.fill(0)
        h["topps"].fill(1.0)
        h["temps"][:nslots] = self._temps
        h["topks"][:nslots] = self._topks
        h["topps"][:nslots] = self._topps
        h["ptab"][:] = self._ptab
        for slot, req in self.active.items():
            src = self._src(req)
            sl = int(self._lengths[slot])
            g, tail = spec.catch_up(slot, src)
            if not 1 <= g <= 2:  # the draft frontier invariant
                raise AssertionError(
                    f"slot {slot}: draft gap {g} outside {{1, 2}} "
                    f"(d_len={int(spec.d_lens[slot])}, len={sl})")
            h["feed"][slot] = src[-1]
            h["d_feed"][slot, :g] = tail
            h["lengths"][slot] = sl
            h["gaps"][slot] = g
            h["widths"][slot] = min(spec.k + 1, self.cfg.max_seq - sl)
        win = h["widths"].copy()
        widths: dict[int, int] = {}
        for row, req in self._prefills.items():
            src = self._src(req)
            self._pack_guard(req, len(src))
            lo = self._prefill_pos[row]
            w = min(csize, len(src) - lo)
            qs = row * csize
            h["pre_tokens"][qs:qs + w] = src[lo:lo + w]
            h["pre_positions"][qs:qs + w] = np.arange(lo, lo + w)
            h["pre_q_len"][row] = w
            h["pre_kv_len"][row] = lo + w
            h["pre_ptab"][row] = self._ptab_row(req.rid)
            widths[row] = w
            if lo + w >= len(src):  # completes: sample with its config
                s = req.sampling
                h["temps"][nslots + row] = s.temperature
                h["topks"][nslots + row] = s.top_k
                h["topps"][nslots + row] = s.top_p
        inputs.upload()
        # the step's only device->host copy: accepted tokens, per-slot
        # counts and (mixed) the completing prefills' first tokens
        out_toks, n_emit, pre_sampled = spec.split(
            self._pull(self._graphs.run(key)))
        self.metrics.dispatches += 1
        self.metrics.transfers_d2h += 1
        now = time.perf_counter()
        if self.active:
            self.metrics.decode_steps += 1
            self.metrics.spec_rounds += 1
        self._finish_spec_slots(out_toks, n_emit, win, now)

        def install(req, slot, row):
            """The pages already hold the prompt's KV in both pools (the
            packed prefill chunks ran through target and draft): promotion
            is host bookkeeping plus seeding the draft frontier."""
            self._ptab[slot] = self._ptab_row(req.rid)
            # _src already includes the just-sampled first token; the
            # pools hold everything before it
            spec.install_slot(slot, len(self._src(req)) - 1)

        self._advance_prefills(widths, pre_sampled, now, install)

    def _finish_spec_slots(self, out_toks: np.ndarray, n_emit: np.ndarray,
                           win: np.ndarray, now: float) -> None:
        """Per-slot commit of a speculative round: append the accepted
        prefix + the resampled/bonus token one at a time under the plain
        decode's stop conditions (max_new / eos / max_seq), so greedy
        outputs truncate as the non-speculative engine's do.  A mid-window
        stop discards the tail and frees the slot; the device's overshoot
        in ``cache.lengths`` dies with the slot."""
        spec = self.speculator
        m = self.metrics
        for slot, req in list(self.active.items()):
            sl = int(self._lengths[slot])
            w = int(win[slot])
            emit = int(n_emit[slot])
            m.spec_slot_rounds += 1
            m.spec_proposed += w - 1
            m.spec_accepted += emit - 1
            m.spec_bonus += emit == w
            m.spec_emitted += emit
            tally = m.spec_by_slot.setdefault(slot, [0, 0])
            tally[0] += emit - 1
            tally[1] += w - 1
            req.tpot_steps += 1
            done = False
            committed = 0
            for j in range(emit):
                tok = int(out_toks[slot, j])
                req.output.append(tok)
                self._lengths[slot] += 1
                committed += 1
                m.generated_tokens += 1
                done = (len(req.output) >= req.max_new_tokens
                        or (req.eos_id is not None and tok == req.eos_id)
                        or self._lengths[slot] >= self.cfg.max_seq - 1)
                if done:
                    break
            spec.commit_slot(slot, sl, committed, spec.proposal_steps(sl))
            if done:
                req.state = "done"
                req.finish_t = now
                del self.active[slot]
                self._release_slot(slot, req)
                self.finished.append(req)
            else:
                self._tokens[slot, 0] = int(out_toks[slot, emit - 1])

    # -- main loop --------------------------------------------------------
    def step(self) -> None:
        if self.metrics.start_t == 0.0:
            self.metrics.start_t = time.perf_counter()
        self.steps += 1
        self.metrics.steps += 1
        # admission is guarded too: a two-dispatch admission resets its
        # scratch row with one replay
        with self._step_guard():
            self._admit()
            if self.speculator is not None:
                self._spec_step()
            elif self.unified:
                self._unified_step()
            elif self.cfg.decode_priority:
                self._decode_step()
                self._prefill_step()
            else:
                self._prefill_step()
                self._decode_step()
        if self.debug_guards and self.paged:
            self.pager.check()  # refcount / free-list invariant audit
            if self.prefix is not None:
                self.prefix.check()
        m = self.metrics
        m.end_t = time.perf_counter()
        m.occupancy_sum += len(self.active) / self.cfg.max_slots
        m.peak_active = max(m.peak_active, len(self.active))
        m.peak_inflight = max(m.peak_inflight,
                              len(self.active) + len(self._prefills))
        # live KV tokens over the reserved capacity, with the same
        # numerator in both layouts
        used = int(sum(self._lengths[s] for s in self.active))
        if self.paged:
            cap_tokens = self.pager.usable_pages * self.cfg.page_size
            m.pages_in_use_peak = max(m.pages_in_use_peak,
                                      self.pager.pages_in_use)
            if self.prefix is not None:
                m.prefix_shared_pages_peak = max(m.prefix_shared_pages_peak,
                                                 self.pager.shared_pages)
        else:
            cap_tokens = self.cfg.max_slots * self.cfg.max_seq
        m.kv_util_sum += used / cap_tokens
        m.kv_used_tokens_peak = max(m.kv_used_tokens_peak, used)
        if self.cfg.record_step_log:
            m.step_log.append((self.steps, len(self.active),
                               len(self._prefills), len(self.queue)))

    def kv_stats(self) -> dict:
        """Static + peak KV-capacity numbers: the decode cache's device
        reservation in bytes and the peak bytes holding live tokens (the
        dense layout's footprint is its reservation).  Attention K/V and,
        quantized, their scales, as the reference counts: Mamba and RWKV
        state is not KV."""
        # a mesh's ranks hold equal shards: the reservation is the mesh's
        # (the reference's global arrays), tp * pp times this rank's
        reserved = self.tp * self.pp * sum(
            t.numel() * t.element_size() for layer in self.cache.layers
            if isinstance(layer, (AttnCache, PagedAttnCache))
            for t in kv_tensors(layer))
        out = {"cache_layout": self.cfg.cache_layout,
               "kv_reserved_bytes": reserved}
        if self.paged:
            per_page = reserved / self.pager.n_pages
            per_token = per_page / self.cfg.page_size
            out.update(
                page_size=self.cfg.page_size,
                n_pages=self.pager.n_pages,
                usable_pages=self.pager.usable_pages,
                kv_peak_bytes=int(self.pager.peak_in_use * per_page),
                kv_live_peak_bytes=int(self.metrics.kv_used_tokens_peak
                                       * per_token),
                pages_in_use=self.pager.pages_in_use)
        else:
            per_token = reserved / (self.cfg.max_slots * self.cfg.max_seq)
            out.update(
                kv_peak_bytes=reserved,  # dense footprint == reservation
                kv_live_peak_bytes=int(self.metrics.kv_used_tokens_peak
                                       * per_token))
        return out

    @property
    def busy(self) -> bool:
        return bool(self.queue or self.active or self._prefills)

    def run(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if not self.busy:
                break
            self.step()

    def serve(self, requests: list[Request],
              max_steps: int = 10_000) -> list[Request]:
        for r in requests:
            self.submit(r)
        self.run(max_steps)
        return requests
