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

An attention-free stack (RWKV-6) serves through the two-dispatch engine
in either layout: its per-slot state is reset, advanced and inserted as
K/V rows are, and the paged layout's page accounting runs unchanged, as
the reference's does.  The unified step refuses it (``ValueError``, as the
reference).

In the paged layout pages are allocated on append and freed on finish;
when the pool runs dry the youngest active request is preempted back to
the queue (recompute-style, so greedy outputs are unchanged).

The scheduler is pure Python over host mirrors (numpy), identical to the
reference's, and ``EngineMetrics.dispatches``/``transfers_d2h`` count
exactly where the reference counts them, so the port's step, preemption
and dispatch counts equal the reference engine's for the same requests.

The steps whose shapes the geometry alone fixes run through
:class:`~repro_torch.serving.step_graph.StepGraph`, as the reference jits
them: the unified engine's two packed profiles and the two-dispatch
decode.  On the card each is one CUDA-graph replay (captured at its first
use), so there a "dispatch" of those steps is one replay; the two-dispatch
prefill chunks (one width each), inserts and row resets stay eager, as
the reference's ``_jit_prefill`` retraces per width.  Every tensor such a
step reads or writes keeps one address for the engine's lifetime: the
engine's one ``ModelCache``, the profiles' static inputs (uploaded with one
non-blocking copy from pinned memory) and their static samples.  With
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
                                paged_insert_rows)
from ..models.model import Model
from .paging import PageAllocator
from .sampling import SamplingConfig, sample_slots
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
    n_cached: int = 0  # prompt tokens served from shared pages (always 0)
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
    """Every tensor of one layer's cache (K/V, or an RWKV layer's state),
    each with the batch (or page) axis first."""
    return [getattr(layer_cache, f.name) for f in fields(layer_cache)]


def _refuse(what: str, item: str) -> None:
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP: queue 1, {item})")


class ServeEngine:
    """The serving engine.  ``device`` defaults to the card (raises without
    one) and must be where ``model`` lives; ``seed`` seeds the engine's
    generator for stochastic sampling.  ``graphs=False`` runs the captured
    steps eagerly on the same static tensors (the counterpart of
    ``jax.disable_jit``; the CPU always does)."""

    def __init__(self, model: Model, config: EngineConfig, *,
                 device: str | torch.device | None = None, seed: int = 0,
                 graphs: bool = True):
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
        if config.tp < 1 or config.pp < 1:
            raise ValueError("EngineConfig tp/pp must be >= 1")
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
        if config.prefix_cache:
            _refuse("prefix_cache=True", "item 6")
        if config.n_spec:
            _refuse(f"speculative decoding (n_spec={config.n_spec})",
                    "item 7")
        if config.tp * config.pp > 1:
            _refuse(f"tp={config.tp} pp={config.pp}", "item 12")
        self.unified = config.unified
        self.paged = config.cache_layout == "paged"
        if spec.attn.kind == "swa" and self.unified:
            raise NotImplementedError(
                f"sliding-window attention ({spec.name!r}): the unified "
                "step has no sliding-window masking, as in the reference; "
                "serve it with cache_layout='dense'")
        if spec.attn.kind == "swa" and self.paged:
            raise NotImplementedError(
                f"sliding-window attention ({spec.name!r}) in the paged "
                "two-dispatch decode (ROADMAP: section 3, the reference's "
                "kernel and gather routes disagree there); serve it with "
                "cache_layout='dense'")
        if self.paged and config.max_seq % config.page_size:
            raise ValueError("paged layout needs max_seq to be a multiple "
                             "of page_size")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine on "
                             f"{self.device}")
        self.model = model
        self.cfg = config
        self.debug_guards = config.debug_guards
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._ids = itertools.count()
        self.queue: deque[Request] = deque()
        self.active: dict[int, Request] = {}  # slot -> request
        self.free_slots = list(range(config.max_slots))
        self.finished: list[Request] = []
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
        if self.unified:
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
        front).  A two-dispatch row is zeroed for its new prompt."""
        while (self.queue and self._free_rows
               and len(self.active) + len(self._prefills)
               < self.cfg.max_slots):
            req = self.queue[0]
            if self.paged and not self.pager.ensure(req.rid,
                                                    len(self._src(req)) + 1):
                break  # pool dry: wait for frees (decode keeps running)
            self.queue.popleft()
            row = self._free_rows.pop()
            self._prefills[row] = req
            self._prefill_pos[row] = req.n_cached
            req.state = "prefill"
            if not self.unified:
                self._reset_row(row)
                self.metrics.dispatches += 1

    def _ptab_row(self, rid: int) -> np.ndarray:
        """One (max_pages,) page-table row of ``rid``'s pages, in token
        order, null-page-0 padded."""
        row = np.zeros((self.max_pages,), np.int32)
        held = self.pager.owned(rid)
        row[:len(held)] = held
        return row

    def _release_slot(self, slot: int, req: Request) -> None:
        """Free-on-finish: the slot and (paged) every page the request
        holds; the slot's table row falls back to the null page, so the
        now idle decode row writes somewhere harmless."""
        self.free_slots.append(slot)
        if self.paged:
            self.pager.release(req.rid)
            self._ptab[slot] = 0
            self._ptab_dirty = True

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
            while not self.pager.ensure(req.rid, need):
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
        already hold it)."""
        req = self._prefills.pop(row)
        del self._prefill_pos[row]
        src_len = len(self._src(req))
        if not req.output:  # resumed requests keep their original TTFT
            req.ttft_steps = self.steps
            req.first_token_t = now
        req.output.append(tok)
        self.metrics.generated_tokens += 1
        slot = self.free_slots.pop()
        req.slot = slot
        install(req, slot, row)
        self._free_rows.append(row)
        self._lengths[slot] = src_len
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
    def _reset_row(self, row: int) -> None:
        """Zero one scratch row (claimed by a newly admitted prompt): its
        K/V, or an RWKV layer's shift caches and WKV state."""
        for layer in self.scratch.layers:
            for t in _tensors(layer):
                t[row].zero_()
        self.scratch.lengths[row].zero_()

    def _prefill_masked(self, tokens: np.ndarray, rows: list[int]
                        ) -> torch.Tensor:
        """One batched chunk over all scratch rows; only ``rows`` advance
        (the others, idle or mid-prefill at another width, keep their K/V
        and lengths).  Returns the (prefill_rows, V) last-position logits."""
        logits, self.scratch = self.model.prefill_chunk(
            self.scratch, self._up(tokens),
            rows=self._up(np.asarray(rows, np.int64)))
        return logits

    def _insert(self, slot: int, row: int) -> None:
        """Copy scratch row ``row`` (K/V or RWKV state, and length) into
        decode slot ``slot`` of the dense cache."""
        for big, small in zip(self.cache.layers, self.scratch.layers):
            for b, s in zip(_tensors(big), _tensors(small)):
                b[slot].copy_(s[row])
        self.cache.lengths[slot] = self.scratch.lengths[row]

    def _insert_paged(self, slot: int, row: int, pages: np.ndarray) -> None:
        """Scatter scratch row ``row`` into the pool pages named by
        ``pages`` (attention layers), copy its RWKV state into slot
        ``slot`` (paging never applies to state), and install the slot's
        length and page-table row on the device (so the table needs no
        separate upload)."""
        pages_dev = self._up(pages)
        for big, small in zip(self.cache.layers, self.scratch.layers):
            if isinstance(big, PagedAttnCache):
                paged_insert_rows(big, small, row, pages_dev)
            else:
                for b, s in zip(_tensors(big), _tensors(small)):
                    b[slot].copy_(s[row])
        self.cache.lengths[slot] = self.scratch.lengths[row]
        self.cache.page_table[slot] = pages_dev

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
        toks = np.zeros((self.cfg.prefill_rows, w), np.int32)
        for row in rows:
            lo = self._prefill_pos[row]
            toks[row] = self._src(self._prefills[row])[lo:lo + w]
        logits = self._prefill_masked(toks, rows)
        self.metrics.prefill_calls += 1
        self.metrics.prefill_tokens += w * len(rows)
        self.metrics.dispatches += 1
        finishing = []
        for row in rows:
            self._prefill_pos[row] += w
            if self._prefill_pos[row] >= len(self._src(self._prefills[row])):
                finishing.append(row)
        if finishing:
            self._finish_prefills(finishing, logits)

    def _finish_prefills(self, rows: list[int], logits: torch.Tensor
                         ) -> None:
        """Sample first tokens for the completing prompts (one batched call,
        one transfer) and move them into decode slots."""
        nrows = self.cfg.prefill_rows
        temps = np.zeros((nrows,), np.float32)
        topks = np.zeros((nrows,), np.int32)
        topps = np.ones((nrows,), np.float32)
        for row in rows:
            s = self._prefills[row].sampling
            temps[row] = s.temperature
            topks[row] = s.top_k
            topps[row] = s.top_p
        first = self._pull(sample_slots(logits, self._up(temps),
                                        self._up(topks), self._up(topps),
                                        self.generator))
        self.metrics.dispatches += 1
        self.metrics.transfers_d2h += 1
        now = time.perf_counter()

        def install(req, slot, row):
            """Device insert: copy the scratch row into the decode cache
            (scattered into the request's pages in the paged layout)."""
            if self.paged:
                pages = self._ptab_row(req.rid)
                self._ptab[slot] = pages
                self._insert_paged(slot, row, pages)
            else:
                self._insert(slot, row)
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
            inputs = self._graphs.profiles[self._decode_key].inputs
            inputs.host["feed"][:] = self._tokens
            inputs.host["temps"][:] = self._temps
            inputs.host["topks"][:] = self._topks
            inputs.host["topps"][:] = self._topps
            inputs.upload()
            self._feed_stale = False
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
        h = inputs.host
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
        now = time.perf_counter()
        if self.active:
            self.metrics.decode_steps += 1
        self._finish_decode_slots(toks, now)
        if widths:
            self.metrics.prefill_calls += 1
            self.metrics.prefill_tokens += sum(widths.values())
        finishing = [row for row, w in widths.items()
                     if self._prefill_pos[row] + w
                     >= len(self._src(self._prefills[row]))]
        for row, w in widths.items():
            self._prefill_pos[row] += w

        def install(req, slot, row):
            """The pages already hold the prompt's KV: "inserting" into a
            decode slot is host bookkeeping."""
            self._ptab[slot] = self._ptab_row(req.rid)

        for row in finishing:
            self._promote_prefill(row, int(toks[nslots + row]), now,
                                  install)

    # -- main loop --------------------------------------------------------
    def step(self) -> None:
        if self.metrics.start_t == 0.0:
            self.metrics.start_t = time.perf_counter()
        self.steps += 1
        self.metrics.steps += 1
        self._admit()
        with self._step_guard():
            if self.unified:
                self._unified_step()
            elif self.cfg.decode_priority:
                self._decode_step()
                self._prefill_step()
            else:
                self._prefill_step()
                self._decode_step()
        if self.debug_guards and self.paged:
            self.pager.check()  # refcount / free-list invariant audit
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
        dense layout's footprint is its reservation).  Attention K/V only,
        as the reference counts: RWKV state is not KV."""
        reserved = sum(t.numel() * t.element_size()
                       for layer in self.cache.layers
                       if isinstance(layer, (AttnCache, PagedAttnCache))
                       for t in (layer.k, layer.v))
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
