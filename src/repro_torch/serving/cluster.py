"""Disaggregated prefill/decode cluster with page-granular KV migration (the
port of ``repro.serving.cluster``).

A :class:`DisaggCluster` runs two :class:`~repro_torch.serving.engine.
ServeEngine` instances on one ``Model`` (one copy of the weights):

  * a **prefill engine** (``unified=True``, chunked): admits prompts, packs
    their chunks through the packed step and writes K/V straight into its
    pages.  Its ``export_fn`` hook fires at prefill completion (first token
    sampled) instead of promoting into a local decode slot, so its decode
    slots stay idle by design.
  * a **decode engine** (paged; unified, or two-dispatch with
    ``decode_unified=False``): receives migrated requests through
    :meth:`ServeEngine.install_imported`, which stitches the pages into a
    slot's page-table row; the attention kernels read migrated pages as
    they read their own.

Between them a :class:`KvMigrationChannel`, page-granular, FIFO and
refcount-correct: a finished prefill's pages stay owned by its request id
in the source pool until the channel (1) reserves pages and a slot on the
decode side, (2) copies the pages pool to pool, (3) releases the source
pages and (4) installs the request.  The copy (:meth:`DisaggCluster.
_copy_pages`) gathers the source pages of every tensor of every layer and
writes them into the destination pages in place; its id vectors are
fixed-width (``max_pages``) and null-page padded, so it is one profile of
the cluster's :class:`~repro_torch.serving.step_graph.StepGraph`: one
CUDA-graph replay per migration on the card (captured at the first), one
eager pass on the CPU.  It runs on the current stream, as both engines'
steps do, so it is ordered after the prefill step that wrote the pages and
before any step that reuses the released ones.

Transports: the in-process device-to-device copy is free
(``MigrationLink.device()``); a bandwidth/latency link prices each transfer
at ``latency + bytes / bandwidth`` (the analytical inter-pool KV-transfer
term) and, with ``time_scale > 0``, holds the landing back by that many
wall-clock seconds per simulated second.  The channel is pumped at the top
of every cluster step.  Admission routes every prompt to the prefill
engine, after a decode-side capacity guard.  :func:`pool_split_from_plan`
maps an analytical plan's prefill:decode ratio onto an engine-unit budget.

TTFT: the first token is sampled on the prefill engine, but the client
streams only once its KV has landed in the decode pool, so the cluster
reports ``ttft_incl_migration_s = ttft_s + transfer_s`` per request.

On one card both pools share the device and one host loop: a cluster step
runs the decode engine's step, then the prefill engine's, one after the
other on one stream.
"""

from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass, field

import torch

from ..models.model import Model
from .engine import EngineConfig, Request, ServeEngine, _tensors
from .paging import PageAllocator
from .step_graph import Staged, StepGraph


@dataclass(frozen=True)
class MigrationLink:
    """Transport pricing for the inter-pool KV channel.

    ``transfer_s`` is the simulated seconds a transfer of ``n_bytes``
    occupies the link (the analytical inter-pool bandwidth term);
    ``time_scale`` turns simulated seconds into wall-clock gating (0.0:
    transfers land at the next pump, their simulated cost still recorded
    and charged to TTFT)."""

    bandwidth: float = 100e9  # bytes/s
    latency_s: float = 0.0
    time_scale: float = 0.0

    @classmethod
    def device(cls) -> "MigrationLink":
        """In-process device-to-device copy: free and instant."""
        return cls(bandwidth=math.inf, latency_s=0.0, time_scale=0.0)

    def transfer_s(self, n_bytes: int) -> float:
        return self.latency_s + (n_bytes / self.bandwidth
                                 if math.isfinite(self.bandwidth) else 0.0)


@dataclass
class Migration:
    """One in-flight prefill->decode hand-off."""

    req: Request
    kv_len: int  # tokens of live KV
    src_pages: list  # source-pool page ids, token order, at submit time
    n_pages: int  # content pages billed to the link
    n_bytes: int
    submit_t: float
    transfer_s: float  # simulated link occupancy
    ready_t: float  # clock instant the copy may land
    installed_t: float = 0.0


class KvMigrationChannel:
    """Page-granular KV hand-off between two :class:`PageAllocator` pools.
    Engine-agnostic: the caller supplies ``copy_fn(src_pages, dst_pages)``
    for the data movement and ``reserve_fn`` / ``install_fn`` at pump time.

    Protocol (FIFO, head-of-line: migrations land in submit order):

      1. ``submit`` records the source pages owned by ``req.rid`` and
         prices the transfer on the link; the source refs stay held.
      2. ``pump``: for each ready migration, ``reserve_fn(rid, kv_len + 1)``
         must allocate destination pages under the same rid and confirm an
         install target; on refusal everything stays as it was and the
         next pump retries.
      3. the pages are copied, the source refs released (the one hand-off
         point of ownership), and ``install_fn`` stitches the request into
         its destination."""

    def __init__(self, src_pager: PageAllocator, dst_pager: PageAllocator,
                 copy_fn, page_bytes: int,
                 link: MigrationLink | None = None,
                 clock=time.perf_counter):
        if src_pager.page_size != dst_pager.page_size:
            raise ValueError(
                f"migration needs equal page sizes: source pool has "
                f"{src_pager.page_size}, destination {dst_pager.page_size}")
        self.src = src_pager
        self.dst = dst_pager
        self.copy_fn = copy_fn
        self.page_bytes = page_bytes
        self.link = link if link is not None else MigrationLink.device()
        self.clock = clock
        self.queue: deque[Migration] = deque()
        # -- lifetime stats -----------------------------------------------
        self.migrations = 0
        self.migrated_pages = 0
        self.migrated_bytes = 0
        self.transfer_s_total = 0.0
        self.wait_s_total = 0.0  # clock seconds submit -> install
        self.pending_peak = 0

    @property
    def pending(self) -> int:
        return len(self.queue)

    def submit(self, req: Request, kv_len: int) -> Migration:
        """Enqueue ``req``'s KV (its source pages stay refcounted under
        ``req.rid`` until the copy lands)."""
        now = self.clock()
        held = list(self.src.owned(req.rid))
        n_content = self.src.pages_for(kv_len)
        n_bytes = n_content * self.page_bytes
        t = self.link.transfer_s(n_bytes)
        mig = Migration(req=req, kv_len=kv_len, src_pages=held,
                        n_pages=n_content, n_bytes=n_bytes, submit_t=now,
                        transfer_s=t, ready_t=now + t * self.link.time_scale)
        self.queue.append(mig)
        self.pending_peak = max(self.pending_peak, len(self.queue))
        return mig

    def pump(self, reserve_fn, install_fn) -> int:
        """Land every ready migration the destination takes; returns the
        number installed.  A blocked head (link still busy, or the
        destination refused the reservation) stops the pump: FIFO order is
        part of the contract."""
        installed = 0
        while self.queue:
            mig = self.queue[0]
            now = self.clock()
            if now < mig.ready_t:
                break
            # +1 token of headroom, as at prefill admission: the first
            # decode step appends without touching the allocator
            if not reserve_fn(mig.req.rid, mig.kv_len + 1):
                break
            dst_pages = self.dst.owned(mig.req.rid)
            self.copy_fn(mig.src_pages, dst_pages)
            self.src.release(mig.req.rid)
            self.queue.popleft()
            mig.installed_t = now
            self.migrations += 1
            self.migrated_pages += mig.n_pages
            self.migrated_bytes += mig.n_bytes
            self.transfer_s_total += mig.transfer_s
            self.wait_s_total += max(now - mig.submit_t, 0.0)
            install_fn(mig)
            installed += 1
        return installed

    def stats(self) -> dict:
        return {
            "migrations": self.migrations,
            "migrated_pages": self.migrated_pages,
            "migrated_bytes": self.migrated_bytes,
            "transfer_s_total": self.transfer_s_total,
            "transfer_s_mean": (self.transfer_s_total / self.migrations
                                if self.migrations else 0.0),
            "wait_s_mean": (self.wait_s_total / self.migrations
                            if self.migrations else 0.0),
            "pending": len(self.queue),
            "pending_peak": self.pending_peak,
        }


def pool_split_from_plan(plan, budget: int) -> tuple[int, int]:
    """Map an analytical plan's prefill:decode device ratio onto ``budget``
    engine units: returns ``(prefill_rows, decode_slots)``, both >= 1.
    ``plan`` is a :class:`~repro_torch.core.disagg.DisaggPlan` (read by
    its ``tp_prefill``, ``n_prefill_groups``, ``tp_decode`` and
    ``n_decode_groups``, so the reference's plan serves as well), or None
    for an even split."""
    if budget < 2:
        raise ValueError(f"pool split needs a budget of >= 2 engine "
                         f"units (got {budget}): each pool takes at "
                         "least one")
    if plan is None:
        n_p = budget // 2
    else:
        xp = plan.tp_prefill * plan.n_prefill_groups
        yp = plan.tp_decode * plan.n_decode_groups
        n_p = round(budget * xp / (xp + yp))
    n_p = min(max(n_p, 1), budget - 1)
    return n_p, budget - n_p


@dataclass(frozen=True)
class DisaggClusterConfig:
    """Geometry of the two pools.  ``max_seq`` / ``page_size`` are shared
    (page-granular migration needs identical page shapes); the pool sizes
    are independent."""

    max_seq: int = 256
    page_size: int = 16
    chunk_size: int = 16
    # -- prefill pool -----------------------------------------------------
    prefill_rows: int = 2  # concurrent chunked prefills
    prefill_slots: int = 1  # packed-layout decode lanes (idle by design)
    prefill_pages: int | None = None  # None: 2x rows of max context + null
    prefix_cache: bool = False
    # -- decode pool ------------------------------------------------------
    decode_slots: int = 4
    decode_prefill_rows: int = 1  # local recompute rows after preemption
    decode_pages: int | None = None  # None: capacity-equivalent to dense
    decode_unified: bool = True  # False: the two-dispatch paged decode
    # -- transport --------------------------------------------------------
    link: MigrationLink = field(default_factory=MigrationLink.device)
    debug_guards: bool = False


@dataclass
class ClusterMetrics:
    """Cluster-level counters the per-engine ``EngineMetrics`` cannot see:
    migration traffic, per-pool occupancy and the wall clock of the whole
    deployment."""

    steps: int = 0
    start_t: float = 0.0
    end_t: float = 0.0
    migration_dispatches: int = 0  # cross-pool copies issued
    migrations_inflight_peak: int = 0
    prefill_finished: int = 0  # done at prefill (eos / max_new == 1)
    prefill_pool_util_sum: float = 0.0  # per-step pages_in_use fractions
    decode_pool_util_sum: float = 0.0
    prefill_rows_busy_sum: float = 0.0
    decode_occupancy_sum: float = 0.0

    @property
    def wall_s(self) -> float:
        return max(self.end_t - self.start_t, 0.0)

    def _mean(self, total: float) -> float:
        return total / self.steps if self.steps else 0.0


class DisaggCluster:
    """Two engines and one migration channel (see the module docstring).
    The surface mirrors :class:`ServeEngine`: ``submit`` / ``step`` /
    ``run`` / ``serve`` / ``summary`` / ``kv_stats``.  ``device`` defaults
    to the card (raises without one) and must be where ``model`` lives;
    the prefill and decode engines draw from generators seeded ``2 seed``
    and ``2 seed + 1``; ``graphs=False`` runs every step and the page copy
    eagerly (the CPU always does)."""

    def __init__(self, model: Model, config: DisaggClusterConfig, *,
                 device: str | torch.device | None = None, seed: int = 0,
                 graphs: bool = True):
        cfg = config
        if cfg.prefill_rows < 1 or cfg.decode_slots < 1:
            raise ValueError("DisaggClusterConfig needs prefill_rows >= 1 "
                             "and decode_slots >= 1")
        self.cfg = cfg
        self.max_pages = cfg.max_seq // cfg.page_size
        prefill_pages = cfg.prefill_pages
        if prefill_pages is None:
            # room for every prefill row at max context, twice over: the
            # second helping buffers exported-but-unmigrated pages
            prefill_pages = 2 * cfg.prefill_rows * self.max_pages + 1
        pre_cfg = EngineConfig(
            max_slots=cfg.prefill_slots, max_seq=cfg.max_seq,
            chunk_size=cfg.chunk_size, prefill_rows=cfg.prefill_rows,
            cache_layout="paged", page_size=cfg.page_size,
            n_pages=prefill_pages, unified=True,
            prefix_cache=cfg.prefix_cache, debug_guards=cfg.debug_guards)
        dec_cfg = EngineConfig(
            max_slots=cfg.decode_slots, max_seq=cfg.max_seq,
            chunk_size=cfg.chunk_size, prefill_rows=cfg.decode_prefill_rows,
            cache_layout="paged", page_size=cfg.page_size,
            n_pages=cfg.decode_pages, unified=cfg.decode_unified,
            debug_guards=cfg.debug_guards)
        self.prefill_eng = ServeEngine(model, pre_cfg, device=device,
                                       seed=2 * seed, graphs=graphs)
        self.decode_eng = ServeEngine(model, dec_cfg, device=device,
                                      seed=2 * seed + 1, graphs=graphs)
        self.prefill_eng.export_fn = self._on_export
        self.device = self.decode_eng.device

        stats = self.decode_eng.kv_stats()
        self.page_bytes = int(stats["kv_reserved_bytes"] / stats["n_pages"])
        self.channel = KvMigrationChannel(
            self.prefill_eng.pager, self.decode_eng.pager,
            self._copy_pages, self.page_bytes, link=cfg.link)
        # the page copy: one profile, its fixed-width id vectors staged (it
        # draws no random numbers; the graph registers the decode engine's
        # generator, whose state a replay then leaves as it was)
        self._graphs = StepGraph(self.device, self.decode_eng.generator,
                                 graphs=graphs)
        ids = Staged({"src": ((self.max_pages,), torch.int32),
                      "dst": ((self.max_pages,), torch.int32)}, self.device)
        self._graphs.add("migrate", ids, None, self._migrate_fn(ids.dev))
        self.metrics = ClusterMetrics()
        #: rid -> simulated link seconds its KV spent in flight
        self.migration_s: dict[int, float] = {}
        self._finished_at_prefill: list[Request] = []

    # -- hand-off callbacks -----------------------------------------------
    def _on_export(self, req: Request, src_len: int, done: bool,
                   now: float) -> None:
        """The prefill engine's ``export_fn``: a completed prefill either
        finishes outright (eos / max_new == 1: nothing to migrate) or
        enters the channel with its pages still source-owned."""
        if done:
            req.state = "done"
            req.finish_t = now
            self.prefill_eng.pager.release(req.rid)
            self._finished_at_prefill.append(req)
            self.metrics.prefill_finished += 1
            return
        req.state = "migrating"
        self.channel.submit(req, src_len)

    def _install(self, mig: Migration) -> None:
        self.decode_eng.install_imported(mig.req, mig.kv_len)
        self.migration_s[mig.req.rid] = mig.transfer_s

    def _migrate_fn(self, ids: dict[str, torch.Tensor]):
        """The copy's step: the ``src`` pages of every tensor of every layer
        of the prefill pool (K/V and, quantized, their scales; page axis
        first) into the ``dst`` pages of the decode pool, in place.  Padded
        lanes copy null page 0 onto null page 0, which no live page-table
        entry within a request's length addresses."""
        pairs = [(d, s) for dl, sl in zip(self.decode_eng.cache.layers,
                                          self.prefill_eng.cache.layers)
                 for d, s in zip(_tensors(dl), _tensors(sl), strict=True)]

        def step() -> None:
            src, dst = ids["src"].long(), ids["dst"].long()
            for d, s in pairs:
                d.index_copy_(0, dst, s.index_select(0, src))
        return step

    def _copy_pages(self, src_pages: list, dst_pages: list) -> None:
        """The channel's ``copy_fn``: stage the fixed-width, null-padded id
        vectors and run the copy profile (one replay on the card)."""
        k = min(len(src_pages), len(dst_pages))
        inputs = self._graphs.profiles["migrate"].inputs
        h = inputs.write()
        h["src"].fill(0)
        h["dst"].fill(0)
        h["src"][:k] = src_pages[:k]
        h["dst"][:k] = dst_pages[:k]
        inputs.upload()
        self._graphs.run("migrate")
        self.metrics.migration_dispatches += 1

    # -- public API -------------------------------------------------------
    def submit(self, req: Request) -> int:
        """Route a prompt to the prefill engine, after checking that the
        decode pool could ever install it (a prompt too large for the
        decode side would otherwise block the channel's head for good)."""
        dec = self.decode_eng
        need = dec.pager.pages_for(len(req.prompt) + 1)
        limit = min(dec.max_pages, dec.pager.usable_pages)
        if need > limit:
            cap = limit * self.cfg.page_size
            raise ValueError(
                f"prompt of {len(req.prompt)} tokens needs {need} KV pages "
                f"but the decode pool installs at most {limit} pages = "
                f"{cap} tokens per request (decode_pages="
                f"{dec.pager.n_pages}, max_seq={self.cfg.max_seq}, "
                f"page_size={self.cfg.page_size}); raise decode_pages or "
                f"max_seq")
        return self.prefill_eng.submit(req)

    @property
    def busy(self) -> bool:
        return (self.prefill_eng.busy or self.decode_eng.busy
                or bool(self.channel.queue))

    @property
    def finished(self) -> list[Request]:
        return self._finished_at_prefill + self.decode_eng.finished

    def step(self) -> None:
        """One cluster iteration: land ready migrations, then advance both
        engines (decode first, in SLO order)."""
        m = self.metrics
        if m.start_t == 0.0:
            m.start_t = time.perf_counter()
        m.steps += 1
        # the pump runs under the decode engine's step guard: with
        # debug_guards on the card, a synchronising call in it raises
        with self.decode_eng._step_guard():
            self.channel.pump(self.decode_eng.reserve_imported,
                              self._install)
        if self.decode_eng.busy:
            self.decode_eng.step()
        if self.prefill_eng.busy:
            self.prefill_eng.step()
        pre, dec = self.prefill_eng, self.decode_eng
        m.prefill_pool_util_sum += pre.pager.utilization
        m.decode_pool_util_sum += dec.pager.utilization
        m.prefill_rows_busy_sum += len(pre._prefills) / pre.cfg.prefill_rows
        m.decode_occupancy_sum += len(dec.active) / dec.cfg.max_slots
        m.migrations_inflight_peak = max(m.migrations_inflight_peak,
                                         len(self.channel.queue))
        m.end_t = time.perf_counter()

    def run(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if not self.busy:
                break
            if not (self.prefill_eng.busy or self.decode_eng.busy):
                # only a simulated transfer is outstanding: wait it out
                dt = self.channel.queue[0].ready_t - self.channel.clock()
                if dt > 0:
                    time.sleep(min(dt, 0.01))
            self.step()

    def serve(self, requests: list[Request],
              max_steps: int = 10_000) -> list[Request]:
        for r in requests:
            self.submit(r)
        self.run(max_steps)
        return requests

    def ttft_incl_migration_s(self, req: Request) -> float:
        """Client-observed TTFT: prefill TTFT plus the simulated link
        seconds the request's KV spent in flight."""
        return req.ttft_s + self.migration_s.get(req.rid, 0.0)

    def summary(self, requests: list[Request] | None = None,
                ttft_slo_s: float | None = None,
                tpot_slo_s: float | None = None) -> dict:
        """Cluster rollup: migration traffic, per-pool occupancy,
        TTFT including migration, goodput (SLO-gated when SLOs are given),
        and each engine's own summary."""
        m, ch = self.metrics, self.channel
        reqs = requests if requests is not None else self.finished
        done = [r for r in reqs if r.state == "done"]
        wall = m.wall_s
        gen = sum(len(r.output) for r in done)
        ttfts = sorted(self.ttft_incl_migration_s(r) for r in done)
        tpots = [r.tpot_s for r in done if r.tpot_s > 0]
        out = {
            "steps": m.steps,
            "wall_s": wall,
            "requests_done": len(done),
            "generated_tokens": gen,
            "tokens_per_s": gen / wall if wall > 0 else 0.0,
            "prefill_finished": m.prefill_finished,
            # -- migration traffic ---------------------------------------
            **{f"migration_{k}" if not k.startswith("mig") else k: v
               for k, v in ch.stats().items()},
            "migration_dispatches": m.migration_dispatches,
            "migrations_inflight_peak": m.migrations_inflight_peak,
            # -- per-pool occupancy --------------------------------------
            "prefill_pool_util_mean": m._mean(m.prefill_pool_util_sum),
            "decode_pool_util_mean": m._mean(m.decode_pool_util_sum),
            "prefill_rows_busy_mean": m._mean(m.prefill_rows_busy_sum),
            "decode_slot_occupancy_mean": m._mean(m.decode_occupancy_sum),
            # -- per-engine rollups --------------------------------------
            "prefill": self.prefill_eng.metrics.summary(),
            "decode": self.decode_eng.metrics.summary(),
        }
        if done:
            out["ttft_s_mean"] = sum(r.ttft_s for r in done) / len(done)
            out["ttft_incl_migration_s_mean"] = sum(ttfts) / len(ttfts)
            out["ttft_incl_migration_s_p95"] = ttfts[
                min(int(len(ttfts) * 0.95), len(ttfts) - 1)]
            out["tpot_s_mean"] = (sum(tpots) / len(tpots)) if tpots else 0.0
        if ttft_slo_s is not None or tpot_slo_s is not None:
            ok = [r for r in done
                  if (ttft_slo_s is None
                      or self.ttft_incl_migration_s(r) <= ttft_slo_s)
                  and (tpot_slo_s is None
                       or (r.tpot_s <= tpot_slo_s or r.tpot_s == 0.0))]
            out["slo_attainment"] = len(ok) / len(done) if done else 0.0
            out["goodput_tok_s"] = (sum(len(r.output) for r in ok) / wall
                                    if wall > 0 else 0.0)
        else:
            out["goodput_tok_s"] = out["tokens_per_s"]
        return out

    def kv_stats(self) -> dict:
        return {"prefill": self.prefill_eng.kv_stats(),
                "decode": self.decode_eng.kv_stats(),
                "page_bytes": self.page_bytes}
