"""Port parity of the disaggregated prefill/decode cluster: the port's
``DisaggCluster`` against the JAX package's on the same spec, converted
weights, config and seeded requests, case by case as
``tests/test_disagg_cluster.py`` holds the reference.

Everything is float32 on the CPU, the port on its plain kernels.  Greedy
outputs must be token-identical, and the cluster's counters (``steps``,
migrations, pages, bytes, ``migration_dispatches``, ``prefill_finished``,
``migrations_inflight_peak``), each engine's own (``exports``,
``imports``, ``preemptions``, ``dispatches`` and the step counts) and
``page_bytes`` equal.  The cluster must also reproduce the port's own
unified engine.  The migration channel, the link and the pool split are
host code: the port's must equal the reference's exactly, and the channel
holds against the brute-force contents and refcount oracle of the
reference's tests.  Each JAX cluster is run once per module (its engines
compile per instance) and shared by the cases that read it.
"""

import functools
import itertools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core.disagg import DisaggPlan
from repro.models import build_model as jax_build_model
from repro.serving import DisaggCluster as JaxDisaggCluster
from repro.serving import DisaggClusterConfig as JaxDisaggClusterConfig
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import KvMigrationChannel as JaxKvMigrationChannel
from repro.serving import MigrationLink as JaxMigrationLink
from repro.serving import PageAllocator as JaxPageAllocator
from repro.serving import Request as JaxRequest
from repro.serving import ServeEngine as JaxServeEngine
from repro.serving import pool_split_from_plan as jax_pool_split
from repro_torch.configs import registry as treg
from repro_torch.core.disagg import DisaggPlan as PortDisaggPlan
from repro_torch.models import build_model, from_jax_params
from repro_torch.serving import (DisaggCluster, DisaggClusterConfig,
                                 EngineConfig, KvMigrationChannel,
                                 MigrationLink, PageAllocator, Request,
                                 ServeEngine, pool_split_from_plan)
from repro_torch.serving.engine import _tensors

ARCH = "minitron-8b"  # reduced: 2 layers, GQA 8/2, d_head 16, vocab 512
MAX_NEW = 8
CLUSTER_COUNTERS = ("steps", "migrations", "migrated_pages",
                    "migrated_bytes", "migration_dispatches",
                    "prefill_finished", "migrations_inflight_peak",
                    "requests_done", "generated_tokens")
ENGINE_COUNTERS = ("steps", "decode_steps", "prefill_calls",
                   "prefill_tokens", "generated_tokens", "dispatches",
                   "transfers_d2h", "preemptions", "capacity_stops",
                   "pages_in_use_peak", "exports", "imports",
                   "prefix_lookups", "prefix_hits", "prefix_cached_tokens",
                   "prefix_inserted_pages")


@functools.lru_cache(maxsize=None)
def _models(quant: bool = False):
    """The JAX model + params and the port model loaded from the same tree
    (float32), both with ``kv_quant=quant``."""
    jspec, tspec = jreg.get_reduced(ARCH), treg.get_reduced(ARCH)
    jmodel = jax_build_model(jspec, mesh=None, param_dtype=jnp.float32,
                             compute_dtype=jnp.float32, kv_quant=quant)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.key(7)))
    tmodel = build_model(tspec, device="cpu", dtype=torch.float32,
                         kv_quant=quant)
    tmodel.load_state_dict(from_jax_params(tree, tspec))
    return jmodel, jax.tree.map(jnp.asarray, tree), tmodel


def _prompts(kind: str = "plain"):
    """Seeded prompts of 4-20 tokens; ``"prefix"``: a page-aligned 16-token
    shared system prompt ahead of each."""
    rng = np.random.default_rng(3)
    vocab = treg.get_reduced(ARCH).vocab
    prompts = [rng.integers(1, vocab, size=int(rng.integers(4, 21))).tolist()
               for _ in range(6)]
    if kind == "prefix":
        system = rng.integers(1, vocab, size=16).tolist()
        prompts = [system + p[:6] for p in prompts]
    return prompts


def _cfg(cls, link=None, **kw):
    base = dict(max_seq=64, page_size=8, chunk_size=8, prefill_rows=2,
                decode_slots=4, debug_guards=True)
    if link is not None:
        base["link"] = link
    base.update(kw)
    return cls(**base)


def _sim_link(cls):
    """A slow simulated link whose landing the injected clock gates: 2 ms
    latency plus 2 KiB a page over 1 MB/s, several cluster steps each."""
    return cls(bandwidth=1e6, latency_s=2e-3, time_scale=1.0)


def _run(cluster, req_cls, prompts, max_new, sim=False):
    """Serve ``prompts`` on ``cluster``; with ``sim`` the channel reads an
    injected clock of 1 ms per cluster step.  Returns the requests, the
    landing order (rid, installed_t) and the summary."""
    landed = []
    if sim:
        cluster.channel.clock = lambda: cluster.metrics.steps * 1e-3
    install = cluster._install

    def recorded(mig):
        install(mig)
        landed.append((mig.req.rid, mig.installed_t, mig.transfer_s))
    cluster._install = recorded
    reqs = cluster.serve([req_cls(prompt=list(p), max_new_tokens=max_new)
                          for p in prompts])
    return reqs, landed, cluster.summary(reqs)


CASES = {
    "device_unified": dict(),
    "device_two_dispatch": dict(decode_unified=False),
    "sim_link": dict(sim=True),
    "preempt": dict(decode_pages=7, max_new=10),
    "preempt_two_dispatch": dict(decode_pages=7, max_new=10,
                                 decode_unified=False),
    "prefill_only": dict(max_new=1),
    "kv_quant": dict(quant=True),
    "prefix": dict(prefix_cache=True, prompts="prefix"),
}


def _case_args(case):
    kw = dict(CASES[case])
    sim = kw.pop("sim", False)
    max_new = kw.pop("max_new", MAX_NEW)
    quant = kw.pop("quant", False)
    prompts = _prompts(kw.pop("prompts", "plain"))
    return kw, sim, max_new, quant, prompts


@functools.lru_cache(maxsize=None)
def _jax_case(case):
    kw, sim, max_new, quant, prompts = _case_args(case)
    jmodel, params, _ = _models(quant)
    link = _sim_link(JaxMigrationLink) if sim else None
    cl = JaxDisaggCluster(jmodel, params,
                          _cfg(JaxDisaggClusterConfig, link, **kw),
                          rng=jax.random.key(1))
    return (cl, *_run(cl, JaxRequest, prompts, max_new, sim))


def _port_case(case, probe=None):
    kw, sim, max_new, quant, prompts = _case_args(case)
    link = _sim_link(MigrationLink) if sim else None
    cl = DisaggCluster(_models(quant)[2], _cfg(DisaggClusterConfig, link,
                                               **kw), device="cpu")
    if probe is not None:
        probe(cl)
    return (cl, *_run(cl, Request, prompts, max_new, sim))


@functools.lru_cache(maxsize=None)
def _unified_outputs(max_new):
    """The port's own unified engine on the plain prompts (the reference's
    head-to-head baseline)."""
    eng = ServeEngine(_models()[2], EngineConfig(
        max_slots=4, max_seq=64, chunk_size=8, prefill_rows=2,
        cache_layout="paged", page_size=8, unified=True), device="cpu")
    return [r.output for r in eng.serve(
        [Request(prompt=list(p), max_new_tokens=max_new)
         for p in _prompts()])]


def _assert_same(jax_run, port_run):
    jcl, jreqs, jlanded, js = jax_run
    tcl, treqs, tlanded, ts = port_run
    assert all(r.state == "done" for r in jreqs + treqs)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    for name in CLUSTER_COUNTERS:
        assert ts[name] == js[name], name
    assert ts.keys() == js.keys()
    for side in ("prefill_eng", "decode_eng"):
        jm, tm = getattr(jcl, side).metrics, getattr(tcl, side).metrics
        for name in ENGINE_COUNTERS:
            assert getattr(tm, name) == getattr(jm, name), (side, name)
        assert tm.summary().keys() == jm.summary().keys(), side
    assert tcl.kv_stats()["page_bytes"] == jcl.kv_stats()["page_bytes"]
    assert [rid for rid, *_ in tlanded] == [rid for rid, *_ in jlanded]
    # the hand-off left both pools clean
    for eng in (tcl.prefill_eng, tcl.decode_eng):
        eng.pager.check()
        assert eng.pager.pages_in_use == 0 or eng.prefix is not None


@pytest.mark.parametrize("case", ["device_unified", "device_two_dispatch"])
def test_device_link_matches_jax(case):
    """Both decode-pool engines: the JAX cluster's tokens and counters, the
    port's unified engine's tokens, and every request migrated once."""
    port = _port_case(case)
    _assert_same(_jax_case(case), port)
    cl, reqs, _, s = port
    assert [r.output for r in reqs] == _unified_outputs(MAX_NEW)
    assert s["migrations"] == s["migration_dispatches"] == len(reqs)
    assert s["migrated_bytes"] == s["migrated_pages"] * cl.page_bytes > 0
    assert cl.prefill_eng.metrics.exports == len(reqs)
    assert cl.decode_eng.metrics.imports == len(reqs)
    assert cl.prefill_eng.metrics.decode_steps == 0
    assert cl._graphs.captures == {"migrate": 1}


def test_simulated_link_matches_jax():
    """A slow link on an injected clock: the same transfer seconds, the
    same landing order and instants, TTFT charged the transfer, and the
    same tokens as the free link."""
    jax_run, port = _jax_case("sim_link"), _port_case("sim_link")
    _assert_same(jax_run, port)
    assert port[2] == jax_run[2]  # (rid, installed_t, transfer_s) each
    cl, reqs, _, s = port
    assert [r.output for r in reqs] == _unified_outputs(MAX_NEW)
    assert s["migrations_inflight_peak"] > 1
    assert s["migration_transfer_s_mean"] > 2e-3
    for r in reqs:
        assert cl.ttft_incl_migration_s(r) > r.ttft_s
    assert abs(s["ttft_incl_migration_s_mean"] - s["ttft_s_mean"]
               - s["migration_transfer_s_mean"]) < 1e-9


@pytest.mark.parametrize("case", ["preempt", "preempt_two_dispatch"])
def test_mid_migration_preemption_matches_jax(case):
    """A 7-page decode pool preempts while later migrations are in flight;
    the recompute-style resume (its flash prefill, on the two-dispatch
    decode pool) keeps the JAX cluster's and the unified engine's
    tokens."""
    port = _port_case(case)
    _assert_same(_jax_case(case), port)
    assert port[0].decode_eng.metrics.preemptions > 0
    assert [r.output for r in port[1]] == _unified_outputs(10)


def test_poisoned_source_pages_change_nothing():
    """After each migration lands, the source pages in the prefill pool
    are set to 1e3 in every tensor of every layer: had the decode pool read
    anything but its own copy, its outputs would move."""
    poisoned = []

    def probe(cl):
        install = cl._install

        def install_and_poison(mig):
            install(mig)
            ids = torch.tensor(mig.src_pages, dtype=torch.long)
            for layer in cl.prefill_eng.cache.layers:
                for t in _tensors(layer):
                    t[ids] = 1e3
            poisoned.append(mig.req.rid)
        cl._install = install_and_poison

    port = _port_case("device_unified", probe)
    assert len(poisoned) == len(_prompts())
    _assert_same(_jax_case("device_unified"), port)


def test_prefill_finishes_short_requests_without_migration():
    port = _port_case("prefill_only")
    _assert_same(_jax_case("prefill_only"), port)
    cl, reqs, _, s = port
    assert [r.output for r in reqs] \
        == [o[:1] for o in _unified_outputs(MAX_NEW)]
    assert s["migrations"] == 0 and s["prefill_finished"] == len(reqs)
    assert cl.prefill_eng.pager.pages_in_use == 0
    assert cl._graphs.captures == {}


def test_kv_quant_cluster_matches_jax():
    """The int8 KV cache: codes and scales migrate together."""
    port = _port_case("kv_quant")
    _assert_same(_jax_case("kv_quant"), port)
    assert port[0].page_bytes > 0


def test_prefix_cache_on_the_prefill_pool_matches_jax():
    """Later prompts hit the shared system prompt in the prefill pool; the
    exported pages stay cached there after their migration."""
    port = _port_case("prefix")
    _assert_same(_jax_case("prefix"), port)
    pre = port[0].prefill_eng
    assert pre.metrics.prefix_hits > 0
    assert vars(pre.prefix.stats) == vars(_jax_case("prefix")[0]
                                          .prefill_eng.prefix.stats)
    pre.prefix.check()


def _message(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_submit_guards_decode_capacity():
    """A prompt the decode pool could never install fails at submit, with
    the reference's message."""
    jmodel, params, tmodel = _models()
    prompt = list(range(1, 30))
    got = _message(lambda: DisaggCluster(
        tmodel, _cfg(DisaggClusterConfig, decode_pages=3),
        device="cpu").submit(Request(prompt=prompt, max_new_tokens=4)))
    want = _message(lambda: JaxDisaggCluster(
        jmodel, params, _cfg(JaxDisaggClusterConfig, decode_pages=3)
    ).submit(JaxRequest(prompt=prompt, max_new_tokens=4)))
    assert got == want and "decode_pages" in got


def test_import_hooks_refuse_as_the_reference():
    """reserve_imported on a dense engine and on a speculating one, and an
    export_fn on a two-dispatch engine: the reference's ValueErrors."""
    jmodel, params, tmodel = _models()
    geo = dict(max_slots=2, max_seq=64, chunk_size=8, page_size=8)
    spec_cfg = dict(geo, cache_layout="paged", unified=True, n_spec=2)
    got = [_message(lambda: ServeEngine(tmodel, EngineConfig(**geo),
                                        device="cpu").reserve_imported(0, 4)),
           _message(lambda: ServeEngine(
               tmodel, EngineConfig(**spec_cfg), device="cpu",
               draft_model=tmodel).reserve_imported(0, 4))]
    want = [_message(lambda: JaxServeEngine(
                jmodel, params, JaxEngineConfig(**geo)).reserve_imported(0,
                                                                         4)),
            _message(lambda: JaxServeEngine(
                jmodel, params, JaxEngineConfig(**spec_cfg),
                draft_model=jmodel, draft_params=params
            ).reserve_imported(0, 4))]
    assert got == want
    assert "cache_layout='paged'" in got[0] and "n_spec > 0" in got[1]
    eng = ServeEngine(tmodel, EngineConfig(**geo, cache_layout="paged"),
                      device="cpu")
    eng.export_fn = lambda *a: None
    eng.submit(Request(prompt=[1, 2, 3], max_new_tokens=4))
    with pytest.raises(ValueError, match="export_fn needs unified=True"):
        eng.run()


def test_install_imported_needs_a_first_token():
    _, _, tmodel = _models()
    eng = ServeEngine(tmodel, EngineConfig(
        max_slots=2, max_seq=64, chunk_size=8, page_size=8,
        cache_layout="paged", unified=True), device="cpu")
    with pytest.raises(ValueError, match="no sampled first token"):
        eng.install_imported(Request(prompt=[1, 2]), 2)


# ---------------------------------------------------------------------------
# host code: the pool split, the link, the channel
# ---------------------------------------------------------------------------

def _plan(xp_tp, xp_groups, yp_tp, yp_groups, cls=DisaggPlan):
    return cls(tp_prefill=xp_tp, tp_decode=yp_tp,
               n_prefill_groups=xp_groups, n_decode_groups=yp_groups,
               goodput_rps=1.0, ttft=0.1, tpot=0.01, decode_batch=8,
               kv_transfer_s=0.0, meets_slo=True)


@pytest.mark.parametrize("budget", range(2, 17))
def test_pool_split_matches_jax(budget):
    """The port's split of the JAX plan, and of the port's own
    ``core.disagg.DisaggPlan``, equals the reference's."""
    grid = list(itertools.product((1, 2, 8), (1, 3, 4), (1, 8), (1, 3)))
    plans = [None] + [_plan(*g) for g in grid]
    ours = [None] + [_plan(*g, cls=PortDisaggPlan) for g in grid]
    for plan, own in zip(plans, ours):
        got = pool_split_from_plan(plan, budget)
        assert got == jax_pool_split(plan, budget)
        assert pool_split_from_plan(own, budget) == got
        assert min(got) >= 1 and sum(got) == budget


def test_pool_split_refuses_a_budget_of_one():
    assert _message(lambda: pool_split_from_plan(None, 1)) \
        == _message(lambda: jax_pool_split(None, 1))


@pytest.mark.parametrize("link", [(100e9, 0.0, 0.0), (50e9, 1e-4, 0.0),
                                  (1e6, 2e-3, 1.0), "device"])
def test_migration_link_matches_jax(link):
    if link == "device":
        pair = MigrationLink.device(), JaxMigrationLink.device()
    else:
        pair = MigrationLink(*link), JaxMigrationLink(*link)
    for n in (0, 1, 2048, 10 ** 9):
        assert pair[0].transfer_s(n) == pair[1].transfer_s(n)


class _Oracle:
    """Brute-force model of the hand-off: host dicts for both pools' page
    contents and the expected payload per request."""

    def __init__(self):
        self.src_store = {}
        self.dst_store = {}
        self.expected = {}
        self.installed = {}

    def copy_fn(self, src_pages, dst_pages):
        assert len(src_pages) == len(dst_pages)
        for s, d in zip(src_pages, dst_pages):
            self.dst_store[d] = self.src_store[s]


def _write_payload(store, pages, payload, ps):
    for i, page in enumerate(pages):
        store[page] = tuple(payload[i * ps:(i + 1) * ps])


def _read_payload(store, pages, n_tokens):
    out = []
    for page in pages:
        out.extend(store[page])
    return out[:n_tokens]


def _channel_trial(seed, alloc, channel_cls, req_cls):
    """The reference's random interleaving of submit / (randomly refused)
    pump / release against the oracle: every install reads back its exact
    payload, the source refs are gone at hand-off, both allocators pass
    their audits after every op, and the backlog drains.  Returns the
    channel's stats and both pools' free lists."""
    rng = random.Random(100 + seed)
    ps = rng.choice([2, 4])
    src = alloc(n_pages=rng.randint(8, 16), page_size=ps)
    dst = alloc(n_pages=rng.randint(8, 16), page_size=ps)
    oracle = _Oracle()
    ch = channel_cls(src, dst, oracle.copy_fn, page_bytes=ps * 4,
                     clock=lambda: 0.0)
    cap = min(src.usable_pages, dst.usable_pages) * ps - 1
    ids = itertools.count()
    slot_free = [True]

    def reserve(rid, n_tokens):
        return slot_free[0] and dst.ensure(rid, n_tokens)

    def install(mig):
        rid = mig.req.rid
        got = _read_payload(oracle.dst_store, dst.owned(rid), mig.kv_len)
        assert got == oracle.expected[rid], "payload corrupted in flight"
        assert src.owned(rid) == []
        assert all(dst.refcount(p) == 1 for p in dst.owned(rid))
        oracle.installed[rid] = got

    for _ in range(60):
        op = rng.choice(("submit", "pump", "pump", "release"))
        if op == "submit":
            n = rng.randint(1, max(cap, 1))
            rid = next(ids)
            if not src.ensure(rid, n + 1):
                continue
            payload = [rng.randrange(1000) for _ in range(n)]
            _write_payload(oracle.src_store, src.owned(rid), payload, ps)
            oracle.expected[rid] = payload
            req = req_cls(prompt=[0], max_new_tokens=1)
            req.rid = rid
            ch.submit(req, n)
        elif op == "pump":
            slot_free[0] = rng.random() < 0.7
            before = ch.pending
            ch.pump(reserve, install)
            if not slot_free[0]:  # a refused head blocks the whole FIFO
                assert ch.pending == before
        elif oracle.installed:
            rid = rng.choice(sorted(oracle.installed))
            dst.release(rid)
            del oracle.installed[rid]
        src.check()
        dst.check()
    slot_free[0] = True
    while ch.pending:
        for rid in list(oracle.installed):
            dst.release(rid)
            del oracle.installed[rid]
        if not ch.pump(reserve, install):
            break
    for rid in list(oracle.installed):
        dst.release(rid)
    src.check()
    dst.check()
    assert ch.pending == 0, "backlog failed to drain"
    assert src.pages_in_use == 0 and dst.pages_in_use == 0
    assert ch.migrations == len(oracle.expected)
    return ch.stats(), list(src._free), list(dst._free)


@pytest.mark.parametrize("seed", range(8))
def test_channel_holds_against_the_oracle_and_jax(seed):
    port = _channel_trial(seed, PageAllocator, KvMigrationChannel, Request)
    ref = _channel_trial(seed, JaxPageAllocator, JaxKvMigrationChannel,
                         JaxRequest)
    assert port == ref


def test_channel_fifo_blocking_is_all_or_nothing():
    """A refused reservation leaves the head migration intact: source refs
    held, nothing copied, nothing installed; the same pump lands it once
    the destination says yes."""
    src = PageAllocator(n_pages=8, page_size=4)
    dst = PageAllocator(n_pages=8, page_size=4)
    oracle = _Oracle()
    ch = KvMigrationChannel(src, dst, oracle.copy_fn, page_bytes=16,
                            clock=lambda: 0.0)
    assert src.ensure(7, 6)
    _write_payload(oracle.src_store, src.owned(7), list(range(5)), 4)
    req = Request(prompt=[0], max_new_tokens=1)
    req.rid = 7
    ch.submit(req, 5)
    assert ch.pump(lambda rid, n: False, lambda mig: None) == 0
    assert ch.pending == 1 and len(src.owned(7)) == 2
    assert ch.migrations == 0 and not oracle.dst_store
    ch.pump(lambda rid, n: dst.ensure(rid, n),
            lambda mig: oracle.installed.setdefault(mig.req.rid, True))
    assert ch.pending == 0 and src.owned(7) == []
    assert len(dst.owned(7)) == 2
    assert _read_payload(oracle.dst_store, dst.owned(7), 5) == list(range(5))


def test_channel_refuses_mismatched_page_sizes():
    got = _message(lambda: KvMigrationChannel(
        PageAllocator(8, 4), PageAllocator(8, 8), lambda s, d: None,
        page_bytes=1))
    want = _message(lambda: JaxKvMigrationChannel(
        JaxPageAllocator(8, 4), JaxPageAllocator(8, 8), lambda s, d: None,
        page_bytes=1))
    assert got == want and "page size" in got
