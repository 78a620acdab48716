"""Port parity of the prefix cache: the port's radix tree against the JAX
package's on the same seeded operation logs, and the port's unified engine
with ``prefix_cache=True`` against the JAX engine on the same converted
weights and requests.

The tree is pure host code, so its results must be equal step for step:
every lookup, acquire, insert and evict result, the allocator's free list
and holder lists.  The engines run float32 on the CPU (the port on its
plain kernels): greedy outputs token-identical, and every prefix counter,
``steps``, ``dispatches``, ``transfers_d2h``, ``prefill_tokens`` and
``preemptions`` equal.  The cases mirror ``tests/test_prefix_cache.py``:
multi-tenant hits, the copy-on-write fork with its shared tail page
poisoned, eviction under pressure, and preemption with the cache on; the
engine cases run a dense GQA stack and a reduced MoE stack.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import build_model as jax_build_model
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import PageAllocator as JaxPageAllocator
from repro.serving import PrefixCache as JaxPrefixCache
from repro.serving import Request as JaxRequest
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch.configs import registry as treg
from repro_torch.models import build_model, from_jax_params
from repro_torch.serving import (EngineConfig, PageAllocator, PrefixCache,
                                 Request, ServeEngine)
from repro_torch.serving.prefix_cache import CACHE_OWNER

PS = 4  # page size of the host-only radix tree cases
ARCHS = ["minitron-8b", "deepseek-moe-16b"]  # dense GQA, reduced MoE
COUNTERS = ("steps", "preemptions", "decode_steps", "prefill_calls",
            "prefill_tokens", "generated_tokens", "dispatches",
            "transfers_d2h", "capacity_stops", "pages_in_use_peak",
            "prefix_lookups", "prefix_hits", "prefix_lookup_tokens",
            "prefix_hit_tokens", "prefix_cached_tokens", "prefix_cow_forks",
            "prefix_inserted_pages", "prefix_evicted_pages",
            "prefix_shared_pages_peak", "prefix_by_tenant")
IMPLS = {"port": (PageAllocator, PrefixCache),
         "jax": (JaxPageAllocator, JaxPrefixCache)}


# ---------------------------------------------------------------------------
# the radix tree, host only
# ---------------------------------------------------------------------------

def _state(pager, cache):
    """Everything the tree and the allocator hold, comparable across
    packages."""
    def walk(node):
        return sorted((blk, c.page, c.last_used, walk(c))
                      for blk, c in node.children.items())
    return (list(pager._free), dict(pager._owned), dict(pager._refs),
            cache.n_nodes, walk(cache.root), vars(cache.stats))


def _put(pager, cache, owner, tokens):
    """Insert as the engine does: the owner prefills into its own pages,
    the cache registers the full ones, the owner releases."""
    assert pager.ensure(owner, len(tokens))
    new = cache.insert(tokens, pager.owned(owner))
    pager.release(owner)
    return new


def _random_tokens(rng, history):
    if history and rng.random() < 0.5:  # extend a known stem: forces shares
        stem = history[int(rng.integers(len(history)))]
        stem = stem[:int(rng.integers(len(stem) + 1))]
    else:
        stem = []
    fresh = rng.integers(0, 2, size=int(rng.integers(0, 13))).tolist()
    return (stem + fresh)[:20]


def _run_ops_both(seed, n_ops=120):
    """One seeded operation log through both packages' trees in lockstep;
    every result and the whole state must be equal after every op."""
    rng = np.random.default_rng(seed)
    pairs = {}
    for k, (alloc, cache_cls) in IMPLS.items():
        pager = alloc(n_pages=257, page_size=PS)
        pairs[k] = pager, cache_cls(pager)
    history, owners, next_owner = [], [], 1
    for _ in range(n_ops):
        op = rng.choice(["insert", "lookup", "acquire", "release", "evict"],
                        p=[0.35, 0.25, 0.15, 0.15, 0.10])
        toks = _random_tokens(rng, history)
        n_evict = 10 ** 9 if rng.random() < 0.3 else int(rng.integers(1, 4))
        victim = owners[int(rng.integers(len(owners)))] if owners else None
        got = {}
        for k, (pager, cache) in pairs.items():
            if op == "insert":
                fits = pager.pages_for(len(toks)) <= pager.free_pages
                got[k] = _put(pager, cache, next_owner, toks) if fits \
                    else None
            elif op == "lookup":
                got[k] = cache.lookup(toks)
            elif op == "acquire":
                got[k] = cache.acquire(next_owner, toks)
            elif op == "release":
                got[k] = None if victim is None else pager.release(victim)
            else:
                got[k] = cache.evict(n_evict)
            cache.check()
            pager.check()
        assert got["port"] == got["jax"], op
        if op == "insert" and got["port"] is not None:
            history.append(toks)
            next_owner += 1
        elif op == "acquire":
            if got["port"]:
                owners.append(next_owner)
            next_owner += 1
        elif op == "release" and victim is not None:
            owners.remove(victim)
        assert _state(*pairs["port"]) == _state(*pairs["jax"])
    for pager, cache in pairs.values():
        for o in owners:
            pager.release(o)
        cache.clear()
        assert cache.cached_pages == 0
        assert pager.free_pages == pager.usable_pages
    assert _state(*pairs["port"]) == _state(*pairs["jax"])


@pytest.mark.parametrize("seed", range(8))
def test_radix_tree_matches_jax(seed):
    _run_ops_both(seed)


try:  # hypothesis drives the same property where the host has it
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:
    pass
else:
    @given(st.integers(0, 2 ** 31 - 1))
    @settings(max_examples=25, deadline=None)
    def test_radix_tree_matches_jax_hypothesis(seed):
        _run_ops_both(seed)


def _first_writer(alloc, cache_cls):
    pager = alloc(n_pages=64, page_size=PS)
    cache = cache_cls(pager)
    toks = [7] * PS
    log = [_put(pager, cache, 1, toks), cache.lookup(toks)[0][0]]
    log += [_put(pager, cache, 2, toks), cache.lookup(toks)[0][0],
            cache.cached_pages]
    return log


def _lru_and_pinning(alloc, cache_cls):
    pager = alloc(n_pages=64, page_size=PS)
    cache = cache_cls(pager)
    a, b, c = [0] * PS, [1] * PS, [2] * PS
    for i, t in enumerate((a, b, c)):
        _put(pager, cache, i + 1, t)
    cache.acquire(9, a)  # refreshes a's LRU and pins its page
    log = [cache.evict(1), cache.lookup(b)[1], cache.lookup(a)[1],
           cache.lookup(c)[1], cache.evict(10), cache.lookup(a)[1]]
    pager.release(9)
    log += [cache.evict(10), cache.cached_pages,
            pager.free_pages == pager.usable_pages]
    return log


def _peel_cold_branch(alloc, cache_cls):
    pager = alloc(n_pages=64, page_size=PS)
    cache = cache_cls(pager)
    log = [_put(pager, cache, 1, list(range(3 * PS))),
           len(cache._evictable()), cache.evict(3), cache.cached_pages]
    cache.check()
    pager.check()
    return log


@pytest.mark.parametrize("case,want", [
    (_first_writer, [1, 1, 0, 1, 1]),  # the latecomer caches nothing new
    (_lru_and_pinning, [1, 0, PS, PS, 1, PS, 1, 0, True]),
    (_peel_cold_branch, [3, 1, 3, 0]),  # the leaf first, then its parents
], ids=["first_writer_wins", "lru_and_pinning", "peel_cold_branch"])
def test_radix_tree_cases_match_jax(case, want):
    logs = {k: case(*impl) for k, impl in IMPLS.items()}
    assert logs["port"] == logs["jax"] == want


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _pair(arch: str):
    """JAX model + params and the port model loaded from the same tree
    (float32); the JAX MoE on its dense path, as without a mesh."""
    jspec, tspec = jreg.get_reduced(arch), treg.get_reduced(arch)
    jmodel = jax_build_model(jspec, mesh=None, param_dtype=jnp.float32,
                             compute_dtype=jnp.float32, moe_impl="dense")
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.key(7)))
    tmodel = build_model(tspec, device="cpu", dtype=torch.float32)
    tmodel.load_state_dict(from_jax_params(tree, tspec))
    return jspec, jmodel, jax.tree.map(jnp.asarray, tree), tmodel


def _cfg(cls, **kw):
    base = dict(max_slots=2, max_seq=64, chunk_size=8, prefill_rows=2,
                cache_layout="paged", page_size=8, unified=True,
                prefix_cache=True, debug_guards=True)
    base.update(kw)
    return cls(**base)


def _engines(arch, **kw):
    _, jmodel, params, tmodel = _pair(arch)
    return (JaxServeEngine(jmodel, params, _cfg(JaxEngineConfig, **kw),
                           rng=jax.random.key(1)),
            ServeEngine(tmodel, _cfg(EngineConfig, **kw), device="cpu"))


def _requests(cls, prompts, max_new, tenants=None):
    tenants = tenants or [None] * len(prompts)
    return [cls(prompt=list(p), max_new_tokens=max_new, tenant=t,
                template_id=t and f"{t}/0")
            for p, t in zip(prompts, tenants)]


def _assert_same(jeng, jreqs, teng, treqs):
    """Outputs, each request's cached tokens, every counter; and the
    reference's accounting: one extra dispatch per copy-on-write fork."""
    assert all(r.state == "done" for r in jreqs + treqs)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert [r.n_cached for r in treqs] == [r.n_cached for r in jreqs]
    for name in COUNTERS:
        assert getattr(teng.metrics, name) == getattr(jeng.metrics, name), \
            name
    m = teng.metrics
    assert m.dispatches == m.steps + m.prefix_cow_forks
    assert m.transfers_d2h == m.steps
    assert teng.metrics.summary(treqs).keys() \
        == jeng.metrics.summary(jreqs).keys()
    assert vars(teng.prefix.stats) == vars(jeng.prefix.stats)
    teng.pager.check()
    teng.prefix.check()
    assert teng.pager.holders() in ([], [CACHE_OWNER])


def _tenant_prompts(vocab, seed, n_each=3, template=16, suffix=5):
    """Two tenants, each a page-aligned shared template plus a fresh
    suffix per request."""
    rng = np.random.default_rng(seed)
    tmpl = {t: rng.integers(1, vocab, size=template).tolist()
            for t in ("tA", "tB")}
    tenants = [t for t in ("tA", "tB") for _ in range(n_each)]
    return [tmpl[t] + rng.integers(1, vocab, size=suffix).tolist()
            for t in tenants], tenants


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_prefix_cache_requires_unified(layout):
    _, _, _, tmodel = _pair("minitron-8b")
    with pytest.raises(ValueError, match="prefix_cache=True requires "
                       "unified=True"):
        ServeEngine(tmodel, _cfg(EngineConfig, unified=False,
                                 cache_layout=layout), device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_multi_tenant_hits_match_jax(arch):
    """Later same-template requests map both template pages, prefill only
    their suffix, and decode exactly the JAX engine's tokens, with every
    counter equal."""
    jspec = _pair(arch)[0]
    prompts, tenants = _tenant_prompts(jspec.vocab, seed=11)
    jeng, teng = _engines(arch, max_slots=3)
    jreqs = jeng.serve(_requests(JaxRequest, prompts, 4, tenants))
    treqs = teng.serve(_requests(Request, prompts, 4, tenants))
    _assert_same(jeng, jreqs, teng, treqs)
    m = teng.metrics
    assert m.prefix_hit_rate > 0.0 and m.prefix_shared_pages_peak >= 1
    assert set(m.prefix_by_tenant) == {"tA", "tB"}
    assert any(r.n_cached >= 16 for r in treqs)
    assert teng._graphs.captures == {"unified/mixed": 1, "unified/decode": 1}


@pytest.mark.parametrize("arch", ARCHS)
def test_cow_fork_poisoned_tail_matches_jax(arch):
    """A full hit forks its tail page copy-on-write (charged the fork page
    and the decode token's page only); poisoning the shared original in
    every layer afterwards leaves the forked request's output equal to the
    first request's, in both packages."""
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3]  # 2 pages
    out = {}
    for name, eng in zip(("jax", "port"), _engines(arch)):
        req_cls = JaxRequest if name == "jax" else Request
        r1 = req_cls(prompt=prompt, max_new_tokens=6)
        eng.serve([r1])
        shared, n_cached = eng.prefix.lookup(prompt)
        assert n_cached == 16 and len(shared) == 2
        free0 = eng.pager.free_pages
        r2 = req_cls(prompt=prompt, max_new_tokens=6)
        eng.submit(r2)
        eng.step()  # admission: attach the hit + the copy-on-write fork
        assert eng.metrics.prefix_cow_forks == 1
        assert r2.n_cached == len(prompt) - 1
        held = eng.pager.owned(r2.rid)
        assert shared[0] in held and shared[1] not in held
        assert free0 - eng.pager.free_pages == 2
        if name == "jax":
            eng.cache = eng.cache.__class__(
                layers=jax.tree.map(lambda a: a.at[:, shared[1]].set(1e9),
                                    eng.cache.layers),
                lengths=eng.cache.lengths, page_table=eng.cache.page_table)
        else:
            for layer in eng.cache.layers:
                layer.k[shared[1]] = 1e9
                layer.v[shared[1]] = 1e9
        while r2.state != "done":
            eng.step()
        assert r2.output == r1.output
        out[name] = eng, [r1, r2]
    _assert_same(*out["jax"], *out["port"])


@pytest.mark.parametrize("arch", ARCHS)
def test_eviction_under_pressure_matches_jax(arch):
    """A pool too small to cache every distinct prompt evicts cold
    refcount-1 leaves before it preempts; outputs and counters equal the
    JAX engine's."""
    jspec = _pair(arch)[0]
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, jspec.vocab, size=16).tolist()
               for _ in range(6)]
    jeng, teng = _engines(arch, n_pages=14)
    jreqs = jeng.serve(_requests(JaxRequest, prompts, 4))
    treqs = teng.serve(_requests(Request, prompts, 4))
    _assert_same(jeng, jreqs, teng, treqs)
    assert teng.metrics.prefix_evicted_pages > 0


def test_preemption_with_prefix_cache_matches_jax():
    """A pool tight enough to preempt mid-decode, with shared prefixes:
    a preempted request's released pages stay cached and its resumption
    hits them; outputs and counters equal the JAX engine's."""
    jspec = _pair("minitron-8b")[0]
    rng = np.random.default_rng(6)
    stem = rng.integers(1, jspec.vocab, size=8).tolist()
    prompts = [stem + rng.integers(1, jspec.vocab, size=n).tolist()
               for n in (5, 3, 6, 4, 1, 7)]
    kw = dict(max_slots=4, max_seq=32, page_size=4, chunk_size=4,
              n_pages=11)
    jeng, teng = _engines("minitron-8b", **kw)
    jreqs = jeng.serve(_requests(JaxRequest, prompts, 10))
    treqs = teng.serve(_requests(Request, prompts, 10))
    _assert_same(jeng, jreqs, teng, treqs)
    assert teng.metrics.preemptions > 0 and teng.metrics.prefix_hits > 0


@pytest.mark.parametrize("graphs", [False, True], ids=["eager", "graphs"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_on_equals_cache_off(arch, graphs):
    """The port alone: the same requests with the cache on and off give
    identical outputs, on the eager engine and through ``StepGraph`` (which
    runs eagerly on the CPU, on the very static tensors a capture binds);
    the cache prefills fewer tokens, and each profile is bound once."""
    jspec, _, _, tmodel = _pair(arch)
    prompts, tenants = _tenant_prompts(jspec.vocab, seed=12, n_each=4,
                                       template=24, suffix=7)
    prompts.append(prompts[0][:24])  # a full hit: the tail page forks
    tenants.append("tA")
    outs, engs = {}, {}
    for on in (False, True):
        eng = ServeEngine(tmodel, _cfg(EngineConfig, prefix_cache=on,
                                       max_slots=3), device="cpu",
                          graphs=graphs)
        reqs = eng.serve(_requests(Request, prompts, 5, tenants))
        assert all(r.state == "done" for r in reqs)
        outs[on], engs[on] = [r.output for r in reqs], eng
    assert outs[True] == outs[False]
    on, off = engs[True].metrics, engs[False].metrics
    assert on.prefill_tokens + on.prefix_cached_tokens == off.prefill_tokens
    assert on.prefix_cow_forks >= 1
    assert on.dispatches == on.steps + on.prefix_cow_forks
    assert off.dispatches == off.transfers_d2h == off.steps
    assert "prefix_lookups" not in off.summary()
    for eng in engs.values():
        assert eng._graphs.captures == {"unified/mixed": 1,
                                        "unified/decode": 1}
