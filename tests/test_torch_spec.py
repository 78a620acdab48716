"""Port parity of speculative decoding: the port's ``rejection_accept``,
``Model.verify_step``, spec engine and batch-1 ``SpeculativeDecoder``
against the JAX package's, case by case as ``tests/test_spec_packed.py``
holds the reference.

JAX initialises the weights and the port loads them through
``from_jax_params``; the perturbed draft is the reference's ``drafted``
recipe (every leaf times ``1 + 0.04 N(0, 1)`` from a seeded generator),
converted the same way.  Everything is float32 on the CPU, the port on its
plain kernels.  ``rejection_accept`` must equal the JAX function exactly on
identical numpy inputs.  ``verify_step``'s logits must agree within atol
1e-4 and the pools within 1e-5 (``tests/test_torch_model.py``'s
tolerances).  The engines must give the same greedy outputs and every
counter equal: ``steps``, ``dispatches``, ``transfers_d2h``, the spec
counters and ``spec_by_slot``, preemptions and pages.  Each JAX engine is
built once per module (a JAX spec engine compiles its two rounds in
seconds).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import build_model as jax_build_model
from repro.models.attention import PackedSegs as JaxPackedSegs
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import Request as JaxRequest
from repro.serving import ServeEngine as JaxServeEngine
from repro.serving import SpeculativeDecoder as JaxSpeculativeDecoder
from repro.serving import rejection_accept as jax_rejection_accept
from repro_torch.configs import registry as treg
from repro_torch.models import build_model, from_jax_params
from repro_torch.models.attention import PackedSegs
from repro_torch.serving import (EngineConfig, PackedSpeculator, Request,
                                 SamplingConfig, ServeEngine,
                                 SpeculativeDecoder, rejection_accept)

K = 3
LOGITS_ATOL = 1e-4
POOL_ATOL = 1e-5
COUNTERS = ("steps", "decode_steps", "prefill_calls", "prefill_tokens",
            "generated_tokens", "dispatches", "transfers_d2h",
            "preemptions", "capacity_stops", "pages_in_use_peak",
            "spec_rounds", "spec_slot_rounds", "spec_proposed",
            "spec_accepted", "spec_bonus", "spec_emitted", "spec_by_slot",
            "prefix_lookups", "prefix_hits", "prefix_cached_tokens",
            "prefix_cow_forks")


# ---------------------------------------------------------------------------
# rejection_accept on identical numpy inputs
# ---------------------------------------------------------------------------

def _random_case(rng, b=6, k=4, v=12):
    """The reference test's generator: greedy and stochastic rows, clipped
    widths, inactive rows."""
    dec = rng.normal(size=(b, k + 1, v)).astype(np.float32) * 2.0
    dp = rng.dirichlet(np.ones(v), size=(b, k)).astype(np.float32)
    dt = np.stack([[rng.choice(v, p=dp[r, i] / dp[r, i].sum())
                    for i in range(k)] for r in range(b)]).astype(np.int32)
    temps = rng.choice([0.0, 0.7, 1.3], size=b).astype(np.float32)
    widths = rng.integers(0, k + 2, size=b).astype(np.int32)
    ua = rng.uniform(size=(b, k)).astype(np.float32)
    uf = rng.uniform(size=b).astype(np.float32)
    return dec, dp, dt, temps, widths, ua, uf


def _port_accept(case):
    return [t.numpy() for t in rejection_accept(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in case))]


_jax_accept = jax.jit(jax_rejection_accept)


def _both_accept(case):
    port = _port_accept(case)
    ref = [np.asarray(a) for a in _jax_accept(
        *(jnp.asarray(a) for a in case))]
    return port, ref


def _assert_accept_equal(case):
    (a, out, ne), (ja, jout, jne) = _both_accept(case)
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(ne, jne)
    np.testing.assert_array_equal(out, jout)
    assert a.dtype == out.dtype == ne.dtype == np.int32


@pytest.mark.parametrize("rows", ["mixed", "greedy", "stochastic", "full"])
def test_rejection_accept_matches_jax_seeded(rows):
    """50 seeded batches per kind of row: accepted counts, every output
    token (committed or not) and n_emit equal the JAX function's."""
    rng = np.random.default_rng({"mixed": 12345, "greedy": 1,
                                 "stochastic": 2, "full": 3}[rows])
    for _ in range(50):
        case = list(_random_case(rng))
        if rows == "greedy":
            case[3] = np.zeros_like(case[3])
        elif rows == "stochastic":
            case[3] = np.full_like(case[3], 0.9)
        elif rows == "full":  # every window at its widest
            case[4] = np.full_like(case[4], case[2].shape[1] + 1)
        _assert_accept_equal(case)


def test_rejection_accept_greedy_is_argmax_chain():
    """Greedy rows emit exactly the target argmax chain, for any draft."""
    rng = np.random.default_rng(7)
    dec, dp, dt, _, _, ua, uf = _random_case(rng, b=8, k=4, v=16)
    a, out, ne = _port_accept((dec, dp, dt, np.zeros(8, np.float32),
                               np.full(8, 5, np.int32), ua, uf))
    am = np.argmax(dec, -1)
    for r in range(8):
        assert ne[r] == a[r] + 1
        np.testing.assert_array_equal(out[r, :ne[r]], am[r, :ne[r]])


def test_rejection_accept_distribution_is_target():
    """Monte-Carlo: with proposals drawn from the draft distribution, the
    first committed token's empirical law matches the target softmax
    (total variation < 2%) though the draft is very different."""
    rng = np.random.default_rng(99)
    v, k, n = 10, 3, 40000
    dec_row = rng.normal(size=(k + 1, v)).astype(np.float32)
    dp_row = rng.dirichlet(np.ones(v) * 0.5, size=k).astype(np.float32)
    dt = np.stack([rng.choice(v, size=n, p=dp_row[i] / dp_row[i].sum())
                   for i in range(k)], 1).astype(np.int32)
    case = (np.broadcast_to(dec_row, (n, k + 1, v)),
            np.broadcast_to(dp_row, (n, k, v)), dt,
            np.ones(n, np.float32), np.full(n, k + 1, np.int32),
            rng.uniform(size=(n, k)).astype(np.float32),
            rng.uniform(size=n).astype(np.float32))
    _, out, ne = _port_accept(case)
    assert (ne >= 1).all()
    freq = np.bincount(out[:, 0], minlength=v) / n
    want = np.exp(dec_row[0].astype(np.float64))
    want /= want.sum()
    assert 0.5 * np.abs(freq - want).sum() < 0.02


try:  # hypothesis drives the same property where the host has it
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:
    pass
else:
    @given(seed=st.integers(0, 2 ** 31 - 1), b=st.integers(1, 5),
           k=st.integers(1, 5), v=st.integers(2, 9))
    @settings(max_examples=20, deadline=None)
    def test_rejection_accept_matches_jax_hypothesis(seed, b, k, v):
        _assert_accept_equal(_random_case(np.random.default_rng(seed),
                                          b=b, k=k, v=v))


# ---------------------------------------------------------------------------
# models: verify_step
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _pair(arch: str):
    """JAX model + params + perturbed draft params, and the port's target
    and perturbed draft loaded from the same trees (float32); the JAX MoE on
    its dense path, as without a mesh."""
    jspec, tspec = jreg.get_reduced(arch), treg.get_reduced(arch)
    jmodel = jax_build_model(jspec, mesh=None, param_dtype=jnp.float32,
                             compute_dtype=jnp.float32, moe_impl="dense")
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.key(7)))
    rng = np.random.default_rng(99)  # the reference's `drafted` fixture
    d_tree = jax.tree.map(
        lambda a: a * (1.0 + 0.04 * rng.standard_normal(a.shape)
                       .astype(np.float32)), tree)
    ported = []
    for t in (tree, d_tree):
        m = build_model(tspec, device="cpu", dtype=torch.float32)
        m.load_state_dict(from_jax_params(t, tspec))
        ported.append(m)
    return dict(spec=jspec, jmodel=jmodel,
                params=jax.tree.map(jnp.asarray, tree),
                d_params=jax.tree.map(jnp.asarray, d_tree),
                target=ported[0], draft=ported[1])


# verify geometry: 3 slots, 2 prefill rows of chunk 8, pages of 4; A and B
# prefilled by two unified steps, then a mixed verify (B's window at 5, A's
# at 13 clipped to width 3, C's prompt in row 0) and a decode-only verify
MAX_SLOTS, ROWS, CHUNK, PS, MAX_SEQ, N_PAGES = 3, 2, 8, 4, 32, 12
PAGES = {"A": [1, 2, 3, 4, 5], "B": [6, 7, 8], "C": [9, 10]}
PREFILL = [{3: ("A", 0, 8), 4: ("B", 0, 5)}, {3: ("A", 8, 5)}]
VERIFY = [("mixed", {0: ("B", 5, K + 1), 1: ("A", 13, K), 3: ("C", 0, 5)}),
          ("decode", {0: ("B", 9, K + 1), 2: ("A", 16, K + 1)})]


def _layout(profile, segs, seqs, stride):
    """Numpy packed inputs: decode slot s at s * stride, prefill row r at
    MAX_SLOTS * stride + r * CHUNK (the decode-only profile has no rows)."""
    mixed = profile == "mixed"
    n_segs = MAX_SLOTS + ROWS if mixed else MAX_SLOTS
    q_start = np.concatenate([np.arange(MAX_SLOTS) * stride,
                              MAX_SLOTS * stride
                              + np.arange(ROWS) * CHUNK])[:n_segs]
    t = MAX_SLOTS * stride + (ROWS * CHUNK if mixed else 0)
    a = dict(tokens=np.zeros((t,), np.int32),
             positions=np.zeros((t,), np.int32),
             q_start=q_start.astype(np.int32),
             q_len=np.zeros((n_segs,), np.int32),
             kv_len=np.zeros((n_segs,), np.int32),
             page_table=np.zeros((n_segs, MAX_SEQ // PS), np.int32))
    for seg, (req, lo, w) in segs.items():
        qs = q_start[seg]
        a["tokens"][qs:qs + w] = seqs[req][lo:lo + w]
        a["positions"][qs:qs + w] = np.arange(lo, lo + w)
        a["q_len"][seg] = w
        a["kv_len"][seg] = lo + w
        a["page_table"][seg, :len(PAGES[req])] = PAGES[req]
    statics = dict(max_q=max(CHUNK, stride) if mixed else stride,
                   n_decode=MAX_SLOTS if mixed else 0, decode_q=stride)
    return a, statics


def _segs(cls, a, statics, to):
    return cls(q_start=to(a["q_start"]), q_len=to(a["q_len"]),
               kv_len=to(a["kv_len"]), page_table=to(a["page_table"]),
               **statics)


@pytest.mark.parametrize("arch", ["minitron-8b", "deepseek-moe-16b"])
def test_verify_step_matches_jax(arch):
    """Per-position window logits, per-segment logits and the pools equal
    the JAX ``verify_step``'s; the lengths are left as they were."""
    p = _pair(arch)
    jmodel, params, tmodel = p["jmodel"], p["params"], p["target"]
    rng = np.random.default_rng(3)
    seqs = {r: rng.integers(0, p["spec"].vocab, size=24).astype(np.int32)
            for r in PAGES}
    jmodel = dataclasses.replace(jmodel, ctx=jmodel.ctx.with_(
        cache_layout="paged", kv_page_size=PS))
    jcache = jmodel.init_cache(MAX_SLOTS, MAX_SEQ, layout="paged",
                               n_pages=N_PAGES)
    tcache = tmodel.init_cache(MAX_SLOTS, MAX_SEQ, page_size=PS,
                               n_pages=N_PAGES)
    junified = jax.jit(jmodel.unified_step)
    jverify = jax.jit(jmodel.verify_step,
                      static_argnames=("n_decode", "width"))
    for segs in PREFILL:
        a, st_ = _layout("mixed", segs, seqs, 1)
        _, jcache = junified(
            params, jcache, jnp.asarray(a["tokens"]),
            jnp.asarray(a["positions"]), _segs(JaxPackedSegs, a, st_,
                                               jnp.asarray))
        tmodel.unified_step(tcache, torch.from_numpy(a["tokens"]),
                            torch.from_numpy(a["positions"]),
                            _segs(PackedSegs, a, st_, torch.from_numpy))
    live_pages = sorted(q for ps in PAGES.values() for q in ps)
    for profile, segs in VERIFY:
        a, st_ = _layout(profile, segs, seqs, K + 1)
        before = tcache.lengths.clone()
        jdec, jseg, jcache = jverify(
            params, jcache, jnp.asarray(a["tokens"]),
            jnp.asarray(a["positions"]),
            _segs(JaxPackedSegs, a, st_, jnp.asarray), n_decode=MAX_SLOTS,
            width=K + 1)
        tdec, tseg, out = tmodel.verify_step(
            tcache, torch.from_numpy(a["tokens"]),
            torch.from_numpy(a["positions"]),
            _segs(PackedSegs, a, st_, torch.from_numpy), n_decode=MAX_SLOTS,
            width=K + 1)
        assert out is tcache and tdec.shape == (MAX_SLOTS, K + 1,
                                                 p["spec"].vocab)
        for seg, (_, _, w) in segs.items():
            if seg < MAX_SLOTS:
                np.testing.assert_allclose(
                    tdec.numpy()[seg, :w], np.asarray(jdec)[seg, :w],
                    atol=LOGITS_ATOL, rtol=0)
        live = sorted(segs)
        np.testing.assert_allclose(tseg.numpy()[live],
                                   np.asarray(jseg)[live],
                                   atol=LOGITS_ATOL, rtol=0)
        assert torch.equal(tcache.lengths, before)
        np.testing.assert_array_equal(tcache.lengths.numpy(),
                                      np.asarray(jcache.lengths))
        for i, layer in enumerate(tcache.layers):
            jl = jcache.layers["pos0"]
            for name in ("k", "v"):
                np.testing.assert_allclose(
                    getattr(layer, name).numpy()[live_pages],
                    np.asarray(getattr(jl, name))[i][live_pages],
                    atol=POOL_ATOL, rtol=0, err_msg=f"{profile} {name}{i}")


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _prompts(vocab, n, seed=0, lo=3, hi=14):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, vocab, size=rng.integers(lo,
                                                                      hi))]
            for _ in range(n)]


def _cfg(cls, n_spec=K, **kw):
    base = dict(max_slots=3, max_seq=96, chunk_size=4, prefill_rows=2,
                cache_layout="paged", page_size=8, unified=True,
                n_spec=n_spec, debug_guards=True)
    base.update(kw)
    return cls(**base)


def _port_engine(arch, draft, n_spec=K, graphs=True, **kw):
    p = _pair(arch)
    d = {"self": p["target"], "perturbed": p["draft"], None: None}[draft]
    return ServeEngine(p["target"], _cfg(EngineConfig, n_spec, **kw),
                       device="cpu", graphs=graphs, draft_model=d)


def _jax_engine(arch, draft, **kw):
    p = _pair(arch)
    d_params = p["params"] if draft == "self" else p["d_params"]
    return JaxServeEngine(p["jmodel"], p["params"], _cfg(JaxEngineConfig,
                                                         **kw),
                          rng=jax.random.key(11), draft_model=p["jmodel"],
                          draft_params=d_params)


def _serve(eng, cls, prompts, max_new, **kw):
    reqs = eng.serve([cls(prompt=list(q), max_new_tokens=max_new, **kw)
                      for q in prompts])
    assert all(r.state == "done" for r in reqs)
    return reqs


# each case: (arch, draft, prompts (seed, n, lo, hi), max_new, config);
# run once per module in both packages
CASES = {
    "self": ("minitron-8b", "self", (1, 5, 3, 14), 10, {}),
    "perturbed": ("minitron-8b", "perturbed", (1, 5, 3, 14), 10, {}),
    "tight_self": ("minitron-8b", "self", (5, 3, 6, 12), 40, dict(
        max_seq=64, prefill_rows=1, n_pages=13)),
    "tight_perturbed": ("minitron-8b", "perturbed", (5, 3, 6, 12), 40, dict(
        max_seq=64, prefill_rows=1, n_pages=13)),
    "moe_self": ("deepseek-moe-16b", "self", (2, 4, 3, 14), 10, {}),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    """(JAX engine, its requests, port engine, its requests, port spec-off
    outputs) of one case."""
    arch, draft, (seed, n, lo, hi), max_new, kw = CASES[name]
    prompts = _prompts(_pair(arch)["spec"].vocab, n, seed, lo, hi)
    jeng = _jax_engine(arch, draft, **kw)
    jreqs = _serve(jeng, JaxRequest, prompts, max_new)
    teng = _port_engine(arch, draft, **kw)
    treqs = _serve(teng, Request, prompts, max_new)
    off = _serve(_port_engine(arch, None, n_spec=0, **kw), Request, prompts,
                 max_new)
    return jeng, jreqs, teng, treqs, [r.output for r in off]


def _assert_same(jeng, jreqs, teng, treqs):
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    for name in COUNTERS:
        assert getattr(teng.metrics, name) == getattr(jeng.metrics, name), \
            name
    assert teng.metrics.summary(treqs).keys() \
        == jeng.metrics.summary(jreqs).keys()
    teng.pager.check()


@pytest.mark.parametrize("name", list(CASES))
def test_spec_engine_matches_jax(name):
    """Outputs and every counter equal the JAX spec engine's; greedy
    outputs equal the port's spec-off engine's; one dispatch and one
    transfer per step; each spec profile bound once."""
    jeng, jreqs, teng, treqs, off = _case(name)
    _assert_same(jeng, jreqs, teng, treqs)
    assert [r.output for r in treqs] == off
    m = teng.metrics
    assert m.dispatches == m.transfers_d2h == m.steps > 0
    assert m.spec_rounds > 0
    assert teng._graphs.captures == {"spec/mixed": 1, "spec/decode": 1}
    if name.startswith("tight"):
        assert m.preemptions > 0  # the pool really was too small


@pytest.mark.parametrize("name", ["self", "tight_self", "moe_self"])
def test_self_draft_accepts_everything(name):
    """Draft == target at temperature 0: every draft equals the target
    argmax, so every window fully accepts and earns its bonus token."""
    _, _, teng, treqs, _ = _case(name)
    m = teng.metrics
    assert m.spec_acceptance_rate == 1.0
    assert m.spec_bonus == m.spec_slot_rounds
    assert m.spec_accepted == m.spec_proposed
    if name == "self":  # roomy max_seq: every window is K+1 wide
        assert m.spec_tokens_per_round == K + 1
        assert m.spec_proposed == K * m.spec_slot_rounds
    s = m.summary(treqs)
    assert s["spec_acceptance_rate"] == 1.0
    assert sum(a for a, _ in m.spec_by_slot.values()) == m.spec_accepted


def test_perturbed_draft_accepts_and_rejects():
    _, _, teng, _, _ = _case("perturbed")
    assert 0.0 < teng.metrics.spec_acceptance_rate < 1.0


def test_prefix_fork_copies_both_pools():
    """A full prefix-cache hit forks its tail page in the target and the
    draft pool (one dispatch); with the shared original then set to 1e9 in
    every layer of both pools, the self-draft still accepts every draft
    and the outputs equal the first request's, in both packages, with
    every counter equal."""
    prompt = list(range(1, 17))  # 2 pages of 8
    kw = dict(max_slots=2, max_seq=64, chunk_size=8, prefill_rows=1,
              prefix_cache=True)
    out = {}
    for name in ("jax", "port"):
        eng = (_jax_engine("minitron-8b", "self", **kw) if name == "jax"
               else _port_engine("minitron-8b", "self", **kw))
        cls = JaxRequest if name == "jax" else Request
        [r1] = _serve(eng, cls, [prompt], 10)
        shared, n_cached = eng.prefix.lookup(prompt)
        assert n_cached == 16 and len(shared) == 2
        r2 = cls(prompt=list(prompt), max_new_tokens=10)
        eng.submit(r2)
        eng.step()  # admission: the hit and the fork in both pools
        assert eng.metrics.prefix_cow_forks == 1
        assert shared[1] not in eng.pager.owned(r2.rid)
        if name == "jax":
            spec = eng.speculator
            for holder, attr in ((eng, "cache"), (spec, "d_cache")):
                c = getattr(holder, attr)
                setattr(holder, attr, c.__class__(
                    layers=jax.tree.map(lambda a: a.at[:, shared[1]].set(
                        1e9), c.layers),
                    lengths=c.lengths, page_table=c.page_table))
        else:
            for cache in (eng.cache, eng.speculator.d_cache):
                for layer in cache.layers:
                    layer.k[shared[1]] = 1e9
                    layer.v[shared[1]] = 1e9
        while r2.state != "done":
            eng.step()
        assert r2.output == r1.output
        assert eng.metrics.spec_acceptance_rate == 1.0
        m = eng.metrics
        assert m.dispatches == m.steps + m.prefix_cow_forks
        assert m.transfers_d2h == m.steps
        out[name] = eng, [r1, r2]
    _assert_same(*out["jax"], *out["port"])


@pytest.mark.parametrize("graphs", [False, True], ids=["eager", "graphs"])
def test_eager_and_step_graph_paths_agree(graphs):
    """The port alone: the spec engine on the eager path and through
    ``StepGraph`` (eager on the CPU, on the very static tensors a capture
    binds) gives the JAX engine's outputs; each profile bound once."""
    jeng, jreqs, _, _, _ = _case("perturbed")
    prompts = [r.prompt for r in jreqs]
    eng = _port_engine("minitron-8b", "perturbed", graphs=graphs)
    reqs = _serve(eng, Request, prompts, 10)
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    assert eng.metrics.spec_by_slot == jeng.metrics.spec_by_slot
    assert eng._graphs.captures == {"spec/mixed": 1, "spec/decode": 1}


def test_stochastic_sampling_runs_clean():
    """Temperature > 0 slots ride the same round (device-side rejection
    sampling with the engine's generator): every request finishes with its
    tokens in the vocabulary and the counters add up."""
    p = _pair("minitron-8b")
    eng = _port_engine("minitron-8b", "perturbed")
    reqs = _serve(eng, Request, _prompts(p["spec"].vocab, 4, seed=4), 8,
                  sampling=SamplingConfig(temperature=0.9, top_k=40))
    assert all(len(r.output) == 8 for r in reqs)
    assert all(0 <= t < p["spec"].vocab for r in reqs for t in r.output)
    m = eng.metrics
    assert 0 < m.spec_accepted <= m.spec_proposed
    assert m.spec_emitted == m.spec_accepted + m.spec_slot_rounds
    assert m.dispatches == m.transfers_d2h == m.steps


def test_summary_has_spec_block_only_when_speculating():
    _, _, teng, treqs, _ = _case("self")
    s = teng.metrics.summary(treqs)
    assert s["spec_tokens_per_round"] == K + 1
    assert s["spec_bonus"] == teng.metrics.spec_slot_rounds
    assert set(s["spec_by_slot"]) == set(teng.metrics.spec_by_slot)
    off = _port_engine("minitron-8b", None, n_spec=0)
    reqs = _serve(off, Request, [[1, 2, 3]], 3)
    assert "spec_acceptance_rate" not in off.metrics.summary(reqs)


# ---------------------------------------------------------------------------
# the batch-1 oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("draft", ["self", "perturbed"])
def test_speculative_decoder_matches_jax(draft):
    """At temperature 0 the batch-1 oracle gives the JAX oracle's tokens
    and stats, and the port engine's greedy outputs."""
    p = _pair("minitron-8b")
    tdraft = p["target"] if draft == "self" else p["draft"]
    jd = p["params"] if draft == "self" else p["d_params"]
    prompt = [5, 9, 2, 17, 33, 4]
    ours = SpeculativeDecoder(p["target"], tdraft, n_spec=K, max_seq=64,
                              temperature=0.0)
    ref = JaxSpeculativeDecoder(p["jmodel"], p["params"], p["jmodel"], jd,
                                n_spec=K, max_seq=64, temperature=0.0)
    got = ours.generate(prompt, 12)
    assert got == ref.generate(prompt, 12)
    assert vars(ours.stats) == vars(ref.stats)
    greedy = _serve(_port_engine("minitron-8b", None, n_spec=0), Request,
                    [prompt], 12)[0].output
    assert got == greedy
    if draft == "self":
        assert ours.stats.acceptance_rate == 1.0


def test_speculative_decoder_stochastic_is_seeded():
    """At temperature 1 the perturbed draft's rounds are drawn from the
    decoder's seeded generator: one seed gives one stream, every token is
    in the vocabulary and the stats add up."""
    p = _pair("minitron-8b")
    prompt = [5, 9, 2, 17, 33, 4]
    runs = []
    for _ in range(2):
        sd = SpeculativeDecoder(p["target"], p["draft"], n_spec=K,
                                max_seq=64, temperature=1.0, seed=3)
        runs.append((sd.generate(prompt, 12), vars(sd.stats)))
    assert runs[0] == runs[1]
    toks, stats = runs[0]
    assert len(toks) == 12
    assert all(0 <= t < p["target"].spec.vocab for t in toks)
    assert 0 <= stats["accepted"] <= stats["proposed"]
    assert stats["proposed"] == K * stats["target_passes"]


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,draft,match", [
    (dict(unified=False), "self", "n_spec > 0 requires unified=True"),
    ({}, None, "n_spec > 0 needs draft_model"),
    (dict(n_spec=0), "self", "draft_model given but n_spec == 0"),
], ids=["two-dispatch", "no-draft", "draft-without-n_spec"])
def test_engine_config_refusals(kw, draft, match):
    """The reference's ValueErrors, in the reference's order."""
    p = _pair("minitron-8b")
    cfg = _cfg(EngineConfig, **{"n_spec": 2, **kw})
    d = p["target"] if draft else None
    with pytest.raises(ValueError, match=match):
        ServeEngine(p["target"], cfg, device="cpu", draft_model=d)
    jcfg = _cfg(JaxEngineConfig, **{"n_spec": 2, **kw})
    with pytest.raises(ValueError, match=match):
        JaxServeEngine(p["jmodel"], p["params"], jcfg,
                       draft_model=p["jmodel"] if draft else None,
                       draft_params=p["params"] if draft else None)


@pytest.mark.parametrize("arch,extra_vocab,match", [
    ("qwen1.5-0.5b", 1, "draft vocab"),
    ("rwkv6-3b", 0, "SSM layers"),
    ("mistral-7b-swa", 0, "sliding-window"),
], ids=["vocab", "ssm", "swa"])
def test_speculator_refuses_unfit_drafts(arch, extra_vocab, match):
    """A draft of another vocabulary, with SSM layers or a sliding window
    is refused with the reference's ValueError."""
    target = _pair("minitron-8b")["target"]
    spec = treg.get_reduced(arch).scaled(
        vocab=target.spec.vocab + extra_vocab)
    draft = build_model(spec, device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match=match):
        PackedSpeculator(target, draft, n_spec=K, max_slots=2, max_seq=64,
                         chunk_size=8, prefill_rows=1, page_size=8,
                         n_pages=17)
