"""Port parity of the RWKV-6 slice: the WKV scan, the RWKV-6 block, the
converter, the model's two-dispatch steps and both two-dispatch engines of
``repro_torch`` against the JAX package, at ``rwkv6-3b-reduced`` widths
(d_model 64, 4 heads of 16, 2 layers) on the CPU.

Inputs are made from numpy seeds and handed to both frameworks.  The
reference's init leaves the token-shift mixes (``maa_*``, ``cm_maa_*``) and
the bonus ``u_bonus`` at zero, which would exercise neither the token shift
nor the bonus term, so every parameter tree here draws them from a seed
(mixes uniform in [0, 1), bonus N(0, 0.5^2)) and gives the same tree to
both packages.  The port runs its plain scan here (the Hopper kernel needs
the card); JAX runs its sequential reference, or the Pallas kernel in
interpret mode where named.

Tolerances, with their reasons:

* float32 scan against the JAX oracle: atol 1e-5 (the same f32 recurrence,
  einsum sums over N = 16 in another order);
* against the Pallas kernel: atol 2e-3, rtol 1e-3, the reference's own
  tolerance for that kernel (``tests/test_kernels.py``), since its wrapper
  folds a non-zero state in afterwards through a cumulative product of the
  decays; in bfloat16 the same plus one bf16 ulp, as that wrapper rounds
  its zero-state output to bf16 before adding the fold;
* bfloat16 r/k/v (f32 w, u and state) against the JAX oracle: out within
  one bf16 ulp (2^-7 |want|) plus 1e-5 (both compute in f32 from the same
  bf16 values and round once), the f32 final state within 1e-5;
* block, model and engine steps in float32: atol 1e-5 on outputs and
  states, 1e-4 on logits (two layers and the head);
* engines: greedy outputs token-identical, the scheduler's counters equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.kernels import ref as jref
from repro.kernels.ssm_scan import pallas_rwkv6_scan
from repro.models import build_model as jax_build_model
from repro.models.common import KeyGen, ModelContext
from repro.models.model import ModelCache as JaxModelCache
from repro.models.ssm import RWKVCache as JaxRWKVCache
from repro.models.ssm import init_rwkv6 as jax_init_rwkv6
from repro.models.ssm import rwkv6_block as jax_rwkv6_block
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import Request as JaxRequest
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch.configs import registry as treg
from repro_torch.kernels import ops as tops
from repro_torch.models import build_model, from_jax_params
from repro_torch.models.attention import PackedSegs
from repro_torch.models.ssm import MIXES, RWKV6, RWKVCache, rwkv6_block
from repro_torch.serving import EngineConfig, Request, ServeEngine

ARCH = "rwkv6-3b"
ATOL = 1e-5
LOGITS_ATOL = 1e-4
BF16_ULP = 2.0 ** -7
COUNTERS = ("steps", "preemptions", "decode_steps", "prefill_calls",
            "prefill_tokens", "generated_tokens", "dispatches",
            "transfers_d2h", "capacity_stops", "peak_active",
            "pages_in_use_peak", "kv_used_tokens_peak")


def _draw_mixes(mixer: dict, seed: int) -> dict:
    """A numpy RWKV mixer tree with the zero-initialised mixes and bonus
    drawn from ``seed`` (any leading stacked axis kept)."""
    rng = np.random.default_rng(seed)
    out = dict(mixer)
    for name in MIXES:
        out[name] = rng.uniform(0.0, 1.0, np.shape(mixer[name])
                                ).astype(np.float32)
    out["u_bonus"] = (0.5 * rng.standard_normal(np.shape(mixer["u_bonus"]))
                      ).astype(np.float32)
    return out


# ---------------------------------------------------------------------------
# the WKV scan
# ---------------------------------------------------------------------------

def _scan_case(b, t, h, n, seed):
    """r, k, v ~ N(0, 0.25), decays in (0.45, 0.95) as the reference's
    kernel test draws them, u ~ N(0, 0.09), state0 ~ N(0, 0.04)."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((b, t, h, n)) for _ in range(3))
    w = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, t, h, n)))) * 0.5 + 0.45
    u = 0.3 * rng.standard_normal((h, n))
    s0 = 0.2 * rng.standard_normal((b, h, n, n))
    return [x.astype(np.float32) for x in (r, k, v, w, u, s0)]


def _as_bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16 and widened back, as numpy has no bf16."""
    return torch.from_numpy(x).bfloat16().float().numpy()


# (B, T, H, N, Pallas chunk): T off the chunk, a single decode step, and
# the reduced config's head size
SCAN_CASES = [(2, 37, 3, 8, 16), (3, 1, 2, 16, 8), (1, 48, 4, 16, 32)]


@pytest.mark.parametrize("case", SCAN_CASES, ids=lambda c: "x".join(map(
    str, c[:4])))
def test_plain_scan_matches_jax_oracle_f32(case):
    b, t, h, n, _ = case
    args = _scan_case(b, t, h, n, seed=t)
    want_o, want_s = jref.rwkv6_reference(*map(jnp.asarray, args))
    got_o, got_s = tops.rwkv6_scan(*map(torch.from_numpy, args))
    assert got_o.dtype == torch.float32 and got_s.dtype == torch.float32
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("case", SCAN_CASES, ids=lambda c: "x".join(map(
    str, c[:4])))
def test_plain_scan_matches_jax_oracle_bf16(case):
    """bf16 r, k, v with f32 w, u and state, as the model feeds the scan."""
    b, t, h, n, _ = case
    r, k, v, w, u, s0 = _scan_case(b, t, h, n, seed=t + 1)
    jo, js = jref.rwkv6_reference(
        *(jnp.asarray(x, jnp.bfloat16) for x in (r, k, v)),
        jnp.asarray(w), jnp.asarray(u), jnp.asarray(s0))
    to, ts = tops.rwkv6_scan(
        *(torch.from_numpy(x).bfloat16() for x in (r, k, v)),
        torch.from_numpy(w), torch.from_numpy(u), torch.from_numpy(s0))
    assert to.dtype == torch.bfloat16 and ts.dtype == torch.float32
    want = np.asarray(jo, np.float32)
    assert np.all(np.abs(to.float().numpy() - want)
                  <= BF16_ULP * np.abs(want) + ATOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SCAN_CASES, ids=lambda c: "x".join(map(
    str, c[:4])))
def test_plain_scan_matches_pallas_interpret(case, dtype):
    """A non-zero state0, folded in by the Pallas wrapper and carried by
    the port's recurrence; T off the Pallas chunk where the case says."""
    b, t, h, n, chunk = case
    r, k, v, w, u, s0 = _scan_case(b, t, h, n, seed=t + 2)
    if dtype == "bfloat16":
        r, k, v = (_as_bf16(x) for x in (r, k, v))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jo, js = pallas_rwkv6_scan(*(jnp.asarray(x, jdt) for x in (r, k, v)),
                               jnp.asarray(w), jnp.asarray(u),
                               jnp.asarray(s0), chunk=chunk, interpret=True)
    tdt = getattr(torch, dtype)
    to, ts = tops.rwkv6_scan(*(torch.from_numpy(x).to(tdt)
                               for x in (r, k, v)),
                             torch.from_numpy(w), torch.from_numpy(u),
                             torch.from_numpy(s0))
    want = np.asarray(jo, np.float32)
    ulp = BF16_ULP * np.abs(want) if dtype == "bfloat16" else 0.0
    assert np.all(np.abs(to.float().numpy() - want)
                  <= 2e-3 + 1e-3 * np.abs(want) + ulp)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-3,
                               rtol=1e-3)


def test_scan_impl_plain_equals_default_on_cpu():
    args = [torch.from_numpy(x) for x in _scan_case(1, 5, 2, 8, seed=3)]
    a = tops.rwkv6_scan(*args)
    b = tops.rwkv6_scan(*args, impl="plain")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="unknown rwkv6 scan impl"):
        tops.rwkv6_scan(*args, impl="pallas")


@pytest.mark.parametrize("case", SCAN_CASES, ids=lambda c: "x".join(map(
    str, c[:4])))
def test_scan_state_out_in_place(case):
    """``state_out`` receives the final state, also when it is state0's
    own buffer (the engine's decode updates its cache so); the output is
    unchanged."""
    b, t, h, n, _ = case
    args = [torch.from_numpy(x) for x in _scan_case(b, t, h, n, seed=t + 3)]
    want_o, want_s = tops.rwkv6_scan(*args)
    state = args[5].clone()
    got_o, got_s = tops.rwkv6_scan(*args[:5], state, state_out=state)
    assert got_s is state
    assert torch.equal(got_o, want_o) and torch.equal(state, want_s)


# ---------------------------------------------------------------------------
# the RWKV-6 block with a cache
# ---------------------------------------------------------------------------

def test_block_with_cache_matches_jax():
    """Two calls of the block on one cache (5 tokens, then 1), each against
    the JAX block: outputs and all three cache tensors."""
    jspec, tspec = jreg.get_reduced(ARCH), treg.get_reduced(ARCH)
    ctx = ModelContext(spec=jspec, param_dtype=jnp.float32,
                       compute_dtype=jnp.float32)
    jparams = jax_init_rwkv6(jspec, KeyGen(jax.random.key(0)), jnp.float32)
    tree = _draw_mixes(jax.tree.map(np.asarray, jparams), seed=1)
    jparams = jax.tree.map(jnp.asarray, tree)
    mod = RWKV6(tspec, "cpu", torch.float32)
    mod.load_state_dict({k: torch.tensor(np.asarray(v))
                         for k, v in tree.items()})
    b, d = 3, jspec.d_model
    nh, hs = d // jspec.ssm.head_size, jspec.ssm.head_size
    rng = np.random.default_rng(2)
    tm = rng.standard_normal((b, 1, d)).astype(np.float32)
    cm = rng.standard_normal((b, 1, d)).astype(np.float32)
    s0 = (0.2 * rng.standard_normal((b, nh, hs, hs))).astype(np.float32)
    jcache = JaxRWKVCache(tm_shift=jnp.asarray(tm), cm_shift=jnp.asarray(cm),
                          wkv=jnp.asarray(s0))
    tcache = RWKVCache(*(torch.from_numpy(x.copy()) for x in (tm, cm, s0)))
    for t in (5, 1):
        x = rng.standard_normal((b, t, d)).astype(np.float32)
        jy, jcache = jax_rwkv6_block(jspec, ctx, jparams, jnp.asarray(x),
                                     jcache)
        ty = rwkv6_block(tspec, mod, torch.from_numpy(x), tcache)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL,
                                   rtol=0)
        for name in ("tm_shift", "cm_shift", "wkv"):
            np.testing.assert_allclose(getattr(tcache, name).numpy(),
                                       np.asarray(getattr(jcache, name)),
                                       atol=ATOL, rtol=0, err_msg=name)


def test_block_keeps_f32_decay_params_in_a_bf16_model():
    """w_bias and u_bonus stay float32 in a bf16 model, and loading a state
    dict keeps them so."""
    mod = RWKV6(treg.get_reduced(ARCH), "cpu", torch.bfloat16)
    assert mod.w_bias.dtype == torch.float32
    assert mod.u_bonus.dtype == torch.float32
    assert mod.wr.dtype == torch.bfloat16
    state = {k: v.float() + 0.1 for k, v in mod.state_dict().items()}
    mod.load_state_dict(state)
    assert mod.w_bias.dtype == torch.float32
    assert float(mod.w_bias[0]) == pytest.approx(-1.9)


# ---------------------------------------------------------------------------
# converter and model steps
# ---------------------------------------------------------------------------

def _pair(seed: int = 0):
    """JAX model + params (mixes and bonus drawn) and the port model loaded
    from the same tree (f32)."""
    jspec, tspec = jreg.get_reduced(ARCH), treg.get_reduced(ARCH)
    jmodel = jax_build_model(jspec, mesh=None, param_dtype=jnp.float32,
                             compute_dtype=jnp.float32,
                             cache_layout="paged", kv_page_size=8)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.key(seed)))
    tree["layers"]["pos0"]["mixer"] = _draw_mixes(
        tree["layers"]["pos0"]["mixer"], seed + 10)
    params = jax.tree.map(jnp.asarray, tree)
    tmodel = build_model(tspec, device="cpu", dtype=torch.float32)
    tmodel.load_state_dict(from_jax_params(tree, tspec))
    return jspec, jmodel, params, tmodel, tree


@pytest.fixture(scope="module")
def pair():
    return _pair()


def test_from_jax_params_on_an_rwkv_tree(pair):
    """Every port parameter is filled from the tree (mixer only, no ffn),
    layer i from repeat i of the stacked leaves."""
    jspec, _, _, tmodel, tree = pair
    state = from_jax_params(tree, tmodel.spec)
    assert set(state) == set(tmodel.state_dict())
    assert not any(".ffn." in name for name in state)
    assert all(layer.ffn is None for layer in tmodel.layers)
    mixer = tree["layers"]["pos0"]["mixer"]
    for i in range(jspec.n_layers):
        for name in ("maa_r", "u_bonus", "w_lora1", "cm_value"):
            np.testing.assert_array_equal(
                getattr(tmodel.layers[i].mixer, name).numpy(),
                mixer[name][i])


def _jax_states(jcache):
    jl = jcache.layers["pos0"]
    return [np.asarray(getattr(jl, n)) for n in ("tm_shift", "cm_shift",
                                                 "wkv")]


def _assert_states(tcache, jcache, rows=None):
    jstates = _jax_states(jcache)
    for i, layer in enumerate(tcache.layers):
        for name, want in zip(("tm_shift", "cm_shift", "wkv"), jstates):
            got = getattr(layer, name).numpy()
            want = want[i]
            if rows is not None:
                got, want = got[rows], want[rows]
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=0,
                                       err_msg=f"{name}{i}")


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_prefill_chunk_rows_and_decode_match_jax(pair, layout):
    """A 6-token chunk on both rows, then a 3-token chunk on row 1 alone
    (row 0 keeps its state bit for bit, as the reference's masked select
    keeps it), then two decode steps, each against JAX; the paged layout
    carries the page table and per-slot state."""
    jspec, jmodel, params, tmodel, _ = pair
    rng = np.random.default_rng(4)
    b, t = 2, 32
    kw = dict(n_pages=9) if layout == "paged" else {}
    jcache = jmodel.init_cache(b, t, layout=layout, **kw)
    tcache = tmodel.init_cache(b, t, layout=layout, page_size=8, **kw)
    assert (tcache.page_table is None) == (layout == "dense")
    jchunk = jax.jit(jmodel.prefill_chunk)
    toks = rng.integers(0, jspec.vocab, (b, 6)).astype(np.int32)
    jlogits, jcache = jchunk(params, jcache, jnp.asarray(toks))
    tlogits, tcache = tmodel.prefill_chunk(tcache, torch.from_numpy(toks))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=LOGITS_ATOL, rtol=0)
    _assert_states(tcache, jcache)

    before = [[x.clone() for x in (l.tm_shift, l.cm_shift, l.wkv)]
              for l in tcache.layers]
    toks = rng.integers(0, jspec.vocab, (b, 3)).astype(np.int32)
    jlogits, jnew = jchunk(params, jcache, jnp.asarray(toks))
    mask = jnp.asarray([False, True])
    # the reference engine's masked select (_prefill_masked)
    jcache = JaxModelCache(
        layers=jax.tree.map(
            lambda n, o: jnp.where(mask.reshape((1, 2) + (1,) * (n.ndim - 2)),
                                   n, o), jnew.layers, jcache.layers),
        lengths=jnp.where(mask, jnew.lengths, jcache.lengths),
        page_table=jcache.page_table)
    tlogits, tcache = tmodel.prefill_chunk(tcache, torch.from_numpy(toks),
                                           rows=torch.tensor([1]))
    np.testing.assert_allclose(tlogits.numpy()[1], np.asarray(jlogits)[1],
                               atol=LOGITS_ATOL, rtol=0)
    assert tcache.lengths.tolist() == [6, 9]
    for old, layer in zip(before, tcache.layers):
        for x, name in zip(old, ("tm_shift", "cm_shift", "wkv")):
            assert torch.equal(getattr(layer, name)[0], x[0]), name
            assert not torch.equal(getattr(layer, name)[1], x[1]), name
    _assert_states(tcache, jcache)

    jdecode = jax.jit(jmodel.decode_step)
    for _ in range(2):
        feed = rng.integers(0, jspec.vocab, (b, 1)).astype(np.int32)
        jlogits, jcache = jdecode(params, jcache, jnp.asarray(feed))
        tlogits, tcache = tmodel.decode_step(tcache, torch.from_numpy(feed))
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   atol=LOGITS_ATOL, rtol=0)
        np.testing.assert_array_equal(tcache.lengths.numpy(),
                                      np.asarray(jcache.lengths))
        _assert_states(tcache, jcache)


def test_unified_step_refuses_rwkv_layers(pair):
    """The packed step has no forward for state-carrying layers, as in the
    reference's stack."""
    _, _, _, tmodel, _ = pair
    cache = tmodel.init_cache(1, 16, layout="paged", page_size=8)
    z = torch.zeros(1, dtype=torch.int32)
    packed = PackedSegs(q_start=z, q_len=z + 1, kv_len=z + 1,
                        page_table=torch.ones((1, 2), dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="attention-only"):
        tmodel.unified_step(cache, z, z, packed)


# ---------------------------------------------------------------------------
# engines: the port's two-dispatch engine against the JAX engine
# ---------------------------------------------------------------------------

def _cfg(cls, **kw):
    base = dict(max_slots=4, max_seq=64, chunk_size=4, prefill_rows=2,
                page_size=8, unified=False)
    base.update(kw)
    return cls(**base)


def _prompts(vocab, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).tolist() for n in lengths]


def _serve_both(pair, prompts, max_new, **cfg_kw):
    spec, jmodel, params, tmodel, _ = pair
    jeng = JaxServeEngine(jmodel, params, _cfg(JaxEngineConfig, **cfg_kw))
    jreqs = jeng.serve([JaxRequest(prompt=list(p), max_new_tokens=m)
                        for p, m in zip(prompts, max_new)])
    teng = ServeEngine(tmodel, _cfg(EngineConfig, **cfg_kw), device="cpu")
    treqs = teng.serve([Request(prompt=list(p), max_new_tokens=m)
                        for p, m in zip(prompts, max_new)])
    assert all(r.state == "done" for r in jreqs + treqs)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    for name in COUNTERS:
        assert getattr(teng.metrics, name) == getattr(jeng.metrics, name), \
            name
    assert teng.kv_stats() == jeng.kv_stats()
    np.testing.assert_array_equal(teng.cache.lengths.numpy(),
                                  np.asarray(jeng.cache.lengths))
    if teng.paged:
        teng.pager.check()
        assert teng.pager.pages_in_use == 0  # every page freed on finish
    return jeng, teng


MIXED = ([3, 11, 4, 17, 9, 5, 23, 8, 2, 13], [6, 3, 8, 6, 1, 6, 4, 6, 7, 5])


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_two_dispatch_matches_jax_mixed_workload(pair, layout):
    """Concurrent chunked prefills of mixed widths (rows at different
    widths in one step) + decode, in each layout."""
    _, teng = _serve_both(pair, _prompts(512, MIXED[0], 4), MIXED[1],
                          cache_layout=layout)
    m = teng.metrics
    assert m.prefill_calls > 0 and m.decode_steps > 0
    assert m.dispatches > m.steps  # resets, chunks, samples, inserts


def test_two_dispatch_paged_matches_jax_under_preemption(pair):
    """A pool small enough to force victim preemption mid-decode: the pager
    reserves pages per request for an attention-free model too, and
    recompute-style resumption keeps outputs and counters identical."""
    _, teng = _serve_both(pair, _prompts(512, [13, 11, 14, 12, 9, 15], 5),
                          [10] * 6, cache_layout="paged", max_seq=32,
                          page_size=4, n_pages=11)
    assert teng.metrics.preemptions > 0


def test_default_config_serves_rwkv_and_matches_jax(pair):
    """EngineConfig() itself, the dense two-dispatch engine, with prompts
    longer than a chunk."""
    spec, jmodel, params, tmodel, _ = pair
    prompts = _prompts(512, [30, 7, 130], 6)
    jreqs = JaxServeEngine(jmodel, params, JaxEngineConfig()).serve(
        [JaxRequest(prompt=list(p), max_new_tokens=4) for p in prompts])
    teng = ServeEngine(tmodel, EngineConfig(), device="cpu")
    treqs = teng.serve([Request(prompt=list(p), max_new_tokens=4)
                        for p in prompts])
    assert not teng.unified and not teng.paged
    assert [r.output for r in treqs] == [r.output for r in jreqs]


def test_dense_and_paged_are_token_identical(pair):
    _, _, _, tmodel, _ = pair
    prompts = _prompts(512, MIXED[0], 13)
    outs = []
    for layout in ("dense", "paged"):
        eng = ServeEngine(tmodel, _cfg(EngineConfig, cache_layout=layout),
                          device="cpu")
        reqs = eng.serve([Request(prompt=list(p), max_new_tokens=m)
                          for p, m in zip(prompts, MIXED[1])])
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]


def test_unified_engine_refuses_rwkv_as_the_reference(pair):
    """unified=True with SSM layers is a limit of the reference, not an
    unported part: both packages raise ValueError."""
    _, jmodel, params, tmodel, _ = pair
    with pytest.raises(ValueError, match="attention-only stacks"):
        JaxServeEngine(jmodel, params, _cfg(JaxEngineConfig,
                                            cache_layout="paged",
                                            unified=True))
    with pytest.raises(ValueError, match="attention-only stacks"):
        ServeEngine(tmodel, _cfg(EngineConfig, cache_layout="paged",
                                 unified=True), device="cpu")
