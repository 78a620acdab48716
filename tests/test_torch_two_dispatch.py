"""Port parity of the two-dispatch engine: ``prefill_chunk``/``decode_step``
of ``repro_torch`` against the JAX ``Model`` in both layouts, and the
port's ``ServeEngine(unified=False)`` against the JAX engine.

JAX initialises the weights; the port loads them through
``from_jax_params``.  Everything is float32 on the CPU, where the port takes
its plain attention and JAX its direct one (the same arithmetic as the
Pallas kernels, which do not run here outside interpret mode).
Tolerances: logits within atol 1e-4 and caches within atol 1e-5 (float32,
sums in different orders through two layers).  Engines: greedy outputs
token-identical and the scheduler's counters equal, dispatches and
transfers included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import modelspec as jms
from repro.models import build_model as jax_build_model
from repro.models.attention import AttnCache as JaxAttnCache
from repro.models.attention import PagedAttnCache as JaxPagedAttnCache
from repro.models.attention import paged_insert_rows as jax_paged_insert_rows
from repro.models.model import ModelCache as JaxModelCache
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import Request as JaxRequest
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch.configs import registry as treg
from repro_torch.core import modelspec as tms
from repro_torch.models import build_model, from_jax_params
from repro_torch.models.attention import paged_insert_rows
from repro_torch.models.model import ModelCache
from repro_torch.serving import EngineConfig, Request, ServeEngine

LOGITS_ATOL = 1e-4
CACHE_ATOL = 1e-5
TINY = dict(name="tiny", d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_head=16, d_ff=128, vocab=256)
COUNTERS = ("steps", "preemptions", "decode_steps", "prefill_calls",
            "prefill_tokens", "generated_tokens", "dispatches",
            "transfers_d2h", "capacity_stops", "peak_active",
            "pages_in_use_peak", "kv_used_tokens_peak")


def _pair(arch: str, seed: int = 0):
    """JAX model + params, and the port model loaded from them (f32)."""
    if arch == "tiny":
        jspec = jms.ModelSpec(**TINY, attn=jms.AttnSpec())
        tspec = tms.ModelSpec(**TINY, attn=tms.AttnSpec())
    else:
        jspec, tspec = jreg.get_reduced(arch), treg.get_reduced(arch)
    jmodel = jax_build_model(jspec, mesh=None, param_dtype=jnp.float32,
                             compute_dtype=jnp.float32,
                             cache_layout="paged", kv_page_size=4)
    params = jmodel.init(jax.random.key(seed))
    tmodel = build_model(tspec, device="cpu", dtype=torch.float32)
    tmodel.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params),
                                           tspec))
    return jspec, jmodel, params, tmodel


@pytest.fixture(scope="module")
def tiny():
    return _pair("tiny")


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# model: prefill_chunk and decode_step in both layouts
# ---------------------------------------------------------------------------

B, T, PS = 3, 32, 4


def _assert_dense_cache(tcache, jcache):
    np.testing.assert_array_equal(tcache.lengths.numpy(), _np(jcache.lengths))
    jl = jcache.layers["pos0"]
    for i, layer in enumerate(tcache.layers):
        for name in ("k", "v"):
            np.testing.assert_allclose(getattr(layer, name).numpy(),
                                       _np(getattr(jl, name))[i],
                                       atol=CACHE_ATOL, rtol=0,
                                       err_msg=f"{name}{i}")


@pytest.mark.parametrize("arch", ["tiny", "mistral-7b-swa"])
def test_dense_prefill_chunk_and_decode_match_jax(arch):
    """Two chunks (5 then 27 tokens: mistral's contexts pass its window of
    24) and two decode steps on a dense cache; the second decode has one
    row past the cache (its write clamps to the last position)."""
    jspec, jmodel, params, tmodel = _pair(arch)
    rng = np.random.default_rng(1)
    jcache = jmodel.init_cache(B, T, layout="dense")
    tcache = tmodel.init_cache(B, T, layout="dense")
    jchunk = jax.jit(jmodel.prefill_chunk)
    jdecode = jax.jit(jmodel.decode_step)
    for w in (5, 27):
        toks = rng.integers(0, jspec.vocab, size=(B, w)).astype(np.int32)
        jlogits, jcache = jchunk(params, jcache, jnp.asarray(toks))
        tlogits, tcache = tmodel.prefill_chunk(tcache, torch.from_numpy(toks))
        np.testing.assert_allclose(tlogits.numpy(), _np(jlogits),
                                   atol=LOGITS_ATOL, rtol=0)
        _assert_dense_cache(tcache, jcache)
    for step in range(2):
        if step == 1:  # row 2 runs past the cache, as an idle slot does
            over = jnp.asarray([32, 32, T + 7], jnp.int32)
            jcache = JaxModelCache(layers=jcache.layers, lengths=over)
            tcache = ModelCache(layers=tcache.layers,
                                lengths=torch.from_numpy(np.array(over)))
        toks = rng.integers(0, jspec.vocab, size=(B, 1)).astype(np.int32)
        jlogits, jcache = jdecode(params, jcache, jnp.asarray(toks))
        tlogits, tcache = tmodel.decode_step(tcache, torch.from_numpy(toks))
        np.testing.assert_allclose(tlogits.numpy(), _np(jlogits),
                                   atol=LOGITS_ATOL, rtol=0)
        _assert_dense_cache(tcache, jcache)


def test_prefill_chunk_rows_keep_the_others_bit_for_bit(tiny):
    """The masked chunk writes only the named rows: the other row's K/V and
    length are untouched, and the named row equals an unmasked run."""
    _, _, _, tmodel = tiny
    rng = np.random.default_rng(2)
    cache = tmodel.init_cache(2, T, layout="dense")
    _, cache = tmodel.prefill_chunk(
        cache, torch.from_numpy(rng.integers(0, 256, (2, 6))))
    before = [(layer.k.clone(), layer.v.clone()) for layer in cache.layers]
    lengths = cache.lengths.clone()
    toks = torch.from_numpy(rng.integers(0, 256, (2, 3)))
    _, masked = tmodel.prefill_chunk(cache, toks,
                                     rows=torch.tensor([1]))
    assert masked.lengths.tolist() == [lengths[0].item(),
                                       lengths[1].item() + 3]
    for (k0, v0), layer in zip(before, masked.layers):
        assert torch.equal(layer.k[0], k0[0]) and torch.equal(layer.v[0],
                                                              v0[0])
        assert not torch.equal(layer.k[1], k0[1])
    ref = tmodel.init_cache(2, T, layout="dense")
    for layer, (k0, v0) in zip(ref.layers, before):
        layer.k.copy_(k0)
        layer.v.copy_(v0)
    _, full = tmodel.prefill_chunk(ModelCache(ref.layers, lengths), toks)
    for a, b in zip(masked.layers, full.layers):
        assert torch.equal(a.k[1], b.k[1])


def test_paged_insert_and_decode_match_jax(tiny):
    """Prefill on a dense scratch, scatter each row into its pages (the
    0-padded tail onto the null page), then paged decode through the page
    table, one slot idle on the null page past max_seq."""
    jspec, jmodel, params, tmodel = tiny
    rng = np.random.default_rng(3)
    mp, n_pages = T // PS, 16
    prompts = (9, 14)
    toks = rng.integers(0, jspec.vocab, size=(2, max(prompts))
                        ).astype(np.int32)
    # the 2-row scratch: one 14-token chunk per row; row 0's prompt is its
    # first 9 tokens (the rest is masked by its length below)
    jscr = jmodel.init_cache(2, T, layout="dense")
    tscr = tmodel.init_cache(2, T, layout="dense")
    _, jscr = jax.jit(jmodel.prefill_chunk)(params, jscr, jnp.asarray(toks))
    _, tscr = tmodel.prefill_chunk(tscr, torch.from_numpy(toks))
    ptab = np.zeros((B, mp), np.int32)
    ptab[0, :3] = [5, 2, 9]  # row 0: 9 tokens + headroom
    ptab[1, :4] = [1, 12, 7, 3]  # row 1: 14 tokens + headroom
    jcache = jmodel.init_cache(B, T, layout="paged", n_pages=n_pages)
    tcache = tmodel.init_cache(B, T, layout="paged", page_size=PS,
                               n_pages=n_pages)
    jl, js = jcache.layers["pos0"], jscr.layers["pos0"]
    jk, jv = [], []
    for i, (tl, sl) in enumerate(zip(tcache.layers, tscr.layers)):
        jpaged = JaxPagedAttnCache(k=jl.k[i], v=jl.v[i])
        jdense = JaxAttnCache(k=js.k[i], v=js.v[i])
        for slot in (0, 1):
            jpaged = jax_paged_insert_rows(jpaged, jdense, slot,
                                           jnp.asarray(ptab[slot]))
            paged_insert_rows(tl, sl, slot, torch.from_numpy(ptab[slot]))
        jk.append(jpaged.k)
        jv.append(jpaged.v)
    live = sorted(int(p) for p in ptab.ravel() if p)
    lengths = np.asarray([prompts[0], prompts[1], T + 5], np.int32)
    jcache = JaxModelCache(
        layers={"pos0": JaxPagedAttnCache(k=jnp.stack(jk),
                                          v=jnp.stack(jv))},
        lengths=jnp.asarray(lengths), page_table=jnp.asarray(ptab))
    tcache = ModelCache(layers=tcache.layers,
                        lengths=torch.from_numpy(lengths),
                        page_table=torch.from_numpy(ptab))
    jdecode = jax.jit(jmodel.decode_step)
    for _ in range(2):
        feed = rng.integers(0, jspec.vocab, size=(B, 1)).astype(np.int32)
        jlogits, jcache = jdecode(params, jcache, jnp.asarray(feed))
        tlogits, tcache = tmodel.decode_step(tcache, torch.from_numpy(feed))
        np.testing.assert_allclose(tlogits.numpy()[:2], _np(jlogits)[:2],
                                   atol=LOGITS_ATOL, rtol=0)
        np.testing.assert_array_equal(tcache.lengths.numpy(),
                                      _np(jcache.lengths))
        jl = jcache.layers["pos0"]
        for i, layer in enumerate(tcache.layers):
            for name in ("k", "v"):
                np.testing.assert_allclose(
                    getattr(layer, name).numpy()[live],
                    _np(getattr(jl, name))[i][live], atol=CACHE_ATOL,
                    rtol=0, err_msg=f"{name}{i}")


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
    spec, jmodel, params, tmodel = pair
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
                                  _np(jeng.cache.lengths))
    if teng.paged:
        teng.pager.check()
        assert teng.pager.pages_in_use == 0  # every page freed on finish
    return jeng, teng


MIXED = ([3, 11, 4, 17, 9, 5, 23, 8, 2, 13], [6, 3, 8, 6, 1, 6, 4, 6, 7, 5])


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_two_dispatch_matches_jax_mixed_workload(tiny, layout):
    """Concurrent chunked prefills of mixed widths + decode."""
    _, teng = _serve_both(tiny, _prompts(256, MIXED[0], 4), MIXED[1],
                          cache_layout=layout)
    m = teng.metrics
    assert m.prefill_calls > 0 and m.decode_steps > 0
    assert m.dispatches > m.steps  # resets, chunks, samples, inserts


def test_default_config_serves_and_matches_jax(tiny):
    """EngineConfig() itself: the dense two-dispatch engine."""
    spec, jmodel, params, tmodel = tiny
    prompts = _prompts(256, [30, 7, 130], 6)
    jreqs = JaxServeEngine(jmodel, params, JaxEngineConfig()).serve(
        [JaxRequest(prompt=list(p), max_new_tokens=4) for p in prompts])
    teng = ServeEngine(tmodel, EngineConfig(), device="cpu")
    treqs = teng.serve([Request(prompt=list(p), max_new_tokens=4)
                        for p in prompts])
    assert not teng.unified and not teng.paged
    assert [r.output for r in treqs] == [r.output for r in jreqs]


def test_two_dispatch_paged_matches_jax_under_preemption(tiny):
    """A pool small enough to force victim preemption mid-decode:
    recompute-style resumption keeps outputs and counters identical."""
    _, teng = _serve_both(tiny, _prompts(256, [13, 11, 14, 12, 9, 15], 5),
                          [10] * 6, cache_layout="paged", max_seq=32,
                          page_size=4, n_pages=11)
    assert teng.metrics.preemptions > 0


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_two_dispatch_prefill_first_matches_jax(tiny, layout):
    """decode_priority=False: prefill chunks run before the decode step."""
    _serve_both(tiny, _prompts(256, [5, 9, 3, 12, 7], 8), [5, 3, 6, 4, 5],
                cache_layout=layout, decode_priority=False)


def test_dense_idle_slot_past_max_seq_matches_jax(tiny):
    """A request done at prefill leaves its slot idle while another decodes
    to the max_seq cap: the idle slot's device length passes max_seq and
    its writes clamp inside its own row, as in JAX."""
    _, teng = _serve_both(tiny, _prompts(256, [4, 12], 9), [100, 1],
                          max_slots=2, max_seq=32)
    assert int(teng.cache.lengths.max()) > 32


def test_two_scratch_rows_at_different_widths_match_jax(tiny):
    """Two rows in flight at widths 2 and 1 in one step: two chunk calls,
    each keeping the other row's state."""
    _, teng = _serve_both(tiny, _prompts(256, [6, 5], 10), [4, 4],
                          chunk_size=4)
    assert teng.metrics.prefill_calls == 3  # widths 4 | 2, 1


def test_mistral_swa_dense_matches_jax():
    """Reduced mistral-7b-swa (window 24) in the dense layout, with
    contexts past the window."""
    pair = _pair("mistral-7b-swa")
    _serve_both(pair, _prompts(pair[0].vocab, [30, 27, 35], 12), [8, 6, 8],
                chunk_size=8)


# ---------------------------------------------------------------------------
# the port's three engine modes against one another
# ---------------------------------------------------------------------------

def test_unified_and_two_dispatch_are_token_identical(tiny):
    _, _, _, tmodel = tiny
    prompts = _prompts(256, MIXED[0], 13)
    outs = []
    for kw in (dict(cache_layout="paged", unified=True),
               dict(cache_layout="paged"), dict(cache_layout="dense")):
        eng = ServeEngine(tmodel, _cfg(EngineConfig, **kw), device="cpu")
        reqs = eng.serve([Request(prompt=list(p), max_new_tokens=m)
                          for p, m in zip(prompts, MIXED[1])])
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1] == outs[2]


def test_unified_engine_needs_the_paged_layout(tiny):
    """As the reference: the packed step writes K/V straight into pages."""
    with pytest.raises(ValueError, match="needs cache_layout='paged'"):
        ServeEngine(tiny[3], _cfg(EngineConfig, unified=True), device="cpu")
