"""The two-dispatch engine's prefill chunks, row resets, inserts and
first-token samples as ``StepGraph`` profiles, held against the JAX engine
on the CPU.

* ``Model.prefill_chunk(mask=)`` against the JAX engine's
  ``_prefill_masked`` on the same numpy-seeded scratch (K/V, RWKV shift
  caches and WKV state, lengths; one unselected row near the cache's end,
  so its write window clamps): the selected rows' logits within 1e-4 of the
  logits' scale and their caches within 1e-5 of theirs; the unselected
  rows' caches and lengths unchanged bit for bit.
* ``ServeEngine(unified=False)`` against the JAX engine in both layouts
  (mistral-7b-swa, whose window the contexts pass, in the dense layout
  only), with slot churn and, paged, with a pool tight enough to preempt:
  greedy outputs token-identical, every counter in ``COUNTERS`` equal,
  every dispatch one profile run, each ``prefill/<w>`` bound once for
  exactly the widths the reference traced, and ``reset``,
  ``insert/<layout>`` and ``sample/first`` bound once each.

JAX initialises the weights and the port loads them through
``from_jax_params``; everything is float32, the port on its plain kernels
(on the CPU a profile's use calls its step function on the very static
tensors a capture binds on the card).  The RWKV-6 mixes and bonus, zero in
the reference's init, are drawn from a seed.
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
from repro.models.model import ModelCache as JaxModelCache
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import Request as JaxRequest
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch.configs import registry as treg
from repro_torch.models import build_model, from_jax_params
from repro_torch.models.ssm import MIXES
from repro_torch.models.transformer import stack_period
from repro_torch.serving import EngineConfig, Request, ServeEngine

LOGITS_RTOL = 1e-4  # of the logits' scale: f32 sums in other orders
CACHE_RTOL = 1e-5  # of the cache's scale
COUNTERS = ("steps", "preemptions", "decode_steps", "prefill_calls",
            "prefill_tokens", "generated_tokens", "dispatches",
            "transfers_d2h", "capacity_stops", "peak_active",
            "pages_in_use_peak", "kv_used_tokens_peak")
ARCHS = ("minitron-8b", "mistral-7b-swa", "deepseek-moe-16b", "rwkv6-3b")


@functools.lru_cache(maxsize=None)
def _pair(arch: str):
    """JAX model + params and the port model loaded from the same tree
    (f32); RWKV-6's mixes and bonus drawn from a seed."""
    jspec, tspec = jreg.get_reduced(arch), treg.get_reduced(arch)
    jmodel = jax_build_model(jspec, mesh=None, param_dtype=jnp.float32,
                             compute_dtype=jnp.float32, moe_impl="dense",
                             cache_layout="paged", kv_page_size=4)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0)))
    if jspec.is_attention_free:
        rng = np.random.default_rng(10)
        mixer = dict(tree["layers"]["pos0"]["mixer"])
        for name in MIXES:
            mixer[name] = rng.uniform(0.0, 1.0, mixer[name].shape
                                      ).astype(np.float32)
        mixer["u_bonus"] = (0.5 * rng.standard_normal(
            mixer["u_bonus"].shape)).astype(np.float32)
        tree["layers"]["pos0"]["mixer"] = mixer
    tmodel = build_model(tspec, device="cpu", dtype=torch.float32)
    tmodel.load_state_dict(from_jax_params(tree, tspec))
    return jspec, jmodel, jax.tree.map(jnp.asarray, tree), tmodel


# ---------------------------------------------------------------------------
# the masked chunk
# ---------------------------------------------------------------------------

ROWS, T = 3, 32
LENGTHS = (5, 30, 20)  # row 1, unselected: at w = 4 its window clamps
MASK = (True, False, True)


def _leaves(jcache, tspec, i):
    """Layer ``i``'s cache in the JAX tree: (the period position's cache,
    the repeat index)."""
    period, _ = stack_period(tspec)
    return jcache.layers[f"pos{i % period}"], i // period


def _seeded_scratch(jmodel, tmodel, seed):
    """One dense scratch of ROWS rows for each side, every cache tensor
    drawn from ``seed`` (the same values on both), lengths LENGTHS."""
    rng = np.random.default_rng(seed)
    tcache = tmodel.init_cache(ROWS, T, layout="dense")
    jcache = jmodel.init_cache(ROWS, T, layout="dense")
    stacked: dict[tuple[str, str], np.ndarray] = {}
    for i, layer in enumerate(tcache.layers):
        jl, rep = _leaves(jcache, tmodel.spec, i)
        pos = next(k for k, v in jcache.layers.items() if v is jl)
        for f in dataclasses.fields(layer):
            t = getattr(layer, f.name)
            if t is None:  # a full-precision cache has no scales
                continue
            x = rng.standard_normal(tuple(t.shape)).astype(np.float32)
            t.copy_(torch.from_numpy(x))
            arr = stacked.setdefault(
                (pos, f.name), np.array(getattr(jl, f.name)))
            arr[rep] = x
    layers = {pos: dataclasses.replace(
        jl, **{name: jnp.asarray(arr) for (p, name), arr in stacked.items()
               if p == pos}) for pos, jl in jcache.layers.items()}
    tcache.lengths.copy_(torch.tensor(LENGTHS, dtype=torch.int32))
    return tcache, JaxModelCache(layers=layers,
                                 lengths=jnp.asarray(LENGTHS, jnp.int32))


@pytest.mark.parametrize("w", [1, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_masked_chunk_matches_jax_prefill_masked(arch, w):
    jspec, jmodel, params, tmodel = _pair(arch)
    tcache, jcache = _seeded_scratch(jmodel, tmodel, seed=len(arch) + w)
    before = [{f.name: getattr(layer, f.name).clone()
               for f in dataclasses.fields(layer)
               if getattr(layer, f.name) is not None}
              for layer in tcache.layers]
    toks = np.random.default_rng(w).integers(
        0, jspec.vocab, (ROWS, w)).astype(np.int32)
    jeng = JaxServeEngine(jmodel, params, JaxEngineConfig(
        max_slots=2, max_seq=T, chunk_size=4, prefill_rows=ROWS))
    jlogits, jnew = jax.jit(jeng._prefill_masked)(
        params, jcache, jnp.asarray(toks), jnp.asarray(MASK))
    mask = torch.tensor(MASK)
    tlogits, tnew = tmodel.prefill_chunk(tcache, torch.from_numpy(toks),
                                         mask=mask)
    assert tnew is tcache
    sel = np.asarray(MASK)
    want = np.asarray(jlogits)[sel]
    np.testing.assert_allclose(tlogits.numpy()[sel], want,
                               atol=LOGITS_RTOL * np.abs(want).max(), rtol=0)
    np.testing.assert_array_equal(tcache.lengths.numpy(),
                                  np.asarray(jnew.lengths))
    assert tcache.lengths.tolist() == [n + w * m
                                       for n, m in zip(LENGTHS, MASK)]
    for i, (layer, old) in enumerate(zip(tcache.layers, before)):
        jl, rep = _leaves(jnew, tmodel.spec, i)
        for name, x in old.items():
            got = getattr(layer, name)
            assert torch.equal(got[~mask], x[~mask]), f"{name}{i}"
            want = np.asarray(getattr(jl, name))[rep][sel]
            np.testing.assert_allclose(
                got.numpy()[sel], want, rtol=0,
                atol=CACHE_RTOL * np.abs(want).max(), err_msg=f"{name}{i}")


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

# prompt lengths and max_new_tokens: five requests over two slots (churn),
# contexts past mistral's window of 24, several final chunk widths
CHURN = ([5, 30, 3, 27, 13], [5, 3, 6, 4, 5])
TIGHT = ([13, 11, 14, 12, 9, 15], [10] * 6)
CASES = [(arch, layout, False) for arch in ARCHS
         for layout in ("dense", "paged")
         if not (arch == "mistral-7b-swa" and layout == "paged")] + [
    (arch, "paged", True) for arch in ARCHS if arch != "mistral-7b-swa"]


def _cfg(cls, layout, tight):
    base = dict(max_slots=2, max_seq=64, chunk_size=8, prefill_rows=2,
                page_size=8, cache_layout=layout, unified=False)
    if tight:
        base.update(max_slots=4, max_seq=32, chunk_size=4, page_size=4,
                    n_pages=11)
    return cls(**base)


def _record_widths(jeng):
    """The chunk widths the JAX engine's ``_jit_prefill`` is called with
    (one trace each), filled as the engine steps."""
    widths: set[int] = set()
    jit = jeng._jit_prefill

    def recorded(params, scratch, tokens, mask):
        widths.add(int(tokens.shape[1]))
        return jit(params, scratch, tokens, mask)
    jeng._jit_prefill = recorded
    return widths


def _count_runs(eng):
    """{profile key: uses} of the port engine's StepGraph, filled as the
    engine steps."""
    runs: dict[str, int] = {}
    run = eng._graphs.run

    def counted(key):
        runs[key] = runs.get(key, 0) + 1
        return run(key)
    eng._graphs.run = counted
    return runs


@pytest.mark.parametrize("arch,layout,tight", CASES,
                         ids=lambda v: v if isinstance(v, str)
                         else ("tight" if v else "churn"))
def test_two_dispatch_profiles_match_jax_engine(arch, layout, tight):
    jspec, jmodel, params, tmodel = _pair(arch)
    lengths, max_new = TIGHT if tight else CHURN
    rng = np.random.default_rng(len(arch) + len(layout) + tight)
    prompts = [rng.integers(0, jspec.vocab, size=n).tolist()
               for n in lengths]
    jeng = JaxServeEngine(jmodel, params, _cfg(JaxEngineConfig, layout,
                                               tight))
    widths = _record_widths(jeng)
    jreqs = jeng.serve([JaxRequest(prompt=list(p), max_new_tokens=m)
                        for p, m in zip(prompts, max_new)])
    teng = ServeEngine(tmodel, _cfg(EngineConfig, layout, tight),
                       device="cpu")
    runs = _count_runs(teng)
    treqs = teng.serve([Request(prompt=list(p), max_new_tokens=m)
                        for p, m in zip(prompts, max_new)])
    assert all(r.state == "done" for r in jreqs + treqs)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    m = teng.metrics
    for name in COUNTERS:
        assert getattr(m, name) == getattr(jeng.metrics, name), name
    assert m.preemptions > 0 if tight else m.peak_active == 2
    # every dispatch is one profile run; each profile bound once, one
    # prefill profile for each width the reference traced
    graphs = teng._graphs
    assert len(widths) > 2
    assert set(graphs.captures) == set(runs) == {
        f"decode/{layout}", "reset", f"insert/{layout}", "sample/first"} | {
        f"prefill/{w}" for w in widths}
    assert set(graphs.captures.values()) == {1}
    assert sum(runs.values()) == m.dispatches
    assert sum(n for key, n in runs.items()
               if key.startswith("prefill/")) == m.prefill_calls
    assert runs[f"decode/{layout}"] == m.decode_steps
    # one reset per admission: each prompt once, a preempted one again
    assert runs["reset"] == len(prompts) + m.preemptions
    assert runs["sample/first"] == m.transfers_d2h - m.decode_steps
    if teng.paged:
        teng.pager.check()
        assert teng.pager.pages_in_use == 0
