"""Port parity of the Mamba slice: the selective scan, the causal conv, the
Mamba block, the converter and both two-dispatch engines serving the
jamba hybrid (Mamba, attention and MoE layers in one 8-layer period) of
``repro_torch`` against the JAX package, at ``jamba-v0.1-52b-reduced``
widths (d_model 64, Di 128, N 8, 8 layers) on the CPU.

Inputs are made from numpy seeds and handed to both frameworks; weights
are the reference's ``init(jax.random.key(s))`` through
``from_jax_params``.  The scan is plain PyTorch on every device (the
reference's is jnp, not Pallas).

Tolerances, with their reasons:

* the f32 scan against the JAX oracle and the chunked scan against the
  unchunked one: atol 1e-5 (the same f32 recurrence; the read-out sums
  over N in another order);
* the causal conv: exact (the same taps summed in the same order);
* block and model steps in float32: atol 1e-5 on outputs and states, 1e-4
  on logits (eight layers and the head);
* engines: greedy outputs token-identical, the scheduler's counters and
  ``kv_stats`` equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import build_model as jax_build_model
from repro.models.common import KeyGen, ModelContext
from repro.models.model import ModelCache as JaxModelCache
from repro.models.ssm import MambaCache as JaxMambaCache
from repro.models.ssm import _causal_conv as jax_causal_conv
from repro.models.ssm import init_mamba as jax_init_mamba
from repro.models.ssm import mamba_block as jax_mamba_block
from repro.serving import DisaggCluster as JaxDisaggCluster
from repro.serving import DisaggClusterConfig as JaxDisaggClusterConfig
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import Request as JaxRequest
from repro.serving import ServeEngine as JaxServeEngine
from repro.serving import SpeculativeDecoder as JaxSpeculativeDecoder
from repro.serving.beam import BeamSearcher as JaxBeamSearcher
from repro_torch.configs import registry as treg
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import build_model, from_jax_params
from repro_torch.models.ssm import (Mamba, MambaCache, _causal_conv,
                                    init_mamba_cache, mamba_block)
from repro_torch.serving import (BeamSearcher, DisaggCluster,
                                 DisaggClusterConfig, EngineConfig, Request,
                                 ServeEngine, SpeculativeDecoder)

ARCH = "jamba-v0.1-52b"
ATOL = 1e-5
LOGITS_ATOL = 1e-4
COUNTERS = ("steps", "preemptions", "decode_steps", "prefill_calls",
            "prefill_tokens", "generated_tokens", "dispatches",
            "transfers_d2h", "capacity_stops", "peak_active",
            "pages_in_use_peak", "kv_used_tokens_peak")


# ---------------------------------------------------------------------------
# the scan and the conv
# ---------------------------------------------------------------------------

def _scan_inputs(b, t, di, n, seed):
    """numpy f32 x, dt (softplus-range), a (negative), b, c, d, state."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((b, t, di)).astype(f),
            rng.uniform(0.001, 0.2, (b, t, di)).astype(f),
            -rng.uniform(0.5, 4.0, (di, n)).astype(f),
            rng.standard_normal((b, t, n)).astype(f),
            rng.standard_normal((b, t, n)).astype(f),
            rng.standard_normal((di,)).astype(f),
            rng.standard_normal((b, di, n)).astype(f))


SCAN_CASES = [(2, 7, 32, 8), (1, 1, 16, 4), (3, 130, 24, 16), (2, 0, 8, 4)]


@pytest.mark.parametrize("case", SCAN_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_scan_matches_jax_oracle(case):
    """The port's scan, whole and in the chunks of ``ops.mamba_scan``,
    against the reference's oracle and its chunked op."""
    args = _scan_inputs(*case, seed=sum(case))
    want_y, want_s = jref.mamba_scan_reference(*map(jnp.asarray, args))
    targs = [torch.from_numpy(a) for a in args]
    for got_y, got_s in (tref.mamba_scan_reference(*targs),
                         tops.mamba_scan(*targs)):
        assert got_y.dtype == torch.float32 and got_s.dtype == torch.float32
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                                   atol=ATOL, rtol=0)
    jy, js = jops.mamba_scan(*map(jnp.asarray, args), chunk=16)
    np.testing.assert_allclose(np.asarray(jy), np.asarray(want_y), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("chunk", [1, 16, 50])
def test_chunked_scan_equals_unchunked(chunk):
    args = [torch.from_numpy(a) for a in _scan_inputs(2, 130, 32, 8, 7)]
    want_y, want_s = tref.mamba_scan_reference(*args)
    got_y, got_s = tops.mamba_scan(*args, chunk=chunk)
    torch.testing.assert_close(got_y, want_y, atol=ATOL, rtol=0)
    torch.testing.assert_close(got_s, want_s, atol=ATOL, rtol=0)


def test_scan_output_takes_x_dtype():
    """bf16 x, b, c: the recurrence runs in f32 and y rounds once to bf16,
    as the reference's; the state stays f32."""
    args = list(_scan_inputs(2, 5, 16, 4, 3))
    bf = [torch.from_numpy(a) for a in args]
    for i in (0, 3, 4):
        bf[i] = bf[i].to(torch.bfloat16)
    y, s = tops.mamba_scan(*bf)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    want_y, want_s = tref.mamba_scan_reference(
        *[t.float() for t in bf])
    torch.testing.assert_close(y, want_y.to(torch.bfloat16), atol=0, rtol=0)
    torch.testing.assert_close(s, want_s, atol=0, rtol=0)


@pytest.mark.parametrize("s", [1, 3, 9])
def test_causal_conv_is_exact(s):
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, 12)).astype(np.float32)
    prev = rng.standard_normal((2, 3, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal((12,)).astype(np.float32)
    want, want_prev = jax_causal_conv(*map(jnp.asarray, (x, prev, w, b)))
    got, got_prev = _causal_conv(*map(torch.from_numpy, (x, prev, w, b)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_prev.numpy(), np.asarray(want_prev))


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

def _block_pair(seed=0):
    spec = treg.get_reduced(ARCH)
    ctx = ModelContext(spec=jreg.get_reduced(ARCH), mesh=None,
                       param_dtype=jnp.float32, compute_dtype=jnp.float32)
    params = jax_init_mamba(jreg.get_reduced(ARCH), KeyGen(
        jax.random.key(seed)), jnp.float32)
    mixer = Mamba(spec, "cpu", torch.float32)
    mixer.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in params.items()})
    return spec, ctx, params, mixer


def test_block_with_cache_and_mask_matches_jax():
    """A 6-token chunk on both rows, a 3-token chunk on row 1 alone (row
    0's conv inputs and SSM state kept bit for bit), then a decode step,
    each against the reference's block; and the full pass with no cache."""
    spec, ctx, params, mixer = _block_pair()
    jspec = ctx.spec
    rng = np.random.default_rng(1)
    b, d = 2, spec.d_model
    jcache = JaxMambaCache(
        conv=jnp.asarray(rng.standard_normal((b, 3, 2 * d)), jnp.float32),
        ssm=jnp.asarray(rng.standard_normal((b, 2 * d, 8)), jnp.float32))
    tcache = MambaCache(conv=torch.from_numpy(np.array(jcache.conv)),
                        ssm=torch.from_numpy(np.array(jcache.ssm)))

    def check(t, mask=None):
        nonlocal jcache
        x = rng.standard_normal((b, t, d)).astype(np.float32)
        jy, jnew = jax_mamba_block(jspec, ctx, params, jnp.asarray(x), jcache)
        before = [tcache.conv.clone(), tcache.ssm.clone()]
        ty = mamba_block(spec, mixer, torch.from_numpy(x), tcache,
                         mask=None if mask is None else torch.tensor(mask))
        rows = [i for i in range(b) if mask is None or mask[i]]
        np.testing.assert_allclose(ty.numpy()[rows], np.asarray(jy)[rows],
                                   atol=ATOL, rtol=0)
        for got, want, old in zip((tcache.conv, tcache.ssm),
                                  (jnew.conv, jnew.ssm), before):
            np.testing.assert_allclose(got.numpy()[rows],
                                       np.asarray(want)[rows], atol=ATOL,
                                       rtol=0)
            for i in set(range(b)) - set(rows):
                assert torch.equal(got[i], old[i])
        sel = jnp.asarray([True] * b if mask is None else mask)
        jcache = jax.tree.map(
            lambda n, o: jnp.where(sel.reshape((b,) + (1,) * (n.ndim - 1)),
                                   n, o), jnew, jcache)

    check(6)
    check(3, mask=[False, True])
    check(1)
    x = rng.standard_normal((b, 5, d)).astype(np.float32)
    jy, none = jax_mamba_block(jspec, ctx, params, jnp.asarray(x))
    assert none is None
    np.testing.assert_allclose(
        mamba_block(spec, mixer, torch.from_numpy(x)).numpy(),
        np.asarray(jy), atol=ATOL, rtol=0)


def test_block_keeps_f32_ssm_params_in_a_bf16_model():
    spec = treg.get_reduced(ARCH)
    mixer = Mamba(spec, "cpu", torch.bfloat16)
    mixer.reset_parameters(torch.Generator().manual_seed(0))
    assert mixer.a_log.dtype == mixer.d_skip.dtype == torch.float32
    assert mixer.in_proj.dtype == mixer.dt_bias.dtype == torch.bfloat16
    np.testing.assert_allclose(mixer.a_log[0].exp().numpy(),
                               np.arange(1, 9), rtol=1e-6)
    cache = init_mamba_cache(spec, 3, "cpu", torch.bfloat16)
    assert cache.conv.shape == (3, 3, 128)
    assert cache.conv.dtype == torch.bfloat16
    assert cache.ssm.shape == (3, 128, 8) and cache.ssm.dtype == torch.float32
    x = torch.randn(3, 4, spec.d_model, generator=torch.Generator()
                    .manual_seed(1)).to(torch.bfloat16)
    assert mamba_block(spec, mixer, x, cache).dtype == torch.bfloat16
    assert cache.ssm.abs().sum() > 0 and cache.conv.abs().sum() > 0


# ---------------------------------------------------------------------------
# converter and model steps
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _pair(seed: int = 0):
    """JAX model + params and the port model loaded from the same tree
    (f32, paged pools of 8-token pages)."""
    jspec, tspec = jreg.get_reduced(ARCH), treg.get_reduced(ARCH)
    jmodel = jax_build_model(jspec, mesh=None, param_dtype=jnp.float32,
                             compute_dtype=jnp.float32,
                             cache_layout="paged", kv_page_size=8)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.key(seed)))
    tmodel = build_model(tspec, device="cpu", dtype=torch.float32)
    tmodel.load_state_dict(from_jax_params(tree, tspec))
    return jspec, jmodel, jax.tree.map(jnp.asarray, tree), tmodel, tree


def test_from_jax_params_on_a_jamba_tree():
    """Every port parameter is filled from the tree: seven Mamba layers and
    one attention layer (offset 4), MoE FFNs on the odd layers, dense
    MLPs on the even ones; layer i from repeat i // 8 of position i % 8."""
    jspec, _, _, tmodel, tree = _pair()
    state = from_jax_params(tree, tmodel.spec)
    assert set(state) == set(tmodel.state_dict())
    kinds = [layer.cls.key for layer in tmodel.layers]
    assert kinds == ["mamba", "mamba_moe", "mamba", "mamba_moe", "attn",
                     "mamba_moe", "mamba", "mamba_moe"]
    for i, layer in enumerate(tmodel.layers):
        assert layer.ffn is not None
        stacked = tree["layers"][f"pos{i}"]
        if layer.cls.kind == "mamba":
            for name in ("in_proj", "conv_w", "a_log", "d_skip", "dt_w"):
                np.testing.assert_array_equal(
                    getattr(layer.mixer, name).numpy(),
                    stacked["mixer"][name][0])


def test_prefill_chunk_rows_and_decode_match_jax():
    """A 6-token chunk on both rows of the dense scratch, a 3-token chunk on
    row 1 alone under the reference engine's masked select, then two
    decode steps, logits and every Mamba state against JAX."""
    jspec, jmodel, params, tmodel, _ = _pair()
    rng = np.random.default_rng(4)
    b, t = 2, 32
    jcache = jmodel.init_cache(b, t, layout="dense")
    tcache = tmodel.init_cache(b, t, layout="dense")
    jchunk = jax.jit(jmodel.prefill_chunk)

    def states_match():
        for i, layer in enumerate(tcache.layers):
            if not isinstance(layer, MambaCache):
                continue
            jl = jcache.layers[f"pos{i}"]
            for name in ("conv", "ssm"):
                np.testing.assert_allclose(
                    getattr(layer, name).numpy(),
                    np.asarray(getattr(jl, name))[0], atol=ATOL, rtol=0,
                    err_msg=f"{name}{i}")

    toks = rng.integers(0, jspec.vocab, (b, 6)).astype(np.int32)
    jlogits, jcache = jchunk(params, jcache, jnp.asarray(toks))
    tlogits, tcache = tmodel.prefill_chunk(tcache, torch.from_numpy(toks))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=LOGITS_ATOL, rtol=0)
    states_match()

    toks = rng.integers(0, jspec.vocab, (b, 3)).astype(np.int32)
    jlogits, jnew = jchunk(params, jcache, jnp.asarray(toks))
    mask = jnp.asarray([False, True])
    jcache = JaxModelCache(
        layers=jax.tree.map(
            lambda n, o: jnp.where(mask.reshape((1, 2) + (1,) * (n.ndim - 2)),
                                   n, o), jnew.layers, jcache.layers),
        lengths=jnp.where(mask, jnew.lengths, jcache.lengths))
    tlogits, tcache = tmodel.prefill_chunk(tcache, torch.from_numpy(toks),
                                           mask=torch.tensor([False, True]))
    np.testing.assert_allclose(tlogits.numpy()[1], np.asarray(jlogits)[1],
                               atol=LOGITS_ATOL, rtol=0)
    assert tcache.lengths.tolist() == [6, 9]
    states_match()

    jdecode = jax.jit(jmodel.decode_step)
    for _ in range(2):
        feed = rng.integers(0, jspec.vocab, (b, 1)).astype(np.int32)
        jlogits, jcache = jdecode(params, jcache, jnp.asarray(feed))
        tlogits, tcache = tmodel.decode_step(tcache, torch.from_numpy(feed))
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   atol=LOGITS_ATOL, rtol=0)
        states_match()


# ---------------------------------------------------------------------------
# engines: the port's two-dispatch engines against the JAX engine
# ---------------------------------------------------------------------------

def _cfg(cls, **kw):
    base = dict(max_slots=4, max_seq=64, chunk_size=4, prefill_rows=2,
                page_size=8, unified=False)
    base.update(kw)
    return cls(**base)


def _prompts(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, size=n).tolist() for n in lengths]


MIXED = ([3, 11, 4, 17, 9, 5, 23, 8], [6, 3, 8, 6, 1, 6, 4, 5])
TIGHT = ([13, 11, 14, 12, 9, 15], [10] * 6)
CASES = {
    "dense": (MIXED, 4, dict(cache_layout="dense")),
    "paged": (MIXED, 4, dict(cache_layout="paged")),
    "paged-tight": (TIGHT, 5, dict(cache_layout="paged", max_seq=32,
                                   page_size=4, n_pages=11)),
}


@functools.lru_cache(maxsize=None)
def _jax_served(case: str):
    """The JAX engine's outputs, counters and kv_stats of ``case``, built
    and served once."""
    (lengths, max_new), seed, kw = CASES[case]
    _, jmodel, params, _, _ = _pair()
    jeng = JaxServeEngine(jmodel, params, _cfg(JaxEngineConfig, **kw))
    reqs = jeng.serve([JaxRequest(prompt=p, max_new_tokens=m) for p, m in
                       zip(_prompts(lengths, seed), max_new)])
    assert all(r.state == "done" for r in reqs)
    return ([r.output for r in reqs],
            {n: getattr(jeng.metrics, n) for n in COUNTERS},
            jeng.kv_stats(), np.asarray(jeng.cache.lengths))


@functools.lru_cache(maxsize=None)
def _served(case: str):
    """The port engine of ``case`` after serving it once, and its outputs
    (read-only below)."""
    (lengths, max_new), seed, kw = CASES[case]
    teng = ServeEngine(_pair()[3], _cfg(EngineConfig, **kw), device="cpu")
    reqs = teng.serve([Request(prompt=p, max_new_tokens=m) for p, m in
                       zip(_prompts(lengths, seed), max_new)])
    assert all(r.state == "done" for r in reqs)
    return teng, [r.output for r in reqs]


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_dispatch_serves_jamba_as_jax(case):
    """Concurrent chunked prefills of mixed widths and decode in each
    layout, and a pool tight enough to preempt: outputs, counters,
    kv_stats and the slots' lengths equal the JAX engine's."""
    teng, outs = _served(case)
    want_outs, want_counters, want_kv, want_lengths = _jax_served(case)
    assert outs == want_outs
    assert {n: getattr(teng.metrics, n) for n in COUNTERS} == want_counters
    assert teng.kv_stats() == want_kv
    np.testing.assert_array_equal(teng.cache.lengths.numpy(), want_lengths)
    m = teng.metrics
    assert m.prefill_calls > 0 and m.decode_steps > 0
    if teng.paged:
        teng.pager.check()
        assert teng.pager.pages_in_use == 0
    if case == "paged-tight":
        assert m.preemptions > 0


def test_dense_and_paged_are_token_identical():
    assert _served("dense")[1] == _served("paged")[1]


def test_unified_engine_refuses_jamba_as_the_reference():
    """unified=True with Mamba layers is a limit of the reference, not an
    unported part: both packages raise ValueError; the packed step itself
    refuses the layer."""
    _, jmodel, params, tmodel, _ = _pair()
    with pytest.raises(ValueError, match="attention-only stacks"):
        JaxServeEngine(jmodel, params, _cfg(JaxEngineConfig,
                                            cache_layout="paged",
                                            unified=True))
    with pytest.raises(ValueError, match="attention-only stacks"):
        ServeEngine(tmodel, _cfg(EngineConfig, cache_layout="paged",
                                 unified=True), device="cpu")
    from repro_torch.models.attention import PackedSegs
    cache = tmodel.init_cache(1, 16, layout="paged", page_size=8)
    z = torch.zeros(1, dtype=torch.int32)
    packed = PackedSegs(q_start=z, q_len=z + 1, kv_len=z + 1,
                        page_table=torch.ones((1, 2), dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="'mamba' carries"):
        tmodel.unified_step(cache, z, z, packed)


PROMPT = [5, 9, 2, 17, 33, 4, 41, 8, 60]


def _refusal(case):
    """Build what ``case`` names in each package: (the reference's
    exception, the port's), each None where that package builds it."""
    _, jmodel, params, tmodel, _ = _pair()
    jcfg = dict(cache_layout="paged", unified=True)
    build = {
        "spec_engine": (
            lambda: JaxServeEngine(jmodel, params, _cfg(
                JaxEngineConfig, **jcfg, n_spec=2), draft_model=jmodel,
                draft_params=params),
            lambda: ServeEngine(tmodel, _cfg(EngineConfig, **jcfg, n_spec=2),
                                device="cpu", draft_model=tmodel)),
        "prefix_cache": (
            lambda: JaxServeEngine(jmodel, params, _cfg(
                JaxEngineConfig, **jcfg, prefix_cache=True)),
            lambda: ServeEngine(tmodel, _cfg(EngineConfig, **jcfg,
                                             prefix_cache=True),
                                device="cpu")),
        "prefix_cache_two_dispatch": (
            lambda: JaxServeEngine(jmodel, params, _cfg(
                JaxEngineConfig, prefix_cache=True)),
            lambda: ServeEngine(tmodel, _cfg(EngineConfig, prefix_cache=True),
                                device="cpu")),
        "cluster": (
            lambda: JaxDisaggCluster(jmodel, params, JaxDisaggClusterConfig(
                max_seq=64, page_size=8, chunk_size=8)),
            lambda: DisaggCluster(tmodel, DisaggClusterConfig(
                max_seq=64, page_size=8, chunk_size=8), device="cpu")),
    }[case]
    out = []
    for make in build:
        try:
            make()
            out.append(None)
        except Exception as e:  # noqa: BLE001 - the type is what we hold
            out.append(e)
    return out


@pytest.mark.parametrize("case", ["spec_engine", "prefix_cache",
                                  "prefix_cache_two_dispatch", "cluster"])
def test_ssm_refusals_match_the_reference(case):
    """Where the reference refuses the jamba hybrid (speculation and the
    prefix cache need the unified step, the disaggregated prefill pool is
    a unified engine), the port refuses it with the same exception type
    and message."""
    ref, ours = _refusal(case)
    assert isinstance(ref, ValueError), ref
    assert type(ours) is type(ref) and str(ours) == str(ref)


def test_beam_and_batch1_speculation_serve_jamba_as_the_reference():
    """The decoders the reference runs on an SSM stack: beam search (its
    row gather reorders the Mamba state with the K/V) and the batch-1
    speculative oracle (a self-draft at temperature 0): the same tokens,
    score and stats."""
    _, _, params, tmodel, _ = _pair()
    # the reference's decoders take the model's default (dense) layout
    jmodel = jax_build_model(jreg.get_reduced(ARCH), mesh=None,
                             param_dtype=jnp.float32,
                             compute_dtype=jnp.float32)
    want_seq, want_score = JaxBeamSearcher(jmodel, params, beam_size=2,
                                           max_seq=32).search(PROMPT, 5)
    got_seq, got_score = BeamSearcher(tmodel, beam_size=2,
                                      max_seq=32).search(PROMPT, 5)
    assert got_seq == want_seq
    np.testing.assert_allclose(got_score, want_score, rtol=0, atol=ATOL)
    ours = SpeculativeDecoder(tmodel, tmodel, n_spec=3, max_seq=64,
                              temperature=0.0)
    ref = JaxSpeculativeDecoder(jmodel, params, jmodel, params, n_spec=3,
                                max_seq=64, temperature=0.0)
    assert ours.generate(PROMPT, 8) == ref.generate(PROMPT, 8)
    assert vars(ours.stats) == vars(ref.stats)


def test_kv_quant_jamba_two_dispatch_matches_jax():
    """The int8 KV cache quantizes jamba's attention layer and leaves the
    Mamba state in full precision: the paged two-dispatch engine against
    the quantized JAX engine, outputs, counters and kv_stats equal."""
    jspec, tspec = jreg.get_reduced(ARCH), treg.get_reduced(ARCH)
    jmodel = jax_build_model(jspec, mesh=None, param_dtype=jnp.float32,
                             compute_dtype=jnp.float32, kv_quant=True,
                             cache_layout="paged", kv_page_size=8)
    _, _, params, _, tree = _pair()
    tmodel = build_model(tspec, device="cpu", dtype=torch.float32,
                         kv_quant=True)
    tmodel.load_state_dict(from_jax_params(tree, tspec))
    prompts = _prompts(MIXED[0][:4], 6)
    cfg = dict(cache_layout="paged")
    jeng = JaxServeEngine(jmodel, params, _cfg(JaxEngineConfig, **cfg))
    jreqs = jeng.serve([JaxRequest(prompt=p, max_new_tokens=5)
                        for p in prompts])
    teng = ServeEngine(tmodel, _cfg(EngineConfig, **cfg), device="cpu")
    treqs = teng.serve([Request(prompt=p, max_new_tokens=5)
                        for p in prompts])
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert {n: getattr(teng.metrics, n) for n in COUNTERS} \
        == {n: getattr(jeng.metrics, n) for n in COUNTERS}
    assert teng.kv_stats() == jeng.kv_stats()
    layer = teng.cache.layers[0]
    assert isinstance(layer, MambaCache) and layer.ssm.dtype == torch.float32
