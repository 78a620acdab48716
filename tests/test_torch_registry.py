"""Port parity of the rest of the registry: ``Model.forward`` of every
reduced architecture (hubert-xlarge and pixtral-12b through ``embeds=``,
as their stub frontends hand them frame and patch embeddings),
``prefill(embeds=)`` and the unified engine serving the dense LLaMA stacks
deepseek-7b (MHA) and yi-34b (G = 7 at full width; 4 here) and the
pixtral-12b backbone on token prompts, against the JAX package on the CPU.

Weights are the reference's ``init(jax.random.key(s))`` through
``from_jax_params``; inputs come from numpy seeds.  Tolerances: logits
within 1e-4 in float32 (a few layers and the head); engines
token-identical with every scheduler counter and ``kv_stats`` equal.
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
from repro.serving import Request as JaxRequest
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch.configs import registry as treg
from repro_torch.models import build_model, from_jax_params
from repro_torch.serving import EngineConfig, Request, ServeEngine

LOGITS_ATOL = 1e-4
COUNTERS = ("steps", "preemptions", "decode_steps", "prefill_calls",
            "prefill_tokens", "generated_tokens", "dispatches",
            "transfers_d2h", "capacity_stops", "peak_active",
            "pages_in_use_peak", "kv_used_tokens_peak")
FRONTENDS = ("hubert-xlarge", "pixtral-12b")


@functools.lru_cache(maxsize=None)
def _pair(arch: str, seed: int = 0):
    """JAX model and params of ``arch``'s reduced config, and the port
    model loaded from the same tree (f32, paged pools of 8-token pages)."""
    jspec, tspec = jreg.get_reduced(arch), treg.get_reduced(arch)
    jmodel = jax_build_model(jspec, mesh=None, param_dtype=jnp.float32,
                             compute_dtype=jnp.float32,
                             cache_layout="paged", kv_page_size=8)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.key(seed)))
    tmodel = build_model(tspec, device="cpu", dtype=torch.float32)
    tmodel.load_state_dict(from_jax_params(tree, tspec))
    return jmodel, jax.tree.map(jnp.asarray, tree), tmodel, tree


# ---------------------------------------------------------------------------
# the full forward, tokens and embeds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_forward_matches_jax(arch):
    """(B, S) tokens, or (B, S, D) embeds for the frontend models, through
    the whole stack: every position's logits within 1e-4."""
    jmodel, params, tmodel, _ = _pair(arch)
    spec = tmodel.spec
    rng = np.random.default_rng(len(arch))
    b, s = 2, 11
    fwd = jax.jit(jmodel.forward)
    runs = []
    if tmodel.embed is not None:
        toks = rng.integers(0, spec.vocab, (b, s)).astype(np.int32)
        runs.append((fwd(params, jnp.asarray(toks)),
                     tmodel.forward(torch.from_numpy(toks))))
    if arch in FRONTENDS:
        emb = rng.standard_normal((b, s, spec.d_model)).astype(np.float32)
        runs.append((fwd(params, embeds=jnp.asarray(emb)),
                     tmodel(embeds=torch.from_numpy(emb))))
    assert runs
    for want, got in runs:
        assert got.shape == (b, s, spec.vocab)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGITS_ATOL, rtol=0)


def test_forward_positions_reach_rope():
    """Explicit positions move a RoPE model's logits as the reference's."""
    jmodel, params, tmodel, _ = _pair("pixtral-12b")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 512, (1, 6)).astype(np.int32)
    pos = (np.arange(6) + 40)[None].astype(np.int32)
    want = jmodel.forward(params, jnp.asarray(toks),
                          positions=jnp.asarray(pos))
    got = tmodel.forward(torch.from_numpy(toks),
                         positions=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGITS_ATOL, rtol=0)
    assert not torch.allclose(got, tmodel.forward(torch.from_numpy(toks)))


def test_hubert_is_an_encoder_without_a_token_embedding():
    """The reference's init gives an encoder-only frontend model no
    ``embed``; tokens are refused with the reference's message, and the
    attention is bidirectional (a later frame moves an earlier one)."""
    _, _, tmodel, tree = _pair("hubert-xlarge")
    assert "embed" not in tree and tmodel.embed is None
    assert "embed" not in tmodel.state_dict()
    assert not tmodel.spec.attn.causal
    with pytest.raises(AssertionError, match="take embeds"):
        tmodel.forward(torch.zeros((1, 3), dtype=torch.int32))
    emb = torch.randn(1, 5, 64, generator=torch.Generator().manual_seed(0))
    base = tmodel(embeds=emb)
    emb2 = emb.clone()
    emb2[0, 4] += 1.0
    assert not torch.allclose(tmodel(embeds=emb2)[0, 0], base[0, 0])


def test_pixtral_prefill_with_embeds_matches_jax():
    """``prefill(embeds=)`` with right-padded lengths, then a decode step
    from the filled cache, against the reference."""
    jmodel, params, tmodel, _ = _pair("pixtral-12b")
    rng = np.random.default_rng(5)
    b, s = 2, 7
    emb = rng.standard_normal((b, s, 64)).astype(np.float32)
    lengths = np.array([7, 4], np.int32)
    jcache = jmodel.init_cache(b, 16, layout="dense")
    tcache = tmodel.init_cache(b, 16, layout="dense")
    jlogits, jcache = jax.jit(jmodel.prefill)(
        params, embeds=jnp.asarray(emb), cache=jcache,
        lengths=jnp.asarray(lengths))
    tlogits, tcache = tmodel.prefill(embeds=torch.from_numpy(emb),
                                     cache=tcache,
                                     lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=LOGITS_ATOL, rtol=0)
    assert tcache.lengths.tolist() == [7, 4]
    feed = rng.integers(0, 512, (b, 1)).astype(np.int32)
    jlogits, _ = jax.jit(jmodel.decode_step)(params, jcache,
                                             jnp.asarray(feed))
    tlogits, _ = tmodel.decode_step(tcache, torch.from_numpy(feed))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=LOGITS_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the unified engine
# ---------------------------------------------------------------------------

def _cfg(cls, **kw):
    base = dict(max_slots=4, max_seq=64, chunk_size=4, prefill_rows=2,
                cache_layout="paged", page_size=8, unified=True)
    base.update(kw)
    return cls(**base)


LENGTHS = ([3, 11, 4, 17, 9, 5, 23, 8], [6, 3, 8, 6, 1, 6, 4, 5])
ENGINE_ARCHS = ("deepseek-7b", "yi-34b", "pixtral-12b")


def _requests(cls, arch):
    rng = np.random.default_rng(len(arch))
    return [cls(prompt=rng.integers(0, 512, size=n).tolist(),
                max_new_tokens=m) for n, m in zip(*LENGTHS)]


@functools.lru_cache(maxsize=None)
def _jax_served(arch: str):
    """The JAX unified engine's outputs, counters and kv_stats, served
    once per arch."""
    jmodel, params, _, _ = _pair(arch)
    jeng = JaxServeEngine(jmodel, params, _cfg(JaxEngineConfig))
    reqs = jeng.serve(_requests(JaxRequest, arch))
    assert all(r.state == "done" for r in reqs)
    return ([r.output for r in reqs],
            {n: getattr(jeng.metrics, n) for n in COUNTERS}, jeng.kv_stats())


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_unified_engine_serves_as_jax(arch):
    """Concurrent chunked prefills of mixed widths packed with decode:
    outputs, counters and kv_stats equal the JAX engine's."""
    teng = ServeEngine(_pair(arch)[2], _cfg(EngineConfig), device="cpu")
    reqs = teng.serve(_requests(Request, arch))
    outs, counters, kv = _jax_served(arch)
    assert [r.output for r in reqs] == outs
    assert {n: getattr(teng.metrics, n) for n in COUNTERS} == counters
    assert teng.kv_stats() == kv
    assert teng.metrics.dispatches == teng.metrics.steps
    teng.pager.check()
    assert teng.pager.pages_in_use == 0


def test_yi_full_width_keeps_its_grouping():
    """The full configs this slice serves on the card: yi-34b at G = 7,
    deepseek-7b at G = 1 (MHA), both 128-wide heads."""
    yi, ds = treg.get_spec("yi-34b"), treg.get_spec("deepseek-7b")
    assert yi.n_heads // yi.n_kv_heads == 7 and yi.d_head == 128
    assert ds.n_heads == ds.n_kv_heads and ds.d_head == 128


def test_engine_refuses_hubert_tokens_as_the_reference():
    """An encoder-only model has no token embedding: both engines fail on
    its first step with the same AssertionError."""
    jmodel, params, tmodel, _ = _pair("hubert-xlarge")
    cfg = dict(cache_layout="dense", unified=False)
    with pytest.raises(AssertionError, match="take embeds"):
        JaxServeEngine(jmodel, params, _cfg(JaxEngineConfig, **cfg)).serve(
            [JaxRequest(prompt=[1, 2, 3], max_new_tokens=2)])
    with pytest.raises(AssertionError, match="take embeds"):
        ServeEngine(tmodel, _cfg(EngineConfig, **cfg), device="cpu").serve(
            [Request(prompt=[1, 2, 3], max_new_tokens=2)])
