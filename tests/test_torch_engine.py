"""Port parity: the port's unified paged ``ServeEngine`` against the JAX
``ServeEngine(EngineConfig(cache_layout="paged", unified=True))`` with the
same converted weights and the same greedy requests, and ``sample_slots``
greedy rows against JAX's.

Greedy outputs must be token-identical (float32 on the CPU) and the
scheduler's counters equal: ``steps``, ``preemptions``, ``decode_steps``,
``prefill_calls``, ``dispatches`` and ``transfers_d2h``.  One run has a
roomy pool; one has a pool small enough to force preemption.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import modelspec as jms
from repro.models import build_model as jax_build_model
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import Request as JaxRequest
from repro.serving import ServeEngine as JaxServeEngine
from repro.serving.sampling import sample_slots as jax_sample_slots
from repro_torch.configs import registry as treg
from repro_torch.core import modelspec as tms
from repro_torch.models import build_model, from_jax_params
from repro_torch.serving import (EngineConfig, Request, SamplingConfig,
                                 ServeEngine, sample_slots)

TINY = dict(name="tiny", d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_head=16, d_ff=128, vocab=256)
COUNTERS = ("steps", "preemptions", "decode_steps", "prefill_calls",
            "prefill_tokens", "generated_tokens", "dispatches",
            "transfers_d2h", "capacity_stops")


@pytest.fixture(scope="module")
def served():
    """Tiny GQA model: JAX weights, and the port model loaded from them."""
    jspec = jms.ModelSpec(**TINY, attn=jms.AttnSpec())
    tspec = tms.ModelSpec(**TINY, attn=tms.AttnSpec())
    jmodel = jax_build_model(jspec, mesh=None, param_dtype=jnp.float32,
                             compute_dtype=jnp.float32)
    params = jmodel.init(jax.random.key(0))
    tmodel = build_model(tspec, device="cpu", dtype=torch.float32)
    tmodel.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params),
                                           tspec))
    return jspec, jmodel, params, tmodel


def _cfg(cls, **kw):
    base = dict(max_slots=4, max_seq=64, chunk_size=4, prefill_rows=2,
                cache_layout="paged", page_size=8, unified=True)
    base.update(kw)
    return cls(**base)


def _serve_both(served, lengths, max_new, seed, **cfg_kw):
    spec, jmodel, params, tmodel = served
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, spec.vocab, size=n).tolist() for n in lengths]
    jeng = JaxServeEngine(jmodel, params, _cfg(JaxEngineConfig, **cfg_kw))
    jreqs = jeng.serve([JaxRequest(prompt=list(p), max_new_tokens=m)
                        for p, m in zip(prompts, max_new)])
    teng = ServeEngine(tmodel, _cfg(EngineConfig, **cfg_kw), device="cpu")
    treqs = teng.serve([Request(prompt=list(p), max_new_tokens=m)
                        for p, m in zip(prompts, max_new)])
    assert all(r.state == "done" for r in jreqs + treqs)
    return jeng, jreqs, teng, treqs


def _assert_same(jeng, jreqs, teng, treqs):
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    for name in COUNTERS:
        assert getattr(teng.metrics, name) == getattr(jeng.metrics, name), \
            name
    assert teng.steps == jeng.steps
    teng.pager.check()
    assert teng.pager.pages_in_use == 0  # every page freed on finish


def test_engine_matches_jax_mixed_workload(served):
    """Concurrent chunked prefills of mixed widths + decode, roomy pool."""
    lengths = [3, 11, 4, 17, 9, 5, 23, 8, 2, 13]
    max_new = [6, 3, 8, 6, 1, 6, 4, 6, 7, 5]
    jeng, jreqs, teng, treqs = _serve_both(served, lengths, max_new, seed=4)
    _assert_same(jeng, jreqs, teng, treqs)
    m = teng.metrics
    assert m.dispatches == m.transfers_d2h == m.steps > 0
    assert m.prefill_calls > 0 and m.decode_steps > 0


def test_engine_matches_jax_under_preemption(served):
    """A pool small enough to force victim preemption mid-decode:
    recompute-style resumption keeps outputs and counters identical."""
    lengths = [13, 11, 14, 12, 9, 15]
    jeng, jreqs, teng, treqs = _serve_both(
        served, lengths, [10] * len(lengths), seed=5, max_seq=32,
        page_size=4, n_pages=11)
    _assert_same(jeng, jreqs, teng, treqs)
    assert teng.metrics.preemptions > 0


def test_engine_capacity_and_eos_exits(served):
    """max_seq exit and eos exit behave as the reference's."""
    spec, _, _, tmodel = served
    eng = ServeEngine(tmodel, _cfg(EngineConfig, max_seq=16, page_size=4),
                      device="cpu")
    long_req = Request(prompt=list(range(1, 12)), max_new_tokens=50)
    eng.serve([long_req])
    assert long_req.state == "done"
    # exits once the cache holds max_seq - 1 tokens, plus the sampled one
    assert len(long_req.prompt) + len(long_req.output) == 16
    probe = Request(prompt=[5, 6, 7], max_new_tokens=3)
    ServeEngine(tmodel, _cfg(EngineConfig), device="cpu").serve([probe])
    eos = probe.output[1]
    stop = Request(prompt=[5, 6, 7], max_new_tokens=10, eos_id=eos)
    ServeEngine(tmodel, _cfg(EngineConfig), device="cpu").serve([stop])
    assert stop.output == probe.output[:probe.output.index(eos) + 1]
    with pytest.raises(ValueError, match="per-request capacity"):
        eng.submit(Request(prompt=list(range(20))))


def test_sample_slots_greedy_rows_equal_jax():
    """Greedy rows (temperature <= 0) take the first maximal index, exactly
    as JAX's argmax, ties included; stochastic rows stay inside top-k."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((6, 97)).astype(np.float32)
    logits[1, [5, 40]] = 9.0  # a tie: the first index wins
    logits[3, :] = 0.0  # all equal
    temps = np.asarray([0.0, 0.0, 0.8, -1.0, 1.0, 0.0], np.float32)
    topks = np.asarray([0, 3, 5, 0, 1, 0], np.int32)
    topps = np.asarray([1.0, 0.5, 0.9, 1.0, 1.0, 0.7], np.float32)
    keys = jax.random.split(jax.random.key(0), 6)
    want = np.asarray(jax_sample_slots(jnp.asarray(logits), keys,
                                       jnp.asarray(temps), jnp.asarray(topks),
                                       jnp.asarray(topps)))
    gen = torch.Generator().manual_seed(0)
    got = sample_slots(torch.from_numpy(logits), torch.from_numpy(temps),
                       torch.from_numpy(topks), torch.from_numpy(topps),
                       gen).numpy()
    greedy = temps <= 0
    np.testing.assert_array_equal(got[greedy], want[greedy])
    assert got[1] == 5 and got[3] == 0
    assert got[2] in np.argsort(-logits[2])[:5]
    assert got[4] == np.argmax(logits[4])  # top_k = 1 is greedy


def test_sample_slots_stochastic_rows_follow_the_distribution():
    """A stochastic row's draws follow softmax(logits / T) (Gumbel-max):
    total-variation distance to the exact distribution under 0.05 over
    4000 draws of an 8-way row."""
    logits = torch.tensor([[1.0, 2.0, 0.5, -1.0, 0.0, 1.5, -0.5, 0.2]])
    gen = torch.Generator().manual_seed(1)
    n = 4000
    draws = sample_slots(logits.expand(n, 8).contiguous(),
                         torch.full((n,), 0.7), torch.zeros(n, dtype=torch.int32),
                         torch.ones(n), gen)
    freq = torch.bincount(draws.long(), minlength=8).float() / n
    want = torch.softmax(logits[0] / 0.7, dim=-1)
    assert 0.5 * (freq - want).abs().sum() < 0.05


def test_engine_stochastic_requests_are_seeded():
    """The engine's generator makes stochastic serving reproducible."""
    spec = treg.get_reduced("minitron-8b")
    model = build_model(spec, device="cpu", dtype=torch.float32, seed=2)
    outs = []
    for _ in range(2):
        eng = ServeEngine(model, _cfg(EngineConfig), device="cpu", seed=9)
        reqs = eng.serve([Request(prompt=[1, 2, 3, 4, 5], max_new_tokens=6,
                                  sampling=SamplingConfig(temperature=1.0,
                                                          top_k=20))
                          for _ in range(3)])
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]
