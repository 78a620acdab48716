"""Port parity of the trace-replay workload: the port's ``generate_trace``
against the JAX package's for the same ``TraceConfig``, JSON traces read
across the two packages both ways, and ``replay`` driving the port's
unified engine.

Replays at ``time_scale=0`` submit every due request at once, so their
schedule depends on engine steps alone: the port's replay and the JAX
engine's then give equal outputs per trace index and equal counters
(float32 on the CPU, the port on its plain kernels).  At a compressed
but non-zero time scale the schedule follows the wall clock; the port's
outputs per trace index must still be equal with the prefix cache on and
off.
"""

import dataclasses
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import build_model as jax_build_model
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServeEngine as JaxServeEngine
from repro.serving import workload as jwl
from repro_torch.configs import registry as treg
from repro_torch.models import build_model, from_jax_params
from repro_torch.serving import (EngineConfig, ServeEngine, TraceConfig,
                                 generate_trace, replay, smoke_config,
                                 trace_from_json, trace_to_json)
from repro_torch.serving import workload as twl

COUNTERS = ("steps", "preemptions", "decode_steps", "prefill_calls",
            "prefill_tokens", "generated_tokens", "dispatches",
            "transfers_d2h", "prefix_lookups", "prefix_hits",
            "prefix_lookup_tokens", "prefix_hit_tokens",
            "prefix_cached_tokens", "prefix_cow_forks",
            "prefix_inserted_pages", "prefix_evicted_pages",
            "prefix_shared_pages_peak", "prefix_by_tenant")

_SMOKE = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SMOKE)
_SMOKE.loader.exec_module(chip_smoke)
# the chip smoke's multi-tenant trace at minitron-8b's vocabulary
CHIP = dict(chip_smoke.PREFIX_TRACE,
            vocab=treg.get_spec("minitron-8b").vocab)
CONFIGS = {"default": {}, "seed3": dict(n_requests=24, seed=3),
           "poisson": dict(seed=5, burst_factor=1.0), "chip": CHIP}


def _dicts(trace):
    return [dataclasses.asdict(r) for r in trace]


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("name", CONFIGS)
def test_generate_trace_matches_jax(name, smoke):
    kw = CONFIGS[name]
    tcfg, jcfg = TraceConfig(**kw), jwl.TraceConfig(**kw)
    if smoke:
        tcfg, jcfg = smoke_config(tcfg), jwl.smoke_config(jcfg)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    trace = generate_trace(tcfg)
    assert _dicts(trace) == _dicts(jwl.generate_trace(jcfg))
    assert any(t.parent is not None for t in trace)


def test_chip_trace_fits_the_chip_engine():
    """The chip smoke's trace: every request, its parent turns' prompts and
    outputs included, stays under the engine's max_seq."""
    trace = generate_trace(TraceConfig(**CHIP))
    full = []
    for t in trace:
        base = full[t.parent] if t.parent is not None else 0
        full.append(base + len(t.prompt) + t.max_new_tokens)
    assert max(full) < chip_smoke.GEOMETRY["max_seq"]
    assert len({t.tenant for t in trace}) == 3


@pytest.mark.parametrize("with_config", [False, True])
def test_trace_json_reads_across_packages(with_config):
    """A trace written by either package loads in the other, config
    optional; an unknown version is refused."""
    tcfg = TraceConfig(n_requests=12, seed=4)
    jcfg = jwl.TraceConfig(n_requests=12, seed=4)
    ttrace, jtrace = generate_trace(tcfg), jwl.generate_trace(jcfg)
    tjson = trace_to_json(ttrace, tcfg if with_config else None)
    jjson = jwl.trace_to_json(jtrace, jcfg if with_config else None)
    assert tjson == jjson
    assert trace_from_json(jjson) == ttrace
    assert _dicts(jwl.trace_from_json(tjson)) == _dicts(ttrace)
    assert twl.TRACE_VERSION == jwl.TRACE_VERSION
    with pytest.raises(ValueError, match="version"):
        trace_from_json('{"version": 99, "requests": []}')


@functools.lru_cache(maxsize=None)
def _pair(arch: str):
    """JAX model + params and the port model loaded from the same tree
    (float32); the JAX MoE on its dense path."""
    jspec, tspec = jreg.get_reduced(arch), treg.get_reduced(arch)
    jmodel = jax_build_model(jspec, mesh=None, param_dtype=jnp.float32,
                             compute_dtype=jnp.float32, moe_impl="dense")
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.key(3)))
    tmodel = build_model(tspec, device="cpu", dtype=torch.float32)
    tmodel.load_state_dict(from_jax_params(tree, tspec))
    return jspec, jmodel, jax.tree.map(jnp.asarray, tree), tmodel


def _cfg(cls, prefix_cache):
    return cls(max_slots=3, max_seq=64, chunk_size=8, prefill_rows=2,
               cache_layout="paged", page_size=8, unified=True,
               prefix_cache=prefix_cache, debug_guards=True)


@pytest.mark.parametrize("prefix_cache", [False, True],
                         ids=["cache_off", "cache_on"])
def test_replay_matches_jax(prefix_cache):
    """The smoke trace at time_scale 0 through both packages' engines:
    outputs per trace index, the continuations' resolved prompts and every
    counter equal."""
    jspec, jmodel, params, tmodel = _pair("minitron-8b")
    trace = generate_trace(smoke_config(TraceConfig(seed=0,
                                                    vocab=jspec.vocab)))
    jtrace = jwl.trace_from_json(trace_to_json(trace))
    jeng = JaxServeEngine(jmodel, params,
                          _cfg(JaxEngineConfig, prefix_cache),
                          rng=jax.random.key(1))
    jsum, jreqs = jwl.replay(jeng, jtrace, time_scale=0.0)
    teng = ServeEngine(tmodel, _cfg(EngineConfig, prefix_cache),
                       device="cpu")
    tsum, treqs = replay(teng, trace, time_scale=0.0)
    assert [r.prompt for r in treqs] == [r.prompt for r in jreqs]
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    for name in COUNTERS:
        assert getattr(teng.metrics, name) == getattr(jeng.metrics, name), \
            name
    assert tsum.n_requests == jsum.n_requests == len(trace)
    assert tsum.engine.keys() == jsum.engine.keys()
    assert {t: v["tokens"] for t, v in tsum.by_tenant.items()} \
        == {t: v["tokens"] for t, v in jsum.by_tenant.items()}
    if prefix_cache:
        assert teng.metrics.prefix_hits > 0


@pytest.mark.parametrize("arch", ["minitron-8b", "deepseek-moe-16b"])
def test_replay_cache_on_equals_cache_off(arch):
    """The smoke trace at a compressed wall clock on the port's engine:
    every request finishes within generous SLOs, continuations carry their
    parent's history, and outputs per trace index are equal with the
    prefix cache on and off, the cache prefilling fewer tokens."""
    jspec, _, _, tmodel = _pair(arch)
    trace = generate_trace(smoke_config(TraceConfig(seed=0,
                                                    vocab=jspec.vocab)))
    outs, engs = {}, {}
    for on in (False, True):
        eng = ServeEngine(tmodel, _cfg(EngineConfig, on), device="cpu")
        summary, reqs = replay(eng, trace, ttft_slo_s=30.0, tpot_slo_s=30.0,
                               time_scale=0.2)
        assert all(r.state == "done" for r in reqs)
        assert summary.n_requests == len(trace)
        assert summary.slo_attainment == 1.0
        assert summary.goodput_tok_s == summary.throughput_tok_s > 0
        assert set(summary.by_tenant) == {t.tenant for t in trace}
        for i, t in enumerate(trace):
            if t.parent is not None:
                par = reqs[t.parent]
                assert reqs[i].prompt == (list(par.prompt) + par.output
                                          + list(t.prompt))
        outs[on], engs[on] = [r.output for r in reqs], eng
    assert outs[True] == outs[False]
    on, off = engs[True].metrics, engs[False].metrics
    assert on.prefix_hits > 0
    assert on.prefill_tokens < off.prefill_tokens
    assert on.dispatches == on.steps + on.prefix_cow_forks
    assert off.dispatches == off.transfers_d2h == off.steps
