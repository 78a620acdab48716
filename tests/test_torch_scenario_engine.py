"""The port's engine backend against ``repro.scenario.engine_backend``, on
the CPU.

The same Scenario (the reference's tiny spec, its ``ENGINE_KW``) is
lowered by both packages: the JAX one onto its engines, the port onto
``ServeEngine`` / ``DisaggCluster`` with ``device="cpu"`` and the weights
of the reference's ``model.init(jax.random.key(0))`` (``from_jax_params``;
the port's ``lower_model`` is patched to load them).  Both Reports must
agree in status, ``extra["lowering"]``, ``extra["engine_config"]`` (apart
from the port-only ``device``, ``dtype`` and ``decode_unified``),
``extra["kv"]`` and every counter of ``extra["engine"]`` (only the
wall-clock fields are dropped), in every mode; the refusals must carry the
reference's messages.  A tp/pp Scenario outside a process group of the
ranks it needs is the engine's error naming them (the sharded Reports
themselves are held by ``tests/test_torch_sharded.py``).  Each Report is
computed once per module (the JAX engines compile per instance) and shared
by the cases that read it.
"""

import dataclasses
import functools
import json
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from repro.scenario import Scenario as JaxScenario
from repro.scenario import engine_backend as jeb
from repro.scenario.codec import decode as jax_decode
from repro_torch.configs import registry as treg
from repro_torch.core.modelspec import AttnSpec, ModelSpec
from repro_torch.core.stages import Workload
from repro_torch.models import build_model, from_jax_params
from repro_torch.scenario import (ChunkedSpec, DisaggSpec, Report, Scenario,
                                  SpeculativeSpec, run)
from repro_torch.scenario import engine_backend as teb
from repro_torch.scenario.codec import encode

# the reference's tests/test_scenario.py: ENGINE_KW and the tiny spec
ENGINE_KW = dict(max_slots=4, max_seq=64, max_prompt=12, max_new=6,
                 prefill_rows=2)
TINY = ModelSpec(name="tiny", d_model=64, n_layers=2, n_heads=4,
                 n_kv_heads=2, d_head=16, d_ff=128, vocab=256,
                 attn=AttnSpec(kind="full", causal=True))
PORT_ONLY = ("device", "dtype", "decode_unified")
#: wall-clock fields of the engine and cluster summaries
TIMED = ("wall_s", "tokens_per_s", "goodput_tok_s", "ttft_s_mean",
         "ttft_s_p50", "ttft_s_p95", "tpot_s_mean",
         "ttft_incl_migration_s_mean", "ttft_incl_migration_s_p95",
         "migration_wait_s_mean")


def _scenario(mode="monolithic", **kw) -> Scenario:
    return Scenario.make(TINY, workload=Workload(batch=3, tau_p=12, tau_d=6),
                         batch=3, mode=mode, **kw)


CASES = {
    "monolithic": (_scenario(), {}),
    "chunked": (_scenario("chunked", chunked=ChunkedSpec(
        chunk=4, decode_batch=2)), {}),
    "chunked-unified": (_scenario("chunked", chunked=ChunkedSpec(
        chunk=4, decode_batch=2)), dict(unified=True)),
    "prefix": (_scenario("chunked", chunked=ChunkedSpec(chunk=4),
                         opt=dict(paged_kv=True, kv_page_size=4,
                                  prefix_hit_rate=0.5)),
               dict(n_requests=6)),
    "speculative": (_scenario("speculative", speculative=SpeculativeSpec(
        draft=TINY, n=2)), {}),
    "disaggregated": (_scenario("disaggregated"), {}),
}


@functools.lru_cache(maxsize=None)
def _jax_params(spec_json: str):
    """The reference's weights of a spec (``model.init(key(0))``, as its
    ``lower_model`` draws them), as numpy; the spec crosses to the
    reference through the JSON codec."""
    _, _, params = jeb.lower_model(jax_decode(json.loads(spec_json)))
    return jax.tree.map(np.asarray, params)


def _converted(ref, *, device=None, dtype=None, seed=0):
    """The port's ``lower_model`` with the reference's weights."""
    spec = ref if isinstance(ref, ModelSpec) else treg.get_reduced(ref)
    model = build_model(spec, device, dtype or torch.float32, seed=seed)
    params = _jax_params(json.dumps(encode(spec)))
    model.load_state_dict(from_jax_params(params, spec))
    return spec, model


@functools.lru_cache(maxsize=None)
def _jax_report(case: str):
    sc, kw = CASES[case]
    return jeb.evaluate(JaxScenario.from_json(sc.to_json()),
                        **ENGINE_KW, **kw)


@functools.lru_cache(maxsize=None)
def _port_report(case: str):
    sc, kw = CASES[case]
    with mock.patch.object(teb, "lower_model", _converted):
        return teb.evaluate(sc, device="cpu", **ENGINE_KW, **kw)


def _untimed(summary: dict) -> dict:
    """A summary without its wall-clock fields, every dict key a str."""
    out = {}
    for k, v in summary.items():
        if k in TIMED:
            continue
        out[str(k)] = _untimed(v) if isinstance(v, dict) else v
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_backend_matches_the_reference(case):
    rep, ref = _port_report(case), _jax_report(case)
    assert rep.status == ref.status == "ok", (rep.error, ref.error)
    assert rep.backend == "engine"
    assert rep.extra["lowering"] == ref.extra["lowering"]
    cfg = rep.extra["engine_config"]
    assert cfg["device"] == "cpu" and cfg["dtype"] == "float32"
    assert {k: v for k, v in cfg.items() if k not in PORT_ONLY} \
        == ref.extra["engine_config"]
    assert rep.extra["kv"] == ref.extra["kv"]
    assert _untimed(rep.extra["engine"]) == _untimed(ref.extra["engine"])
    assert rep.max_concurrency == ref.max_concurrency
    assert rep.extra["engine"]["generated_tokens"] \
        == 6 * (6 if case == "prefix" else 3)
    for key in ("model", "draft", "acceptance_rate", "tokens_per_pass",
                "target_passes", "plan", "colocated",
                "predicted_kv_transfer_s", "measured_kv_transfer_s"):
        assert rep.extra.get(key) == ref.extra.get(key), key
    assert set(rep.extra) == set(ref.extra)
    for f in ("ttft_s", "tpot_s", "throughput_tok_s", "latency_s"):
        assert getattr(rep, f) > 0, f
    assert Report.from_json(rep.to_json()) == rep


def test_counters_cover_every_mode():
    """The counters the comparison above holds are the ones each mode
    moves: prefix hits, speculation, migrations."""
    prefix = _port_report("prefix").extra["engine"]
    assert prefix["prefix_hits"] > 0 and prefix["prefix_cached_tokens"] > 0
    spec = _port_report("speculative").extra
    assert spec["engine"]["spec_proposed"] > 0
    assert spec["acceptance_rate"] == 1.0  # a self-draft, in f32
    disagg = _port_report("disaggregated").extra["engine"]
    assert disagg["migrations"] == 3 and disagg["migrated_bytes"] > 0
    assert disagg["decode"]["imports"] == 3


def _refusal(sc, **kw):
    """The port's and the reference's error Reports for ``sc``."""
    kw = dict(ENGINE_KW, **kw)
    rep = teb.evaluate(sc, device="cpu", **kw)
    ref = jeb.evaluate(JaxScenario.from_json(sc.to_json()), **kw)
    assert rep.status == ref.status == "error"
    return rep.error, ref.error


@pytest.mark.parametrize("case", ["paper-model", "paper-draft",
                                  "max-slots-1", "ssm", "swa",
                                  "swa-chunked-unified"])
def test_refusals_carry_the_reference_messages(case):
    sc, kw = {
        "paper-model": (Scenario.make("llama3-70b", use_case="chat",
                                      batch=1), {}),
        "paper-draft": (_scenario("speculative", speculative=SpeculativeSpec(
            draft="llama2-7b", n=2)), dict(unified=True)),
        "max-slots-1": (_scenario("disaggregated"), dict(max_slots=1)),
        "ssm": (_scenario("disaggregated").replace(
            model=treg.get_reduced("rwkv6-3b")), {}),
        "swa": (_scenario("disaggregated").replace(
            model=treg.get_reduced("mistral-7b-swa")), {}),
        "swa-chunked-unified": (_scenario("chunked", chunked=ChunkedSpec(
            chunk=4, decode_batch=2)).replace(
            model=treg.get_reduced("mistral-7b-swa")), dict(unified=True)),
    }[case]
    got, want = _refusal(sc, **kw)
    # the one difference: the registry named is the port's own
    assert got == want.replace("repro.configs", "repro_torch.configs")
    assert {"paper-model": "reduced", "paper-draft": "reduced",
            "max-slots-1": "max_slots", "ssm": "SSM",
            "swa": "sliding-window",
            "swa-chunked-unified": "ValueError: unified=True has no "
            "sliding-window"}[case] in got


def test_unified_engine_refuses_a_window_as_the_reference_does():
    """A sliding-window model on the unified step: the port's engine raises
    the reference's exception type and text, and raises it where the
    reference does, ahead of the prefix-cache and speculation checks (the
    config also asks for both, without a draft model)."""
    from repro.configs.registry import get_reduced as jax_reduced
    from repro.models import build_model as jax_build_model
    from repro.serving import EngineConfig as JaxEngineConfig
    from repro.serving import ServeEngine as JaxServeEngine
    from repro_torch.serving import EngineConfig, ServeEngine
    kw = dict(max_slots=2, max_seq=64, page_size=8, chunk_size=8,
              cache_layout="paged", unified=True, prefix_cache=True,
              n_spec=2)
    with pytest.raises(Exception) as ref:
        JaxServeEngine(jax_build_model(jax_reduced("mistral-7b-swa")), None,
                       JaxEngineConfig(**kw))
    with pytest.raises(Exception) as got:
        ServeEngine(build_model(treg.get_reduced("mistral-7b-swa"),
                                device="cpu", dtype=torch.float32),
                    EngineConfig(**kw), device="cpu")
    assert type(got.value) is type(ref.value) is ValueError
    assert str(got.value) == str(ref.value) == (
        "unified=True has no sliding-window masking in the ragged kernel "
        "yet")


@pytest.mark.parametrize("mode", ["monolithic", "chunked", "speculative",
                                  "disaggregated"])
def test_tp_lowers_to_the_sharded_engine_or_is_refused(mode):
    """tp=2 lowers the monolithic and chunked modes onto the sharded
    unified engine, which outside a process group of 2 ranks is an error
    Report naming the ranks and how to launch them; the speculative and
    disaggregated modes carry the reference's refusal.  ep=2 is the
    reference's axis refusal in every mode."""
    kw = {"speculative": dict(speculative=SpeculativeSpec(draft=TINY, n=2))
          }.get(mode, {})
    sc = _scenario(mode, parallelism=dict(tp=2), **kw)
    if mode in ("monolithic", "chunked"):
        rep, = run([sc], backend="engine",
                   engine_kw=dict(ENGINE_KW, device="cpu"))
        assert rep.status == "error"
        assert rep.error.startswith(
            "ValueError: tp=2 x pp=1 needs a torch.distributed process "
            "group of 2 ranks, but the group is not initialised; launch 2 "
            "ranks with torchrun --nproc-per-node 2"), rep.error
    else:
        got, want = _refusal(sc)
        assert got == want and mode in got and "TP=2" in got
    got, want = _refusal(_scenario(mode, parallelism=dict(ep=2), **kw))
    assert got == want and "ep=2" in got.lower()


JAMBA_CASES = {
    "monolithic": (_scenario(), {}),
    "chunked": (_scenario("chunked", chunked=ChunkedSpec(
        chunk=4, decode_batch=2)), {}),
    "chunked-unified": (_scenario("chunked", chunked=ChunkedSpec(
        chunk=4, decode_batch=2)), dict(unified=True)),
    "speculative": (_scenario("speculative", speculative=SpeculativeSpec(
        draft=treg.get_reduced("jamba-v0.1-52b"), n=2)), {}),
    "disaggregated": (_scenario("disaggregated"), {}),
}


def _jamba_reports(case):
    """The port's and the reference's Reports of the reduced jamba hybrid
    in ``JAMBA_CASES[case]``, the port on the reference's weights."""
    sc, kw = JAMBA_CASES[case]
    sc = sc.replace(model=treg.get_reduced("jamba-v0.1-52b"))
    with mock.patch.object(teb, "lower_model", _converted):
        rep = teb.evaluate(sc, device="cpu", **ENGINE_KW, **kw)
    ref = jeb.evaluate(JaxScenario.from_json(sc.to_json()), **ENGINE_KW,
                       **kw)
    return rep, ref


def test_unported_architectures_are_error_reports():
    """Every registry architecture now lowers as the reference's: the
    jamba hybrid's monolithic Report equals the reference's (lowering,
    engine config, kv stats and every counter); hubert-xlarge, an encoder
    with no token embedding, is the reference's error Report; an unknown
    arch is an error Report."""
    rep, ref = _jamba_reports("monolithic")
    assert rep.status == ref.status == "ok", (rep.error, ref.error)
    assert rep.extra["lowering"] == ref.extra["lowering"]
    assert {k: v for k, v in rep.extra["engine_config"].items()
            if k not in PORT_ONLY} == ref.extra["engine_config"]
    assert rep.extra["kv"] == ref.extra["kv"]
    assert _untimed(rep.extra["engine"]) == _untimed(ref.extra["engine"])
    hubert = _scenario().replace(model=treg.get_reduced("hubert-xlarge"))
    with mock.patch.object(teb, "lower_model", _converted):
        rep = teb.evaluate(hubert, device="cpu", **ENGINE_KW)
    ref = jeb.evaluate(JaxScenario.from_json(hubert.to_json()), **ENGINE_KW)
    assert rep.status == ref.status == "error"
    assert rep.error == ref.error == \
        "AssertionError: encoder-only frontend archs take embeds"
    rep = teb.evaluate(_scenario().replace(mode="monolithic").replace(
        model="no-such-arch"), device="cpu", **ENGINE_KW)
    assert rep.status == "error" and "unknown arch" in rep.error


@pytest.mark.parametrize("case", sorted(set(JAMBA_CASES) - {"monolithic"}))
def test_jamba_reports_equal_the_reference(case):
    """The jamba hybrid in the other modes: the dense two-dispatch chunked
    Report equals the reference's; where the reference refuses its Mamba
    layers (the unified step, speculation, the disaggregated prefill pool)
    the port gives the same error."""
    rep, ref = _jamba_reports(case)
    assert rep.status == ref.status, (rep.error, ref.error)
    if case == "chunked":
        assert rep.status == "ok", rep.error
        assert rep.extra["lowering"] == ref.extra["lowering"]
        assert rep.extra["kv"] == ref.extra["kv"]
        assert _untimed(rep.extra["engine"]) == _untimed(ref.extra["engine"])
    else:
        assert rep.status == "error" and rep.error == ref.error
        assert "SSM layers" in rep.error


def test_lower_then_serve_equals_evaluate(monkeypatch):
    """``evaluate`` is ``lower`` -> ``serve`` -> the Report; an engine that
    ``lower`` built, warmed by one short serve and its metrics reset,
    serves the same requests to the same counters and tokens."""
    from repro_torch.serving import EngineMetrics, Request
    sc, kw = CASES["chunked-unified"]
    monkeypatch.setattr(teb, "lower_model", _converted)
    cold_low = teb.serve(teb.lower(sc, device="cpu", **ENGINE_KW, **kw))
    cold = teb.report(cold_low)
    assert _untimed(cold.extra["engine"]) == _untimed(teb.evaluate(
        sc, device="cpu", **ENGINE_KW, **kw).extra["engine"])
    low = teb.lower(sc, device="cpu", **ENGINE_KW, **kw)
    assert low.kind == "engine" and low.geometry == cold.extra["lowering"]
    low.runner.serve([Request(prompt=list(range(1, 10)), max_new_tokens=2)])
    low.runner.metrics = EngineMetrics()
    warm = teb.report(teb.serve(low))
    assert _untimed(warm.extra["engine"]) == _untimed(cold.extra["engine"])
    assert [r.output for r in low.requests] \
        == [r.output for r in cold_low.requests]


def test_evaluate_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        teb.evaluate(_scenario(), **ENGINE_KW)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        teb.lower(_scenario(), **ENGINE_KW)
    assert teb.DEFAULTS["device"] is None and teb.DEFAULTS["dtype"] is None
    assert set(teb.DEFAULTS) - set(jeb.DEFAULTS) == {"device", "dtype"}
    assert teb.LOWERABLE_MODES == jeb.LOWERABLE_MODES


def test_reference_report_reads_back_in_the_port():
    """A measured Report the reference wrote decodes in the port."""
    ref = _jax_report("disaggregated")
    assert Report.from_json(ref.to_json()).to_json() == ref.to_json()
    assert dataclasses.asdict(Report.from_json(ref.to_json()).scenario
                              .model) == dataclasses.asdict(TINY)
