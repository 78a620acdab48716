"""The port's GenZ analytical core and Scenario layer against the JAX
package's, on the CPU.

The analytical side is the same pure-Python arithmetic in both packages,
so every comparison here is exact (``==`` on floats): the model accounting
of every Table-IV and registry spec, the analytical backend's whole
``Report.to_dict()`` over a grid of modes, platforms, tp degrees, dtypes,
paged KV and prefix hits, ``Sweep`` sizes and pruning, the §VI
requirements, the disaggregation planner, JSON written by one package and
read by the other, and the deprecated ``GenZ`` shim's single warning.
"""

import dataclasses
import itertools
import json
import warnings

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core as jcore
import repro.scenario as jscen
import repro_torch.core as tcore
import repro_torch.scenario as tscen
from repro.configs import registry as jreg
from repro.core import disagg as jdisagg
from repro.core import requirements as jreq
from repro_torch.configs import registry as treg
from repro_torch.core import disagg as tdisagg
from repro_torch.core import requirements as treq

ARCHS = sorted(treg.ARCH_IDS)
PAPER = sorted(tcore.PAPER_MODELS)
PLATFORMS = ("hgx-h100x1", "hgx-h100x8", "gb200x8", "v5e-1x16x16", "gpus",
             "sram_wafer", "sram_chips", "asics")
MODES = ("monolithic", "chunked", "speculative", "disaggregated")
MODELS = ("llama3-8b", "llama3-70b", "mixtral-8x7b", "falcon-mamba-7b",
          "minitron-8b", "deepseek-moe-16b", "jamba-v0.1-52b",
          "mistral-7b-swa")


def _ref_scenario(sc: tscen.Scenario) -> jscen.Scenario:
    """The port's Scenario as the JAX package's, through the JSON codec
    (both tag each dataclass by its class name)."""
    return jscen.Scenario.from_json(sc.to_json())


# ---------------------------------------------------------------------------
# model accounting
# ---------------------------------------------------------------------------

def _accounting(spec) -> dict:
    out = {"param_count": spec.param_count(),
           "active_param_count": spec.active_param_count(),
           "n_attn_layers": spec.n_attn_layers(),
           "n_ssm_layers": spec.n_ssm_layers(),
           "layer_kinds": spec.layer_kinds(),
           "moe_layers": spec.moe_layer_indices(),
           "long_context": spec.supports_long_context,
           "attention_free": spec.is_attention_free,
           "embedding_params": spec.embedding_params()}
    for dt in ("bf16", "fp8", "int4"):
        out[dt] = (spec.kv_bytes_per_token(dt), spec.ssm_state_bytes(dt),
                   spec.weight_bytes(dt),
                   spec.kv_cache_bytes(8, 1024, 32, beam=2, dtype=dt))
    return out


@pytest.mark.parametrize("name", PAPER)
def test_paper_model_accounting_matches(name):
    t, j = tcore.PAPER_MODELS[name], jcore.PAPER_MODELS[name]
    assert tcore.paper_model(name) is t
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert _accounting(t) == _accounting(j)


@pytest.mark.parametrize("arch", ARCHS)
def test_registry_accounting_matches(arch):
    for get in ("get_spec", "get_reduced"):
        t, j = getattr(treg, get)(arch), getattr(jreg, get)(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), (arch, get)
        assert _accounting(t) == _accounting(j), (arch, get)


def test_registry_resolves_the_same_names():
    assert set(treg.ARCH_IDS) == set(jreg.ARCH_IDS)
    for name in PAPER + ARCHS:
        assert dataclasses.asdict(tscen.resolve_model(name)) \
            == dataclasses.asdict(jscen.resolve_model(name))
    with pytest.raises(ValueError, match="paper models"):
        tscen.resolve_model("llama-9000")


def test_platform_catalog_matches():
    assert tscen.platform_names() == jscen.platform_names()
    for name in PLATFORMS + ("hgx-h100x4", "gb200x16", "v5e-2x8x8"):
        t = tscen.resolve_platform(name)
        j = jscen.resolve_platform(name)
        assert json.dumps(tscen.Scenario.make(
            "llama3-8b", use_case="chat", platform=t).to_dict()) \
            == json.dumps(jscen.Scenario.make(
                "llama3-8b", use_case="chat", platform=j).to_dict())


# ---------------------------------------------------------------------------
# the analytical backend, Report for Report
# ---------------------------------------------------------------------------

def _grid_scenario(platform, tp, mode, k):
    """One point of the grid: the model, dtypes, paged KV and prefix hits
    drawn from a seeded generator for (platform, tp, mode)."""
    rng = np.random.default_rng(k)
    model = MODELS[int(rng.integers(len(MODELS)))]
    dt = ("fp8", "bf16")[int(rng.integers(2))]
    paged = bool(rng.integers(2))
    hit = (0.0, 0.5)[int(rng.integers(2))] if paged else 0.0
    uc = ("chat", "question_answering", "code_generation")[
        int(rng.integers(3))]
    kw = {}
    if mode == "chunked":
        kw["chunked"] = tscen.ChunkedSpec(chunk=(128, 512)[k % 2],
                                          decode_batch=1 + k % 8)
    elif mode == "speculative":
        kw["speculative"] = tscen.SpeculativeSpec(draft="llama3-8b", n=4,
                                                  gamma=0.8)
    elif mode == "disaggregated" and k % 2:
        kw["disaggregated"] = tscen.DisaggSpec(
            total_npus=2, colocated_tp=1, tp_options=(1,))
    return tscen.Scenario.make(
        model, use_case=uc, batch=1 + int(rng.integers(16)),
        platform=platform, parallelism=dict(tp=tp), mode=mode,
        opt=dict(weight_dtype=dt, act_dtype=dt, kv_dtype=dt, paged_kv=paged,
                 prefix_hit_rate=hit), **kw)


GRID = list(itertools.product(PLATFORMS, (1, 2, 4, 8)))


@pytest.mark.parametrize("platform,tp", GRID,
                         ids=[f"{p}-tp{t}" for p, t in GRID])
def test_analytical_reports_equal(platform, tp):
    statuses = set()
    for i, mode in enumerate(MODES):
        sc = _grid_scenario(platform, tp, mode,
                            GRID.index((platform, tp)) * 4 + i)
        t = tscen.run([sc], max_workers=1)[0]
        j = jscen.run([_ref_scenario(sc)], max_workers=1)[0]
        assert t.to_dict() == j.to_dict(), (platform, tp, mode)
        statuses.add(t.status)
    assert statuses


def test_minitron_on_one_h100_matches_in_every_mode():
    """The scenario ``chip_smoke.py`` measures, priced by both packages."""
    spec = treg.get_spec("minitron-8b")
    base = tscen.Scenario.make(spec, workload=tcore.Workload(
        batch=8, tau_p=1024, tau_d=32), platform="hgx-h100x1")
    scs = [base,
           base.replace(mode="chunked", chunked=tscen.ChunkedSpec(
               chunk=128, decode_batch=8)),
           base.replace(mode="speculative", speculative=tscen.SpeculativeSpec(
               draft=spec, n=4)),
           base.replace(mode="disaggregated", disaggregated=tscen.DisaggSpec(
               total_npus=2, colocated_tp=1, tp_options=(1,))),
           base.replace(mode="disaggregated")]
    reps = tscen.run(scs, max_workers=1)
    refs = jscen.run([_ref_scenario(s) for s in scs], max_workers=1)
    assert [r.to_dict() for r in reps] == [r.to_dict() for r in refs]
    assert [r.status for r in reps] == ["ok"] * 4 + ["infeasible"]


@settings(max_examples=40, deadline=None)
@given(model=st.sampled_from(MODELS), platform=st.sampled_from(PLATFORMS),
       tp=st.sampled_from((1, 2, 4, 8)), pp=st.sampled_from((1, 2)),
       mode=st.sampled_from(MODES), dt=st.sampled_from(("fp8", "bf16")),
       paged=st.booleans(), hit=st.sampled_from((0.0, 0.25, 0.9)),
       batch=st.integers(1, 64), tau_p=st.integers(1, 40000),
       tau_d=st.integers(1, 4000))
def test_analytical_reports_equal_property(model, platform, tp, pp, mode, dt,
                                           paged, hit, batch, tau_p, tau_d):
    kw = {"speculative": tscen.SpeculativeSpec(draft="llama3-8b")} \
        if mode == "speculative" else {}
    sc = tscen.Scenario.make(
        model, workload=tcore.Workload(batch=batch, tau_p=tau_p,
                                       tau_d=tau_d),
        platform=platform, parallelism=dict(tp=tp, pp=pp), mode=mode,
        opt=dict(weight_dtype=dt, act_dtype=dt, kv_dtype=dt,
                 paged_kv=paged, prefix_hit_rate=hit if paged else 0.0),
        **kw)
    t = tscen.run([sc], max_workers=1)[0]
    j = jscen.run([_ref_scenario(sc)], max_workers=1)[0]
    assert t.to_dict() == j.to_dict()


# ---------------------------------------------------------------------------
# Sweep, requirements, the disaggregation planner
# ---------------------------------------------------------------------------

SWEEPS = {
    "tp": dict(tp=[1, 2, 4, 8, 16]),
    "models-tp": dict(model=["llama3-8b", "llama3-70b", "mixtral-8x7b"],
                      tp=[1, 2, 4, 8]),
    "pp-ep": dict(model=["mixtral-8x7b", "llama3-8b"], pp=[1, 4, 64],
                  ep=[1, 8, 16]),
    "use-case-batch": dict(use_case=["chat", "qa_rag"], batch=[1, 8],
                           kv_dtype=["fp8", "bf16"]),
    "platform-mode": dict(platform=["hgx-h100x1", "hgx-h100x8", "gb200x8"],
                          mode=["monolithic", "chunked"], tp=[1, 8]),
}


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_sweep_sizes_and_pruning_match(name):
    axes = SWEEPS[name]
    t_base = tscen.Scenario.make("llama3-8b", use_case="chat", batch=4,
                                 platform="hgx-h100x8")
    j_base = _ref_scenario(t_base)
    t = tscen.Sweep(t_base).over(**axes)
    j = jscen.Sweep(j_base).over(**axes)
    assert len(t) == len(j) > 0
    assert [s.to_dict() for s in t] == [s.to_dict() for s in j]
    assert [tscen.feasible(s) for s in tscen.sweep(t_base, **axes)] \
        == [jscen.feasible(s) for s in jscen.sweep(j_base, **axes)]
    pred = lambda sc: sc.parallelism.tp < 8  # noqa: E731
    assert [s.to_dict() for s in tscen.Sweep(t_base).over(**axes)
            .where(pred)] == [s.to_dict() for s in jscen.Sweep(j_base)
                              .over(**axes).where(pred)]


@pytest.mark.parametrize("model", MODELS)
def test_requirements_match(model):
    t_spec, j_spec = tscen.resolve_model(model), jscen.resolve_model(model)
    for uc in sorted(tcore.USE_CASES):
        for dt in ("fp8", "bf16"):
            t_opt = tcore.Optimizations(weight_dtype=dt, kv_dtype=dt)
            j_opt = jcore.Optimizations(weight_dtype=dt, kv_dtype=dt)
            t_wl = tcore.use_case(uc, batch=16)
            j_wl = jcore.use_case(uc, batch=16)
            assert dataclasses.asdict(treq.platform_requirements(
                t_spec, t_wl, t_opt)) == dataclasses.asdict(
                jreq.platform_requirements(j_spec, j_wl, j_opt))
    sc = tscen.Scenario.make(model, use_case="chat", batch=8)
    assert dataclasses.asdict(treq.scenario_requirements(sc)) \
        == dataclasses.asdict(jreq.scenario_requirements(_ref_scenario(sc)))


@pytest.mark.parametrize("platform,kw", [
    ("hgx-h100x8", {}),
    ("hgx-h100x8", dict(total_npus=8, tp_options=(1, 2, 4))),
    ("hgx-h100x1", dict(total_npus=2, colocated_tp=1, tp_options=(1,))),
    ("hgx-h100x1", {}),
    ("gb200x8", dict(inter_pool_bw=25e9, colocated_chunk=256)),
    ("gpus", dict(total_npus=16)),
], ids=["default", "tp124", "h100x1-split", "h100x1-default", "gb200-slow",
        "gpus16"])
def test_plan_with_baseline_matches(platform, kw):
    for model in ("llama3-8b", "minitron-8b", "mixtral-8x7b"):
        args = []
        for scen, core in ((tscen, tcore), (jscen, jcore)):
            args.append((scen.resolve_model(model),
                         scen.resolve_platform(platform),
                         core.Workload(batch=8, tau_p=1024, tau_d=128,
                                       ttft_slo=0.5, tpot_slo=0.05),
                         core.Optimizations()))
        assert _plans(tdisagg, args[0], kw) == _plans(jdisagg, args[1], kw)


def _plans(module, args, kw):
    """The plans and the colocated baseline as plain data, or the planner's
    refusal (the default colocated tp of 8 exceeds one H100)."""
    try:
        plans, co = module.plan_with_baseline(*args, **kw)
    except ValueError as e:
        return "refused", str(e)
    return [dataclasses.asdict(p) for p in plans], co


def test_pool_split_reads_the_ports_own_plan():
    from repro_torch.serving import pool_split_from_plan
    spec = treg.get_spec("minitron-8b")
    plat = tscen.resolve_platform("hgx-h100x8")
    plans, _ = tdisagg.plan_with_baseline(
        spec, plat, tcore.Workload(batch=8, tau_p=1024, tau_d=32),
        tcore.Optimizations())
    assert plans and isinstance(plans[0], tdisagg.DisaggPlan)
    rows, slots = pool_split_from_plan(plans[0], 8)
    assert rows >= 1 and slots >= 1 and rows + slots == 8


# ---------------------------------------------------------------------------
# JSON across the two packages; the deprecated facade
# ---------------------------------------------------------------------------

def _scenarios():
    base = tscen.Scenario.make("llama3-8b", use_case="chat", batch=4,
                               platform="hgx-h100x8", parallelism=dict(tp=8))
    return [
        base,
        base.replace(mode="chunked", chunked=tscen.ChunkedSpec(chunk=256)),
        base.replace(mode="speculative", speculative=tscen.SpeculativeSpec(
            draft=treg.get_reduced("minitron-8b"), n=3, gamma=0.7)),
        base.replace(mode="disaggregated", disaggregated=tscen.DisaggSpec(
            total_npus=8, tp_options=(1, 2, 4))),
        base.replace(model=treg.get_spec("jamba-v0.1-52b"),
                     platform=tscen.resolve_platform("gb200x8")),
    ]


@pytest.mark.parametrize("k", range(5), ids=MODES + ("inline",))
def test_json_crosses_packages_both_ways(k):
    sc = _scenarios()[k]
    ref = jscen.Scenario.from_json(sc.to_json())
    assert ref.to_json() == sc.to_json()
    assert tscen.Scenario.from_json(ref.to_json()) == sc
    t_rep = tscen.run([sc], max_workers=1)[0]
    j_rep = jscen.Report.from_json(t_rep.to_json())
    assert j_rep.to_json() == t_rep.to_json()
    back = tscen.Report.from_json(jscen.run([ref], max_workers=1)[0]
                                  .to_json())
    assert back == t_rep


def test_genz_shim_warns_once_and_matches():
    from repro.core import genz as jgenz
    from repro_torch.core import genz as tgenz
    fp8 = dict(weight_dtype="fp8", act_dtype="fp8", kv_dtype="fp8")
    t = tcore.GenZ.hgx_h100(8).with_opt(**fp8)
    j = jcore.GenZ.hgx_h100(8).with_opt(**fp8)
    tgenz.reset_deprecation_warnings()
    jgenz.reset_deprecation_warnings()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        olds = [t.estimate("llama3-8b", use_case="chat", batch=4,
                           parallelism=dict(tp=8)) for _ in range(3)]
    deps = [w for w in caught if issubclass(w.category, DeprecationWarning)]
    assert len(deps) == 1
    assert "repro_torch.scenario.Scenario" in str(deps[0].message)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = j.estimate("llama3-8b", use_case="chat", batch=4,
                         parallelism=dict(tp=8))
    assert all((o.ttft, o.tpot, o.throughput) == (ref.ttft, ref.tpot,
                                                  ref.throughput)
               for o in olds)


@pytest.mark.parametrize("name,argv", [
    ("quickstart", []),
    ("platform_dse", []),
    ("platform_dse", ["--model", "llama3-70b", "--input", "2048",
                      "--output", "256", "--batch", "32"]),
], ids=["quickstart", "platform_dse", "platform_dse-70b"])
def test_launchers_print_the_examples_lines(name, argv, capsys, monkeypatch):
    """``repro_torch.launch.quickstart`` / ``platform_dse`` print exactly
    the lines of the reference's ``examples/`` scripts."""
    import importlib.util
    import sys
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_example_{name}", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    monkeypatch.setattr(sys, "argv", [str(path)] + argv)
    example.main()
    want = capsys.readouterr().out
    port = importlib.import_module(f"repro_torch.launch.{name}")
    port.main(argv)
    assert capsys.readouterr().out == want
