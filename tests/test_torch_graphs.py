"""The port's compiled steps on the CPU: ``StepGraph``'s static-tensor path
against the JAX engine, the static tensors' addresses, ``debug_guards``
(the mirrors of ``tests/test_serving_engine.py``'s four reference tests),
the launch-counter arithmetic that replays rely on, and ``sample_slots``
without its host-built ``-inf``.

On the CPU a profile's use calls its step function on the very static
tensors a CUDA graph would have bound on the card, so an engine that
replaced one of them instead of writing into it gives wrong tokens here.
JAX initialises the weights and the port loads them through
``from_jax_params``; everything is float32, the port on its plain kernels.
Greedy outputs must be token-identical and the scheduler's counters equal
(``steps``, ``dispatches``, ``transfers_d2h``, ``preemptions`` and the
rest of ``COUNTERS``).  Every case has more requests than slots (slot
churn); two have a pool tight enough to preempt.
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
from repro_torch.kernels import launches
from repro_torch.models import build_model, from_jax_params
from repro_torch.models.ssm import MIXES
from repro_torch.serving import (EngineConfig, Request, ServeEngine,
                                 sample_slots)
from repro_torch.serving.step_graph import Staged, StepGraph

COUNTERS = ("steps", "preemptions", "decode_steps", "prefill_calls",
            "prefill_tokens", "generated_tokens", "dispatches",
            "transfers_d2h", "capacity_stops", "peak_active",
            "pages_in_use_peak", "kv_used_tokens_peak")
MODES = {"unified": dict(cache_layout="paged", unified=True),
         "paged": dict(cache_layout="paged", unified=False),
         "dense": dict(cache_layout="dense", unified=False)}


@functools.lru_cache(maxsize=None)
def _pair(arch: str):
    """JAX model + params and the port model loaded from the same tree
    (f32).  RWKV-6's zero-initialised mixes and bonus are drawn from a seed
    so that the token shift and the bonus are exercised."""
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


def _cfg(cls, mode, **kw):
    base = dict(max_slots=2, max_seq=64, chunk_size=4, prefill_rows=2,
                page_size=8, **MODES[mode])
    base.update(kw)
    return cls(**base)


def _record_widths(jeng):
    """Wrap the JAX engine's ``_jit_prefill``: returns the set of chunk
    widths it is called with (one trace each), filled as the engine
    steps."""
    widths: set[int] = set()
    jit = jeng._jit_prefill

    def recorded(params, scratch, tokens, mask):
        widths.add(int(tokens.shape[1]))
        return jit(params, scratch, tokens, mask)
    jeng._jit_prefill = recorded
    return widths


def _two_dispatch_keys(layout, widths):
    """The profiles a two-dispatch engine binds: its decode, row reset,
    insert and first-token sample, and one prefill per chunk width."""
    return ({f"decode/{layout}", "reset", f"insert/{layout}",
             "sample/first"} | {f"prefill/{w}" for w in widths})


def _count_runs(eng):
    """Wrap the engine's StepGraph.run: returns {key: uses}, filled as the
    engine steps."""
    runs: dict[str, int] = {}
    run = eng._graphs.run

    def counted(key):
        runs[key] = runs.get(key, 0) + 1
        return run(key)
    eng._graphs.run = counted
    return runs


# (arch, mode): the three engine modes of the dense stack, the MoE stack in
# the unified engine, the attention-free stack in both two-dispatch layouts
CASES = [("minitron-8b", "unified"), ("minitron-8b", "paged"),
         ("minitron-8b", "dense"), ("deepseek-moe-16b", "unified"),
         ("rwkv6-3b", "paged"), ("rwkv6-3b", "dense")]
CHURN = ([5, 11, 3, 9, 7], [5, 3, 6, 4, 5])
TIGHT = ([13, 11, 14, 12, 9, 15], [10] * 6)


@pytest.mark.parametrize("arch,mode,tight", [c + (False,) for c in CASES]
                         + [("minitron-8b", "unified", True),
                            ("minitron-8b", "paged", True)],
                         ids=lambda v: v if isinstance(v, str)
                         else ("tight" if v else "churn"))
def test_static_tensor_steps_match_jax(arch, mode, tight):
    jspec, jmodel, params, tmodel = _pair(arch)
    lengths, max_new = TIGHT if tight else CHURN
    kw = dict(max_slots=4, max_seq=32, page_size=4, n_pages=11) if tight \
        else {}
    rng = np.random.default_rng(len(arch) + len(mode))
    prompts = [rng.integers(0, jspec.vocab, size=n).tolist()
               for n in lengths]
    jeng = JaxServeEngine(jmodel, params, _cfg(JaxEngineConfig, mode, **kw))
    widths = _record_widths(jeng)
    jreqs = jeng.serve([JaxRequest(prompt=list(p), max_new_tokens=m)
                        for p, m in zip(prompts, max_new)])
    teng = ServeEngine(tmodel, _cfg(EngineConfig, mode, **kw), device="cpu")
    runs = _count_runs(teng)
    treqs = teng.serve([Request(prompt=list(p), max_new_tokens=m)
                        for p, m in zip(prompts, max_new)])
    assert all(r.state == "done" for r in jreqs + treqs)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    for name in COUNTERS:
        assert getattr(teng.metrics, name) == getattr(jeng.metrics, name), \
            name
    m = teng.metrics
    assert m.preemptions > 0 if tight else m.peak_active == 2
    # every dispatch went through the step graph, each profile bound once
    # at its first use, one prefill profile per width the reference traced
    want = ({"unified/mixed", "unified/decode"} if mode == "unified"
            else _two_dispatch_keys(MODES[mode]["cache_layout"], widths))
    assert set(runs) == want == set(teng._graphs.captures)
    assert set(teng._graphs.captures.values()) == {1}
    assert sum(runs.values()) == m.dispatches
    if teng.paged:
        teng.pager.check()
        assert teng.pager.pages_in_use == 0


def _pointers(eng) -> dict[str, int]:
    """The address of every tensor a captured step reads or writes: the
    cache's lengths, page table and layer tensors, the two-dispatch
    scratch's, and each profile's static inputs and output (the
    two-dispatch feed and prefill logits among them)."""
    c = eng.cache
    out = {"lengths": c.lengths.data_ptr()}
    if c.page_table is not None:
        out["page_table"] = c.page_table.data_ptr()
    for i, layer in enumerate(c.layers):
        for name, t in vars(layer).items():
            if t is not None:  # a full-precision cache has no scales
                out[f"layer{i}.{name}"] = t.data_ptr()
    if eng.scratch is not None:
        out["scratch.lengths"] = eng.scratch.lengths.data_ptr()
        for i, layer in enumerate(eng.scratch.layers):
            for name, t in vars(layer).items():
                if t is not None:
                    out[f"scratch{i}.{name}"] = t.data_ptr()
    for key, p in eng._graphs.profiles.items():
        if p.out is not None:
            out[f"{key}.out"] = p.out.data_ptr()
        for name, t in p.inputs.dev.items():
            out[f"{key}.{name}"] = t.data_ptr()
    return out


@pytest.mark.parametrize("arch,mode", [
    ("minitron-8b", "unified"), ("minitron-8b", "paged"),
    ("minitron-8b", "dense"), ("rwkv6-3b", "paged"), ("rwkv6-3b", "dense")])
def test_captured_tensors_keep_their_addresses(arch, mode):
    """Across slot churn and preemption, every tensor a captured step binds
    keeps its data_ptr() from the step its profile is registered on (the
    prefill profiles at their first chunk), and the engine keeps its one
    ModelCache and its one scratch."""
    spec = treg.get_reduced(arch)
    model = build_model(spec, device="cpu", dtype=torch.float32, seed=3)
    eng = ServeEngine(model, _cfg(EngineConfig, mode, max_slots=3,
                                  max_seq=32, page_size=4, n_pages=10),
                      device="cpu")
    cache, scratch, seen = eng.cache, eng.scratch, _pointers(eng)
    names = {"lengths", "unified/mixed.tokens", "unified/mixed.positions",
             "unified/mixed.q_len", "unified/mixed.kv_len",
             "unified/mixed.seg_ptab", "unified/mixed.temps",
             "unified/mixed.topks", "unified/mixed.topps"} \
        if mode == "unified" else {
            "lengths", f"decode/{mode}.feed", "scratch.lengths",
            "scratch0.k" if arch == "minitron-8b" else "scratch0.wkv",
            "reset.row", f"insert/{mode}.slot", f"insert/{mode}.row",
            "sample/first.temps", "sample/first.topks", "sample/first.topps",
            "sample/first.out"} | ({"insert/paged.pages"} if mode == "paged"
                                   else set())
    assert names <= set(seen)
    rng = np.random.default_rng(1)
    for n in TIGHT[0] + CHURN[0]:
        eng.submit(Request(prompt=rng.integers(0, spec.vocab, n).tolist(),
                           max_new_tokens=8))
    while eng.busy:
        eng.step()
        assert eng.cache is cache and eng.scratch is scratch
        now = _pointers(eng)
        assert {key: now.get(key) for key in seen} == seen
        seen = now
    assert all(r.state == "done" for r in eng.finished)
    if mode != "unified":
        # every width's chunk writes the one logits buffer the sample reads
        prefill = {key for key in seen if key.startswith("prefill/")}
        assert {key.split(".")[0] for key in prefill} == {
            key for key in eng._graphs.profiles if key.startswith("prefill/")}
        assert len(prefill) > 3
        assert {seen[key] for key in prefill if key.endswith(".out")} == {
            eng._prefill_logits.data_ptr()}
    if eng.paged:
        assert eng.metrics.preemptions > 0


# ---------------------------------------------------------------------------
# debug guards: the mirrors of the reference's four tests
# ---------------------------------------------------------------------------

PROMPTS = [[5, 9, 2, 17, 33], [7, 7, 7], [42] * 9, [3, 1, 4, 1, 5, 9]]


def _tiny_model():
    return _pair("minitron-8b")[3]


def test_debug_guards_unified_matches_guard_off():
    """A debug_guards engine completes a mixed prefill + decode workload and
    its greedy outputs are token-identical to guard-off."""
    outs = {}
    for guards in (False, True):
        eng = ServeEngine(_tiny_model(), _cfg(EngineConfig, "unified",
                                              max_slots=4,
                                              debug_guards=guards),
                          device="cpu")
        reqs = eng.serve([Request(prompt=list(p), max_new_tokens=5)
                          for p in PROMPTS])
        assert all(r.state == "done" for r in reqs)
        outs[guards] = [r.output for r in reqs]
    assert outs[True] == outs[False]


def test_debug_guards_two_dispatch_slot_churn():
    """Across slot churn the two-dispatch engine binds each of its
    profiles exactly once: the decode, the row reset, the insert, the
    first-token sample and the one chunk width (3) of these prompts."""
    eng = ServeEngine(_tiny_model(),
                      EngineConfig(max_slots=2, max_seq=64, chunk_size=8,
                                   debug_guards=True), device="cpu")
    reqs = [Request(prompt=[1 + i, 2, 3], max_new_tokens=3 + i % 3)
            for i in range(5)]  # > max_slots: forces churn
    eng.serve(reqs)
    assert all(r.state == "done" for r in reqs)
    assert eng._graphs.captures == dict.fromkeys(
        _two_dispatch_keys("dense", {3}), 1)


@pytest.mark.parametrize("mode", ["unified", "paged"])
def test_debug_guards_are_armed_every_step(mode, monkeypatch):
    """Every dispatch of a guarded engine runs inside ``_step_guard()``,
    entered once per step, and the allocator audit runs after every step
    (neither without the guards)."""
    for guards in (True, False):
        eng = ServeEngine(_tiny_model(), _cfg(EngineConfig, mode,
                                              debug_guards=guards),
                          device="cpu")
        entered, audits, inside = [0], [0], [False]
        guard = eng._step_guard

        class Counted:
            def __enter__(self):
                entered[0] += 1
                inside[0] = True
                self.ctx = guard()
                return self.ctx.__enter__()

            def __exit__(self, *exc):
                inside[0] = False
                return self.ctx.__exit__(*exc)

        run, check = eng._graphs.run, eng.pager.check

        def guarded_run(key):
            assert inside[0] == guards
            return run(key)

        def counted_check():
            audits[0] += 1
            check()
        if guards:
            monkeypatch.setattr(eng, "_step_guard", Counted)
        monkeypatch.setattr(eng._graphs, "run", guarded_run)
        monkeypatch.setattr(eng.pager, "check", counted_check)
        eng.serve([Request(prompt=list(p), max_new_tokens=4)
                   for p in PROMPTS])
        assert eng.steps > 0
        assert entered[0] == (eng.steps if guards else 0)
        assert audits[0] == (eng.steps if guards else 0)


@pytest.mark.parametrize("mode", ["unified", "dense"])
def test_debug_guards_recapture_assertion_fires(mode):
    """Binding a profile a second time, or a key outside the engine's
    geometry, raises (the counterpart of a retrace in the reference)."""
    eng = ServeEngine(_tiny_model(), _cfg(EngineConfig, mode,
                                          debug_guards=True), device="cpu")
    eng.submit(Request(prompt=[5, 9, 2], max_new_tokens=4))
    while not eng.active:
        eng.step()
    eng.step()
    bound = sorted(eng._graphs.captures)
    assert bound and set(eng._graphs.captures.values()) == {1}
    with pytest.raises(AssertionError, match="recapture"):
        eng._graphs.capture(bound[0])
    with pytest.raises(AssertionError, match="recapture"):
        eng._graphs.capture("decode/foreign")
    assert eng._graphs.captures == dict.fromkeys(bound, 1)


# ---------------------------------------------------------------------------
# the pieces replays rely on
# ---------------------------------------------------------------------------

def test_launch_counters_snapshot_diff_add_restore():
    """A capture's delta, added per replay, gives the counts the eager
    calls would have; restore undoes a capture's own counting."""
    mod = launches.MODULES[0]  # the ragged wrapper: launches and routes
    start = launches.snapshot()
    try:
        mod.launches += 3
        mod.routes["tensor_core"] += 2
        mod.routes["cuda_core"] += 1
        delta = launches.diff(launches.snapshot(), start)
        assert delta[mod.__name__] == (3, {"tensor_core": 2, "cuda_core": 1})
        assert all(n == 0 for name, (n, _) in delta.items()
                   if name != mod.__name__)
        launches.restore(start)
        assert launches.snapshot() == start
        launches.add(delta)
        launches.add(delta)
        assert mod.launches == start[mod.__name__][0] + 6
        assert mod.routes["tensor_core"] == \
            start[mod.__name__][1]["tensor_core"] + 4
    finally:
        launches.restore(start)


def test_step_graph_cpu_path_runs_on_the_static_tensors():
    """On the CPU a profile's every use calls its function on the staged
    device tensors (an upload is a copy, not a rebinding), the samples
    land in one static output, and the key is bound once."""
    inputs = Staged({"a": ((2, 3), torch.int32), "b": ((3,), torch.float32)},
                    torch.device("cpu"))
    seen = []

    def fn():
        seen.append(inputs.dev["a"].data_ptr())
        return inputs.dev["a"].sum(dim=0) + inputs.dev["b"].int()

    sg = StepGraph(torch.device("cpu"), torch.Generator(), graphs=True)
    sg.add("k", inputs, 3, fn)
    outs = []
    for step in range(3):
        inputs.host["a"][:] = step
        inputs.host["b"][:] = 0.5 + step
        inputs.upload()
        outs.append(sg.run("k").tolist())
        assert sg.run("k").data_ptr() == sg.profiles["k"].out.data_ptr()
    assert outs == [[0, 0, 0], [3, 3, 3], [6, 6, 6]]
    assert len(set(seen)) == 1 and sg.captures == {"k": 1}
    assert sg.capture_s == 0.0 and sg.pool_bytes == 0


def _sample_slots_host_inf(logits, temperature, top_k, top_p, generator):
    """``sample_slots`` as it was, with its ``-inf`` built as a tensor from
    the host (a copy inside the step, which a capture cannot hold)."""
    v = logits.shape[-1]
    greedy = logits.argmax(dim=-1).to(torch.int32)
    lf = logits.float() / temperature.float().clamp(min=1e-8)[:, None]
    neg = torch.tensor(float("-inf"), device=lf.device)
    desc = lf.sort(dim=-1, descending=True).values
    kth = desc.gather(-1, (top_k.long() - 1).clamp(0, v - 1)[:, None])
    lf = torch.where((top_k[:, None] > 0) & (lf < kth), neg, lf)
    desc = lf.sort(dim=-1, descending=True).values
    cum = torch.softmax(desc, dim=-1).cumsum(dim=-1)
    cutoff_idx = (cum < top_p[:, None]).sum(dim=-1).clamp(max=v - 1)
    cutoff = desc.gather(-1, cutoff_idx[:, None])
    lf = torch.where((top_p[:, None] < 1.0) & (lf < cutoff), neg, lf)
    u = torch.rand(lf.shape, generator=generator, device=lf.device)
    gumbel = -torch.log(-torch.log(u.clamp_(min=1e-20)))
    stochastic = (lf + gumbel).argmax(dim=-1).to(torch.int32)
    return torch.where(temperature <= 0.0, greedy, stochastic)


def test_sample_slots_unchanged_by_the_scalar_fill():
    """Greedy rows and seeded stochastic rows (top-k, top-p, both, neither)
    give the same tokens as before the fix, draw for draw."""
    rng = np.random.default_rng(7)
    n = 64
    logits = torch.from_numpy(rng.standard_normal((n, 97)).astype(
        np.float32) * 3)
    temps = torch.from_numpy(np.where(np.arange(n) % 4 == 0, 0.0,
                                      rng.uniform(0.3, 1.5, n)).astype(
                                          np.float32))
    topks = torch.from_numpy(rng.choice([0, 1, 5, 40], n).astype(np.int32))
    topps = torch.from_numpy(rng.choice([1.0, 0.9, 0.5], n).astype(
        np.float32))
    for seed in range(3):
        want = _sample_slots_host_inf(logits, temps, topks, topps,
                                      torch.Generator().manual_seed(seed))
        got = sample_slots(logits, temps, topks, topps,
                           torch.Generator().manual_seed(seed))
        assert torch.equal(got, want)
