"""The port's mesh-sharded serving against the JAX package, on the CPU.

The port's unified paged engine serves across gloo ranks on the CPU in f32
(``repro_torch.serving.sharded.spawn``: a world of 4 and a world of 2,
each spawned once per module), on the weights of the reference's
``model.init(key(0))`` (``from_jax_params``; every rank cuts its shard from
them).  The reference runs in this process on one device, as
``tests/test_tp_serving.py`` holds its sharded engine against it.  Every
comparison is exact: greedy tokens, counters, pool shapes, error texts
and the analytical collective counts and bytes.  The rank bodies import
nothing of JAX: the JAX package is imported inside the functions that run
it here.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch.core.modelspec import AttnSpec, ModelSpec
from repro_torch.models import Shard, build_model, from_jax_params
from repro_torch.models.convert import shard_state
from repro_torch.serving import EngineConfig, Request, ServeEngine
from repro_torch.serving import sharded

# the reference's tests/test_tp_serving.py: its spec, engine and prompts
SPEC = ModelSpec(name="t8", d_model=64, n_layers=2, n_heads=8, n_kv_heads=4,
                 d_head=16, d_ff=128, vocab=256,
                 attn=AttnSpec(kind="full", causal=True))
CFG = dict(max_slots=4, max_seq=64, chunk_size=4, prefill_rows=2,
           cache_layout="paged", page_size=8, unified=True)
PROMPTS = [[7, 8, 9] + list(range(1, 10 + i)) for i in range(6)]
PREFIX_PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3]] * 4
MAX_NEW = 6
#: (tp, pp) -> the reference's collectives per step for SPEC
MESHES = {(4, 1): 5, (2, 2): 8, (1, 2): 3}
#: the named runs, each with its engine options and prompts; the mesh runs
#: and the tp=2 variants
RUNS = {"base": ({}, PROMPTS), "tight": (dict(n_pages=9), PROMPTS),
        "prefix": (dict(prefix_cache=True), PREFIX_PROMPTS),
        "kvq": ({}, PROMPTS)}


# ---------------------------------------------------------------------------
# the reference, in this process
# ---------------------------------------------------------------------------

def _jax_spec():
    from repro.core.modelspec import AttnSpec as JAttn
    from repro.core.modelspec import ModelSpec as JSpec
    return JSpec(**{**dataclasses.asdict(SPEC),
                    "attn": JAttn(**dataclasses.asdict(SPEC.attn))})


@pytest.fixture(scope="module")
def jax_params():
    import jax
    import jax.numpy as jnp
    from repro.models import build_model as jax_build
    model = jax_build(_jax_spec(), mesh=None, param_dtype=jnp.float32,
                      compute_dtype=jnp.float32)
    return jax.tree.map(np.asarray, model.init(jax.random.key(0)))


def _jax_runs(jax_params) -> dict:
    """Each named run on the single-device JAX engine: outputs and the
    counters the port's ranks are held to."""
    import jax
    import jax.numpy as jnp
    from repro.models import build_model as jax_build
    from repro.serving import EngineConfig as JCfg
    from repro.serving import Request as JReq
    from repro.serving import ServeEngine as JEngine
    params = jax.device_put(jax_params)
    out = {}
    for name, (kw, prompts) in RUNS.items():
        model = jax_build(_jax_spec(), mesh=None, param_dtype=jnp.float32,
                          compute_dtype=jnp.float32,
                          kv_quant=name == "kvq")
        eng = JEngine(model, params, JCfg(**CFG, **kw, debug_guards=True))
        reqs = [JReq(prompt=list(p), max_new_tokens=MAX_NEW)
                for p in prompts]
        eng.serve(reqs)
        m = eng.metrics
        out[name] = dict(outputs=[r.output for r in reqs], steps=m.steps,
                         mixed=m.prefill_calls, preemptions=m.preemptions,
                         prefix_hits=m.prefix_hits,
                         prefix_cow_forks=m.prefix_cow_forks)
    return out


# ---------------------------------------------------------------------------
# the port, on gloo ranks
# ---------------------------------------------------------------------------

def _serve(model, tp: int, pp: int, kw: dict, prompts) -> dict:
    """One engine on this rank, its outputs, counters, pool shapes and the
    largest page id any step's tables named."""
    eng = ServeEngine(model, EngineConfig(**CFG, **kw, tp=tp, pp=pp,
                                          debug_guards=True), device="cpu")
    reqs = [Request(prompt=list(p), max_new_tokens=MAX_NEW) for p in prompts]
    for r in reqs:
        eng.submit(r)
    page_ids = [0]
    while eng.busy:
        eng.step()
        page_ids.append(int(eng._ptab.max()))
        page_ids += [int(p.inputs.dev["seg_ptab"].max())
                     for p in eng._graphs.profiles.values()]
    m = eng.metrics
    return dict(outputs=[r.output for r in reqs], steps=m.steps,
                mixed=m.prefill_calls, dispatches=m.dispatches,
                transfers_d2h=m.transfers_d2h, collectives=m.collectives,
                collective_bytes=m.collective_bytes,
                preemptions=m.preemptions, prefix_hits=m.prefix_hits,
                prefix_cow_forks=m.prefix_cow_forks,
                pool=[tuple(layer.k.shape) for layer in eng.cache.layers],
                scales=[tuple(layer.k_scale.shape)
                        for layer in eng.cache.layers
                        if layer.k_scale is not None],
                max_page_id=max(page_ids), n_pages=eng.pager.n_pages,
                summary=eng.metrics.summary())


def _full_model(state: dict, kv_quant: bool = False):
    torch.set_num_threads(1)  # tiny shapes: threads would only contend
    model = build_model(SPEC, device="cpu", dtype=torch.float32)
    model.load_state_dict(state)
    model.kv_quant = kv_quant
    return model


def _world4(state: dict) -> dict:
    """Rank body of the world of 4: tp=4, then tp=2 x pp=2."""
    model = _full_model(state)
    return {mesh: _serve(model, *mesh, {}, PROMPTS)
            for mesh in ((4, 1), (2, 2))}


def _world2(state: dict) -> dict:
    """Rank body of the world of 2: pp=2, then the tp=2 variants and one
    engine-backend Scenario."""
    from repro_torch.scenario import engine_backend as teb
    out = {(1, 2): _serve(_full_model(state), 1, 2, {}, PROMPTS)}
    for name, (kw, prompts) in RUNS.items():
        if name != "base":
            out[name] = _serve(_full_model(state, name == "kvq"), 2, 1, kw,
                               prompts)
    rep = teb.evaluate(_scenario(), device="cpu", **SCENARIO_KW)
    out["scenario"] = dict(status=rep.status, error=rep.error,
                           engine=rep.extra.get("engine"),
                           kv=rep.extra.get("kv"),
                           config=rep.extra.get("engine_config"))
    return out


SCENARIO_KW = dict(max_slots=4, max_seq=64, max_prompt=12, max_new=6,
                   prefill_rows=2)


def _scenario(tp: int = 2):
    from repro_torch.core.stages import Workload
    from repro_torch.scenario import ChunkedSpec, Scenario
    return Scenario.make(SPEC, workload=Workload(batch=3, tau_p=12, tau_d=6),
                         batch=3, mode="chunked",
                         chunked=ChunkedSpec(chunk=4, decode_batch=2),
                         parallelism=dict(tp=tp))


@pytest.fixture(scope="module")
def runs(jax_params):
    """The JAX engine's runs and each rank's of the two worlds, side by
    side: the worlds are spawned from two threads (which only wait on
    their ranks) while this process runs the JAX engines."""
    state = from_jax_params(jax_params, SPEC)
    with ThreadPoolExecutor(max_workers=2) as pool:
        world4 = pool.submit(sharded.spawn, 4, _world4, state,
                             timeout_s=300)
        world2 = pool.submit(sharded.spawn, 2, _world2, state,
                             timeout_s=300)
        return dict(jax=_jax_runs(jax_params), world4=world4.result(),
                    world2=world2.result())


@pytest.fixture(scope="module")
def jax_runs(runs):
    return runs["jax"]


@pytest.fixture(scope="module")
def world4(runs):
    return runs["world4"]


@pytest.fixture(scope="module")
def world2(runs):
    return runs["world2"]


def _mesh_id(mesh) -> str:
    return f"tp{mesh[0]}pp{mesh[1]}"


def _mesh_runs(mesh, world4, world2):
    return [ranks[mesh] for ranks in (world4 if mesh[0] * mesh[1] == 4
                                      else world2)]


# ---------------------------------------------------------------------------
# the sharded engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES), ids=_mesh_id)
def test_greedy_tokens_equal_the_jax_engine_on_every_rank(mesh, jax_runs,
                                                          world4, world2):
    """Exact: every rank's greedy tokens equal the single-device JAX
    engine's, and so each other's."""
    for run in _mesh_runs(mesh, world4, world2):
        assert run["outputs"] == jax_runs["base"]["outputs"]


@pytest.mark.parametrize("mesh", list(MESHES), ids=_mesh_id)
def test_collectives_are_the_references_on_every_rank(mesh, jax_runs,
                                                      world4, world2):
    """Exact: collectives per step are the reference's 5, 8 and 3, and the
    bytes are its ``collective_stats`` of the mixed and the decode-only
    profile summed over the JAX engine's steps."""
    from repro.serving.sharded import collective_stats
    tp, pp = mesh
    ref = jax_runs["base"]
    t_pack = CFG["max_slots"] + CFG["prefill_rows"] * CFG["chunk_size"]
    n_segs = CFG["max_slots"] + CFG["prefill_rows"]
    mixed = collective_stats(_jax_spec(), tp, pp, t_pack, n_segs, 4)
    decode = collective_stats(_jax_spec(), tp, pp, CFG["max_slots"],
                              CFG["max_slots"], 4)
    n_decode = ref["steps"] - ref["mixed"]
    for run in _mesh_runs(mesh, world4, world2):
        assert (run["steps"], run["mixed"]) == (ref["steps"], ref["mixed"])
        assert run["collectives"] / run["steps"] == MESHES[mesh]
        assert run["collective_bytes"] > 0
        assert run["collective_bytes"] \
            == ref["mixed"] * mixed[1] + n_decode * decode[1]
        assert run["summary"]["collectives_per_step"] == MESHES[mesh]


@pytest.mark.parametrize("mesh", list(MESHES), ids=_mesh_id)
def test_one_dispatch_and_one_copy_a_step_on_every_rank(mesh, world4,
                                                        world2):
    """Exact, with debug_guards on: dispatches == d2h copies == steps."""
    for run in _mesh_runs(mesh, world4, world2):
        assert run["dispatches"] == run["transfers_d2h"] == run["steps"]


def test_preemption_under_tp_equals_the_jax_engine(jax_runs, world2):
    """A 9-page pool at tp=2: the same preemptions as the JAX engine's
    (more than 0) and its tokens, exactly."""
    ref = jax_runs["tight"]
    assert ref["preemptions"] > 0
    for ranks in world2:
        run = ranks["tight"]
        assert run["preemptions"] == ref["preemptions"]
        assert run["outputs"] == ref["outputs"]


def test_prefix_cache_under_tp_equals_the_jax_engine(jax_runs, world2):
    """Identical two-page prompts at tp=2: every later request a full hit
    forking its tail page in the rank's pools; hits, forks and tokens equal
    the JAX engine's, exactly, and dispatches are steps + forks."""
    ref = jax_runs["prefix"]
    assert ref["prefix_hits"] > 0 and ref["prefix_cow_forks"] > 0
    for ranks in world2:
        run = ranks["prefix"]
        assert (run["prefix_hits"], run["prefix_cow_forks"]) \
            == (ref["prefix_hits"], ref["prefix_cow_forks"])
        assert run["outputs"] == ref["outputs"]
        assert run["dispatches"] == run["steps"] + run["prefix_cow_forks"]
        assert run["transfers_d2h"] == run["steps"]


def test_int8_kv_cache_under_tp_equals_the_jax_engine(jax_runs, world2):
    """The reference serves kv_quant at tp=2 (its cache axes shard the
    scales with the codes): the port's codes and scales hold the rank's kv
    heads, and its tokens equal the quantized JAX engine's, exactly."""
    for ranks in world2:
        run = ranks["kvq"]
        assert run["outputs"] == jax_runs["kvq"]["outputs"]
        assert run["scales"] == [p[:-1] for p in run["pool"]]
        assert run["pool"][0][1] == SPEC.n_kv_heads // 2


def test_each_rank_holds_its_pool_slice_and_valid_page_ids(world4):
    """tp=2 x pp=2: every rank's pool is (repeats/pp, pages, kv_heads/tp,
    page_size, d_head), the page axis whole, and every page id any step's
    table named lies inside it."""
    for ranks in world4:
        run = ranks[(2, 2)]
        pool = (len(run["pool"]),) + run["pool"][0]
        assert pool == (SPEC.n_layers // 2, run["n_pages"],
                        SPEC.n_kv_heads // 2, CFG["page_size"],
                        SPEC.d_head)
        assert 0 < run["max_page_id"] < run["n_pages"]


def test_engine_backend_serves_a_tp_scenario(world2):
    """A chunked Scenario at tp=2 lowers onto the sharded unified engine
    inside the world of 2: each rank's Report is ok and carries the
    collective counters (5 a step), and, exactly, the same untimed
    counters and KV reservation as the port's tp=1 unified lowering."""
    from repro_torch.scenario import engine_backend as teb
    base = teb.evaluate(_scenario(tp=1), device="cpu", unified=True,
                        **SCENARIO_KW)
    assert base.status == "ok", base.error
    untimed = {k: v for k, v in base.extra["engine"].items()
               if not k.endswith("_s") and "_s_" not in k
               and k != "tokens_per_s"}
    for ranks in world2:
        rep = ranks["scenario"]
        assert rep["status"] == "ok", rep["error"]
        assert rep["config"]["tp"] == 2 and rep["config"]["unified"]
        eng = rep["engine"]
        assert eng["collectives_per_step"] == 5
        assert eng["collective_bytes"] > 0
        assert {k: eng[k] for k in untimed} == untimed
        assert rep["kv"] == base.extra["kv"]


# ---------------------------------------------------------------------------
# validation, the analytical counts, the shard's weights, the launcher
# ---------------------------------------------------------------------------

VALIDATION = {
    "tp0": ({}, dict(tp=0)),
    "two-dispatch": ({}, dict(tp=2, unified=False)),
    "n_spec": ({}, dict(tp=2, n_spec=2)),
    "moe-or-ssm": (dict(hybrid_pattern=("attn", "ssm")), dict(pp=2)),
    "n_heads": (dict(n_heads=6, n_kv_heads=2, d_head=16), dict(tp=4)),
    "n_kv_heads": ({}, dict(tp=8)),
    "d_ff": (dict(d_ff=130), dict(tp=4)),
    "vocab": (dict(vocab=255), dict(tp=2)),
    "repeats": (dict(n_layers=3), dict(pp=2)),
}


@pytest.mark.parametrize("case", sorted(VALIDATION))
def test_validation_raises_the_references_text(case):
    """Exact: each refusal's ValueError text is the reference's (its shape
    checks come before its device count, so it runs here on one
    device)."""
    from repro.serving import EngineConfig as JCfg
    from repro.serving.sharded import validate_engine_sharding as jvalidate
    from repro.core.modelspec import SSMSpec as JSSM
    from repro_torch.core.modelspec import SSMSpec
    spec_kw, cfg_kw = VALIDATION[case]
    spec = dataclasses.replace(SPEC, **spec_kw)
    jspec = dataclasses.replace(_jax_spec(), **spec_kw)
    if "hybrid_pattern" in spec_kw:
        spec = dataclasses.replace(spec, ssm=SSMSpec())
        jspec = dataclasses.replace(jspec, ssm=JSSM())
    cfg = {**CFG, **cfg_kw}
    with pytest.raises(ValueError) as got:
        sharded.validate_engine_sharding(spec, EngineConfig(**cfg))
    with pytest.raises(ValueError) as want:
        jvalidate(jspec, JCfg(**cfg))
    assert str(got.value) == str(want.value)


def test_validation_outside_a_group_names_the_ranks():
    """With shapes that shard, the reference's device count becomes the
    process group's size: the error names the ranks and both launchers."""
    with pytest.raises(ValueError) as got:
        sharded.validate_engine_sharding(SPEC, EngineConfig(**CFG, tp=2,
                                                            pp=2))
    assert str(got.value).startswith(
        "tp=2 x pp=2 needs a torch.distributed process group of 4 ranks")
    assert "torchrun --nproc-per-node 4" in str(got.value)
    assert "sharded.spawn(4" in str(got.value)
    sharded.validate_engine_sharding(SPEC, EngineConfig(**CFG))


def test_collective_stats_equal_the_references():
    """Exact, over specs (tied and untied heads, 1-3 layers), tp, pp,
    packed widths and segment counts, in f32 and bf16 bytes."""
    from repro.serving.sharded import collective_stats as jstats
    for n_layers, tied in ((1, False), (2, True), (3, False)):
        spec = dataclasses.replace(SPEC, n_layers=n_layers,
                                   tied_embeddings=tied)
        jspec = dataclasses.replace(_jax_spec(), n_layers=n_layers,
                                    tied_embeddings=tied)
        for tp in (1, 2, 4):
            for pp in (1, 2, 3):
                for t_pack, n_segs in ((4, 4), (12, 6), (264, 10)):
                    for nbytes in (4, 2):
                        assert sharded.collective_stats(
                            spec, tp, pp, t_pack, n_segs, nbytes) \
                            == jstats(jspec, tp, pp, t_pack, n_segs, nbytes)


def test_a_seeded_shard_holds_its_slices_of_the_seeded_model():
    """Exact: ``build_model(shard=)`` draws every full tensor from the seed
    and keeps its slice, so each rank of every mesh holds what
    ``shard_state`` cuts from the unsharded model of the same seed."""
    full = build_model(SPEC, device="cpu", dtype=torch.float32, seed=5)
    state = full.state_dict()
    for tp, pp in ((2, 1), (1, 2), (2, 2), (4, 1)):
        for rank in range(tp * pp):
            shard = Shard(tp=tp, pp=pp, tp_rank=rank % tp,
                          pp_rank=rank // tp)
            model = build_model(SPEC, device="cpu", dtype=torch.float32,
                                seed=5, shard=shard)
            want = shard_state(state, SPEC, shard)
            got = model.state_dict()
            assert got.keys() == want.keys()
            for name, t in got.items():
                assert torch.equal(t, want[name]), (tp, pp, rank, name)


def _fail_on_rank_1() -> int:
    import torch.distributed as dist
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails")
    dist.barrier()  # rank 0 would wait here forever
    return 0


def test_spawn_stops_every_rank_when_one_fails():
    """A rank that raises stops the others (one waits in a barrier) well
    inside the timeout, and the call raises with that rank's
    traceback."""
    with pytest.raises(RuntimeError, match="rank 1 fails"):
        sharded.spawn(2, _fail_on_rank_1, timeout_s=120)
