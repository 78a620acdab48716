"""Port parity of the MoE slice: the expert GEMM's plain version, the MoE
block, the parameter converter and the engines serving reduced
deepseek-moe-16b (shared experts, G = 1) and granite-moe-3b-a800m (no
shared experts, tied head, G = 2), each against the JAX package.

Inputs are made from a numpy seed and handed to both sides; JAX initialises
the weights and the port loads them through ``from_jax_params``.  The JAX
MoE takes its dense no-drop path (``moe_impl="dense"``, the one it takes
without a mesh), the port its only one.  Tolerances, float32 on the CPU:
the expert GEMM within atol 1e-5 at unit output scale (bf16: one bf16
ulp, 2^-7 |want|, plus 1e-5); the MoE block within 1e-5 of its output's
scale, max(1, max |want|).  The block's outputs reach about 25 (the
reference's expert init takes E as the fan-in), where float32 sums taken
in different orders differ by a few ulps, about 1e-5 absolute.  Engines:
greedy outputs token-identical and the scheduler's counters equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.kernels import ref as jref
from repro.kernels.moe_gemm import pallas_expert_gemm
from repro.models import build_model as jax_build_model
from repro.models.moe import moe_block as jax_moe_block
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import Request as JaxRequest
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch.configs import registry as treg
from repro_torch.kernels import expert_gemm, ops, ref
from repro_torch.models import build_model, from_jax_params
from repro_torch.models.moe import moe_block
from repro_torch.serving import EngineConfig, Request, ServeEngine

ATOL = 1e-5
BF16_ULP = 2.0 ** -7
ARCHS = ["deepseek-moe-16b", "granite-moe-3b-a800m"]
COUNTERS = ("steps", "preemptions", "decode_steps", "prefill_calls",
            "prefill_tokens", "generated_tokens", "dispatches",
            "transfers_d2h", "capacity_stops")

# (E, C, D, F) and the Pallas blocks of tests/test_kernels.py's MoE cases
GEMM_CASES = [(4, 40, 24, 56, 16, 16), (2, 16, 32, 32, 16, 32),
              (8, 8, 8, 8, 8, 8)]


def _gemm_inputs(e, c, d, f, seed):
    """x ~ N(0, 1), w ~ N(0, 1/D): outputs of unit scale."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((e, c, d)).astype(np.float32)
    w = (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32)
    return x, w


@pytest.mark.parametrize("oracle", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GEMM_CASES,
                         ids=["E4C40", "E2C16", "E8C8"])
def test_moe_gemm_reference_matches_jax(case, dtype, oracle):
    e, c, d, f, bc, bf = case
    x, w = _gemm_inputs(e, c, d, f, seed=c)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jx, jw = jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)
    if oracle == "ref":
        want = jref.moe_gemm_reference(jx, jw)
    else:
        want = pallas_expert_gemm(jx, jw, block_c=bc, block_f=bf,
                                  interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    got = ref.moe_gemm_reference(torch.from_numpy(x).to(tdt),
                                 torch.from_numpy(w).to(tdt))
    assert got.dtype == tdt and got.shape == (e, c, f)
    rtol = BF16_ULP if dtype == "bfloat16" else 0.0
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=ATOL)


def test_expert_gemm_on_cpu_takes_the_plain_version():
    """On CPU tensors ``impl="kernel"`` is the plain version, bit for bit,
    launches nothing, and takes the broadcast view of one (C, D) matrix
    as it takes the same matrix copied per expert."""
    x, w = _gemm_inputs(4, 40, 24, 56, seed=3)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    before = expert_gemm.launches
    got = ops.expert_gemm(tx, tw)
    assert torch.equal(got, ops.expert_gemm(tx, tw, impl="plain"))
    assert torch.equal(got, ref.moe_gemm_reference(tx, tw))
    bcast = tx[0].expand(4, 40, 24)
    assert bcast.stride(0) == 0
    assert torch.equal(ops.expert_gemm(bcast, tw),
                       ops.expert_gemm(bcast.contiguous(), tw))
    assert expert_gemm.launches == before
    with pytest.raises(ValueError, match="unknown expert gemm impl"):
        ops.expert_gemm(tx, tw, impl="pallas")


def _pair(arch: str, seed: int = 0):
    """JAX spec/model/params, and the port model loaded from them (f32)."""
    jspec, tspec = jreg.get_reduced(arch), treg.get_reduced(arch)
    jmodel = jax_build_model(jspec, mesh=None, param_dtype=jnp.float32,
                             compute_dtype=jnp.float32, moe_impl="dense",
                             cache_layout="paged", kv_page_size=4)
    params = jmodel.init(jax.random.key(seed))
    tmodel = build_model(tspec, device="cpu", dtype=torch.float32)
    state = from_jax_params(jax.tree.map(np.asarray, params), tspec)
    tmodel.load_state_dict(state)
    return jspec, jmodel, params, tmodel, state


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _pair(request.param)


def test_from_jax_params_names_every_moe_parameter(pair):
    jspec, _, _, tmodel, state = pair
    want = tmodel.state_dict()
    assert set(state) == set(want)
    for name, t in state.items():
        assert t.shape == want[name].shape, name
    m = jspec.moe
    d, ff, e = jspec.d_model, m.d_ff_expert, m.num_experts
    for i in range(jspec.n_layers):
        p = f"layers.{i}.ffn."
        assert state[p + "router"].shape == (d, e)
        assert state[p + "w_up"].shape == state[p + "w_gate"].shape \
            == (e, d, ff)
        assert state[p + "w_down"].shape == (e, ff, d)
        shared = {n for n in state if n.startswith(p + "shared.")}
        if m.shared_experts:
            sff = m.shared_experts * ff
            assert shared == {p + f"shared.{n}" for n in
                              ("norm", "w_up", "w_gate", "w_down")}
            assert state[p + "shared.w_up"].shape == (d, sff)
            assert state[p + "shared.w_down"].shape == (sff, d)
        else:
            assert not shared


@pytest.mark.parametrize("layer", [0, 1])
def test_moe_block_matches_jax(pair, layer):
    """One MoE block, the same (B, S, D) input through both, each layer of
    the stack (repeat ``layer`` of the reference's stacked tree)."""
    jspec, jmodel, params, tmodel, _ = pair
    x = np.random.default_rng(11 + layer).standard_normal(
        (2, 7, jspec.d_model)).astype(np.float32)
    ffn = jax.tree.map(lambda a: a[layer], params["layers"]["pos0"]["ffn"])
    want = np.asarray(jax_moe_block(jspec, jmodel.ctx, ffn, jnp.asarray(x)))
    spec = tmodel.spec
    atol = ATOL * max(1.0, float(np.abs(want).max()))
    got = moe_block(spec, tmodel.layers[layer].ffn, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
    # the packed step's (T, D) rows give the same rows
    flat = moe_block(spec, tmodel.layers[layer].ffn,
                     torch.from_numpy(x.reshape(-1, jspec.d_model)))
    np.testing.assert_allclose(flat.numpy(), want.reshape(flat.shape),
                               rtol=0, atol=atol)


def _cfg(cls, **kw):
    base = dict(max_slots=4, max_seq=64, chunk_size=4, prefill_rows=2,
                cache_layout="paged", page_size=8, unified=True)
    base.update(kw)
    return cls(**base)


def _serve_both(pair, lengths, max_new, seed, make_cfg=_cfg, **cfg_kw):
    jspec, jmodel, params, tmodel, _ = pair
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, jspec.vocab, size=n).tolist()
               for n in lengths]
    jeng = JaxServeEngine(jmodel, params, make_cfg(JaxEngineConfig, **cfg_kw))
    jreqs = jeng.serve([JaxRequest(prompt=list(p), max_new_tokens=m)
                        for p, m in zip(prompts, max_new)])
    teng = ServeEngine(tmodel, make_cfg(EngineConfig, **cfg_kw),
                       device="cpu")
    treqs = teng.serve([Request(prompt=list(p), max_new_tokens=m)
                        for p, m in zip(prompts, max_new)])
    assert all(r.state == "done" for r in jreqs + treqs)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    for name in COUNTERS:
        assert getattr(teng.metrics, name) == getattr(jeng.metrics, name), \
            name
    return teng


def test_unified_engine_matches_jax(pair):
    """Concurrent chunked prefills of mixed widths + decode, roomy pool."""
    teng = _serve_both(pair, [3, 11, 4, 17, 9, 5, 13],
                       [6, 3, 8, 6, 1, 6, 5], seed=4)
    m = teng.metrics
    assert m.dispatches == m.transfers_d2h == m.steps > 0
    assert m.prefill_calls > 0 and m.decode_steps > 0
    teng.pager.check()
    assert teng.pager.pages_in_use == 0


def test_unified_engine_matches_jax_under_preemption(pair):
    """A pool small enough to force victim preemption mid-decode."""
    teng = _serve_both(pair, [13, 11, 14, 12, 9, 15], [10] * 6, seed=5,
                       max_seq=32, page_size=4, n_pages=11)
    assert teng.metrics.preemptions > 0


def test_default_two_dispatch_engine_matches_jax(pair):
    """EngineConfig() itself: the dense two-dispatch engine."""
    teng = _serve_both(pair, [30, 7, 130], [4, 4, 4], seed=6,
                       make_cfg=lambda cls: cls())
    assert not teng.unified and not teng.paged


def test_paged_two_dispatch_engine_matches_jax(pair):
    """The two-dispatch engine in the paged layout."""
    teng = _serve_both(pair, [3, 11, 4, 17, 9], [6, 3, 8, 6, 1], seed=7,
                       unified=False)
    assert not teng.unified and teng.paged
    assert teng.metrics.dispatches > teng.metrics.steps
