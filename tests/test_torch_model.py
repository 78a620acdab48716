"""Port parity: ``from_jax_params`` + ``Model.unified_step`` of
``repro_torch`` against the JAX ``Model.unified_step``, and the model's
building blocks against their JAX counterparts.

Five specs: a tiny GQA model (the shape of ``tests/conftest.py``'s),
qwen1.5-0.5b REDUCED (QKV bias, tied head, SwiGLU), minitron-8b REDUCED
(squared ReLU, G=4, untied head), and the MoE stacks deepseek-moe-16b
REDUCED (shared experts) and granite-moe-3b-a800m REDUCED (tied head, no
shared experts).  JAX initialises the weights; the port
loads them through the converter.  Three packed steps drive both packed
profiles (mixed decode+prefill, then decode-only).  Everything is float32
on the CPU.  Tolerances: logits of live segments within atol 1e-4 and the
K/V pools within atol 1e-5 on every page a request owns (float32, sums in
different orders through two layers).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import modelspec as jms
from repro.models import build_model as jax_build_model
from repro.models import common as jcommon
from repro.models.attention import PackedSegs as JaxPackedSegs
from repro_torch.configs import registry as treg
from repro_torch.core import modelspec as tms
from repro_torch.models import build_model, common as tcommon, \
    from_jax_params
from repro_torch.models.attention import PackedSegs

LOGITS_ATOL = 1e-4
POOL_ATOL = 1e-5
TINY = dict(name="tiny", d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_head=16, d_ff=128, vocab=256)


def spec_pair(arch: str):
    """(JAX spec, port spec) describing the same architecture."""
    if arch == "tiny":
        return (jms.ModelSpec(**TINY, attn=jms.AttnSpec()),
                tms.ModelSpec(**TINY, attn=tms.AttnSpec()))
    return jreg.get_reduced(arch), treg.get_reduced(arch)


def port_from_jax(jspec, tspec, seed=0):
    """JAX model + params, and the port model loaded from them (f32)."""
    jmodel = jax_build_model(jspec, mesh=None, param_dtype=jnp.float32,
                             compute_dtype=jnp.float32,
                             cache_layout="paged", kv_page_size=4)
    params = jmodel.init(jax.random.key(seed))
    tmodel = build_model(tspec, device="cpu", dtype=torch.float32)
    tmodel.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params),
                                           tspec))
    return jmodel, params, tmodel


def test_port_spec_copies_reference_fields():
    jfields = {f.name for f in dataclasses.fields(jms.ModelSpec)}
    tfields = {f.name for f in dataclasses.fields(tms.ModelSpec)}
    assert jfields == tfields
    for arch in treg.ARCH_IDS:
        j, t = jreg.get_spec(arch), treg.get_spec(arch)
        for f in tfields - {"attn", "moe", "ssm"}:
            assert getattr(j, f) == getattr(t, f), (arch, f)
        assert j.layer_kinds() == t.layer_kinds()
        assert dataclasses.asdict(j.attn) == dataclasses.asdict(t.attn)
        assert (j.moe is None) == (t.moe is None), arch
        if j.moe is not None:
            assert dataclasses.asdict(j.moe) == dataclasses.asdict(t.moe)


# three packed steps over 3 decode slots + 2 prefill rows (chunk 8, pages
# of 4): request A has a 13-token prompt (pages 1-4), B a 5-token prompt
# (pages 5-6).  Each step: (profile, segments) with one segment per
# (q_len, kv_len, first position, pages, tokens-from).
MAX_SLOTS, ROWS, CHUNK, PS, MAX_SEQ, N_PAGES = 3, 2, 8, 4, 32, 10
PAGES = {"A": [1, 2, 3, 4], "B": [5, 6]}
STEPS = [
    # mixed: slots idle; row 0 = A[0:8], row 1 = B[0:5]
    ("mixed", {3: ("A", 0, 8), 4: ("B", 0, 5)}),
    # mixed: slot 0 decodes B at position 5; row 0 = A[8:13]
    ("mixed", {0: ("B", 5, 1), 3: ("A", 8, 5)}),
    # decode-only: slot 0 = B at 6, slot 1 = A at 13
    ("decode", {0: ("B", 6, 1), 1: ("A", 13, 1)}),
]


def _pack(profile, segs, seqs):
    """Numpy packed inputs of one step in the engine's fixed layout."""
    mixed = profile == "mixed"
    n_segs = MAX_SLOTS + ROWS if mixed else MAX_SLOTS
    t = MAX_SLOTS + ROWS * CHUNK if mixed else MAX_SLOTS
    q_start = np.concatenate([np.arange(MAX_SLOTS),
                              MAX_SLOTS + np.arange(ROWS) * CHUNK])[:n_segs]
    tokens = np.zeros((t,), np.int32)
    positions = np.zeros((t,), np.int32)
    q_len = np.zeros((n_segs,), np.int32)
    kv_len = np.zeros((n_segs,), np.int32)
    ptab = np.zeros((n_segs, MAX_SEQ // PS), np.int32)
    for seg, (req, lo, w) in segs.items():
        qs = q_start[seg]
        tokens[qs:qs + w] = seqs[req][lo:lo + w]
        positions[qs:qs + w] = np.arange(lo, lo + w)
        q_len[seg] = w
        kv_len[seg] = lo + w
        ptab[seg, :len(PAGES[req])] = PAGES[req]
    return dict(tokens=tokens, positions=positions,
                q_start=q_start.astype(np.int32), q_len=q_len,
                kv_len=kv_len, page_table=ptab,
                max_q=CHUNK if mixed else 1,
                n_decode=MAX_SLOTS if mixed else 0)


@pytest.mark.parametrize("arch", ["tiny", "qwen1.5-0.5b", "minitron-8b",
                                  "deepseek-moe-16b",
                                  "granite-moe-3b-a800m"])
def test_unified_step_matches_jax(arch):
    jspec, tspec = spec_pair(arch)
    jmodel, params, tmodel = port_from_jax(jspec, tspec)
    rng = np.random.default_rng(7)
    seqs = {r: rng.integers(0, jspec.vocab, size=16).astype(np.int32)
            for r in PAGES}
    jcache = jmodel.init_cache(MAX_SLOTS, MAX_SEQ, layout="paged",
                               n_pages=N_PAGES)
    tcache = tmodel.init_cache(MAX_SLOTS, MAX_SEQ, page_size=PS,
                               n_pages=N_PAGES)
    jstep = jax.jit(jmodel.unified_step)
    live_pages = sorted(p for ps in PAGES.values() for p in ps)
    for profile, segs in STEPS:
        a = _pack(profile, segs, seqs)
        jpacked = JaxPackedSegs(
            q_start=jnp.asarray(a["q_start"]), q_len=jnp.asarray(a["q_len"]),
            kv_len=jnp.asarray(a["kv_len"]),
            page_table=jnp.asarray(a["page_table"]), max_q=a["max_q"],
            n_decode=a["n_decode"])
        jlogits, jcache = jstep(params, jcache, jnp.asarray(a["tokens"]),
                                jnp.asarray(a["positions"]), jpacked)
        tpacked = PackedSegs(
            q_start=torch.from_numpy(a["q_start"]),
            q_len=torch.from_numpy(a["q_len"]),
            kv_len=torch.from_numpy(a["kv_len"]),
            page_table=torch.from_numpy(a["page_table"]),
            max_q=a["max_q"], n_decode=a["n_decode"])
        tlogits, tcache = tmodel.unified_step(
            tcache, torch.from_numpy(a["tokens"]),
            torch.from_numpy(a["positions"]), tpacked)
        live = sorted(segs)
        np.testing.assert_allclose(tlogits.numpy()[live],
                                   np.asarray(jlogits)[live],
                                   atol=LOGITS_ATOL, rtol=0)
        np.testing.assert_array_equal(tcache.lengths.numpy(),
                                      np.asarray(jcache.lengths))
        for i, layer in enumerate(tcache.layers):
            jl = jcache.layers["pos0"]
            for name in ("k", "v"):
                np.testing.assert_allclose(
                    getattr(layer, name).numpy()[live_pages],
                    np.asarray(getattr(jl, name))[i][live_pages],
                    atol=POOL_ATOL, rtol=0, err_msg=f"{profile} {name}{i}")


def test_converter_names_every_parameter():
    """Strict load: the converted tree has exactly the port's names, the
    tied head has no lm_head, and the repeats axis is unstacked in order
    (layer i == repeat i of the single period position)."""
    for arch in ("qwen1.5-0.5b", "minitron-8b"):
        jspec, tspec = spec_pair(arch)
        _, params, tmodel = port_from_jax(jspec, tspec)
        state = from_jax_params(jax.tree.map(np.asarray, params), tspec)
        assert set(state) == set(tmodel.state_dict())
        assert ("lm_head" in state) == (not tspec.tied_embeddings)
        wq = np.asarray(params["layers"]["pos0"]["mixer"]["wq"])
        for i in range(tspec.n_layers):
            np.testing.assert_array_equal(
                state[f"layers.{i}.mixer.wq"].numpy(), wq[i])


def test_converter_widens_bf16_leaves():
    jspec, tspec = spec_pair("tiny")
    jmodel = jax_build_model(jspec, mesh=None, param_dtype=jnp.bfloat16,
                             compute_dtype=jnp.bfloat16)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.key(1)))
    state = from_jax_params(params, tspec)
    assert all(v.dtype == torch.float32 for v in state.values())
    np.testing.assert_array_equal(state["embed"].numpy(),
                                  params["embed"].astype(np.float32))


@pytest.mark.parametrize("act", ["swiglu", "gelu", "relu2"])
def test_activation_matches_jax(act):
    x = np.random.default_rng(0).standard_normal((4, 32), dtype=np.float32)
    np.testing.assert_allclose(
        tcommon.activation(act)(torch.from_numpy(x)).numpy(),
        np.asarray(jcommon.activation(act)(jnp.asarray(x))),
        atol=1e-6, rtol=1e-6)


def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 4, 16), dtype=np.float32)
    scale = rng.standard_normal((16,), dtype=np.float32)
    pos = rng.integers(0, 2048, size=(6,)).astype(np.int32)
    np.testing.assert_allclose(
        tcommon.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        atol=1e-6, rtol=1e-6)
    # positions up to 2k: the same f32 angles; sin/cos of those arguments
    # agree to a few ulp
    np.testing.assert_allclose(
        tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                           1e4).numpy(),
        np.asarray(jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)),
        atol=1e-5, rtol=0)


def test_random_init_is_seeded_and_scaled():
    """build_model draws from its generator: same seed, same weights;
    dense weights are truncated normals with std 1/sqrt(fan_in)."""
    _, tspec = spec_pair("minitron-8b")
    a = build_model(tspec, device="cpu", dtype=torch.float32, seed=3)
    b = build_model(tspec, device="cpu", dtype=torch.float32, seed=3)
    for (n, x), (_, y) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(x, y), n
    w = a.layers[0].ffn.w_up
    assert w.abs().max() <= 2.0 / tspec.d_model ** 0.5 + 1e-6
    assert 0.5 < float(w.std()) * tspec.d_model ** 0.5 < 1.0
