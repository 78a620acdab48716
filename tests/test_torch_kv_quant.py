"""Port parity of the int8 KV cache (the reference's ``kv_quant``): the
port's quantize and dequantize, its three quantized read paths and its
engines, all against the JAX package on the CPU.

JAX initialises the weights and the port loads them through
``from_jax_params``; inputs are drawn with numpy from a seed; everything is
float32, the port on its plain kernels.  Tolerances, each written where it
is used:

* ``_quantize_kv``/``_dequantize_kv`` on the same inputs: codes and scales
  bit for bit, the dequantized values bit for bit (f32 and bf16).
* A read path against the JAX function: logits within ``LOGITS_ATOL``
  (1e-3: the quantized K/V move the logits by a code step's share, and the
  two packages' f32 sums may round a value across a .5 boundary of its
  code); codes equal but for off-by-one flips on under ``FLIP_SHARE`` of
  the entries; scales within ``SCALE_RTOL`` (1e-6) relative in the first
  layer, whose K/V come from one projection of the embeddings, and within
  ``DEEP_SCALE_RTOL`` (1e-5) in later layers, whose inputs carry the f32
  sum-order differences the other port tests allow their caches (1e-5);
  rows a mask leaves out bit for bit.
* Engines: greedy outputs token-identical, every counter equal and
  ``kv_stats()`` equal to the JAX engine's.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import modelspec as jms
from repro.models import build_model as jax_build_model
from repro.models.attention import PackedSegs as JaxPackedSegs
from repro.models.attention import PagedAttnCache as JaxPagedAttnCache
from repro.models.attention import _dequantize_kv as jax_dequantize_kv
from repro.models.attention import _quantize_kv as jax_quantize_kv
from repro.models.attention import paged_insert_rows as jax_paged_insert_rows
from repro.models.model import ModelCache as JaxModelCache
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import Request as JaxRequest
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch.configs import registry as treg
from repro_torch.core import modelspec as tms
from repro_torch.kernels import ref
from repro_torch.models import attention as tattn
from repro_torch.models import build_model, from_jax_params
from repro_torch.models.attention import PackedSegs, paged_insert_rows
from repro_torch.models.model import ModelCache
from repro_torch.serving import EngineConfig, Request, ServeEngine

LOGITS_ATOL = 1e-3
FLIP_SHARE = 1e-3  # off-by-one code flips allowed on under 0.1% of entries
SCALE_RTOL = 1e-6  # first layer
DEEP_SCALE_RTOL = 1e-5  # later layers: f32 sums in other orders upstream
COUNTERS = ("steps", "preemptions", "decode_steps", "prefill_calls",
            "prefill_tokens", "generated_tokens", "dispatches",
            "transfers_d2h", "capacity_stops", "peak_active",
            "pages_in_use_peak", "kv_used_tokens_peak")
SPEC_COUNTERS = COUNTERS + (
    "spec_rounds", "spec_slot_rounds", "spec_proposed", "spec_accepted",
    "spec_bonus", "spec_emitted", "spec_by_slot")
PREFIX_COUNTERS = COUNTERS + (
    "prefix_lookups", "prefix_hits", "prefix_lookup_tokens",
    "prefix_hit_tokens", "prefix_cached_tokens", "prefix_cow_forks",
    "prefix_inserted_pages", "prefix_evicted_pages",
    "prefix_shared_pages_peak", "prefix_by_tenant")


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# the two functions
# ---------------------------------------------------------------------------

def _kv_input(dtype, seed=0):
    """(3, 5, 4, 16) K/V values times 3, with a zero row (its scale maps
    to 1.0) and a row whose absmax is 127, so that its values divided by
    the scale of 1.0 land on .5 (round half to even)."""
    x = np.random.default_rng(seed).standard_normal((3, 5, 4, 16)) * 3.0
    x[0, 1, 2] = 0.0
    x[1, 3, 0] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 63.5, -63.5, 126.5,
                  -126.5, 3.5, 4.5, -3.5, 0.0, 5.5, 6.5]
    t = torch.from_numpy(x.astype(np.float32)).to(dtype)
    return t, jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_quantize_matches_jax_bit_for_bit(dtype):
    x, jx = _kv_input(dtype)
    codes, scale = tattn._quantize_kv(x)
    jcodes, jscale = jax_quantize_kv(jx)
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), _np(jcodes))
    np.testing.assert_array_equal(scale.numpy(), _np(jscale))
    assert scale[0, 1, 2] == 1.0 and not codes[0, 1, 2].any()
    assert codes[1, 3, 0].tolist() == [127, 0, 2, 2, 0, -2, 64, -64, 126,
                                       -126, 4, 4, -4, 0, 6, 6]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_dequantize_is_one_pass_and_matches_jax_bit_for_bit(dtype):
    """The one-pass product into a buffer equals the JAX function and the
    three-pass f32 chain bit for bit."""
    rng = np.random.default_rng(1)
    codes = rng.integers(-127, 128, (64, 8, 16, 32)).astype(np.int8)
    scale = (rng.random((64, 8, 16)) * 0.05).astype(np.float32)
    tc, ts = torch.from_numpy(codes), torch.from_numpy(scale)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    buf = torch.empty(tc.shape, dtype=dtype)
    got = tattn._dequantize_kv(tc, ts, dtype, out=buf)
    assert got is buf
    want = _np(jax_dequantize_kv(jnp.asarray(codes), jnp.asarray(scale),
                                 jdt).astype(jnp.float32))
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert torch.equal(got, (tc.float() * ts[..., None]).to(dtype))


def test_quantize_roundtrip_error_bounded():
    """The mirror of the reference's: every value comes back within its
    row's absmax / 127."""
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 8, 4, 16)).astype(np.float32) * 3.0)
    codes, scale = tattn._quantize_kv(x)
    y = tattn._dequantize_kv(codes, scale, torch.float32)
    bound = x.abs().amax(-1, keepdim=True) / 127.0 + 1e-6
    assert bool(((x - y).abs() <= bound).all())


def test_gathered_view_is_the_reference_linearization():
    """The paged decode's gather + dequantize (one pass through the
    page-to-token transpose) equals ``paged_gather`` of the codes and of the
    scales, then the dequantize, bit for bit; out-of-range ids clamp."""
    rng = np.random.default_rng(3)
    p, hkv, ps, d = 9, 2, 4, 16
    codes = [torch.from_numpy(rng.integers(-127, 128, (p, hkv, ps, d))
                              .astype(np.int8)) for _ in range(2)]
    scales = [torch.from_numpy(rng.random((p, hkv, ps)).astype(np.float32))
              for _ in range(2)]
    cache = tattn.PagedAttnCache(*codes, *scales)
    table = torch.tensor([[3, 1, 0], [8, 12, 2]], dtype=torch.int32)
    views = {}
    got = tattn._gathered(cache, table, views, torch.float32)
    for g, c, s in zip(got, codes, scales):
        want = tattn._dequantize_kv(ref.paged_gather(c, table),
                                    ref.paged_gather(s, table),
                                    torch.float32)
        assert torch.equal(g, want)
    assert [t.data_ptr() for t in got] == [
        t.data_ptr() for t in tattn._gathered(cache, table, views,
                                              torch.float32)]


# ---------------------------------------------------------------------------
# models: the reference's tests/test_kv_quant.py, mirrored
# ---------------------------------------------------------------------------

TINY = dict(name="tiny", d_model=128, n_layers=2, n_heads=8, n_kv_heads=4,
            d_head=16, d_ff=128, vocab=256)


@functools.lru_cache(maxsize=None)
def _tiny():
    """The reference's pair: one JAX model + params; the port's
    full-precision and quantized models loaded from them."""
    jspec = jms.ModelSpec(**TINY, attn=jms.AttnSpec())
    tspec = tms.ModelSpec(**TINY, attn=tms.AttnSpec())
    jq8 = jax_build_model(jspec, mesh=None, param_dtype=jnp.float32,
                          compute_dtype=jnp.float32, kv_quant=True)
    params = jq8.init(jax.random.key(0))
    state = from_jax_params(jax.tree.map(np.asarray, params), tspec)
    models = []
    for quant in (False, True):
        m = build_model(tspec, device="cpu", dtype=torch.float32,
                        kv_quant=quant)
        m.load_state_dict(state)
        models.append(m)
    return tspec, jq8, params, *models


def _bytes(cache):
    return sum(t.numel() * t.element_size() for layer in cache.layers
               for t in tattn.kv_tensors(layer))


def test_cache_dtype_and_size():
    _, _, _, fp, q8 = _tiny()
    c = q8.init_cache(2, 32, layout="dense")
    layer = c.layers[0]
    assert layer.k.dtype == layer.v.dtype == torch.int8
    assert layer.k_scale.shape == (2, 32, 4)
    assert layer.k_scale.dtype == torch.float32
    assert fp.init_cache(2, 32, layout="dense").layers[0].k_scale is None
    for layout in ("dense", "paged"):
        assert _bytes(q8.init_cache(2, 32, layout=layout)) \
            < 0.45 * _bytes(fp.init_cache(2, 32, layout=layout))


def test_quantized_decode_tracks_full_precision():
    """Prefill then 6 greedy decode steps: quantized logits within 0.05 of
    full precision (the reference's bound) and the greedy paths equal; the
    quantized logits within LOGITS_ATOL of the JAX quantized model's."""
    spec, jq8, params, fp, q8 = _tiny()
    toks = np.random.default_rng(1).integers(0, spec.vocab, (2, 12)
                                             ).astype(np.int32)
    c1 = fp.init_cache(2, 32, layout="dense")
    c2 = q8.init_cache(2, 32, layout="dense")
    jc = jq8.init_cache(2, 32)
    l1, c1 = fp.prefill(torch.from_numpy(toks), cache=c1)
    l2, c2 = q8.prefill(torch.from_numpy(toks), cache=c2)
    jl, jc = jq8.prefill(params, jnp.asarray(toks), cache=jc)
    jdecode = jax.jit(jq8.decode_step)
    for _ in range(6):
        assert float((l1 - l2).abs().max()) < 0.05
        np.testing.assert_allclose(l2.numpy(), _np(jl), atol=LOGITS_ATOL,
                                   rtol=0)
        t1, t2 = l1.argmax(-1)[:, None], l2.argmax(-1)[:, None]
        assert torch.equal(t1, t2), "greedy path diverged"
        l1, c1 = fp.decode_step(c1, t1)
        l2, c2 = q8.decode_step(c2, t2)
        jl, jc = jdecode(params, jc, jnp.asarray(t2.numpy()))


def test_quantized_chunked_prefill():
    """Three chunks of 4 into a quantized cache: within 0.05 of the
    full-precision model's logits after the 12 tokens (the reference's
    bound), and within LOGITS_ATOL of the JAX quantized chunks'."""
    spec, jq8, params, fp, q8 = _tiny()
    toks = np.random.default_rng(2).integers(0, spec.vocab, (1, 12)
                                             ).astype(np.int32)
    c = q8.init_cache(1, 32, layout="dense")
    jc = jq8.init_cache(1, 32)
    jchunk = jax.jit(jq8.prefill_chunk)
    for lo in (0, 4, 8):
        logits, c = q8.prefill_chunk(c, torch.from_numpy(toks[:, lo:lo + 4]))
        jl, jc = jchunk(params, jc, jnp.asarray(toks[:, lo:lo + 4]))
        np.testing.assert_allclose(logits.numpy(), _np(jl),
                                   atol=LOGITS_ATOL, rtol=0)
    want, _ = fp.prefill(torch.from_numpy(toks),
                         cache=fp.init_cache(1, 32, layout="dense"))
    np.testing.assert_allclose(logits.numpy(), want.numpy(), atol=0.05,
                               rtol=0.05)


# ---------------------------------------------------------------------------
# each read path against the JAX function, at reduced minitron-8b
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _pair(arch: str, quant: bool = True):
    """JAX model + params (quantized), and the port model loaded from the
    same tree with ``kv_quant=quant``; the JAX MoE on its dense path, as
    without a mesh."""
    jspec, tspec = jreg.get_reduced(arch), treg.get_reduced(arch)
    jmodel = jax_build_model(jspec, mesh=None, param_dtype=jnp.float32,
                             compute_dtype=jnp.float32, moe_impl="dense",
                             cache_layout="paged", kv_page_size=4,
                             kv_quant=True)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0)))
    tmodel = build_model(tspec, device="cpu", dtype=torch.float32,
                         kv_quant=quant)
    tmodel.load_state_dict(from_jax_params(tree, tspec))
    return jspec, jmodel, jax.tree.map(jnp.asarray, tree), tmodel


def _assert_codes(got, want, what):
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max(initial=0) <= 1, what
    assert np.count_nonzero(d) < FLIP_SHARE * d.size, what


def _assert_layer(layer, jl, rep, what, rows=slice(None)):
    """Codes and scales of one port layer against the JAX stack's repeat
    ``rep`` (= the layer index), on ``rows`` (the batch or page axis)."""
    rtol = SCALE_RTOL if rep == 0 else DEEP_SCALE_RTOL
    for name in ("k", "v"):
        _assert_codes(getattr(layer, name).numpy()[rows],
                      _np(getattr(jl, name))[rep][rows], f"{what} {name}")
        np.testing.assert_allclose(
            getattr(layer, f"{name}_scale").numpy()[rows],
            _np(getattr(jl, f"{name}_scale"))[rep][rows], rtol=rtol,
            atol=0, err_msg=f"{what} {name}_scale")


def _assert_cache(tcache, jcache, what, rows=slice(None)):
    for i, layer in enumerate(tcache.layers):
        _assert_layer(layer, jcache.layers["pos0"], i, f"{what} layer {i}",
                      rows)


B, T, PS = 3, 32, 4


@pytest.mark.parametrize("widths", [(T,), (5, 11)], ids=["full", "chunks"])
def test_dense_branch_matches_jax(widths):
    """Full width (s == T: codes and scales stored, attention over the
    unquantized K/V) or two chunks then two decode steps (the second with
    a row past the cache, whose write clamps)."""
    jspec, jmodel, params, tmodel = _pair("minitron-8b")
    rng = np.random.default_rng(len(widths))
    jcache = jmodel.init_cache(B, T, layout="dense")
    tcache = tmodel.init_cache(B, T, layout="dense")
    jchunk, jdecode = jax.jit(jmodel.prefill_chunk), \
        jax.jit(jmodel.decode_step)
    for w in widths:
        toks = rng.integers(0, jspec.vocab, (B, w)).astype(np.int32)
        jl, jcache = jchunk(params, jcache, jnp.asarray(toks))
        tl, tcache = tmodel.prefill_chunk(tcache, torch.from_numpy(toks))
        np.testing.assert_allclose(tl.numpy(), _np(jl), atol=LOGITS_ATOL,
                                   rtol=0)
        _assert_cache(tcache, jcache, f"chunk {w}")
    if widths == (T,):
        return
    for step in range(2):
        if step == 1:
            over = np.asarray([16, 17, T + 3], np.int32)
            jcache = JaxModelCache(layers=jcache.layers,
                                   lengths=jnp.asarray(over))
            tcache = ModelCache(layers=tcache.layers,
                                lengths=torch.from_numpy(over),
                                views=tcache.views)
        toks = rng.integers(0, jspec.vocab, (B, 1)).astype(np.int32)
        jl, jcache = jdecode(params, jcache, jnp.asarray(toks))
        tl, tcache = tmodel.decode_step(tcache, torch.from_numpy(toks))
        np.testing.assert_allclose(tl.numpy(), _np(jl), atol=LOGITS_ATOL,
                                   rtol=0)
        _assert_cache(tcache, jcache, f"decode {step}")


ROWS = 3
LENGTHS = (5, 30, 20)  # row 1, unselected: at w = 4 its window clamps
MASK = (True, False, True)


def _seeded_scratch(jmodel, tmodel, seed):
    """One quantized dense scratch of ROWS rows a side, the same codes
    (uniform in [-127, 127]) and scales (uniform in (0, 0.05]) on both,
    lengths LENGTHS."""
    rng = np.random.default_rng(seed)
    tcache = tmodel.init_cache(ROWS, T, layout="dense")
    jl = jmodel.init_cache(ROWS, T, layout="dense").layers["pos0"]
    stacked = {}
    for i, layer in enumerate(tcache.layers):
        for name, t in zip(("k", "v", "k_scale", "v_scale"),
                           tattn.kv_tensors(layer)):
            x = (rng.integers(-127, 128, t.shape).astype(np.int8)
                 if t.dtype == torch.int8 else
                 (0.05 * (1.0 - rng.random(t.shape))).astype(np.float32))
            t.copy_(torch.from_numpy(x))
            stacked.setdefault(name, np.array(getattr(jl, name)))[i] = x
    tcache.lengths.copy_(torch.tensor(LENGTHS, dtype=torch.int32))
    layers = {"pos0": dataclasses.replace(
        jl, **{n: jnp.asarray(a) for n, a in stacked.items()})}
    return tcache, JaxModelCache(layers=layers,
                                 lengths=jnp.asarray(LENGTHS, jnp.int32))


@pytest.mark.parametrize("w", [1, 4])
def test_masked_chunk_matches_jax_prefill_masked(w):
    """The masked chunk against the JAX engine's ``_prefill_masked`` on a
    seeded quantized scratch: the selected rows within the tolerances, the
    unselected row's codes, scales and length unchanged bit for bit."""
    jspec, jmodel, params, tmodel = _pair("minitron-8b")
    tcache, jcache = _seeded_scratch(jmodel, tmodel, seed=w)
    before = [[t.clone() for t in tattn.kv_tensors(layer)]
              for layer in tcache.layers]
    toks = np.random.default_rng(w).integers(0, jspec.vocab, (ROWS, w)
                                             ).astype(np.int32)
    jeng = JaxServeEngine(jmodel, params, JaxEngineConfig(
        max_slots=2, max_seq=T, chunk_size=4, prefill_rows=ROWS))
    jl, jnew = jax.jit(jeng._prefill_masked)(params, jcache,
                                             jnp.asarray(toks),
                                             jnp.asarray(MASK))
    mask = torch.tensor(MASK)
    tl, _ = tmodel.prefill_chunk(tcache, torch.from_numpy(toks), mask=mask)
    sel = np.asarray(MASK)
    np.testing.assert_allclose(tl.numpy()[sel], _np(jl)[sel],
                               atol=LOGITS_ATOL, rtol=0)
    assert tcache.lengths.tolist() == [n + w * m
                                       for n, m in zip(LENGTHS, MASK)]
    for layer, old in zip(tcache.layers, before):
        for got, x in zip(tattn.kv_tensors(layer), old):
            assert torch.equal(got[~mask], x[~mask])
    _assert_cache(tcache, jnew, f"masked w={w}", rows=sel)


def test_paged_insert_and_decode_match_jax():
    """A quantized scratch prefill scattered into pages with its scales
    (the 0-padded tail onto the null page), then two paged decode steps
    through the table (the gather route: flash at Sq = 1 over the
    dequantized view), one slot idle on the null page past max_seq."""
    jspec, jmodel, params, tmodel = _pair("minitron-8b")
    rng = np.random.default_rng(3)
    mp, n_pages = T // PS, 16
    prompts = (9, 14)
    toks = rng.integers(0, jspec.vocab, (2, 14)).astype(np.int32)
    jscr = jmodel.init_cache(2, T, layout="dense")
    tscr = tmodel.init_cache(2, T, layout="dense")
    _, jscr = jax.jit(jmodel.prefill_chunk)(params, jscr, jnp.asarray(toks))
    _, tscr = tmodel.prefill_chunk(tscr, torch.from_numpy(toks))
    ptab = np.zeros((B, mp), np.int32)
    ptab[0, :3] = [5, 2, 9]
    ptab[1, :4] = [1, 12, 7, 3]
    tcache = tmodel.init_cache(B, T, layout="paged", page_size=PS,
                               n_pages=n_pages)
    jpool = jmodel.init_cache(B, T, layout="paged",
                              n_pages=n_pages).layers["pos0"]
    js = jscr.layers["pos0"]
    stacked = {n: [] for n in ("k", "v", "k_scale", "v_scale")}
    for i, (tl, sl) in enumerate(zip(tcache.layers, tscr.layers)):
        jp = JaxPagedAttnCache(**{n: getattr(jpool, n)[i] for n in stacked})
        for slot in (0, 1):
            jp = jax_paged_insert_rows(
                jp, dataclasses.replace(js, **{
                    n: getattr(js, n)[i] for n in stacked}),
                slot, jnp.asarray(ptab[slot]))
            paged_insert_rows(tl, sl, torch.tensor([slot]),
                              torch.from_numpy(ptab[slot]))
        for n in stacked:
            stacked[n].append(getattr(jp, n))
    live = sorted(int(p) for p in ptab.ravel() if p)
    lengths = np.asarray([prompts[0], prompts[1], T + 5], np.int32)
    jcache = JaxModelCache(
        layers={"pos0": JaxPagedAttnCache(
            **{n: jnp.stack(a) for n, a in stacked.items()})},
        lengths=jnp.asarray(lengths), page_table=jnp.asarray(ptab))
    _assert_cache(tcache, jcache, "insert", rows=live)
    tcache = ModelCache(layers=tcache.layers,
                        lengths=torch.from_numpy(lengths),
                        page_table=torch.from_numpy(ptab))
    jdecode = jax.jit(jmodel.decode_step)
    for step in range(2):
        feed = rng.integers(0, jspec.vocab, (B, 1)).astype(np.int32)
        jl, jcache = jdecode(params, jcache, jnp.asarray(feed))
        tl, tcache = tmodel.decode_step(tcache, torch.from_numpy(feed))
        np.testing.assert_allclose(tl.numpy()[:2], _np(jl)[:2],
                                   atol=LOGITS_ATOL, rtol=0)
        _assert_cache(tcache, jcache, f"decode {step}", rows=live)
    # one (B, max_pages * page_size) view pair, reused by both layers
    assert list(tcache.views) == [((B, T, 2, 16), torch.float32)]


# three packed steps over 3 decode slots + 2 prefill rows (chunk 8, pages
# of 4): A has a 13-token prompt (pages 1-4), B 5 tokens (pages 5-6); the
# second step splits 1 decode segment from the prefill rows
MAX_SLOTS, CHUNK, N_PAGES = 3, 8, 10
PAGES = {"A": [1, 2, 3, 4], "B": [5, 6]}
STEPS = [("mixed", {3: ("A", 0, 8), 4: ("B", 0, 5)}),
         ("mixed", {0: ("B", 5, 1), 3: ("A", 8, 5)}),
         ("decode", {0: ("B", 6, 1), 1: ("A", 13, 1)})]


def _pack(profile, segs, seqs):
    mixed = profile == "mixed"
    n_segs = MAX_SLOTS + 2 if mixed else MAX_SLOTS
    t = MAX_SLOTS + 2 * CHUNK if mixed else MAX_SLOTS
    a = dict(q_start=np.concatenate([np.arange(MAX_SLOTS), MAX_SLOTS
                                     + np.arange(2) * CHUNK])[:n_segs]
             .astype(np.int32),
             tokens=np.zeros((t,), np.int32),
             positions=np.zeros((t,), np.int32),
             q_len=np.zeros((n_segs,), np.int32),
             kv_len=np.zeros((n_segs,), np.int32),
             page_table=np.zeros((n_segs, T // PS), np.int32))
    for seg, (req, lo, w) in segs.items():
        qs = a["q_start"][seg]
        a["tokens"][qs:qs + w] = seqs[req][lo:lo + w]
        a["positions"][qs:qs + w] = np.arange(lo, lo + w)
        a["q_len"][seg], a["kv_len"][seg] = w, lo + w
        a["page_table"][seg, :len(PAGES[req])] = PAGES[req]
    statics = dict(max_q=CHUNK if mixed else 1,
                   n_decode=MAX_SLOTS if mixed else 0)
    return a, statics


def test_packed_step_matches_jax():
    """Two mixed steps (the second with its decode/prefill split) and a
    decode-only step: K/V quantized into pages, the ragged attention over
    the dequantized pools, against the JAX ``unified_step``."""
    jspec, jmodel, params, tmodel = _pair("minitron-8b")
    rng = np.random.default_rng(7)
    seqs = {r: rng.integers(0, jspec.vocab, 16).astype(np.int32)
            for r in PAGES}
    jcache = jmodel.init_cache(MAX_SLOTS, T, layout="paged",
                               n_pages=N_PAGES)
    tcache = tmodel.init_cache(MAX_SLOTS, T, page_size=PS, n_pages=N_PAGES)
    jstep = jax.jit(jmodel.unified_step)
    live = sorted(p for ps in PAGES.values() for p in ps)
    for profile, segs in STEPS:
        a, statics = _pack(profile, segs, seqs)
        names = ("q_start", "q_len", "kv_len", "page_table")
        jl, jcache = jstep(params, jcache, jnp.asarray(a["tokens"]),
                           jnp.asarray(a["positions"]), JaxPackedSegs(
                               **{n: jnp.asarray(a[n]) for n in names},
                               **statics))
        tl, tcache = tmodel.unified_step(
            tcache, torch.from_numpy(a["tokens"]),
            torch.from_numpy(a["positions"]), PackedSegs(
                **{n: torch.from_numpy(a[n]) for n in names}, **statics))
        segs_live = sorted(segs)
        np.testing.assert_allclose(tl.numpy()[segs_live],
                                   _np(jl)[segs_live], atol=LOGITS_ATOL,
                                   rtol=0)
        _assert_cache(tcache, jcache, profile, rows=live)
    assert list(tcache.views) == [((N_PAGES, 2, PS, 16), torch.float32)]


# ---------------------------------------------------------------------------
# engines against the JAX engine, quantized
# ---------------------------------------------------------------------------

MODES = {"unified": dict(cache_layout="paged", unified=True),
         "paged": dict(cache_layout="paged", unified=False),
         "dense": dict(cache_layout="dense", unified=False)}
# prompt lengths and max_new_tokens: five requests over two slots (churn),
# contexts past mistral's window of 24; and six over a pool that preempts
CHURN = ([5, 30, 3, 27, 13], [5, 3, 6, 4, 5])
TIGHT = ([13, 11, 14, 12, 9, 15], [10] * 6)


def _cfg(cls, mode, tight, **kw):
    base = dict(max_slots=2, max_seq=64, chunk_size=8, prefill_rows=2,
                page_size=8, **MODES[mode])
    if tight:
        base.update(max_slots=4, max_seq=32, chunk_size=4, page_size=4,
                    n_pages=11)
    return cls(**base, **kw)


def _prompts(vocab, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).tolist() for n in lengths]


def _port_serve(tmodel, cfg, prompts, max_new, **kw):
    eng = ServeEngine(tmodel, cfg, device="cpu", **kw)
    reqs = eng.serve([Request(prompt=list(p), max_new_tokens=m)
                      for p, m in zip(prompts, max_new)])
    assert all(r.state == "done" for r in reqs)
    return eng, [r.output for r in reqs]


def _assert_engines(jeng, jouts, teng, touts, counters=COUNTERS):
    assert touts == jouts
    for name in counters:
        assert getattr(teng.metrics, name) == getattr(jeng.metrics, name), \
            name
    assert teng.kv_stats() == jeng.kv_stats()
    if teng.paged:
        teng.pager.check()


CASES = [(arch, mode, False) for arch in ("minitron-8b", "deepseek-moe-16b")
         for mode in MODES] + [
    (arch, mode, True) for arch in ("minitron-8b", "deepseek-moe-16b")
    for mode in ("unified", "paged")] + [
    ("mistral-7b-swa", mode, False) for mode in ("dense", "paged")] + [
    ("rwkv6-3b", mode, tight) for mode, tight in (("dense", False),
                                                  ("paged", True))]


@pytest.mark.parametrize("arch,mode,tight", CASES,
                         ids=lambda v: v if isinstance(v, str)
                         else ("tight" if v else "churn"))
def test_engine_matches_jax_quantized(arch, mode, tight):
    """Outputs, the 12 counters and ``kv_stats()`` equal the quantized JAX
    engine's (mistral-7b-swa in both two-dispatch layouts: its contexts
    pass the window; rwkv6-3b, whose state is never quantized, also equals
    the port's engine without ``kv_quant``)."""
    jspec, jmodel, params, tmodel = _pair(arch)
    lengths, max_new = TIGHT if tight else CHURN
    prompts = _prompts(jspec.vocab, lengths, len(arch) + len(mode) + tight)
    jeng = JaxServeEngine(jmodel, params, _cfg(JaxEngineConfig, mode, tight))
    jreqs = jeng.serve([JaxRequest(prompt=list(p), max_new_tokens=m)
                        for p, m in zip(prompts, max_new)])
    assert all(r.state == "done" for r in jreqs)
    teng, touts = _port_serve(tmodel, _cfg(EngineConfig, mode, tight),
                              prompts, max_new)
    _assert_engines(jeng, [r.output for r in jreqs], teng, touts)
    m = teng.metrics
    assert m.preemptions > 0 if tight else m.peak_active == 2
    if jspec.is_attention_free:
        assert teng.kv_stats()["kv_reserved_bytes"] == 0
        feng, fouts = _port_serve(_pair(arch, quant=False)[3],
                                  _cfg(EngineConfig, mode, tight), prompts,
                                  max_new)
        assert fouts == touts and feng.kv_stats() == teng.kv_stats()
        for name in COUNTERS:
            assert getattr(feng.metrics, name) == getattr(m, name), name
    else:
        layer = teng.cache.layers[0]
        assert layer.k.dtype == torch.int8 and layer.k_scale is not None


def test_quantized_engines_are_token_identical():
    """The reference's equalities, on the port: dense equals paged, and
    unified equals two-dispatch, quantized."""
    jspec, _, _, tmodel = _pair("minitron-8b")
    prompts = _prompts(jspec.vocab, CHURN[0], 13)
    outs = [_port_serve(tmodel, _cfg(EngineConfig, mode, False), prompts,
                        CHURN[1])[1] for mode in MODES]
    assert outs[0] == outs[1] == outs[2]


def test_kv_reserved_bytes_count_the_scales():
    """Codes plus scales: 1 byte a value and 4 a (token, head), and the
    reference's figure for the same geometry."""
    jspec, jmodel, params, tmodel = _pair("minitron-8b")
    for mode in ("unified", "dense"):
        teng = ServeEngine(tmodel, _cfg(EngineConfig, mode, False),
                           device="cpu")
        jeng = JaxServeEngine(jmodel, params,
                              _cfg(JaxEngineConfig, mode, False))
        per_token = jspec.n_kv_heads * (jspec.d_head + 4) * 2 \
            * jspec.n_layers
        tokens = (teng.pager.n_pages * 8 if teng.paged else 2 * 64)
        assert teng.kv_stats()["kv_reserved_bytes"] == tokens * per_token \
            == jeng.kv_stats()["kv_reserved_bytes"]


@pytest.mark.parametrize("arch", ["minitron-8b", "deepseek-moe-16b"])
def test_prefix_fork_poisoned_codes_and_scales_match_jax(arch):
    """A full hit forks its tail page copy-on-write with its scales; the
    shared original then set to code 127 and scale 1e9 in every layer
    leaves the forked request's output equal to the first request's, in
    both packages, with every counter equal."""
    _, jmodel, params, tmodel = _pair(arch)
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3]  # 2 pages
    kw = dict(max_slots=2, max_seq=64, chunk_size=8, prefill_rows=2,
              cache_layout="paged", page_size=8, unified=True,
              prefix_cache=True, debug_guards=True)
    out = {}
    for name in ("jax", "port"):
        if name == "jax":
            eng = JaxServeEngine(jmodel, params, JaxEngineConfig(**kw),
                                 rng=jax.random.key(1))
            req_cls = JaxRequest
        else:
            eng = ServeEngine(tmodel, EngineConfig(**kw), device="cpu")
            req_cls = Request
        r1 = req_cls(prompt=prompt, max_new_tokens=6)
        eng.serve([r1])
        shared, n_cached = eng.prefix.lookup(prompt)
        assert n_cached == 16 and len(shared) == 2
        r2 = req_cls(prompt=prompt, max_new_tokens=6)
        eng.submit(r2)
        eng.step()  # admission: attach the hit + the copy-on-write fork
        assert eng.metrics.prefix_cow_forks == 1
        assert shared[1] not in eng.pager.owned(r2.rid)
        if name == "jax":
            eng.cache = eng.cache.__class__(
                layers=jax.tree.map(
                    lambda a: a.at[:, shared[1]].set(
                        127 if a.dtype == jnp.int8 else 1e9),
                    eng.cache.layers),
                lengths=eng.cache.lengths, page_table=eng.cache.page_table)
        else:
            for layer in eng.cache.layers:
                layer.k[shared[1]] = layer.v[shared[1]] = 127
                layer.k_scale[shared[1]] = layer.v_scale[shared[1]] = 1e9
        while r2.state != "done":
            eng.step()
        assert r2.output == r1.output
        out[name] = eng, [r1.output, r2.output]
    (jeng, jouts), (teng, touts) = out["jax"], out["port"]
    _assert_engines(jeng, jouts, teng, touts, PREFIX_COUNTERS)
    assert vars(teng.prefix.stats) == vars(jeng.prefix.stats)


@functools.lru_cache(maxsize=None)
def _drafts():
    """The reference's ``drafted`` draft (every leaf times 1 + 0.04 N(0, 1)
    from seed 99) in both packages, quantized."""
    jspec, _, params, _ = _pair("minitron-8b")
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(99)
    d_tree = jax.tree.map(
        lambda a: a * (1.0 + 0.04 * rng.standard_normal(a.shape)
                       .astype(np.float32)), tree)
    tspec = treg.get_reduced("minitron-8b")
    draft = build_model(tspec, device="cpu", dtype=torch.float32,
                        kv_quant=True)
    draft.load_state_dict(from_jax_params(d_tree, tspec))
    return jax.tree.map(jnp.asarray, d_tree), draft


@pytest.mark.parametrize("arch,draft", [("minitron-8b", "self"),
                                        ("minitron-8b", "perturbed"),
                                        ("deepseek-moe-16b", "self")])
def test_spec_engine_matches_jax_quantized(arch, draft):
    """A quantized target with a quantized draft (itself, or the perturbed
    one; each with its own mirrored int8 pool): outputs, every counter and
    every spec counter equal the JAX spec engine's; greedy outputs equal the
    port's quantized engine without speculation."""
    jspec, jmodel, params, tmodel = _pair(arch)
    if draft == "self":
        d_params, d_model = params, tmodel
    else:
        d_params, d_model = _drafts()
    kw = dict(max_slots=3, max_seq=96, chunk_size=4, prefill_rows=2,
              cache_layout="paged", page_size=8, unified=True,
              debug_guards=True)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jspec.vocab, size=int(n)).tolist()
               for n in rng.integers(3, 14, size=5)]
    jeng = JaxServeEngine(jmodel, params, JaxEngineConfig(**kw, n_spec=3),
                          rng=jax.random.key(11), draft_model=jmodel,
                          draft_params=d_params)
    jreqs = jeng.serve([JaxRequest(prompt=list(p), max_new_tokens=10)
                        for p in prompts])
    teng, touts = _port_serve(tmodel, EngineConfig(**kw, n_spec=3), prompts,
                              [10] * 5, draft_model=d_model)
    _assert_engines(jeng, [r.output for r in jreqs], teng, touts,
                    SPEC_COUNTERS)
    assert teng.speculator.d_cache.layers[0].k_scale is not None
    off = _port_serve(tmodel, EngineConfig(**kw), prompts, [10] * 5)[1]
    assert touts == off
    rate = teng.metrics.spec_acceptance_rate
    assert rate == 1.0 if draft == "self" else 0.0 < rate < 1.0


@pytest.mark.parametrize("mode", list(MODES))
def test_step_graph_keeps_scale_and_view_addresses(mode):
    """The ``StepGraph`` path (``graphs=True``; on the CPU each profile runs
    on the very static tensors a capture binds) under ``debug_guards``:
    every scale tensor and every dequantize buffer keeps its address from
    the first step to the last, no buffer is added after the first steps,
    and the outputs equal the eager engine's."""
    jspec, _, _, tmodel = _pair("minitron-8b")
    prompts = _prompts(jspec.vocab, CHURN[0], 21)
    cfg = _cfg(EngineConfig, mode, False, debug_guards=True)
    eng = ServeEngine(tmodel, cfg, device="cpu", graphs=True)
    caches = [eng.cache] + ([eng.scratch] if eng.scratch else [])

    def ptrs():
        return ([t.data_ptr() for c in caches for layer in c.layers
                 for t in (layer.k_scale, layer.v_scale)],
                {key: [t.data_ptr() for t in pair] for c in caches
                 for key, pair in c.views.items()})
    reqs = [Request(prompt=list(p), max_new_tokens=m)
            for p, m in zip(prompts, CHURN[1])]
    for r in reqs:
        eng.submit(r)
    for _ in range(6):
        eng.step()
    first = ptrs()
    assert first[1]  # the quantized reads made their buffers
    eng.run()
    assert all(r.state == "done" for r in reqs)
    assert ptrs() == first
    assert set(eng._graphs.captures.values()) == {1}
    _, eager = _port_serve(tmodel, cfg, prompts, CHURN[1], graphs=False)
    assert [r.output for r in reqs] == eager
