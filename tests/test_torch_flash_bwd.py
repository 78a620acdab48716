"""Port parity of training's attention: the blockwise plain flash forward
with its log-sum-exp (``ref.flash_fwd_reference``, the port of
``flash_jnp._fwd_core``) and the FlashAttention-2 backward
(``ref.flash_bwd_reference``, the port of ``flash_jnp._bwd_core``) against
the JAX package: the forward's o and lse against ``_fwd_core``, and dq,
dk, dv against ``jax.vjp`` through ``flash_jnp.flash_attention`` and
through ``pallas_flash_attention(interpret=True)``, over
``tests/test_kernels.py``'s ``FLASH_CASES`` (causal, bidirectional, GQA,
window) and two cases of this file (kv_len with q_offset; rows that see no
key).  The differentiable ``FlashAttention`` function passes
``torch.autograd.gradcheck`` in float64, and the CUDA wrapper refuses CPU
tensors.

Inputs and the upstream gradient are made with numpy from a seed and
handed to both frameworks (bf16 rounded once on each side, the same
bits).  Tolerances: the reference's ``TOL`` of ``tests/test_kernels.py``,
2e-4 in float32 and 4e-2 in bfloat16 (atol and rtol).  On rows with no
visible key ``flash_jnp``'s backward gives NaN (its ``exp(s - lse) *
valid`` is ``inf * 0`` there) where the Pallas route and the port give 0:
that case is held against the Pallas route only (ROADMAP section 3).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_jnp
from repro.kernels.flash_attention import pallas_flash_attention
from repro_torch.kernels import flash_attention_bwd, ops
from repro_torch.kernels import ref as tref

from test_kernels import FLASH_CASES, TOL

@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny shapes: torch's intra-op threads would only contend with the
    other test workers (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (B, Sq, Skv, Hq, Hkv, D, causal, window, kv_len, q_offset)
EXTRA_CASES = {
    # a 16-query chunk against a longer cache, GQA
    "kv_len_q_offset": (2, 16, 64, 4, 2, 16, True, None, [48, 64],
                        [32, 48]),
    # row 0: queries at -8..7 (the first 8 see no key); row 1: kv_len 0
    "no_visible_key": (2, 16, 32, 4, 4, 16, True, None, [32, 0], [-8, 4]),
}
CASES = {f"flash{i}": c + (None, 0) for i, c in enumerate(FLASH_CASES)}
CASES.update(EXTRA_CASES)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@functools.lru_cache(maxsize=None)
def _arrays(name):
    """q, k, v and the upstream gradient of a case, float32 numpy."""
    b, sq, skv, hq, hkv, d = CASES[name][:6]
    rng = np.random.default_rng(sum(map(ord, name)))
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, sq, hq, d), (b, skv, hkv, d),
                           (b, skv, hkv, d), (b, sq, hq, d)))


def _bounds(name):
    b, _, skv = CASES[name][:3]
    kv_len, q_offset = CASES[name][8:]
    kl = np.full((b,), skv, np.int32) if kv_len is None \
        else np.asarray(kv_len, np.int32)
    qo = np.broadcast_to(np.asarray(q_offset, np.int32), (b,)).copy()
    return kl, qo


@functools.partial(jax.jit, static_argnames=("causal", "window"))
def _vjps(q, k, v, do, kl, qo, *, causal, window):
    """One compiled program per case: the (B, Hq, Sq) log-sum-exp of
    ``_fwd_core`` over every (batch row, KV head), and, in float32 and in
    bfloat16, o and (dq, dk, dv) through the Pallas kernel (interpret mode)
    and through ``flash_jnp``, blocks of 128 (one block a case, which
    compiles fastest; the reference's blockwise walk is
    ``tests/test_kernels.py``'s to hold)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1:3]
    g = hq // hkv
    cfg = flash_jnp.FlashConfig(causal=causal, sm_scale=1.0 / d ** 0.5,
                                block_q=sq, block_kv=skv, window=window)
    core = jax.vmap(jax.vmap(flash_jnp._fwd_core,
                             in_axes=(None, 0, 0, 0, None, None)),
                    in_axes=(None, 0, 0, 0, 0, 0))
    qr = jnp.moveaxis(q.reshape(b, sq, hkv, g, d), 1, 3)
    kr, vr = (jnp.moveaxis(x, 1, 2) for x in (k, v))
    _, lse = core(cfg, qr, kr, vr, kl, qo)
    out = {"lse": lse.reshape(b, hq, sq)}
    kw = dict(causal=causal, window=window, kv_len=kl, q_offset=qo,
              block_q=128, block_kv=128)
    for dtype in DTYPES:
        xs = [x.astype(DTYPES[dtype][0]) for x in (q, k, v, do)]
        for route, f in (("pallas", functools.partial(
                pallas_flash_attention, interpret=True, **kw)),
                ("jnp", functools.partial(flash_jnp.flash_attention, **kw))):
            o, vjp = jax.vjp(f, *xs[:3])
            out[f"{dtype}/{route}"] = (o, vjp(xs[3]))
    return out


@functools.lru_cache(maxsize=None)
def _jax_vjps(name):
    """The reference's lse, and {"dtype/route": (o, (dq, dk, dv))},
    float32 numpy."""
    causal, window = CASES[name][6:8]
    kl, qo = _bounds(name)
    q, k, v, do = (jnp.asarray(a) for a in _arrays(name))
    out = _vjps(q, k, v, do, jnp.asarray(kl), jnp.asarray(qo),
                causal=causal, window=window)
    lse = np.asarray(out.pop("lse"), np.float32)
    return {"lse": lse, **{
        key: (np.asarray(o, np.float32),
              tuple(np.asarray(g, np.float32) for g in grads))
        for key, (o, grads) in out.items()}}


def _port(name, dtype):
    """(o, lse, (dq, dk, dv)) of the port's plain forward and backward."""
    causal, window = CASES[name][6:8]
    kl, qo = _bounds(name)
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in _arrays(name))
    kw = dict(causal=causal, window=window, kv_len=torch.from_numpy(kl),
              q_offset=torch.from_numpy(qo))
    # 16-wide blocks: several key and query blocks a case
    o, lse = tref.flash_fwd_reference(q, k, v, block_kv=16, **kw)
    grads = tref.flash_bwd_reference(q, k, v, o, lse, do, block_q=16,
                                     block_kv=16, **kw)
    return o, lse, grads


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_matches_jax_grad(name, dtype):
    """The port's o and (dq, dk, dv) against ``jax.vjp`` through the
    Pallas kernel in interpret mode and through ``flash_jnp`` (whose
    backward is NaN on rows that see no key: held against Pallas only)."""
    jdt, tdt = DTYPES[dtype]
    tol = TOL[jdt]
    o, _, grads = _port(name, tdt)
    ref = _jax_vjps(name)
    routes = ("pallas",) if name == "no_visible_key" else ("pallas", "jnp")
    for route in routes:
        jo, jgrads = ref[f"{dtype}/{route}"]
        _close(o, jo, tol)
        for g, jg in zip(grads, jgrads):
            _close(g, jg, tol)
    if name == "no_visible_key":
        _, (jdq, _, _) = ref[f"{dtype}/jnp"]
        assert np.isnan(jdq).any()  # the reference's divergence
        assert all(bool(g.isfinite().all()) for g in grads)
        assert bool(grads[0][0, :8].eq(0).all())
        assert bool(grads[0][1].eq(0).all())


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_forward_lse_matches_fwd_core(name):
    """f32: the blockwise forward's lse equals ``_fwd_core``'s (NEG_INF on
    a row that sees no key)."""
    _, lse, _ = _port(name, torch.float32)
    np.testing.assert_allclose(lse.numpy(), _jax_vjps(name)["lse"],
                               rtol=1e-5, atol=2e-5)


def test_flash_function_gradcheck():
    """The differentiable path of ``ops.multi_head_attention`` (the
    ``FlashAttention`` function on the CPU's plain versions) in float64:
    GQA, a window, kv_len and q_offset, and a row that sees no key."""
    gen = torch.Generator().manual_seed(0)

    def leaf(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64,
                           requires_grad=True)

    q, k, v = leaf(2, 5, 4, 4), leaf(2, 7, 2, 4), leaf(2, 7, 2, 4)
    kl = torch.tensor([7, 3])
    qo = torch.tensor([2, -3])  # row 1's first query sees no key

    def f(q, k, v):
        return ops.multi_head_attention(q, k, v, causal=True, window=4,
                                        kv_len=kl, q_offset=qo)
    assert torch.autograd.gradcheck(f, (q, k, v))
    assert bool(f(q, k, v)[1, 0].eq(0).all())


def test_grad_mode_routes_through_the_flash_function():
    """Without a gradient the call is the serving path's (the plain
    version's output, bit for bit); with one it is the FlashAttention
    function, whose output agrees within float32 rounding."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 9, 4, 16), (2, 9, 2, 16), (2, 9, 2, 16)))
    with torch.no_grad():
        plain = ops.multi_head_attention(q, k, v)
    assert torch.equal(plain, tref.mha_reference(q, k, v))
    qg = q.clone().requires_grad_()
    out = ops.multi_head_attention(qg, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    torch.testing.assert_close(out.detach(), plain, atol=1e-6, rtol=1e-6)


def test_backward_wrapper_refuses_cpu_tensors():
    """No silent fallback: the CUDA backward raises on CPU tensors and
    counts no launch; ``ops`` takes the plain backward for them."""
    q = torch.zeros((1, 4, 2, 16))
    kv = torch.zeros((1, 4, 2, 16))
    lse = torch.zeros((1, 2, 4))
    before = flash_attention_bwd.launches
    with pytest.raises(ValueError, match="must lie on the card"):
        flash_attention_bwd.flash_attention_bwd_cuda(q, kv, kv, q, lse, q)
    assert flash_attention_bwd.launches == before
    qg = q.clone().requires_grad_()
    ops.multi_head_attention(qg, kv, kv).sum().backward()
    assert qg.grad.shape == q.shape
    assert flash_attention_bwd.launches == before
