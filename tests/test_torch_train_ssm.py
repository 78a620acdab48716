"""Port parity of training the RWKV-6 and Mamba stacks on the CPU: the
repaired full pass and Mamba scan, the WKV scan's backward, ``Model.loss``
and its gradients, and the ``Trainer``, against the JAX package.

* ``Model.loss`` and the gradient of every leaf of reduced rwkv6-3b and
  jamba-v0.1-52b against ``jax.jit(jax.value_and_grad(model.loss))``, as
  ``tests/test_torch_train_moe.py`` holds the other nine archs (same
  inputs, same tolerances).
* ``ops.rwkv6_scan``'s autograd function on the CPU (the plain forward
  with its chunk-boundary states, ``ref.rwkv6_bwd_reference``) against
  ``jax.vjp`` of the reference's chunked scan (``kernels/ops.py``
  ``rwkv6_scan``, chunks of 16 under ``jax.checkpoint``), 48 steps from
  a non-zero state, with and without a gradient of the final state:
  within 1e-5 of each gradient's scale (the same f32 recurrence, sums in
  another order).  48 is a multiple of the chunk: the reference pads a
  partial last chunk with zero decays, which zeroes its final state
  (ROADMAP section 3); the port's own partial chunks (32 + 16 steps) are
  exercised.
* The repaired full pass: an RWKV-6 block with no cache differentiates
  (the scan used to write its final state over the initial state that
  autograd saved) and keeps nothing, while a serving cache is still
  written in place.
* The repaired Mamba scan: ``ref.mamba_scan_reference`` differentiates
  (it stepped in place over saved views), with the same numbers as under
  ``torch.no_grad()`` bit for bit; ``ops.mamba_scan`` over 20 steps in
  chunks of 8 runs each chunk under ``torch.utils.checkpoint`` and gives
  ``jax.vjp``'s gradients of the reference's chunked scan within 1e-5 of
  their scale.
* The port's ``Trainer`` against the JAX ``Trainer`` on reduced rwkv6-3b
  and jamba-v0.1-52b over 5 steps (``tests/test_torch_train_moe.py``'s
  configuration): losses and final weights within 1e-4.

Each JAX program is built once per module (``lru_cache``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.configs import registry as treg
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import build_model
from repro_torch.models.ssm import init_rwkv_cache, rwkv6_block
from test_torch_train_moe import check_loss_and_grads, check_trainer, close

SSM_ARCHS = ["rwkv6-3b", "jamba-v0.1-52b"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small shapes: torch's intra-op threads would only contend with the
    other test workers (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_loss_and_grads_match_jax_value_and_grad(arch):
    assert check_loss_and_grads(arch) == []


# ---------------------------------------------------------------------------
# the WKV scan's backward
# ---------------------------------------------------------------------------

def _wkv_case(b=2, t=48, h=2, n=8, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, t, h, n)) for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((b, t, h, n))))
    u = rng.standard_normal((h, n))
    state = rng.standard_normal((b, h, n, n))
    dout = rng.standard_normal((b, t, h, n))
    dstate = rng.standard_normal((b, h, n, n))
    return [a.astype(np.float32)
            for a in (r, k, v, w, u, state, dout, dstate)]


@pytest.mark.parametrize("with_state_grad", [True, False],
                         ids=["out_and_state", "out_only"])
def test_rwkv6_scan_backward_matches_jax_vjp(with_state_grad):
    *inputs, dout, dstate = _wkv_case()
    if not with_state_grad:
        dstate = np.zeros_like(dstate)

    def f(*a):
        return jops.rwkv6_scan(*a, chunk=16)
    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in inputs))
    want = vjp((jnp.asarray(dout), jnp.asarray(dstate)))

    leaves = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    out, final = tops.rwkv6_scan(*leaves)
    if with_state_grad:
        got = torch.autograd.grad((out, final), leaves,
                                  (torch.from_numpy(dout),
                                   torch.from_numpy(dstate)))
    else:  # the final state unused, as in a full pass
        got = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    for name, g, wnt in zip("rkvwus", got, want):
        assert g.shape == wnt.shape, name
        close(g, np.asarray(wnt))


def test_rwkv6_bwd_reference_in_bfloat16():
    """bf16 r, k, v and dout: the gradients come back in bf16 (w, u and
    the state's in f32), one bf16 rounding of the f32 walk on the same
    widened values."""
    r, k, v, w, u, state, dout, dstate = (torch.from_numpy(a)
                                          for a in _wkv_case(seed=1))
    rb, kb, vb, db = (a.bfloat16() for a in (r, k, v, dout))
    _, _, bounds = tref.rwkv6_fwd_reference(rb, kb, vb, w, u, state,
                                            chunk=32)
    got = tref.rwkv6_bwd_reference(rb, kb, vb, w, u, bounds, db, dstate,
                                   chunk=32)
    _, _, bounds32 = tref.rwkv6_fwd_reference(
        *(a.float() for a in (rb, kb, vb)), w, u, state, chunk=32)
    want = tref.rwkv6_bwd_reference(*(a.float() for a in (rb, kb, vb)), w,
                                    u, bounds32, db.float(), dstate,
                                    chunk=32)
    assert [g.dtype for g in got] == [torch.bfloat16] * 3 \
        + [torch.float32] * 3
    for g, wnt in zip(got[:3], want[:3]):
        assert torch.equal(g, wnt.bfloat16())
    for g, wnt in zip(got[3:], want[3:]):
        assert torch.equal(g, wnt)


# ---------------------------------------------------------------------------
# the repairs
# ---------------------------------------------------------------------------

def test_rwkv_full_pass_differentiates_and_keeps_no_state():
    """The full pass (``Model.forward``, ``Model.loss``) gives an RWKV-6
    layer no cache: the block starts from a zero state of its own and
    writes none back, so autograd's saved initial state is intact (the
    scan used to write its final state over it); a serving cache is still
    written in place, with the same output."""
    spec = treg.get_reduced("rwkv6-3b")
    model = build_model(spec, device="cpu", dtype=torch.float32)
    model.requires_grad_(True)
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, spec.vocab, (2, 12)))
    leaves = list(model.parameters())
    grads = torch.autograd.grad(model.forward(tokens).square().mean(),
                                leaves)
    assert all(torch.isfinite(g).all() for g in grads)
    params = model.layers[0].mixer
    x = torch.randn(2, 12, spec.d_model,
                    generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        cache = init_rwkv_cache(spec, 2, "cpu", torch.float32)
        wkv = cache.wkv
        want = rwkv6_block(spec, params, x, cache)
        assert torch.equal(rwkv6_block(spec, params, x, None), want)
    assert cache.wkv is wkv and wkv.abs().sum() > 0  # written in place


def _mamba_case(b=2, t=20, di=6, n=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, di))
    dt = np.log1p(np.exp(rng.standard_normal((b, t, di))))
    a = -np.exp(rng.standard_normal((di, n)))
    bm, cm = (rng.standard_normal((b, t, n)) for _ in range(2))
    d = rng.standard_normal((di,))
    state = rng.standard_normal((b, di, n))
    dy = rng.standard_normal((b, t, di))
    dstate = rng.standard_normal((b, di, n))
    return [z.astype(np.float32)
            for z in (x, dt, a, bm, cm, d, state, dy, dstate)]


def test_mamba_scan_differentiates_with_its_no_grad_numbers():
    *inputs, dy, dstate = _mamba_case(t=9)
    with torch.no_grad():
        want = tref.mamba_scan_reference(*map(torch.from_numpy, inputs))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    got = tref.mamba_scan_reference(*leaves)
    for g, wnt in zip(got, want):
        assert torch.equal(g.detach(), wnt)
    grads = torch.autograd.grad(got, leaves, (torch.from_numpy(dy),
                                              torch.from_numpy(dstate)))

    def f(*a):
        return jref.mamba_scan_reference(*a)
    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in inputs))
    for g, wnt in zip(grads, vjp((jnp.asarray(dy), jnp.asarray(dstate)))):
        close(g, np.asarray(wnt))


def test_mamba_scan_checkpoints_each_chunk(monkeypatch):
    *inputs, dy, dstate = _mamba_case()
    calls = []

    def counted(fn, *a, **kw):
        calls.append(a[0].shape[1])
        return torch.utils.checkpoint.checkpoint(fn, *a, **kw)
    monkeypatch.setattr(tops, "checkpoint", counted)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    got = tops.mamba_scan(*leaves, chunk=8)
    assert calls == [8, 8, 4]
    grads = torch.autograd.grad(got, leaves, (torch.from_numpy(dy),
                                              torch.from_numpy(dstate)))

    def f(*a):
        return jops.mamba_scan(*a, chunk=8)
    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in inputs))
    for g, wnt in zip(grads, vjp((jnp.asarray(dy), jnp.asarray(dstate)))):
        close(g, np.asarray(wnt))
    with torch.no_grad():  # no checkpoint without a gradient
        tops.mamba_scan(*map(torch.from_numpy, inputs), chunk=8)
    assert len(calls) == 3


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_trainer_matches_the_jax_trainer(arch, tmp_path):
    check_trainer(arch, tmp_path)
