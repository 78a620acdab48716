"""Port parity of training the attention and MoE stacks on the CPU:
``Model.loss`` and its gradients, the expert GEMM's backward and the
``Trainer`` on a shared-expert MoE, against the JAX package.

* ``Model.loss`` and the gradient of every leaf against
  ``jax.jit(jax.value_and_grad(model.loss))`` on nine reduced archs (every
  registry arch but rwkv6-3b and jamba-v0.1-52b, which
  ``tests/test_torch_train_ssm.py`` holds), float32, with converted
  weights and the inputs of ``tests/test_models_smoke.py``'s train step:
  loss within 1e-5 relative, each gradient within 1e-4 of its leaf's
  scale (max(1, max |g|)).  A leaf the loss does not reach (pixtral-12b's
  token embedding, fed ``embeds=``; deepseek-moe-16b's shared experts'
  ``norm``) has no port gradient and a zero JAX one.
* ``ref.expert_gemm_bwd_reference`` against ``jax.vjp`` of the
  reference's ``moe_gemm_reference``, for a per-expert x and for one
  (C, D) matrix broadcast over the experts, within 1e-5 of the scale
  (the same f32 products summed in another order); ``ops.expert_gemm``'s
  autograd function on the CPU against it, exactly.
* The card's backward, ``expert_gemm_bwd_cuda``, with its one launch
  replaced by the plain product: its transposes, padding of the token
  dimension to a multiple of 8 and the broadcast gradient's (C, E F) @
  (E F, D) product against the plain backward within 1e-5 of the scale.
* The repaired unused parameter: the ``Trainer`` on reduced
  deepseek-moe-16b gives the shared experts' ``norm`` a zero gradient
  (``jax.value_and_grad`` does), where it raised.
* The port's ``Trainer`` against the JAX ``Trainer`` on reduced
  deepseek-moe-16b from the same converted initial weights over 5 steps:
  losses within 1e-4, final weights within 1e-4 (AdamW's decay of the
  untouched ``norm`` included), with AdamW's eps at 1e-6 (see ``OPT``).

Each JAX program is built once per module (``lru_cache``).
"""

import functools
import tempfile
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.kernels import ref as jref
from repro.models import build_model as jax_build_model
from repro.training.optimizer import AdamWConfig as JaxAdamWConfig
from repro.training.train_loop import TrainConfig as JaxTrainConfig
from repro.training.train_loop import Trainer as JaxTrainer
from repro_torch.configs import registry as treg
from repro_torch.data.pipeline import DataConfig
from repro_torch.kernels import expert_gemm as tgemm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import build_model, from_jax_params
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import TrainConfig, Trainer

ARCHS = [a for a in jreg.ARCH_IDS if a not in ("rwkv6-3b", "jamba-v0.1-52b")]
MOE = "deepseek-moe-16b"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small shapes: torch's intra-op threads would only contend with the
    other test workers (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _smoke_inputs(jspec, b=2, s=16):
    """(tokens, embeds, targets) of ``test_models_smoke.py``'s train
    step, as numpy."""
    if jspec.frontend != "none":
        tokens, embeds = None, np.asarray(jax.random.normal(
            jax.random.key(2), (b, s, jspec.d_model), jnp.float32))
    else:
        tokens, embeds = np.asarray(jax.random.randint(
            jax.random.key(2), (b, s), 0, jspec.vocab)), None
    targets = np.asarray(jax.random.randint(jax.random.key(3), (b, s), 0,
                                            jspec.vocab))
    return tokens, embeds, targets


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(arch):
    """The reference's initial weights, loss and gradients on the smoke
    inputs (one compile per arch)."""
    jspec = jreg.get_reduced(arch)
    jmodel = jax_build_model(jspec, mesh=None, param_dtype=jnp.float32,
                             compute_dtype=jnp.float32)
    params = jmodel.init(jax.random.key(1))
    tokens, embeds, targets = _smoke_inputs(jspec)

    def loss_fn(p):
        return jmodel.loss(p, None if tokens is None else jnp.asarray(tokens),
                           jnp.asarray(targets),
                           embeds=None if embeds is None
                           else jnp.asarray(embeds), chunk=8)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return (_np_tree(params), float(loss), _np_tree(grads),
            (tokens, embeds, targets))


def check_loss_and_grads(arch):
    params, want_loss, jgrads, (tokens, embeds, targets) = \
        _jax_value_and_grad(arch)
    tspec = treg.get_reduced(arch)
    model = build_model(tspec, device="cpu", dtype=torch.float32)
    model.load_state_dict(from_jax_params(params, tspec))
    model.requires_grad_(True)
    loss = model.loss(_t(tokens), _t(targets), embeds=_t(embeds), chunk=8)
    names, leaves = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    want = from_jax_params(jgrads, tspec)
    assert set(names) == set(want)
    assert abs(float(loss.detach()) - want_loss) <= 1e-5 * abs(want_loss)
    unused = []
    for name, leaf, g in zip(names, leaves, grads):
        w = want[name].numpy()
        if g is None:
            unused.append(name)
            g = torch.zeros_like(leaf)
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * scale, rtol=0,
                                   err_msg=name)
    return unused


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax_value_and_grad(arch):
    unused = check_loss_and_grads(arch)
    if arch == "pixtral-12b":
        assert unused == ["embed"]
    elif arch == MOE:
        assert unused and all(n.endswith("shared.norm") for n in unused)
    else:
        assert unused == []


# ---------------------------------------------------------------------------
# the expert GEMM's backward
# ---------------------------------------------------------------------------

def close(got, want):
    """Within 1e-5 of the scale max(1, max |want|): f32 sums of up to 72
    products of O(1) values, taken in another order."""
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * scale, rtol=0)


def _gemm_case(broadcast, e=3, c=13, d=16, f=24, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((c, d) if broadcast else (e, c, d))
    w = rng.standard_normal((e, d, f))
    dy = rng.standard_normal((e, c, f))
    return (a.astype(np.float32) for a in (x, w, dy))


@pytest.mark.parametrize("broadcast", [False, True],
                         ids=["per_expert", "broadcast"])
def test_expert_gemm_bwd_reference_matches_jax_vjp(broadcast):
    x, w, dy = _gemm_case(broadcast)
    e = w.shape[0]

    def f(x_, w_):
        xe = jnp.broadcast_to(x_, (e,) + x_.shape) if broadcast else x_
        return jref.moe_gemm_reference(xe, w_)
    _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = (np.asarray(a) for a in vjp(jnp.asarray(dy)))
    dx, dw = tref.expert_gemm_bwd_reference(_t(x), _t(w), _t(dy))
    assert dx.shape == x.shape and dw.shape == w.shape
    close(dx, jdx)
    close(dw, jdw)

    # the autograd function that ops.expert_gemm runs under grad
    xt, wt = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    y = tops.expert_gemm(xt, wt)
    close(y.detach(), np.asarray(f(x, w)))
    gx, gw = torch.autograd.grad(y, (xt, wt), _t(dy))
    assert torch.equal(gx, dx) and torch.equal(gw, dw)


@pytest.mark.parametrize("broadcast", [False, True],
                         ids=["per_expert", "broadcast"])
@pytest.mark.parametrize("c", [13, 16])
def test_expert_gemm_bwd_cuda_operands(monkeypatch, broadcast, c):
    """The card's backward with each launch swapped for the plain product
    on the operands it builds (the checks the launch makes included):
    dW = X^T dY with C zero-padded to a multiple of 8, dX = dY W^T and the
    broadcast dX as one (C, E F) @ (E F, D) product."""
    x, w, dy = _gemm_case(broadcast, c=c, seed=1)
    seen = []

    def launch(xa, wa):
        assert xa.stride(2) == 1 and xa.stride(0) in (0, xa.shape[1]
                                                      * xa.shape[2])
        assert wa.is_contiguous() and xa.shape[2] % 8 == 0
        seen.append((tuple(xa.shape), tuple(wa.shape)))
        return tref.moe_gemm_reference(xa, wa), SimpleNamespace(
            route="cuda_core")

    monkeypatch.setattr(tgemm, "_launch", launch)
    monkeypatch.setattr(tgemm, "bwd_routes", {"cuda_core": 0})
    n0 = tgemm.bwd_launches
    dx, dw = tgemm.expert_gemm_bwd_cuda(_t(x), _t(w), _t(dy))
    want_dx, want_dw = tref.expert_gemm_bwd_reference(_t(x), _t(w), _t(dy))
    close(dx, want_dx.numpy())
    close(dw, want_dw.numpy())
    e, _, f = dy.shape
    d = w.shape[1]
    cp = -(-c // 8) * 8
    assert seen[0] == ((e, d, cp), (e, cp, f))  # dW
    assert seen[1] == (((1, c, e * f), (1, e * f, d)) if broadcast
                       else ((e, c, f), (e, f, d)))  # dX
    assert tgemm.bwd_launches - n0 == 2


# ---------------------------------------------------------------------------
# the trainer on a shared-expert MoE
# ---------------------------------------------------------------------------

STEPS = 5
DATA = dict(seq_len=16, global_batch=2, seed=0)
#: AdamW's eps at 1e-6, not its default 1e-8: a leaf whose gradient is
#: near eps moves by ``lr * g / (|g| + eps)``, which turns the two
#: frameworks' f32 rounding of such a gradient (~1e-8) into a weight
#: difference of a fraction of lr (8.5e-4 of one expert's w_up after 2
#: steps at eps 1e-8; 5.2e-5 at most over 5 steps at 1e-6)
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=20, eps=1e-6)


@functools.lru_cache(maxsize=None)
def _jax_trainer_run(arch):
    """The JAX trainer's initial weights, losses and final weights over
    STEPS steps (built and run once per module)."""
    jspec = jreg.get_reduced(arch)
    jmodel = jax_build_model(jspec, mesh=None, param_dtype=jnp.float32,
                             compute_dtype=jnp.float32)
    init = _np_tree(jmodel.init(jax.random.key(0)))
    with tempfile.TemporaryDirectory() as d:
        tr = JaxTrainer(jmodel, JaxDataConfig(vocab=jspec.vocab, **DATA),
                        JaxTrainConfig(checkpoint_every=100,
                                       checkpoint_dir=d,
                                       optimizer=JaxAdamWConfig(**OPT)),
                        rng=jax.random.key(0))
        tr.run(0, STEPS)
        return init, [h["loss"] for h in tr.history], _np_tree(tr.params)


def port_trainer(arch, d, init):
    tspec = treg.get_reduced(arch)
    model = build_model(tspec, device="cpu", dtype=torch.float32)
    model.load_state_dict(from_jax_params(init, tspec))
    return Trainer(model, DataConfig(vocab=tspec.vocab, **DATA),
                   TrainConfig(checkpoint_every=100, checkpoint_dir=str(d),
                               optimizer=AdamWConfig(**OPT)))


def check_trainer(arch, d):
    init, losses, final = _jax_trainer_run(arch)
    tr = port_trainer(arch, d, init)
    tr.run(0, STEPS)
    np.testing.assert_allclose([h["loss"] for h in tr.history], losses,
                               atol=1e-4, rtol=0)
    want = from_jax_params(final, treg.get_reduced(arch))
    for name, t in tr.model.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), atol=1e-4,
                                   rtol=0, err_msg=name)


def test_trainer_gives_an_unused_parameter_a_zero_gradient(tmp_path):
    """deepseek-moe-16b's shared MLP runs on the block's normed input, so
    its own ``norm`` never reaches the loss: the trainer raised in
    ``torch.autograd.grad``; it now gets zeros, and the step decays it."""
    tr = port_trainer(MOE, tmp_path, _jax_trainer_run(MOE)[0])
    x = torch.from_numpy(tr.data.batch_at(0)["x"])
    t = torch.from_numpy(tr.data.batch_at(0)["targets"])
    loss, grads = tr._grads(x, t)
    named = dict(zip(tr.params, grads))
    unused = [n for n in named if n.endswith("shared.norm")]
    assert unused and torch.isfinite(loss)
    for n in unused:
        assert torch.equal(named[n], torch.zeros_like(tr.params[n]))
    before = {n: tr.params[n].detach().clone() for n in unused}
    tr.run(0, 1)
    for n in unused:
        after = tr.params[n].detach()
        assert torch.all(after.abs() < before[n].abs()), n  # decayed


def test_trainer_matches_the_jax_trainer_on_shared_experts(tmp_path):
    check_trainer(MOE, tmp_path)


def test_adamw_updates_a_large_leaf_in_blocks_bit_for_bit(monkeypatch):
    """A leaf past ``UPDATE_BLOCK`` elements is updated in blocks of rows
    (its f32 temporaries stay small): the same numbers as one pass."""
    from repro_torch.training import optimizer as topt
    rng = np.random.default_rng(0)
    shapes = {"layers.0.ffn.w_up": (5, 8, 6), "norm": (12,), "s": ()}
    runs = []
    for block in (topt.UPDATE_BLOCK, 40):
        monkeypatch.setattr(topt, "UPDATE_BLOCK", block)
        params = {n: torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)) for n, s in shapes.items()}
        opt = topt.adamw(topt.AdamWConfig(lr=1e-2, warmup_steps=0))
        state = opt.init(params)
        for _ in range(3):
            grads = {n: torch.from_numpy(rng.standard_normal(s).astype(
                np.float32)) for n, s in shapes.items()}
            opt.update(grads, state, params)
        runs.append((params, state))
        rng = np.random.default_rng(0)
    assert len(topt._row_blocks(runs[1][0]["layers.0.ffn.w_up"])) == 5
    for name in shapes:
        assert torch.equal(runs[0][0][name], runs[1][0][name]), name
        for key in ("m", "v"):
            assert torch.equal(runs[0][1][key][name], runs[1][1][key][name])
