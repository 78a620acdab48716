"""Port parity of training: ``repro_torch.training`` and ``Model.loss``
against the JAX package on the CPU.

* ``adamw``: updates equal to the JAX ``adamw``'s over 10 steps within
  1e-6, with clipping active, warmup then cosine, decay only on matrices.
* ``TokenPipeline.batch_at``: equal to the reference's (exact), sharded
  too.
* ``quantize_int8`` / ``compress_roundtrip`` / ``ErrorFeedback``: equal to
  the reference's.
* ``CheckpointManager``: the cases of ``tests/test_training.py``
  (roundtrip, GC and fallback on corruption, async, atomicity), and a
  bf16 tensor restored bit for bit.
* The fault utilities: the straggler monitor and the restart budget; the
  pipeline schedule's bubble fraction.
* ``Model.loss`` and the gradient of every leaf (attention's through the
  plain flash backward) against ``jax.value_and_grad`` of the JAX
  ``Model.loss``, on reduced qwen1.5-0.5b and a tiny GQA spec with
  converted weights, float32: loss within 1e-5 relative, each gradient
  within 1e-4 of its leaf's scale (max(1, max |g|)).
* The port's ``Trainer`` against the JAX ``Trainer`` from the same
  converted initial weights over 10 steps: losses within 1e-4, final
  weights within 1e-4.
* Crash and restart equal to the uninterrupted run, bit for bit on the
  CPU (the reference's bound is 1e-5); ``micro_batches=4`` against one
  batch within 2e-4 (the reference's); the loss falling by 0.2 over 30
  steps.

Inputs are made with numpy from seeds and handed to both frameworks.
One uninterrupted port run of 30 steps serves the trainer, restart and
loss tests (``lru_cache``).
The JAX trainer is built and run once per file (``lru_cache``); its
final AdamW state is held too (``from_jax_opt_state``).
"""

import functools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import modelspec as jms
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import TokenPipeline as JaxTokenPipeline
from repro.models import build_model as jax_build_model
from repro.training import compression as jcomp
from repro.training.optimizer import AdamWConfig as JaxAdamWConfig
from repro.training.optimizer import adamw as jax_adamw
from repro.training.train_loop import TrainConfig as JaxTrainConfig
from repro.training.train_loop import Trainer as JaxTrainer
from repro_torch.configs import registry as treg
from repro_torch.core import modelspec as tms
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models import (build_model, from_jax_opt_state,
                                from_jax_params)
from repro_torch.training import compression as tcomp
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.fault import (FailureInjector, SimulatedFailure,
                                        StragglerMonitor, run_with_restarts)
from repro_torch.training.optimizer import AdamWConfig, adamw, global_norm
from repro_torch.training.train_loop import TrainConfig, Trainer

TINY = dict(name="tiny", d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_head=16, d_ff=128, vocab=64)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny shapes: torch's intra-op threads would only contend with the
    other test workers (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def spec_pair(arch: str):
    """(JAX spec, port spec) of the same architecture."""
    if arch == "tiny":
        return (jms.ModelSpec(**TINY, attn=jms.AttnSpec()),
                tms.ModelSpec(**TINY, attn=tms.AttnSpec()))
    return jreg.get_reduced(arch), treg.get_reduced(arch)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def port_model(tspec, params_np):
    """A float32 CPU port model holding the converted JAX weights."""
    model = build_model(tspec, device="cpu", dtype=torch.float32)
    model.load_state_dict(from_jax_params(params_np, tspec))
    return model


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_adamw_matches_the_reference_over_ten_steps():
    cfg = dict(lr=1e-2, warmup_steps=3, total_steps=10, min_lr_frac=0.1,
               weight_decay=0.1, grad_clip=1.0)
    rng = np.random.default_rng(0)
    shapes = {"w": (4, 8), "b": (8,), "e": (2, 3, 4)}
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()}
    jopt, topt = jax_adamw(JaxAdamWConfig(**cfg)), adamw(AdamWConfig(**cfg))
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    tp = {n: torch.from_numpy(a.copy()) for n, a in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    jupdate = jax.jit(jopt.update)
    clipped = 0
    for _ in range(10):
        grads = {n: (3.0 * rng.standard_normal(s)).astype(np.float32)
                 for n, s in shapes.items()}
        clipped += float(global_norm({n: torch.from_numpy(g)
                                      for n, g in grads.items()})) > 1.0
        jp, js = jupdate({n: jnp.asarray(g) for n, g in grads.items()}, js,
                         jp)
        topt.update({n: torch.from_numpy(g) for n, g in grads.items()}, ts,
                    tp)
        for n in shapes:
            for want, got in ((jp[n], tp[n]), (js["m"][n], ts["m"][n]),
                              (js["v"][n], ts["v"][n])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           atol=1e-6, rtol=0)
    assert clipped == 10 and ts["step"] == int(js["step"]) == 10


# ---------------------------------------------------------------------------
# data pipeline, compression, checkpoints, fault tolerance
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shard", [(0, 1), (1, 2)])
def test_pipeline_batches_equal_the_reference(shard):
    kw = dict(vocab=128, seq_len=16, global_batch=4, seed=3,
              shard_id=shard[0], num_shards=shard[1])
    ours, theirs = TokenPipeline(DataConfig(**kw)), \
        JaxTokenPipeline(JaxDataConfig(**kw))
    for step in (0, 1, 7, 1000):
        a, b = ours.batch_at(step), theirs.batch_at(step)
        for key in ("x", "targets"):
            np.testing.assert_array_equal(a[key], b[key])
    assert next(ours)["x"].shape == (4 // shard[1], 16)


def test_compression_equals_the_reference():
    x = (np.random.default_rng(1).standard_normal(1000) * 0.01) \
        .astype(np.float32)
    q, s = tcomp.quantize_int8(torch.from_numpy(x), 64)
    jq, js = jcomp.quantize_int8(jnp.asarray(x), 64)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_allclose(
        tcomp.compress_roundtrip(torch.from_numpy(x), 64).numpy(),
        np.asarray(jcomp.compress_roundtrip(jnp.asarray(x), 64)), atol=0)
    ours = tcomp.ErrorFeedback(tcomp.CompressionConfig(chunk=64))
    theirs = jcomp.ErrorFeedback(jcomp.CompressionConfig(chunk=64))
    for i in range(5):
        g = np.full((256,), 0.003 * (i + 1), np.float32)
        a = ours({"w": torch.from_numpy(g)})["w"]
        b = theirs({"w": jnp.asarray(g)})["w"]
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7)
    np.testing.assert_allclose(ours.residual["w"].numpy(),
                               np.asarray(theirs.residual["w"]), atol=1e-7)


def test_pipeline_schedule_equals_the_reference():
    from repro.training import pipeline as jpipe
    from repro_torch.training import pipeline as tpipe
    assert tpipe.PipelineConfig() == tpipe.PipelineConfig(n_micro=4,
                                                          axis="pod")
    for stages, micro in ((1, 1), (2, 4), (4, 8), (8, 3)):
        assert tpipe.bubble_fraction(stages, micro) \
            == jpipe.bubble_fraction(stages, micro)


def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.int32),
                  "h": torch.randn(3, 5, generator=torch.Generator()
                                   .manual_seed(0)).to(torch.bfloat16)}}


def test_checkpoint_roundtrip_bf16_bit_for_bit(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    tree = _tree()
    mgr.save(10, tree, extra={"note": "x"})
    target = {"a": torch.zeros(2, 3), "b": {"c": torch.zeros(4, dtype=torch
                                                         .int32),
                                            "h": torch.zeros(
                                                3, 5, dtype=torch.bfloat16)}}
    got, extra, step = mgr.restore(target)
    assert step == 10 and extra["note"] == "x"
    assert torch.equal(got["a"], tree["a"])
    assert torch.equal(got["b"]["c"], tree["b"]["c"])
    assert got["b"]["h"].dtype == torch.bfloat16
    assert torch.equal(got["b"]["h"].view(torch.int16),
                       tree["b"]["h"].view(torch.int16))


def test_checkpoint_gc_and_fallback_on_corruption(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3):
        mgr.save(s, {"a": torch.full((3,), float(s))})
    assert mgr.available_steps() == [2, 3]
    (mgr._step_dir(3) / "arrays.npz").write_bytes(b"garbage")
    got, _, step = mgr.restore({"a": torch.zeros(3)})
    assert step == 2 and float(got["a"][0]) == 2.0


def test_checkpoint_async_snapshots_before_the_write(tmp_path):
    mgr = CheckpointManager(tmp_path)
    t = torch.ones(8)
    mgr.save_async(5, {"a": t})
    t.add_(1.0)  # the loop updates in place right after the snapshot
    mgr.wait()
    assert mgr.latest_step() == 5
    got, _, _ = mgr.restore({"a": torch.zeros(8)})
    assert torch.equal(got["a"], torch.ones(8))


def test_checkpoint_atomicity_no_partial_dirs(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"a": torch.ones(2)})
    for p in mgr.dir.glob("step_*"):
        assert (p / "COMMITTED").exists()
    assert not list(mgr.dir.glob(".tmp_step_*"))


def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor(threshold=3.0)
    for i in range(20):
        mon.observe(i, 0.10 + 0.001 * (i % 3))
    assert mon.observe(20, 0.5)  # 5x step time -> straggler
    assert not mon.observe(21, 0.10)
    assert len(mon.flagged) == 1


def test_failure_injector_fires_once_and_restart_budget(tmp_path):
    inj = FailureInjector(fail_at_steps=(2,))
    with pytest.raises(SimulatedFailure):
        inj.check(2)
    inj.check(2)  # fired already
    _, tspec = spec_pair("tiny")

    def make(attempt):
        injector = FailureInjector(fail_at_steps=(2,))  # fails every time
        return _port_trainer(tmp_path / "loop", tspec, injector=injector)

    with pytest.raises(RuntimeError, match="restart budget"):
        run_with_restarts(make, total_steps=10, max_restarts=2)


# ---------------------------------------------------------------------------
# Model.loss and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "tiny"])
def test_loss_and_grads_match_jax_value_and_grad(arch):
    """A masked loss over 24 positions in chunks of 16 (the reference pads
    the last chunk)."""
    jspec, tspec = spec_pair(arch)
    jmodel = jax_build_model(jspec, mesh=None, param_dtype=jnp.float32,
                             compute_dtype=jnp.float32)
    params = jmodel.init(jax.random.key(1))
    rng = np.random.default_rng(2)
    x = rng.integers(0, jspec.vocab, (2, 24)).astype(np.int32)
    t = rng.integers(0, jspec.vocab, (2, 24)).astype(np.int32)
    mask = (rng.random((2, 24)) < 0.8).astype(np.float32)

    def jloss(p):
        return jmodel.loss(p, tokens=jnp.asarray(x), targets=jnp.asarray(t),
                           mask=jnp.asarray(mask), chunk=16)
    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    want = from_jax_params(_np_tree(jg), tspec)

    model = port_model(tspec, _np_tree(params))
    model.requires_grad_(True)
    loss = model.loss(torch.from_numpy(x), torch.from_numpy(t),
                      mask=torch.from_numpy(mask), chunk=16)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in
                                       model.named_parameters()])
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    assert set(names) == set(want)
    for name, g in zip(names, grads):
        w = want[name].numpy()
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * scale, rtol=0,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

STEPS = 10
DATA = dict(seq_len=32, global_batch=8, seed=0)
OPT = dict(lr=3e-3, warmup_steps=5, total_steps=60)


@functools.lru_cache(maxsize=None)
def _jax_run():
    """The JAX trainer's initial weights, losses, final weights and
    final AdamW state over STEPS steps on the tiny spec (built and run
    once per file)."""
    jspec, _ = spec_pair("tiny")
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
        return (init, [h["loss"] for h in tr.history], _np_tree(tr.params),
                _np_tree(tr.opt_state))


def _port_trainer(d, tspec, *, injector=None, micro_batches=1, lr=None,
                  warmup=None):
    """A tiny-spec port trainer from the JAX trainer's initial weights."""
    opt = dict(OPT)
    if lr is not None:
        opt.update(lr=lr, warmup_steps=warmup)
    return Trainer(port_model(tspec, _jax_run()[0]),
                   DataConfig(vocab=tspec.vocab, **DATA),
                   TrainConfig(checkpoint_every=5, checkpoint_dir=str(d),
                               micro_batches=micro_batches,
                               optimizer=AdamWConfig(**opt)),
                   failure_injector=injector)


@functools.lru_cache(maxsize=None)
def _port_run():
    """The uninterrupted port trainer over 30 steps from the JAX trainer's
    initial weights (built and run once per file): its loss history, and
    its weights and AdamW state after STEPS and after 20 steps."""
    _, tspec = spec_pair("tiny")
    snaps = {}
    with tempfile.TemporaryDirectory() as d:
        tr = _port_trainer(d, tspec)

        def snapshot(step, _):
            if step + 1 in (STEPS, 20):
                snaps[step + 1] = (
                    {n: t.clone() for n, t in tr.model.state_dict().items()},
                    {k: {n: t.clone() for n, t in tr.opt_state[k].items()}
                     for k in ("m", "v")}, tr.opt_state["step"])
        tr.run(0, 30, callback=snapshot)
    return [h["loss"] for h in tr.history], snaps


def test_trainer_matches_the_jax_trainer():
    _, losses, final, opt = _jax_run()
    _, tspec = spec_pair("tiny")
    history, snaps = _port_run()
    weights, state, step = snaps[STEPS]
    np.testing.assert_allclose(history[:STEPS], losses, atol=1e-4, rtol=0)
    want = from_jax_params(final, tspec)
    for name, t in weights.items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), atol=1e-4,
                                   rtol=0, err_msg=name)
    want_opt = from_jax_opt_state(opt, tspec)
    assert step == want_opt["step"] == STEPS
    for key in ("m", "v"):  # within 1e-4 of each leaf's scale
        for name, t in state[key].items():
            w = want_opt[key][name].numpy()
            np.testing.assert_allclose(
                t.numpy(), w, rtol=0, err_msg=f"{key} {name}",
                atol=1e-4 * max(1.0, float(np.abs(w).max())))


def test_restart_equals_the_uninterrupted_run_bit_for_bit(tmp_path):
    _, tspec = spec_pair("tiny")
    weights, state, _ = _port_run()[1][20]
    injector = FailureInjector(fail_at_steps=(12,))
    attempts = []

    def make(attempt):
        attempts.append(attempt)
        return _port_trainer(tmp_path / "ft", tspec, injector=injector)

    tr = run_with_restarts(make, total_steps=20)
    assert attempts == [0, 1]
    assert tr.history[0]["step"] == 10  # resumed after step 9's checkpoint
    theirs = tr.model.state_dict()
    for name, t in weights.items():
        assert torch.equal(t, theirs[name]), name
    for key in ("m", "v"):
        for name, t in state[key].items():
            assert torch.equal(t, tr.opt_state[key][name]), (key, name)


def test_gradient_accumulation_matches_large_batch(tmp_path):
    _, tspec = spec_pair("tiny")
    one = _port_trainer(tmp_path / "a", tspec, lr=1e-3, warmup=0)
    acc = _port_trainer(tmp_path / "b", tspec, micro_batches=4, lr=1e-3,
                        warmup=0)
    one.run(0, 3)
    acc.run(0, 3)
    theirs = acc.model.state_dict()
    for name, t in one.model.state_dict().items():
        np.testing.assert_allclose(t.numpy(), theirs[name].numpy(),
                                   atol=2e-4, rtol=0, err_msg=name)


def test_loss_decreases():
    history, _ = _port_run()
    assert len(history) == 30
    first, last = np.mean(history[:5]), np.mean(history[-5:])
    assert last < first - 0.2, (first, last)


def test_trainer_refuses_a_mesh(tmp_path):
    """``Trainer(mesh=)`` trains a model built on that mesh
    (``tests/test_torch_mesh.py``); a model built without it is
    refused."""
    _, tspec = spec_pair("tiny")
    model = build_model(tspec, device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="build the model on that mesh"):
        Trainer(model, DataConfig(vocab=64, **DATA),
                TrainConfig(checkpoint_dir=str(tmp_path)), mesh=object())


def test_train_launcher_on_the_cpu(tmp_path, capsys):
    """The launcher's code path (reduced qwen1.5-0.5b, float32) trains,
    checkpoints at its last step and resumes from it."""
    from repro_torch.launch import train
    argv = ["--device", "cpu", "--steps", "3", "--batch", "2", "--seq",
            "16", "--checkpoint-dir", str(tmp_path)]
    tr = train.main(argv)
    assert len(tr.history) == 3 and tr.ckpt.latest_step() == 2
    assert all(np.isfinite(h["loss"]) for h in tr.history)
    again = train.main(argv)  # resumes at step 3: nothing left to run
    assert again.history == [] and "resumed from step 3" in \
        capsys.readouterr().out
