"""The port's mesh-sharded model and trainer, compressed all-reduce and
GPipe against the JAX package's, on the CPU.

The reference runs once, in one subprocess with four fake host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, as
``tests/test_distributed.py`` runs it), and writes every output this file
compares to.  The port then runs on one gloo world of 4 ranks
(``repro_torch.serving.sharded.spawn``), spawned once; the rank bodies
import nothing of JAX.  Inputs come from the reference's seeds, weights
through ``from_jax_params`` and ``shard_state(state, spec, mesh,
policy)``.  Gradients are held to each leaf's own scale, max |g|.

* Expert-parallel ``moe_block`` against the reference's ``_moe_shardmap``
  (``moe_impl="shardmap"``) over four settings of two levels each:
  reduced deepseek-moe-16b and granite-moe-3b-a800m, meshes (data,
  model) = (1, 4) and (2, 2), capacity factor 1.25 (drops occur: the
  reference's output differs from its dense route's, and the port counts
  dropped assignments) and 8.0 (none: it equals the dense route),
  ``moe_partition_tokens`` off and on.  The eight cases are the half of
  the sixteen combinations whose levels have even parity, so every pair
  of levels of any two settings meets in two cases.  Outputs within 1e-5
  of the output's scale on model rank 0 (with ``partition`` on every
  rank: without it each model rank combines its own copies, and over
  capacity later source ranks lose theirs first; the reference returns
  device 0's), and the gradients of every parameter and of x within 1e-4
  of each leaf's scale.  The inputs share one offset direction, so the
  router loads its experts unevenly.  The dense route on the same meshes
  (``moe_impl="dense"``: each rank's experts on every token, the sums met
  over ``model``), in each arch and mesh's case at 8.0: its output equals
  the reference's dense route, its gradients the reference's
  expert-parallel ones.
* The loss and every gradient of ``build_model(mesh=, policy=
  "train_2d")`` on a (2, 2) mesh (reduced qwen1.5-0.5b; reduced granite
  with partitioned tokens at 1.25, and unpartitioned at 8.0) against the
  reference's jitted ``value_and_grad`` on the same mesh: loss within
  1e-5 relative, gradients within 1e-4 of each leaf's scale.
* Padded experts: the reference's ``init`` on a 3-way ``model`` axis
  pads granite's 8 experts to 9; the tree converts and each of three
  ranks loads its 3 rows.
* ``Trainer(mesh=)`` against the JAX ``Trainer(mesh=)``: reduced granite
  on (2, 2), expert-parallel with partitioned tokens at capacity 1.25,
  from the reference's initial weights, 5 AdamW steps (eps 1e-6, as
  ``tests/test_torch_train_moe.py`` sets it): losses within 1e-4 on every
  rank, final weights within 1e-4.
* ``compressed_psum_grads`` against the reference's on a 4-way data mesh,
  every rank (device) holding its own gradient tree (a leaf of 2,100
  elements over three 1,024-element chunks, a 2,050-element leaf scaled
  by 10^-rank, an all-zero leaf): within 1e-6 of each leaf's scale (the
  int8 round trips are the same; the f32 sums may differ in order).
  With compression on, one ``Trainer(mesh=)`` step is AdamW on
  ``compressed_psum_grads`` of the ranks' gradient shares, bit for bit
  (the reference's ``Trainer`` builds its error feedback but its step
  never calls it, so there is no reference step to hold this one to).
* GPipe: ``make_pipelined_fn`` over a 4-rank ``pod`` axis on the
  reference's 4-stage tanh stack (``tests/test_distributed.py``) within
  1e-5 of the reference's pipelined output, on every rank;
  ``bubble_fraction(4, 4) == 3/7``.
* Elastic restore: a ``Trainer`` checkpoint written on (2, 2) (tensors
  gathered, rank 0 writing) restores bit for bit on (1, 2) and (1, 1).
* ``DeviceMesh.send``/``recv`` pass a ring of four ranks.
* The launcher: ``launch.train --device cpu --devices 4 --tp 2`` trains
  reduced qwen1.5-0.5b from seed 0 with the single-device launcher's
  losses (within 1e-5).
"""

import copy
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as treg
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.mesh import DeviceMesh, make_mesh
from repro_torch.models import build_model, from_jax_params, shard_state
from repro_torch.models.moe import moe_block
from repro_torch.serving import sharded
from repro_torch.training.compression import (CompressionConfig,
                                              compressed_psum_grads)
from repro_torch.training.optimizer import AdamWConfig, adamw
from repro_torch.training.pipeline import (PipelineConfig, bubble_fraction,
                                           make_pipelined_fn)
from repro_torch.training.train_loop import TrainConfig, Trainer

REPO = Path(__file__).resolve().parent.parent
MOE_ARCHS = ("deepseek-moe-16b", "granite-moe-3b-a800m")
MESHES = ((1, 4), (2, 2))
#: the half of the 2^4 settings whose levels have even parity (a
#: resolution-IV fraction: every pair of levels of two settings meets)
MOE_CASES = [(a, m, cf, part) for ia, a in enumerate(MOE_ARCHS)
             for im, m in enumerate(MESHES) for ic, cf in enumerate((1.25, 8.0))
             for part in (False, True) if (ia + im + ic + part) % 2 == 0]
MODEL_CASES = [("qwen1.5-0.5b", 1.25, False),
               ("granite-moe-3b-a800m", 1.25, True),
               ("granite-moe-3b-a800m", 8.0, False)]
#: the capacity at which a MoE case's rank also runs the dense route on
#: the mesh (once per arch and mesh: its output and gradients do not
#: depend on the capacity or the partition, and at 8.0 nothing drops)
DENSE_CF = 8.0
GRANITE = "granite-moe-3b-a800m"
RESTORE_OPT = dict(lr=3e-3, warmup_steps=2, total_steps=20, eps=1e-6)
#: Trainer(mesh=) against the reference's
DATA = dict(seq_len=16, global_batch=4, seed=0)
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=20, eps=1e-6)
STEPS = 5
CHUNK = 1024


def _grad_trees() -> list[dict]:
    """Each rank's gradient tree for the compressed all-reduce."""
    rng = np.random.default_rng(0)
    return [{"a": rng.standard_normal((3, 700)).astype(np.float32),
             "b": {"c": (rng.standard_normal(2050)
                         * 10.0 ** -r).astype(np.float32)},
             "z": np.zeros((5, 4), np.float32)} for r in range(4)]


REFERENCE = """
import pickle, sys, tempfile
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import registry
from repro.data.pipeline import DataConfig
from repro.launch.mesh import make_mesh
from repro.models import build_model
from repro.models.moe import moe_block
from repro.training.compression import CompressionConfig, compressed_psum_grads
from repro.training.optimizer import AdamWConfig
from repro.training.pipeline import PipelineConfig, make_pipelined_fn
from repro.training.train_loop import TrainConfig, Trainer

ARGS = pickle.load(open(sys.argv[2], "rb"))
np_tree = lambda t: jax.tree.map(np.asarray, t)
out = {}
for arch, shape, cf, part in ARGS["moe_cases"]:
    spec = registry.get_reduced(arch)
    mesh = make_mesh(shape, ("data", "model"))
    model = build_model(spec, mesh=mesh, param_dtype=jnp.float32,
                        compute_dtype=jnp.float32, moe_capacity_factor=cf,
                        moe_partition_tokens=part)
    params = model.init(jax.random.key(0))
    p = jax.tree.map(lambda x: x[0], params["layers"]["pos0"]["ffn"])
    x = (jax.random.normal(jax.random.key(2), (4, 64, spec.d_model))
         + jax.random.normal(jax.random.key(3), (spec.d_model,)))
    ctx = model.ctx.with_(moe_impl="shardmap")
    def loss(p, x):
        y = moe_block(spec, ctx, p, x)
        return jnp.sum(y ** 2), y
    with mesh:
        (_, y), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                               has_aux=True))(p, x)
    dctx = model.ctx.with_(moe_impl="dense", mesh=None)
    dense = jax.jit(lambda p, x: moe_block(spec, dctx, p, x))(p, x)
    out[("moe", arch, shape, cf, part)] = dict(
        p=np_tree(p), x=np.asarray(x), y=np.asarray(y),
        dense=np.asarray(dense), g=np_tree(g[0]), gx=np.asarray(g[1]))
mesh = make_mesh((2, 2), ("data", "model"))
for arch, cf, part in ARGS["model_cases"]:
    spec = registry.get_reduced(arch)
    model = build_model(spec, mesh=mesh, policy="train_2d",
                        param_dtype=jnp.float32, compute_dtype=jnp.float32,
                        moe_capacity_factor=cf, moe_partition_tokens=part)
    params = model.init(jax.random.key(0))
    tokens = jax.random.randint(jax.random.key(1), (4, 32), 0, spec.vocab)
    targets = jax.random.randint(jax.random.key(2), (4, 32), 0, spec.vocab)
    with mesh:
        loss, g = jax.jit(jax.value_and_grad(
            lambda p: model.loss(p, tokens, targets, chunk=16)))(params)
    out[("model", arch, cf, part)] = dict(
        params=np_tree(params), tokens=np.asarray(tokens),
        targets=np.asarray(targets), loss=float(loss), grads=np_tree(g))
    if spec.moe is not None and cf == 1.25:  # the drops move the loss
        plain = build_model(spec, mesh=None, param_dtype=jnp.float32,
                            compute_dtype=jnp.float32)
        out[("model", arch, cf, part)]["dense_loss"] = float(
            plain.loss(params, tokens, targets, chunk=16))
spec = registry.get_reduced(ARGS["granite"])
padded = build_model(spec, mesh=make_mesh((1, 3), ("data", "model")),
                     policy="train_2d", param_dtype=jnp.float32,
                     compute_dtype=jnp.float32)
out["padded"] = np_tree(padded.init(jax.random.key(0)))
# Trainer(mesh=)
model = build_model(spec, mesh=mesh, policy="train_2d", param_dtype=jnp.float32,
                    compute_dtype=jnp.float32, moe_partition_tokens=True)
with tempfile.TemporaryDirectory() as d:
    tr = Trainer(model, DataConfig(vocab=spec.vocab, **ARGS["data"]),
                 TrainConfig(checkpoint_every=100, checkpoint_dir=d,
                             optimizer=AdamWConfig(**ARGS["opt"])),
                 rng=jax.random.key(0), mesh=mesh)
    init = np_tree(tr.params)
    with mesh:
        tr.run(0, ARGS["steps"])
out["trainer"] = dict(init=init, losses=[h["loss"] for h in tr.history],
                      final=np_tree(tr.params))
# compressed_psum_grads: each device holds its own tree
mesh4 = make_mesh((4, 1), ("data", "model"))
devs = list(mesh4.devices.flat)
def per_device(*leaves):
    arrs = [jax.device_put(jnp.asarray(l), d) for l, d in zip(leaves, devs)]
    return jax.make_array_from_single_device_arrays(
        leaves[0].shape, NamedSharding(mesh4, P()), arrs)
g = jax.tree.map(per_device, *ARGS["grads"])
got = compressed_psum_grads(g, mesh4, cfg=CompressionConfig(chunk=ARGS["chunk"]))
out["compressed"] = jax.tree.map(
    lambda a: [np.asarray(s.data) for s in a.addressable_shards], got)
# GPipe: tests/test_distributed.py's 4-stage tanh stack
pod = make_mesh((4,), ("pod",))
L, D = 8, 32
ws = jax.random.normal(jax.random.key(0), (L, D, D)) * 0.1
def stage_fn(w_stack, x):
    return jax.lax.scan(lambda h, w: (jnp.tanh(h @ w), None), x, w_stack)[0]
x = jax.random.normal(jax.random.key(1), (4, 2, 4, D))
fn = make_pipelined_fn(stage_fn, pod, 4, ws, PipelineConfig(n_micro=4))
with pod:
    got = jax.jit(fn)(ws, x)
out["gpipe"] = dict(ws=np.asarray(ws), x=np.asarray(x), got=np.asarray(got),
                    want=np.asarray(jax.vmap(lambda xm: stage_fn(ws, xm))(x)))
pickle.dump(out, open(sys.argv[1], "wb"))
"""


def _jax_reference(tmp: Path) -> dict:
    args = dict(moe_cases=MOE_CASES, model_cases=MODEL_CASES,
                granite=GRANITE, data=DATA, opt=OPT, steps=STEPS,
                grads=_grad_trees(), chunk=CHUNK)
    (tmp / "args.pkl").write_bytes(pickle.dumps(args))
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    run = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE),
                          str(tmp / "reference.pkl"), str(tmp / "args.pkl")],
                         capture_output=True, text=True, env=env, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    return pickle.loads((tmp / "reference.pkl").read_bytes())


# ---------------------------------------------------------------------------
# the port, on gloo ranks
# ---------------------------------------------------------------------------

def _moe_case(key, p: dict, x: np.ndarray) -> dict:
    """One expert-parallel block on this rank: its output rows, the
    gradient of every parameter and of its rows of x for
    ``sum(y ** 2)``, and its drops."""
    _, arch, shape, cf, part = key
    spec = treg.get_reduced(arch)
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    model = build_model(spec, "cpu", torch.float32, mesh=mesh,
                        policy="train_2d")
    blk = model.layers[0].ffn
    full = {k: torch.from_numpy(np.array(v)) for k, v in p.items()
            if k != "shared"}
    full.update({f"shared.{k}": torch.from_numpy(np.array(v))
                 for k, v in p.get("shared", {}).items()})
    places = {n[len("layers.0.ffn."):]: pl for n, pl in
              model.param_placements().items()
              if n.startswith("layers.0.ffn.")}
    blk.load_state_dict({n: places[n].local(t) for n, t in full.items()})
    blk.requires_grad_(True)
    rows = x.shape[0] // mesh.size("data")
    i = mesh.index("data")
    names = [n for n, _ in blk.named_parameters()]

    log = []

    def run(moe_impl: str) -> dict:
        xl = torch.from_numpy(x[i * rows:(i + 1) * rows]).requires_grad_(
            True)
        y = moe_block(spec, blk, xl, moe_impl=moe_impl, mesh=mesh,
                      capacity_factor=cf, partition_tokens=part,
                      dispatch_log=log)
        leaves = [q for _, q in blk.named_parameters()]
        grads = torch.autograd.grad((y ** 2).sum(), leaves + [xl],
                                    allow_unused=True)
        # parameter gradients are this data rank's share: sum over data
        gp = {n: mesh.all_reduce(torch.zeros_like(q) if g is None else g,
                                 "data").numpy()
              for n, g, q in zip(names, grads, leaves)}
        return dict(y=y.detach().numpy(), g=gp, gx=grads[-1].numpy())

    out = dict(run("shardmap"), places=places,
               drops=int(log[0]["dropped_send"])
               + int(log[0]["dropped_expert"]))
    if cf == DENSE_CF:  # once per arch and mesh
        out["dense"] = run("dense")
    return out


def _model_case(key, ref: dict) -> dict:
    """The mesh model's loss and every gradient on this rank (summed over
    the data axis), for the global batch."""
    _, arch, cf, part = key
    spec = treg.get_reduced(arch)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    model = build_model(spec, "cpu", torch.float32, mesh=mesh,
                        policy="train_2d")
    model.moe_capacity_factor = cf
    model.moe_partition_tokens = part
    model.load_state_dict(shard_state(from_jax_params(ref["params"], spec),
                                      spec, mesh, "train_2d"))
    model.requires_grad_(True)
    tokens = torch.from_numpy(ref["tokens"])
    loss = model.loss(tokens, torch.from_numpy(ref["targets"]), chunk=16)
    names, leaves = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    axes = model.batch_axes(tokens.shape[0])
    return dict(loss=float(loss.detach()),
                shard=dataclasses.replace(model.shard, comm=None),
                places=model.param_placements(),
                g={n: mesh.all_reduce(torch.zeros_like(q) if g is None
                                      else g, axes).numpy()
                   for n, g, q in zip(names, grads, leaves)})


def _restore_trainer(mesh, ckpt_dir: str, ref: dict) -> Trainer:
    spec = treg.get_reduced(GRANITE)
    model = build_model(spec, "cpu", torch.float32, mesh=mesh,
                        policy="train_2d")
    model.moe_partition_tokens = True
    model.load_state_dict(shard_state(from_jax_params(ref["params"], spec),
                                      spec, mesh, "train_2d"))
    return Trainer(model, DataConfig(vocab=spec.vocab, seq_len=16,
                                     global_batch=4),
                   TrainConfig(checkpoint_every=2, checkpoint_dir=ckpt_dir,
                               optimizer=AdamWConfig(**RESTORE_OPT)),
                   mesh=mesh)


def _state(tr: Trainer) -> dict:
    return {"params": {n: t.detach().clone()
                       for n, t in tr.model.state_dict().items()},
            "m": dict(tr.opt_state["m"]), "v": dict(tr.opt_state["v"])}


def _trainer(init: dict, ckpt: str, compression: bool) -> Trainer:
    spec = treg.get_reduced(GRANITE)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    model = build_model(spec, "cpu", torch.float32, mesh=mesh,
                        policy="train_2d")
    model.moe_partition_tokens = True
    model.load_state_dict(shard_state(from_jax_params(init, spec), spec,
                                      mesh, "train_2d"))
    cfg = TrainConfig(checkpoint_every=100, checkpoint_dir=ckpt,
                      optimizer=AdamWConfig(**OPT),
                      compression=CompressionConfig(enabled=compression))
    return Trainer(model, DataConfig(vocab=spec.vocab, **DATA), cfg,
                   mesh=mesh)


def _compressed_step(init: dict, ckpt: str) -> dict:
    """One compressed step of the trainer, and AdamW on
    ``compressed_psum_grads`` of the same shares computed here."""
    tr = _trainer(init, ckpt, compression=True)
    batch = tr.data.batch_at(0)
    x, t = torch.from_numpy(batch["x"]), torch.from_numpy(batch["targets"])
    _, shares = tr._grads(x, t)
    summed = compressed_psum_grads(dict(zip(tr.params, shares)), tr.mesh,
                                   tr.model.batch_axes(x.shape[0]))
    params = {n: p.detach().clone() for n, p in tr.params.items()}
    state = copy.deepcopy(tr.opt_state)
    adamw(AdamWConfig(**OPT)).update(summed, state, params,
                                     norm=tr._mesh_norm)
    before = {n: p.detach().clone() for n, p in tr.params.items()}
    tr.run(0, 1)
    return dict(same=all(torch.equal(params[n], p.detach())
                         for n, p in tr.params.items()),
                moved=any(not torch.equal(before[n], p.detach())
                          for n, p in tr.params.items()))


def _train_world(ref: dict, ckpt: str) -> dict:
    """The trainer, the compressed all-reduce and GPipe on this rank."""
    init = ref["trainer"]["init"]
    tr = _trainer(init, ckpt, compression=False)
    tr.run(0, STEPS)
    out = dict(losses=[h["loss"] for h in tr.history],
               final={n: t.detach().numpy().copy()
                      for n, t in tr.model.state_dict().items()},
               places=tr.placements,
               compressed_step=_compressed_step(init, ckpt))
    mesh4 = make_mesh((4, 1), ("data", "model"), "cpu")
    mine = _grad_trees()[mesh4.rank]
    flat = {"a": mine["a"], "b.c": mine["b"]["c"], "z": mine["z"]}
    got = compressed_psum_grads(
        {k: torch.from_numpy(v) for k, v in flat.items()}, mesh4,
        cfg=CompressionConfig(chunk=CHUNK))
    out["compressed"] = {k: v.numpy() for k, v in got.items()}
    pod = make_mesh((4,), ("pod",), "cpu")

    def stage_fn(w_stack, h):
        for w in w_stack:
            h = torch.tanh(h @ w)
        return h
    g = ref["gpipe"]
    fn = make_pipelined_fn(stage_fn, pod, 4, cfg=PipelineConfig(n_micro=4))
    out["gpipe"] = fn(torch.from_numpy(g["ws"]),
                      torch.from_numpy(g["x"])).numpy()
    return out


def _world(ref: dict, ckpt_dir: str) -> dict:
    """Rank body of the world of 4."""
    torch.set_num_threads(1)  # tiny shapes: threads would only contend
    out = {"train": _train_world(ref, ckpt_dir + "_train")}
    for key, r in ref.items():
        if key[0] == "moe":
            out[key] = _moe_case(key, r["p"], r["x"])
        elif key[0] == "model":
            out[key] = _model_case(key, r)
    tr = _restore_trainer(make_mesh((2, 2), ("data", "model"), "cpu"),
                          ckpt_dir, ref[("model", GRANITE, 1.25, True)])
    tr.run(0, 2)  # checkpoints after step 1
    out["trained"] = dict(state=_state(tr), places=tr.placements,
                          losses=[h["loss"] for h in tr.history])
    ring = make_mesh((4,), ("pod",), "cpu")
    r = ring.index("pod")
    mine = torch.full((3,), float(r))
    if r % 2 == 0:  # a ring of blocking sends: even ranks send first
        ring.send(mine, (r + 1) % 4, "pod")
        got = ring.recv(mine, (r - 1) % 4, "pod")
    else:
        got = ring.recv(mine, (r - 1) % 4, "pod")
        ring.send(mine, (r + 1) % 4, "pod")
    out["ring"] = got.tolist()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's outputs, then each rank's of the world of 4 on the
    reference's weights and inputs."""
    tmp = tmp_path_factory.mktemp("mesh")
    ref = _jax_reference(tmp)
    ckpt = str(tmp / "ckpt")
    world = sharded.spawn(4, _world, ref, ckpt, timeout_s=600)
    return dict(ref=ref, world=world, ckpt=ckpt)


def _scale(a: np.ndarray) -> float:
    """A leaf's own scale, max |a| (floored only so that an all-zero leaf
    must match exactly): a tolerance of 1e-4 of it fails a factor-2 error
    in any leaf, whatever its magnitude."""
    return max(float(np.abs(a).max()), 1e-30)


def _full(ranks: list[dict], name: str, mesh=(2, 2)) -> np.ndarray:
    """Leaf ``name`` of the full model from data row 0's model ranks."""
    place = ranks[0]["places"][name]
    parts = [ranks[m]["g"][name] for m in range(mesh[1])]
    return np.concatenate(parts, axis=place.dim) if place.sharded \
        else parts[0]


def _moe_id(case) -> str:
    arch, mesh, cf, part = case
    return (f"{arch.split('-')[0]}-{mesh[0]}x{mesh[1]}-cf{cf}-"
            f"{'part' if part else 'nopart'}")


# ---------------------------------------------------------------------------
# expert parallelism
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", MOE_CASES, ids=_moe_id)
def test_expert_parallel_block_equals_the_references_shardmap(case, runs):
    key = ("moe",) + case
    ref = runs["ref"][key]
    ranks = [w[key] for w in runs["world"]]
    arch, (dp, mp), cf, part = case
    scale = _scale(ref["y"])
    # drops at 1.25 (the output parts from the dense route), none at 8.0
    drops = sum(r["drops"] for r in ranks)
    parted = np.abs(ref["y"] - ref["dense"]).max() / scale
    if cf == 1.25:
        assert drops > 0 and parted > 1e-2, (drops, parted)
    else:
        assert drops == 0 and parted < 1e-5, (drops, parted)
    for m in range(mp) if part else (0,):
        y = np.concatenate([ranks[d * mp + m]["y"] for d in range(dp)])
        np.testing.assert_allclose(y, ref["y"], atol=1e-5 * scale, rtol=0,
                                   err_msg=f"model rank {m}")
    gx = np.concatenate([ranks[d * mp]["gx"] for d in range(dp)])
    np.testing.assert_allclose(gx, ref["gx"], atol=1e-4 * _scale(ref["gx"]),
                               rtol=0, err_msg="x")
    for name, place in ranks[0]["places"].items():
        leaf = ref["g"]
        for part_name in name.split("."):
            leaf = leaf[part_name]
        got = [ranks[m]["g"][name] for m in range(mp)]
        got = np.concatenate(got, axis=place.dim) if place.sharded \
            else got[0]
        np.testing.assert_allclose(got, leaf, atol=1e-4 * _scale(leaf),
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("case", [c for c in MOE_CASES
                                  if c[2] == DENSE_CF], ids=_moe_id)
def test_dense_route_on_a_mesh_equals_the_references_dense_route(case,
                                                                  runs):
    """``moe_impl="dense"`` with the experts split over ``model``: each
    rank runs its experts on every token and the sums meet over the axis.
    The output equals the reference's dense route; at capacity 8.0 (no
    drop) the gradients equal the reference's expert-parallel ones, which
    equal the dense oracle's."""
    key = ("moe",) + case
    ref = runs["ref"][key]
    ranks = [w[key] for w in runs["world"]]
    _, (dp, mp), _, _ = case
    for m in range(mp):
        y = np.concatenate([ranks[d * mp + m]["dense"]["y"]
                            for d in range(dp)])
        np.testing.assert_allclose(y, ref["dense"],
                                   atol=1e-5 * _scale(ref["dense"]), rtol=0,
                                   err_msg=f"model rank {m}")
    gx = np.concatenate([ranks[d * mp]["dense"]["gx"] for d in range(dp)])
    np.testing.assert_allclose(gx, ref["gx"], atol=1e-4 * _scale(ref["gx"]),
                               rtol=0, err_msg="x")
    for name, place in ranks[0]["places"].items():
        leaf = ref["g"]
        for part_name in name.split("."):
            leaf = leaf[part_name]
        got = [ranks[m]["dense"]["g"][name] for m in range(mp)]
        got = np.concatenate(got, axis=place.dim) if place.sharded \
            else got[0]
        np.testing.assert_allclose(got, leaf, atol=1e-4 * _scale(leaf),
                                   rtol=0, err_msg=name)


# ---------------------------------------------------------------------------
# the mesh model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", MODEL_CASES,
                         ids=lambda c: f"{c[0].split('-')[0]}-cf{c[1]}-"
                         f"{'part' if c[2] else 'nopart'}")
def test_mesh_model_loss_and_gradients_equal_the_references(case, runs):
    key = ("model",) + case
    ref = runs["ref"][key]
    ranks = [w[key] for w in runs["world"]]
    spec = treg.get_reduced(case[0])
    want = from_jax_params(ref["grads"], spec)
    for r in ranks:
        assert abs(r["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    if spec.moe is not None and case[1] == 1.25:
        assert abs(ref["loss"] - ref["dense_loss"]) > 1e-5  # drops
    shard = ranks[0]["shard"]
    assert shard.tp == 2 and shard.ep == (2 if spec.moe else 1)
    assert set(ranks[0]["g"]) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(_full(ranks, name), w.numpy(),
                                   atol=1e-4 * _scale(w.numpy()), rtol=0,
                                   err_msg=name)


SEEDED_ARCHS = ("qwen1.5-0.5b", "minitron-8b", "deepseek-moe-16b",
                GRANITE, "jamba-v0.1-52b", "rwkv6-3b")


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", SEEDED_ARCHS)
def test_a_seeded_mesh_rank_holds_its_slices_of_the_seeded_model(arch,
                                                                 shape):
    """Exact: ``build_model(mesh=)`` draws every full tensor from the seed
    and keeps its slice, so each rank holds what ``shard_state`` cuts
    from the unsharded model of the same seed (by the same placements as
    a serving shard's: one path), and computes with the geometry its
    splits give: heads and kv heads over ``model`` where both divide,
    the experts always, an untied head whole."""
    spec = treg.get_reduced(arch)
    state = build_model(spec, "cpu", torch.float32, seed=3).state_dict()
    for rank in range(shape[0] * shape[1]):
        mesh = DeviceMesh(shape, ("data", "model"), "cpu", rank=rank)
        model = build_model(spec, "cpu", torch.float32, seed=3, mesh=mesh,
                            policy="train_2d")
        want = shard_state(state, spec, mesh, "train_2d")
        got = model.state_dict()
        assert got.keys() == want.keys()
        for name, t in got.items():
            assert torch.equal(t, want[name]), (rank, name)
        m, plain = shape[1], all(k == "attn" for k in spec.layer_kinds())
        heads = plain and spec.n_heads % m == 0 and spec.n_kv_heads % m == 0
        assert model.shard.tp == (m if heads else 1)
        assert model.spec.n_kv_heads == spec.n_kv_heads // model.shard.tp
        assert model.shard.ep == (m if spec.moe else 1)
        if not spec.tied_embeddings:
            assert model.lm_head.shape == state["lm_head"].shape


def test_padded_experts_convert_and_load_on_a_three_way_axis(runs):
    """8 experts over model = 3: the reference pads to 9; each rank loads
    its 3 rows, and the router keeps 8 columns."""
    spec = treg.get_reduced(GRANITE)
    state = from_jax_params(runs["ref"]["padded"], spec)
    assert state["layers.0.ffn.w_up"].shape[0] == 9
    assert state["layers.0.ffn.router"].shape[1] == 8
    for rank in range(3):
        mesh = DeviceMesh((1, 3), ("data", "model"), "cpu", rank=rank)
        model = build_model(spec, "cpu", torch.float32, mesh=mesh,
                            policy="train_2d")
        assert model.layers[0].ffn.e_pad == 9
        model.load_state_dict(shard_state(state, spec, mesh, "train_2d"))
        for name in ("w_up", "w_gate", "w_down"):
            got = getattr(model.layers[1].ffn, name)
            full = state[f"layers.1.ffn.{name}"]
            assert torch.equal(got, full[3 * rank:3 * rank + 3])


# ---------------------------------------------------------------------------
# elastic restore and the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 2), (1, 1)], ids=["1x2", "1x1"])
def test_checkpoint_from_a_2x2_mesh_restores_bit_for_bit(shape, runs):
    ranks = [w["trained"] for w in runs["world"]]
    assert all(r["losses"] == ranks[0]["losses"] for r in ranks)
    places = ranks[0]["places"]

    def full(kind: str, name: str) -> torch.Tensor:
        p = places[name]
        parts = [ranks[m]["state"][kind][name] for m in range(2)]
        return torch.cat(parts, p.dim) if p.sharded else parts[0]

    ref = runs["ref"][("model", GRANITE, 1.25, True)]
    for rank in range(shape[0] * shape[1]):
        mesh = DeviceMesh(shape, ("data", "model"), "cpu", rank=rank)
        tr = _restore_trainer(mesh, runs["ckpt"], ref)
        assert tr.resume() == 2
        assert tr.opt_state["step"] == 2
        mine = _state(tr)
        for kind in ("params", "m", "v"):
            for name, t in mine[kind].items():
                want = tr.placements[name].local(full(kind, name))
                assert torch.equal(t, want), (kind, name)


def test_mesh_send_and_recv_pass_a_ring(runs):
    for rank, w in enumerate(runs["world"]):
        assert w["ring"] == [float((rank - 1) % 4)] * 3


def test_launcher_trains_on_a_mesh_of_four_cpu_ranks(tmp_path, capfd):
    """``--devices 4 --tp 2``: four gloo ranks, (data 2, model 2), the
    single-device launcher's losses from the same seed."""
    from repro_torch.launch import train
    argv = ["--device", "cpu", "--steps", "3", "--batch", "4",
            "--checkpoint-every", "100"]
    histories = train.main(argv + ["--devices", "4", "--tp", "2",
                                   "--checkpoint-dir", str(tmp_path / "m")])
    assert "mesh: {'data': 2, 'model': 2} over gloo" in capfd.readouterr().out
    single = train.main(argv + ["--checkpoint-dir", str(tmp_path / "s")])
    want = [h["loss"] for h in single.history]
    assert len(histories) == 4
    for h in histories:
        np.testing.assert_allclose([x["loss"] for x in h], want, rtol=1e-5,
                                   atol=0)


# ---------------------------------------------------------------------------
# the trainer, the compressed all-reduce and GPipe
# ---------------------------------------------------------------------------

def _train(runs) -> list[dict]:
    return [w["train"] for w in runs["world"]]


def test_mesh_trainer_equals_the_jax_trainer(runs):
    ref = runs["ref"]["trainer"]
    spec = treg.get_reduced(GRANITE)
    for rank in _train(runs):
        np.testing.assert_allclose(rank["losses"], ref["losses"], atol=1e-4,
                                   rtol=0)
    want = from_jax_params(ref["final"], spec)
    ranks = _train(runs)
    for name, w in want.items():
        place = ranks[0]["places"][name]
        parts = [ranks[m]["final"][name] for m in range(2)]
        got = np.concatenate(parts, place.dim) if place.sharded else parts[0]
        np.testing.assert_allclose(got, w.numpy(), atol=1e-4, rtol=0,
                                   err_msg=name)


def test_compressed_psum_grads_equals_the_references(runs):
    want = runs["ref"]["compressed"]
    flat = {"a": want["a"], "b.c": want["b"]["c"], "z": want["z"]}
    for rank in _train(runs):
        for name, shards in flat.items():
            w = shards[0]
            assert all(np.array_equal(w, s) for s in shards)
            np.testing.assert_allclose(rank["compressed"][name], w,
                                       atol=1e-6 * max(1.0, np.abs(w).max()),
                                       rtol=0, err_msg=name)
    assert not np.any(_train(runs)[0]["compressed"]["z"])


def test_compressed_trainer_step_is_adamw_on_the_compressed_sum(runs):
    for rank in _train(runs):
        assert rank["compressed_step"] == dict(same=True, moved=True)


def test_gpipe_equals_the_references_pipelined_forward(runs):
    g = runs["ref"]["gpipe"]
    np.testing.assert_allclose(g["got"], g["want"], atol=1e-5)
    for rank in _train(runs):
        np.testing.assert_allclose(rank["gpipe"], g["got"], atol=1e-5,
                                   rtol=0)
    assert abs(bubble_fraction(4, 4) - 3 / 7) < 1e-9
