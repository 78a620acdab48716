"""Mesh-sharded unified serving (the port of ``repro.serving.sharded``): the
engine's one-dispatch token-packed step across ``tp * pp``
``torch.distributed`` ranks, SPMD style.

Every rank runs the same host scheduler on the same requests and holds its
shard of the weights and of the paged KV pools; rank ``pp_rank * tp +
tp_rank`` sits at (pp_rank, tp_rank) of the reference's (pp, tp) mesh.

Sharding plan (Megatron-style, the reference's rules, no communication
inside attention):

- tp splits *heads*: wq/wk/wv column-parallel, so a rank computes
  ``n_heads/tp`` query heads against its own ``n_kv_heads/tp`` KV heads
  (:func:`local_spec`); the paged pools hold the rank's kv heads over the
  full page axis, so host page ids, and the replicated page table and
  lengths, are valid on every rank.  wo and w_down are row-parallel: one
  all-reduce after each, two a layer.  An untied lm_head is vocab-parallel,
  its (S, V/tp) logits all-gathered once a step; the embedding (and a tied
  head) stays replicated.  The leaves and axes are
  :data:`~repro_torch.models.common.TP_SHARD_DIM`.
- pp splits the layers: a rank of stage s holds the contiguous layers
  ``[s L/pp, (s+1) L/pp)`` (the reference shards the stacked ``repeats``
  axis of a period-1 stack, which is the same layers).  The ring
  (:meth:`EngineMesh.pp_ring`): the rank whose stage it is runs its
  sub-stack and sends the activation to the next stage; after pp hops
  stage 0 holds the last stage's hidden state and broadcasts it, so every
  rank samples the same tokens from the same generator.  The reference's
  masked commit, where every rank computes every stage, is shard_map's
  idiom and is not copied: the results are the same.

A model carries its :class:`~repro_torch.models.common.Shard`, whose
``comm`` is this module's :class:`EngineMesh`; ``Model.unified_step`` is
the sharded step (the counterpart of ``build_sharded_step``).

Backends.  ``nccl``: one card per rank, collectives on the card, captured
with the step in its CUDA graph.  ``gloo``: CPU tensors (the tests), or card
tensors staged through pinned host memory; gloo cannot be captured, so a
card engine over gloo needs ``graphs=False``.  Two ranks on one card run
over gloo: NCCL refuses two ranks on one device.

Launch ``tp * pp`` ranks with ``torchrun --nproc-per-node N`` (each calls
``torch.distributed.init_process_group``) or :func:`spawn`, then build the
engine on every rank: ``ServeEngine(model, EngineConfig(cache_layout=
"paged", unified=True, tp=, pp=))`` with the full model (the engine cuts
its shard) or with the rank's shard (``build_model(spec,
shard=make_engine_mesh(tp, pp, device).shard)``).
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from ..launch.mesh import AxisComm, DeviceMesh
from ..models import transformer as T
from ..models.common import Shard, local_spec
from ..models.convert import shard_state
from ..models.model import Model

__all__ = ["SUPPORTED_AXES", "EngineMesh", "collective_stats", "local_spec",
           "make_engine_mesh", "shard_model", "spawn",
           "validate_engine_sharding"]

TP_AXIS = "tp"
PP_AXIS = "pp"
#: parallelism axes the live engine can lower (everything else runs
#: analytically only)
SUPPORTED_AXES = (TP_AXIS, PP_AXIS)


def _world_size() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def validate_engine_sharding(spec, config) -> None:
    """Raise ``ValueError`` for any (tp, pp) the live engine cannot lower
    against ``spec`` (the reference's checks and messages).  Shape
    divisibility is checked before the process group, so
    misconfigurations fail identically on any host."""
    tp, pp = config.tp, config.pp
    if tp < 1 or pp < 1:
        raise ValueError(f"EngineConfig tp/pp must be >= 1, got "
                         f"tp={tp} pp={pp}")
    if tp * pp == 1:
        return
    if not config.unified:
        raise ValueError(
            "tp/pp > 1 requires unified=True: only the token-packed "
            "one-dispatch step is threaded through shard_map")
    if getattr(config, "n_spec", 0):
        raise ValueError(
            f"n_spec={config.n_spec} with tp={tp} pp={pp}: speculative "
            "decoding is single-device only — the fused draft/verify step "
            "is not threaded through build_sharded_step yet (the draft "
            "pool and accept/reject would need their own shard_map "
            "plumbing)")
    if any(k != "attn" for k in spec.layer_kinds()) \
            or spec.moe is not None:
        raise ValueError(
            f"tp/pp > 1 supports dense attention-only stacks; "
            f"{spec.name!r} has non-attention or MoE layers (route MoE "
            "through ep — analytical backend only)")
    if tp > 1:
        for field_name, val in (("n_heads", spec.n_heads),
                                ("n_kv_heads", spec.n_kv_heads),
                                ("d_ff", spec.d_ff)):
            if val % tp:
                raise ValueError(
                    f"tp={tp} must divide {field_name}={val} "
                    f"({spec.name!r}): heads/FFN shard column-wise")
        if not spec.tied_embeddings and spec.vocab % tp:
            raise ValueError(
                f"tp={tp} must divide vocab={spec.vocab} ({spec.name!r}): "
                "the untied lm_head is vocab-sharded")
    if pp > 1:
        _, repeats = T.stack_period(spec)
        if repeats % pp:
            raise ValueError(
                f"pp={pp} must divide the stacked layer repeats={repeats} "
                f"({spec.name!r})")
    world = _world_size()
    if world != tp * pp:
        where = (f"has {world}" if world > 1 or dist.is_initialized()
                 else "is not initialised")
        raise ValueError(
            f"tp={tp} x pp={pp} needs a torch.distributed process group of "
            f"{tp * pp} ranks, but the group {where}; launch {tp * pp} "
            f"ranks with torchrun --nproc-per-node {tp * pp} (or "
            f"repro_torch.serving.sharded.spawn({tp * pp}, fn, "
            "backend=...)), each building the same engine")


def collective_stats(spec, tp: int, pp: int, t_pack: int, n_segs: int,
                     dtype_bytes: int = 4) -> tuple[int, int]:
    """(collectives_per_step, estimated all-reduce bytes per step) for one
    packed step of ``t_pack`` tokens — the measured column next to the
    analytical network model's message-size terms.

    Counts per device: 2 psums per layer when tp>1 (each moving
    ~2*(tp-1)/tp of the (T, d_model) residual in a ring), pp ppermute
    hops + 1 broadcast psum when pp>1, and one logits all_gather when the
    head is untied ((tp-1)/tp of (S, V) received per rank)."""
    coll = 0
    bytes_ = 0.0
    if tp > 1:
        n_ar = 2 * spec.n_layers
        payload = t_pack * spec.d_model * dtype_bytes
        coll += n_ar
        bytes_ += n_ar * 2.0 * (tp - 1) / tp * payload
        if not spec.tied_embeddings:
            coll += 1
            bytes_ += (tp - 1) / tp * n_segs * spec.vocab * dtype_bytes
    if pp > 1:
        coll += pp + 1  # ring hops + final broadcast psum
        hop = t_pack * spec.d_model * dtype_bytes
        bytes_ += pp * hop + 2.0 * (pp - 1) / pp * hop
    return coll, int(bytes_)


class EngineMesh(AxisComm):
    """This rank's (pp, tp) serving mesh: a view of a
    :class:`~repro_torch.launch.mesh.DeviceMesh` with axes ``("pp",
    "tp")`` over the default process group (rank ``pp_rank * tp +
    tp_rank``), whose collectives it runs (over gloo, card tensors staged
    through pinned host memory).  As an ``AxisComm`` over ``tp`` it is
    the shard's communicator: ``enter`` and ``exit`` around the split
    blocks (a serving step takes no gradient, so ``exit`` sums in
    place), the vocab-parallel logits' gather, and the pipeline ring."""

    def __init__(self, tp: int, pp: int, device: torch.device):
        super().__init__(DeviceMesh((pp, tp), (PP_AXIS, TP_AXIS), device),
                         TP_AXIS)
        self.tp, self.pp = tp, pp
        self.pp_rank = self.mesh.coords[PP_AXIS]
        self.tp_rank = self.mesh.coords[TP_AXIS]
        self.device = self.mesh.device
        self.backend, self.staged = self.mesh.backend, self.mesh.staged

    @property
    def shard(self) -> Shard:
        return Shard(tp=self.tp, pp=self.pp, tp_rank=self.tp_rank,
                     pp_rank=self.pp_rank, comm=self)

    def all_gather_last(self, t: torch.Tensor) -> torch.Tensor:
        """(..., n) on each tp rank -> (..., tp * n), the ranks' slices in
        rank order along the last axis."""
        return self.mesh.all_gather(t, TP_AXIS, dim=-1)

    def pp_ring(self, x: torch.Tensor, run) -> torch.Tensor:
        """The pipeline ring of one step: stage s > 0 receives the
        activation from stage s-1; each stage runs ``run`` (its sub-stack)
        and sends to the next stage, the last to stage 0; stage 0 then
        holds the final hidden state and broadcasts it over the pp group.
        ``x`` is the embedded input (read on stage 0 only).  Returns the
        final hidden state on every rank: pp hops and one broadcast."""
        m, s = self.mesh, self.pp_rank
        if s > 0:
            x = m.recv(x, s - 1, PP_AXIS)
        y = run(x)
        m.send(y, (s + 1) % self.pp, PP_AXIS)
        if s == 0:
            y = m.recv(y, self.pp - 1, PP_AXIS)
        return m.broadcast_(y, 0, PP_AXIS)


def make_engine_mesh(tp: int, pp: int,
                     device: str | torch.device) -> EngineMesh:
    """The (pp, tp) mesh over the default process group, whose world size
    must be ``tp * pp``; every rank calls it, in the same order."""
    world = _world_size()
    if world != tp * pp:
        raise ValueError(f"tp={tp} x pp={pp} needs a process group of "
                         f"{tp * pp} ranks, not {world}")
    return EngineMesh(tp, pp, torch.device(device))


def shard_model(model: Model, mesh: EngineMesh) -> Model:
    """This rank's shard of the full ``model`` (same device, dtype, kernel
    route and KV quantization), its weights cut from the full model's."""
    shard = mesh.shard
    out = Model(model.spec, model.device, model.dtype, shard=shard)
    out.kv_quant = model.kv_quant
    out.kernel_impl = model.kernel_impl
    out.load_state_dict(shard_state(model.state_dict(), model.spec, shard))
    return out


# ---------------------------------------------------------------------------
# launching ranks
# ---------------------------------------------------------------------------

def _rank_main(fn, args, rank: int, world: int, backend: str, tmp: str,
               timeout_s: float) -> None:
    """One spawned rank: join the group, run ``fn(*args)``, write its
    result (or traceback) for the parent, leave the group."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"file://{tmp}/rendezvous", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    out = Path(tmp) / f"rank{rank}.pkl"
    try:
        out.write_bytes(pickle.dumps(("ok", fn(*args))))
    except BaseException:
        out.write_bytes(pickle.dumps(("error", traceback.format_exc())))
        raise
    finally:
        dist.destroy_process_group()


def spawn(world: int, fn, *args, backend: str = "gloo",
          timeout_s: float = 900.0) -> list:
    """Run ``fn(*args)`` on ``world`` fresh ranks (``spawn`` processes,
    each inside a process group of ``backend`` joined through a
    ``file://`` rendezvous in a temporary directory: no TCP port to
    collide on) and return each rank's result, in rank order.  ``fn`` must
    be importable by name (a module-level function) and its result
    picklable; inside it ``torch.distributed.get_rank()`` is the rank.  A
    rank that raises, dies or outlives ``timeout_s`` stops every rank, and
    the call raises ``RuntimeError`` with each failed rank's traceback.
    The ranks inherit the parent's environment; nccl ranks take card
    ``rank % device_count``."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, args, rank, world, backend, tmp,
                                   timeout_s))
                 for rank in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        timed_out = False
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break  # a rank failed: the others may wait forever
                if time.monotonic() > deadline:
                    timed_out = True
                    break
                time.sleep(0.02)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
        results, errors = [], []
        for rank, p in enumerate(procs):
            path = Path(tmp) / f"rank{rank}.pkl"
            if not path.exists():
                errors.append(f"rank {rank}: no result (exit code "
                              f"{p.exitcode})")
                continue
            status, value = pickle.loads(path.read_bytes())
            if status != "ok":
                errors.append(f"rank {rank}:\n{value}")
            results.append(value)
    if timed_out:
        errors.insert(0, f"ranks outlived {timeout_s} s")
    if errors:
        raise RuntimeError(f"spawn({world}, {fn.__name__}, backend="
                           f"{backend!r}) failed:\n" + "\n".join(errors))
    return results
