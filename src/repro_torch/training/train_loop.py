"""The fault-tolerant training loop (the port of
``repro.training.train_loop``).

Wires together: the model's loss and its gradients (``Model.loss``;
attention's backward is the flash backward kernel on the card), AdamW,
the deterministic data pipeline, async checkpointing, straggler
monitoring, optional gradient compression (error-feedback int8) and the
failure injector the restart tests use.  ``Trainer.resume()`` +
``fault.run_with_restarts`` give checkpoint/restart semantics; because
the pipeline is a pure function of the step index, a restarted run
consumes identical batches.

The trainer takes a built port ``Model`` on its device and trains its
parameters in place (``model.requires_grad_(True)``); with a seeded
``torch.Generator`` it first draws them anew (the reference's
``rng=``), without one it trains the weights the model holds (converted
ones, in the tests).  A step's loss reaches the host once a step
(``float(loss)``), as in the reference; on the card each history entry
also holds the step's forward, backward and optimizer milliseconds
(CUDA events).

``mesh=`` (a :class:`~repro_torch.launch.mesh.DeviceMesh`; the model
built on it, ``build_model(spec, mesh=mesh, policy="train_2d")``) trains
one rank's part of a (data, model) mesh: every rank reads the same global
batch (``batch_at(step)``), ``Model.loss`` runs the rank's rows and gives
the global mean (local sums over the global count), the gradients are
summed over the batch's data axes (through ``compressed_psum_grads`` when
compression is on, in place of the single-device error feedback), the
clip's global norm sums the squares of every rank's slices once, and
AdamW updates each rank's own tensors.  A checkpoint holds whole tensors
(gathered, written by rank 0) and restores onto any mesh.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable

import torch

from ..data.pipeline import DataConfig, TokenPipeline
from ..models.model import Model
from .checkpoint import CheckpointManager
from .compression import (CompressionConfig, ErrorFeedback,
                          compressed_psum_grads, psum_grads)
from .fault import FailureInjector, StragglerMonitor
from .optimizer import AdamWConfig, adamw, global_norm


@dataclass
class TrainConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    log_every: int = 10
    checkpoint_dir: str = "checkpoints"
    optimizer: AdamWConfig = field(default_factory=AdamWConfig)
    compression: CompressionConfig = field(
        default_factory=lambda: CompressionConfig(enabled=False))
    micro_batches: int = 1  # gradient accumulation


class _Parts:
    """On the card, CUDA events around a step's forward, backward and
    optimizer update (summed over micro-batches), read once the step's
    loss has reached the host (by then the stream has run past them)."""

    def __init__(self, on: bool):
        self.on = on
        self.marks: list[tuple[str, torch.cuda.Event, torch.cuda.Event]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        yield
        e1.record()
        self.marks.append((name, e0, e1))

    def read(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for name, e0, e1 in self.marks:
            out[f"{name}_ms"] = out.get(f"{name}_ms", 0.0) \
                + e0.elapsed_time(e1)
        self.marks.clear()
        return out


class Trainer:
    def __init__(self, model: Model, data_cfg: DataConfig,
                 cfg: TrainConfig, generator: torch.Generator | None = None,
                 failure_injector: FailureInjector | None = None,
                 mesh=None):
        if mesh is not None and getattr(model, "mesh", None) is not mesh:
            raise ValueError(
                "Trainer(mesh=): build the model on that mesh, "
                "build_model(spec, mesh=mesh, policy='train_2d')")
        self.mesh = mesh
        self.model = model
        self.device = model.device
        self.cfg = cfg
        self.data = TokenPipeline(data_cfg)
        self.ckpt = CheckpointManager(cfg.checkpoint_dir)
        self.monitor = StragglerMonitor()
        self.injector = failure_injector
        self.optimizer = adamw(cfg.optimizer)
        self.errfb = ErrorFeedback(cfg.compression)
        self.history: list[dict] = []
        self._parts = _Parts(self.device.type == "cuda")

        if generator is not None:
            model.reset_parameters(generator)
        model.requires_grad_(True)
        self.params = dict(model.named_parameters())
        self.opt_state = self.optimizer.init(self.params)
        self.placements = (model.param_placements() if mesh is not None
                           else None)

    # -- one step ---------------------------------------------------------
    def _grads(self, x: torch.Tensor, t: torch.Tensor
               ) -> tuple[torch.Tensor, list[torch.Tensor]]:
        """The loss and the gradient of every parameter for one batch.  A
        parameter the loss does not reach (deepseek-moe-16b's shared
        experts' norm: the shared MLP runs on the block's normed input)
        gets a zero gradient, as ``jax.value_and_grad`` gives it, and
        AdamW then treats it as the reference does, decay included."""
        params = list(self.params.values())
        with self._parts.span("forward"):
            loss = self.model.loss(x, t)
        with self._parts.span("backward"):
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(params, grads)]

    def _step(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        mb = self.cfg.micro_batches
        if mb > 1:  # gradient accumulation over micro-batches
            xs = x.reshape(mb, -1, *x.shape[1:])
            ts = t.reshape(mb, -1, *t.shape[1:])
            loss = torch.zeros((), dtype=torch.float32, device=self.device)
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=self.device)
                     for p in self.params.values()]
            for i in range(mb):
                li, gi = self._grads(xs[i], ts[i])
                loss = loss + li
                for acc, g in zip(grads, gi):
                    acc.add_(g)
            loss = loss / mb
            for g in grads:  # in place: a second f32 copy would not fit
                g.div_(mb)   # jamba-v0.1-52b's 2 layers on one card
        else:
            loss, grads = self._grads(x, t)
        named = dict(zip(self.params, grads))
        norm = None
        if self.mesh is None:
            named = self.errfb(named)
        else:
            with self._parts.span("grad_sync"):
                named = self._sum_over_data(named, x.shape[0] // mb)
            norm = self._mesh_norm
        with self._parts.span("optimizer"):
            self.optimizer.update(named, self.opt_state, self.params,
                                  norm=norm)
        return loss

    # -- mesh -------------------------------------------------------------
    def _sum_over_data(self, grads: dict[str, torch.Tensor], rows: int
                       ) -> dict[str, torch.Tensor]:
        """Each rank's gradient shares summed over the data axes its
        batch of ``rows`` rows is split over (none: it is replicated, and
        so are the gradients)."""
        axes = self.model.batch_axes(rows)
        if not axes:
            return grads
        comp = self.cfg.compression
        if comp.enabled:
            return compressed_psum_grads(grads, self.mesh, axes, comp)
        return psum_grads(grads, self.mesh, axes)

    def _mesh_norm(self, grads: dict[str, torch.Tensor]) -> torch.Tensor:
        """The global norm of the whole model's gradients: a split
        tensor's squares summed over the ranks of its axes, a replicated
        one's counted once."""
        by_axes: dict[tuple, list] = {}
        for n, g in grads.items():
            p = self.placements[n]
            by_axes.setdefault(p.axes if p.sharded else (), []).append(g)
        total = 0.0
        for axes, gs in by_axes.items():
            sq = global_norm(gs).square()
            total = total + (self.mesh.all_reduce(sq, axes, tag="grad_norm")
                             if axes else sq)
        return total.sqrt()

    # -- checkpoint/restart -----------------------------------------------
    def _state(self) -> dict:
        return {"params": dict(self.model.state_dict()),
                "opt": {"m": self.opt_state["m"], "v": self.opt_state["v"],
                        "step": torch.tensor(self.opt_state["step"])}}

    def _state_placements(self) -> dict | None:
        if self.placements is None:
            return None
        return {"params": self.placements,
                "opt": {"m": self.placements, "v": self.placements}}

    def resume(self) -> int:
        restored = self.ckpt.restore(self._state(),
                                     shardings=self._state_placements())
        if restored is None:
            return 0
        tree, extra, _ = restored
        with torch.no_grad():
            for name, t in self.model.state_dict().items():
                t.copy_(tree["params"][name])
            for key in ("m", "v"):
                for name, t in self.opt_state[key].items():
                    t.copy_(tree["opt"][key][name])
        self.opt_state["step"] = int(tree["opt"]["step"])
        self.data.load_state_dict(extra["data"])
        return int(extra["next_step"])

    def _checkpoint(self, step: int) -> None:
        self.ckpt.save_async(step, self._state(),
                             extra={"next_step": step + 1,
                                    "data": self.data.state_dict()},
                             mesh=self.mesh,
                             placements=self._state_placements())

    # -- main loop --------------------------------------------------------
    def run(self, start_step: int, total_steps: int,
            callback: Callable[[int, float], None] | None = None) -> None:
        for step in range(start_step, total_steps):
            t0 = time.time()
            batch = self.data.batch_at(step)
            self.data.step = step + 1
            if self.injector is not None:
                self.injector.check(step)
            x = torch.from_numpy(batch["x"]).to(self.device)
            t = torch.from_numpy(batch["targets"]).to(self.device)
            loss = float(self._step(x, t))
            dt = time.time() - t0
            straggled = self.monitor.observe(step, dt)
            self.history.append({"step": step, "loss": loss, "dt": dt,
                                 "straggled": straggled,
                                 **self._parts.read()})
            if callback is not None:
                callback(step, loss)
            if (step + 1) % self.cfg.checkpoint_every == 0 \
                    or step + 1 == total_steps:
                self._checkpoint(step)
        self.ckpt.wait()
        if self.mesh is not None:
            self.mesh.barrier()  # rank 0's checkpoint is on disk
