"""Pipeline parallelism over one mesh axis, GPipe schedule (the port of
``repro.training.pipeline``).

The multi-pod mesh's outer axis crosses the slow inter-pod network; its
two natural uses are data parallelism (gradients cross pods once a step)
and pipeline parallelism (activations cross pods once a micro-batch).
Each stage rank holds ``n_layers / n_stages`` consecutive layers; the
forward runs ``n_micro + n_stages - 1`` ticks: stage 0 feeds micro-batch
t at tick t, every stage applies its layers to what it holds and passes
the result one stage on around the ring (a send and a receive), and the
last stage banks micro-batch ``t - (n_stages - 1)``.  A final broadcast
from the last stage gives every rank the outputs (the reference's
``psum`` of the last stage's outputs and the others' zeros).  The bubble
fraction is (p - 1) / (m + p - 1).  The forward is not differentiated
(the reference's is, through JAX's transpose of ``ppermute``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class PipelineConfig:
    n_micro: int = 4
    axis: str = "pod"


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def pipeline_forward(layer_fn, n_stages: int, cfg: PipelineConfig,
                     params_stacked, x_micro: torch.Tensor, mesh
                     ) -> torch.Tensor:
    """Run on every rank of ``mesh``'s ``cfg.axis`` (a
    :class:`~repro_torch.launch.mesh.DeviceMesh`).

    layer_fn(params_slice, x) -> x : applies this stage's layers.
    params_stacked: this stage's layer stack.
    x_micro: (n_micro, mb, S, D) micro-batches, the same on every stage
             (stage 0 reads them; the others ignore their copy).
    Returns the (n_micro, mb, S, D) last-stage outputs on every rank."""
    axis = cfg.axis
    stage = mesh.index(axis)
    n_micro = x_micro.shape[0]
    nxt, prev = (stage + 1) % n_stages, (stage - 1) % n_stages
    buf = torch.zeros_like(x_micro[0])
    outputs = torch.zeros_like(x_micro)
    for t in range(n_micro + n_stages - 1):
        if stage == 0:
            inp = x_micro[t] if t < n_micro else torch.zeros_like(buf)
        else:
            inp = buf
        out = layer_fn(params_stacked, inp)
        mb_idx = t - (n_stages - 1)
        if stage == n_stages - 1 and 0 <= mb_idx < n_micro:
            outputs[mb_idx] = out
        buf = mesh.exchange(out, nxt, prev, axis, tag="pipeline_hop")
    return mesh.broadcast_(outputs, n_stages - 1, axis,
                           tag="pipeline_broadcast")


def make_pipelined_fn(layer_fn, mesh, n_stages: int,
                      cfg: PipelineConfig = PipelineConfig()):
    """Wrap a stage function into a pipelined callable ``fn(params, x)``:
    ``params``' leaves (a tensor or a dict of tensors) have a leading layer
    dimension, n_stages * layers_per_stage; each rank takes its stage's
    slice of it.  x: (n_micro, mb, S, D), the same on every rank."""
    stage = mesh.index(cfg.axis)

    def stage_slice(t: torch.Tensor) -> torch.Tensor:
        per = t.shape[0] // n_stages
        return t[stage * per:(stage + 1) * per]

    def fn(params, x_micro: torch.Tensor) -> torch.Tensor:
        local = ({k: stage_slice(v) for k, v in params.items()}
                 if isinstance(params, dict) else stage_slice(params))
        return pipeline_forward(layer_fn, n_stages, cfg, local, x_micro,
                                mesh)

    return fn
