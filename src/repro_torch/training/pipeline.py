"""Pipeline parallelism's schedule arithmetic (the single-device part of
the port of ``repro.training.pipeline``): the GPipe configuration and its
bubble fraction, (p - 1) / (m + p - 1) for p stages and m micro-batches.

The reference's ``pipeline_forward`` / ``make_pipelined_fn`` (the GPipe
loop that rotates micro-batch activations between stages) need ranks and
a mesh: they wait for ``DeviceMesh`` (ROADMAP item 15).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class PipelineConfig:
    n_micro: int = 4
    axis: str = "pod"


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
