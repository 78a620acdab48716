"""Training substrate (the port of ``repro.training``): optimizer, train
loop, checkpointing, fault tolerance, gradient compression, straggler
mitigation, on one device or across the ranks of a ``DeviceMesh`` (the
compressed all-reduce, the GPipe forward, ``Trainer(mesh=)``, gathered
checkpoints and their elastic restore)."""

from .optimizer import AdamWConfig, adamw

__all__ = ["AdamWConfig", "adamw"]
