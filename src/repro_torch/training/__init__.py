"""Training substrate (the port of ``repro.training``): optimizer, train
loop, checkpointing, fault tolerance, gradient compression, straggler
mitigation, on one device.  The rank-spanning parts (the compressed
all-reduce, the GPipe forward, ``Trainer(mesh=)``) wait for ROADMAP item
15."""

from .optimizer import AdamWConfig, adamw

__all__ = ["AdamWConfig", "adamw"]
