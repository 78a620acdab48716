"""Model descriptions shared by the port's model and engine."""

from .modelspec import AttnSpec, ModelSpec, MoESpec, SSMSpec

__all__ = ["AttnSpec", "ModelSpec", "MoESpec", "SSMSpec"]
