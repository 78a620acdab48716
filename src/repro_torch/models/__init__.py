"""The port's model: dense, GQA and MoE decoders served through the
token-packed paged step, and RWKV-6 decoders through the two-dispatch
steps.

    model = build_model(spec)                   # on the card, bf16 weights
    model = build_model(spec, device="cpu", dtype=torch.float32)
    model.load_state_dict(from_jax_params(params_np, spec))
"""

from .convert import from_jax_params
from .model import Model, ModelCache, build_model

__all__ = ["Model", "ModelCache", "build_model", "from_jax_params"]
