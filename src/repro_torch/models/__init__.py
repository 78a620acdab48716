"""The port's model: every architecture of the registry.  Dense, GQA and
MoE decoders serve through the token-packed paged step; the Mamba hybrid
(jamba) and RWKV-6 decoders through the two-dispatch steps; the encoder
(hubert) and the frontends' backbones run ``Model.forward(embeds=)``.

    model = build_model(spec)                   # on the card, bf16 weights
    model = build_model(spec, device="cpu", dtype=torch.float32)
    model.load_state_dict(from_jax_params(params_np, spec))
    shard = Model(spec, device, dtype, shard=Shard(tp=2, tp_rank=1))
    shard.load_state_dict(shard_state(full_state, spec, shard.shard))
"""

from .common import Shard, local_spec
from .convert import from_jax_opt_state, from_jax_params, shard_state
from .model import Model, ModelCache, build_model

__all__ = ["Model", "ModelCache", "Shard", "build_model",
           "from_jax_opt_state", "from_jax_params", "local_spec",
           "shard_state"]
