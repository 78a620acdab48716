"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2.  Mamba+attention 1:7 interleave (one attention
layer per 8-layer Jamba block, at in-block offset 4), MoE every other layer.
[arXiv:2403.19887]
"""

from ..core.modelspec import AttnSpec, ModelSpec, MoESpec, SSMSpec

_PATTERN = ("ssm", "ssm", "ssm", "ssm", "attn", "ssm", "ssm", "ssm")

SPEC = ModelSpec(
    name="jamba-v0.1-52b",
    d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=65536,
    attn=AttnSpec(kind="full", causal=True),
    moe=MoESpec(num_experts=16, top_k=2, d_ff_expert=14336, period=2,
                first_dense=1),
    ssm=SSMSpec(kind="mamba", d_state=16, d_conv=4, expand=2),
    hybrid_pattern=_PATTERN,
    act="swiglu", norm="rmsnorm", pos="none",  # Jamba uses no positional enc.
)

REDUCED = SPEC.scaled(
    name="jamba-v0.1-52b-reduced", d_model=64, n_layers=8, n_heads=4,
    n_kv_heads=2, d_head=16, d_ff=128, vocab=512,
    moe=MoESpec(num_experts=4, top_k=2, d_ff_expert=128, period=2,
                first_dense=1),
    ssm=SSMSpec(kind="mamba", d_state=8, d_conv=4, expand=2))
