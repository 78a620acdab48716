"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40 experts top-8, no shared experts, tied head.
[hf:ibm-granite/granite-3.0-1b-a400m-base family]
"""

from ..core.modelspec import AttnSpec, ModelSpec, MoESpec

SPEC = ModelSpec(
    name="granite-moe-3b-a800m",
    d_model=1536, n_layers=32, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab=49155,
    attn=AttnSpec(kind="full", causal=True),
    moe=MoESpec(num_experts=40, top_k=8, d_ff_expert=512),
    tied_embeddings=True,
    act="swiglu", norm="rmsnorm", pos="rope", rope_theta=1e4,
)

REDUCED = SPEC.scaled(
    name="granite-moe-3b-a800m-reduced", d_model=64, n_layers=2, n_heads=4,
    n_kv_heads=2, d_head=16, d_ff=32, vocab=512,
    moe=MoESpec(num_experts=8, top_k=2, d_ff_expert=32))
