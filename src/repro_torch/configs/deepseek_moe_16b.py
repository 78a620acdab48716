"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (kv=16) d_ff=1408
vocab=102400, MoE 64 routed experts top-6 + 2 shared experts (fine-grained
expert segmentation).  [arXiv:2401.06066]

Note: the released checkpoint uses a dense first layer (d_ff=10944); the
repository's config applies the fine-grained MoE uniformly, to every
layer, and the port follows it.
"""

from ..core.modelspec import AttnSpec, ModelSpec, MoESpec

SPEC = ModelSpec(
    name="deepseek-moe-16b",
    d_model=2048, n_layers=28, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=102400,
    attn=AttnSpec(kind="full", causal=True),
    moe=MoESpec(num_experts=64, top_k=6, d_ff_expert=1408, shared_experts=2),
    act="swiglu", norm="rmsnorm", pos="rope", rope_theta=1e4,
)

REDUCED = SPEC.scaled(
    name="deepseek-moe-16b-reduced", d_model=64, n_layers=2, n_heads=4,
    n_kv_heads=4, d_head=16, d_ff=88, vocab=512,
    moe=MoESpec(num_experts=8, top_k=2, d_ff_expert=88, shared_experts=1))
