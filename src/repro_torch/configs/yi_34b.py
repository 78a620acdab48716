"""yi-34b [dense]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.

LLaMA architecture with GQA.  [arXiv:2403.04652]
"""

from ..core.modelspec import AttnSpec, ModelSpec

SPEC = ModelSpec(
    name="yi-34b",
    d_model=7168, n_layers=60, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab=64000,
    attn=AttnSpec(kind="full", causal=True),
    act="swiglu", norm="rmsnorm", pos="rope", rope_theta=5e6,
)

REDUCED = SPEC.scaled(name="yi-34b-reduced", d_model=128, n_layers=2,
                      n_heads=8, n_kv_heads=2, d_head=16, d_ff=368, vocab=512)
