"""deepseek-7b [dense]: 30L d_model=4096 32H (kv=32) d_ff=11008 vocab=102400.

LLaMA architecture.  [arXiv:2401.02954]
"""

from ..core.modelspec import AttnSpec, ModelSpec

SPEC = ModelSpec(
    name="deepseek-7b",
    d_model=4096, n_layers=30, n_heads=32, n_kv_heads=32,
    d_ff=11008, vocab=102400,
    attn=AttnSpec(kind="full", causal=True),
    act="swiglu", norm="rmsnorm", pos="rope", rope_theta=1e4,
)

REDUCED = SPEC.scaled(name="deepseek-7b-reduced", d_model=128, n_layers=2,
                      n_heads=4, n_kv_heads=4, d_head=32, d_ff=344, vocab=512)
