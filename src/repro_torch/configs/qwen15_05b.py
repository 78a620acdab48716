"""qwen1.5-0.5b [dense]: 24L d_model=1024 16H (kv=16) d_ff=2816 vocab=151936.

QKV bias, tied embeddings.  [hf:Qwen/Qwen1.5-0.5B]
"""

from ..core.modelspec import AttnSpec, ModelSpec

SPEC = ModelSpec(
    name="qwen1.5-0.5b",
    d_model=1024, n_layers=24, n_heads=16, n_kv_heads=16,
    d_ff=2816, vocab=151936,
    attn=AttnSpec(kind="full", causal=True),
    qkv_bias=True, tied_embeddings=True,
    act="swiglu", norm="rmsnorm", pos="rope", rope_theta=1e6,
)

REDUCED = SPEC.scaled(name="qwen1.5-0.5b-reduced", d_model=64, n_layers=2,
                      n_heads=4, n_kv_heads=4, d_head=16, d_ff=176,
                      vocab=512)
