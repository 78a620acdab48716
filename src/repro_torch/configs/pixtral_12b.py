"""pixtral-12b [vlm]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072.  Transformer BACKBONE only (Mistral-Nemo-style decoder with
d_head=128); the Pixtral-ViT vision frontend is a STUB — ``input_specs``
provides precomputed patch embeddings.  [hf:mistralai/Pixtral-12B-2409]
"""

from ..core.modelspec import AttnSpec, ModelSpec

SPEC = ModelSpec(
    name="pixtral-12b",
    d_model=5120, n_layers=40, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab=131072,
    attn=AttnSpec(kind="full", causal=True),
    act="swiglu", norm="rmsnorm", pos="rope", rope_theta=1e9,
    frontend="vision",
)

REDUCED = SPEC.scaled(name="pixtral-12b-reduced", d_model=64, n_layers=2,
                      n_heads=4, n_kv_heads=2, d_head=16, d_ff=160, vocab=512)
