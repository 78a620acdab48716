"""mistral-7b-swa: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000,
sliding-window attention W=4096.  The port serves it through the dense
two-dispatch engine, whose flash attention applies the window, and, with
the int8 KV cache, through the paged one too.
[arXiv:2310.06825]
"""

from ..core.modelspec import AttnSpec, ModelSpec

SPEC = ModelSpec(
    name="mistral-7b-swa",
    d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000,
    attn=AttnSpec(kind="swa", window=4096, causal=True),
    act="swiglu", norm="rmsnorm", pos="rope", rope_theta=1e4,
)

REDUCED = SPEC.scaled(name="mistral-7b-swa-reduced", d_model=128, n_layers=2,
                      n_heads=8, n_kv_heads=2, d_head=16, d_ff=384,
                      vocab=512, attn=AttnSpec(kind="swa", window=24,
                                               causal=True))
