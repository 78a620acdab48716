"""minitron-8b [dense]: 32L d_model=4096 32H (GQA kv=8) d_ff=16384
vocab=256000.  Pruned Nemotron: 2-matrix squared-ReLU MLP (no gate), which
is what puts the total at ~8B despite the 256k vocab.  [arXiv:2407.14679]
"""

from ..core.modelspec import AttnSpec, ModelSpec

SPEC = ModelSpec(
    name="minitron-8b",
    d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8,
    d_ff=16384, vocab=256000,
    attn=AttnSpec(kind="full", causal=True),
    act="relu2", norm="rmsnorm", pos="rope", rope_theta=1e4,
)

REDUCED = SPEC.scaled(name="minitron-8b-reduced", d_model=128, n_layers=2,
                      n_heads=8, n_kv_heads=2, d_head=16, d_ff=512, vocab=512)
