"""hubert-xlarge [audio]: 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504.

Encoder-only transformer (wav2vec2 architecture); the convolutional waveform
frontend is a STUB — ``input_specs`` provides precomputed frame embeddings
(B, S, d_model).  vocab=504 is the masked-unit prediction codebook.  No
autoregressive decode stage.  [arXiv:2106.07447]
"""

from ..core.modelspec import AttnSpec, ModelSpec

SPEC = ModelSpec(
    name="hubert-xlarge",
    d_model=1280, n_layers=48, n_heads=16, n_kv_heads=16,
    d_ff=5120, vocab=504,
    attn=AttnSpec(kind="full", causal=False),
    act="gelu", norm="rmsnorm", pos="none",
    frontend="audio", decoder=False,
)

REDUCED = SPEC.scaled(name="hubert-xlarge-reduced", d_model=64, n_layers=2,
                      n_heads=4, n_kv_heads=4, d_head=16, d_ff=256, vocab=64)
