"""rwkv6-3b [ssm]: 32L d_model=2560 (attention-free) d_ff=8960 vocab=65536.

RWKV-6 "Finch": data-dependent decay linear attention; head size 64 (40
heads).  Constant-size recurrent state -> context-length-independent decode.
[arXiv:2404.05892]
"""

from ..core.modelspec import ModelSpec, SSMSpec

SPEC = ModelSpec(
    name="rwkv6-3b",
    d_model=2560, n_layers=32, n_heads=0, n_kv_heads=0,
    d_ff=8960, vocab=65536,
    ssm=SSMSpec(kind="rwkv6", head_size=64),
    act="swiglu", norm="rmsnorm", pos="none",
)

REDUCED = SPEC.scaled(name="rwkv6-3b-reduced", d_model=64, n_layers=2,
                      d_ff=224, vocab=512,
                      ssm=SSMSpec(kind="rwkv6", head_size=16))
