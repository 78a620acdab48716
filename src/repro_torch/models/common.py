"""Shared building blocks: norms, RoPE, activations, inits (the port of
``repro.models.common``), and the geometry of one rank's shard of a
model, on a serving (pp, tp) mesh or a training (data, model) mesh
(:class:`Shard`, :func:`local_spec`, :func:`tag_shards`,
:func:`mesh_shard`, :data:`TP_SHARD_DIM`)."""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..launch.mesh import AxisComm
from ..sharding.axes import entry_axes, logical_spec


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """Normalize in f32, cast back to x's dtype, then scale in that dtype
    (the reference's cast order)."""
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return y.to(dt) * scale.to(dt)


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "swiglu":  # the gate nonlinearity of SwiGLU
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":
        return lambda x: F.relu(x).square()
    raise ValueError(f"unknown activation {name!r}")


def rope_freqs(d_head: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, d_head, 2, dtype=np.float64)
                            / d_head))


@functools.lru_cache(maxsize=None)
def _inv_freqs(d_head: int, theta: float, device: torch.device
               ) -> torch.Tensor:
    """The (D/2,) f32 rotary frequencies on ``device``, uploaded once (from
    pinned memory on the card: a step that reads them copies nothing from
    the host, so it can be captured in a CUDA graph)."""
    inv = torch.from_numpy(rope_freqs(d_head, theta).astype(np.float32))
    if device.type == "cuda":
        inv = inv.pin_memory()
    return inv.to(device, non_blocking=True)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D) rotated by half-split pairs in f32; positions:
    broadcastable to x.shape[:-2] ending in S."""
    d = x.shape[-1]
    inv = _inv_freqs(d, theta, x.device)
    ang = positions[..., None].float() * inv  # (..., S, D/2)
    sin = ang.sin()[..., None, :]  # broadcast over heads
    cos = ang.cos()[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Initializers: N(0, 1) truncated to [-2, 2], scaled, drawn in f32 from an
# explicit generator (the reference's inits; not the reference's numbers —
# JAX keys and torch generators give different streams from one seed)
# ---------------------------------------------------------------------------

@torch.no_grad()
def _trunc_normal_(w: torch.Tensor, std: float,
                   generator: torch.Generator) -> None:
    """Draw the whole tensor ``w`` is (or is a tensor-parallel slice of,
    see :func:`full_shape`) on the generator's device and keep ``w``'s
    slice: a shard draws what the unsharded model draws from the same
    generator, so both hold the same weights.  A ``meta`` tensor keeps
    nothing (a pipeline stage's draw of another stage's layer)."""
    tmp = torch.empty(full_shape(w), dtype=torch.float32,
                      device=generator.device)
    torch.nn.init.trunc_normal_(tmp, 0.0, 1.0, -2.0, 2.0,
                                generator=generator)
    if w.is_meta:
        return
    shard = getattr(w, "tp_shard", None)
    if shard is not None:
        dim, _, rank = shard
        tmp = tmp.narrow(dim, rank * w.shape[dim], w.shape[dim])
    w.copy_(tmp.mul_(std))


def dense_init_(w: torch.Tensor, generator: torch.Generator,
                in_axis: int = 0) -> None:
    _trunc_normal_(w, 1.0 / float(np.sqrt(full_shape(w)[in_axis])),
                   generator)


def embed_init_(w: torch.Tensor, generator: torch.Generator) -> None:
    _trunc_normal_(w, 0.02, generator)


def weight(shape: tuple[int, ...], device, dtype, fill: float | None = None
           ) -> torch.nn.Parameter:
    """An inference parameter (no grad): uninitialized unless ``fill``."""
    t = torch.empty(shape, device=device, dtype=dtype)
    if fill is not None:
        t.fill_(fill)
    return torch.nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------------------
# One rank's shard of a model (Megatron's plan, the reference's
# ``serving/sharded.py`` and ``_moe_shardmap`` rules): column-parallel
# q/k/v and up/gate projections, row-parallel wo and w_down, a
# vocab-parallel untied head, routed experts split whole, the embedding and
# every norm replicated, contiguous layers per pipeline stage
# ---------------------------------------------------------------------------

#: parameter leaf name -> the axis a tensor-parallel split cuts it on (every
#: other leaf of an attention or MLP block is replicated).  Heads are
#: contiguous column blocks of d_head, so a rank's columns are whole heads,
#: and its kv heads are the ones its query heads' groups read.
TP_SHARD_DIM = {"wq": 1, "wk": 1, "wv": 1, "bq": 0, "bk": 0, "bv": 0,
                "wo": 0, "w_up": 1, "w_gate": 1, "w_down": 0, "lm_head": 1}
#: an MoE block's per-expert tensors: split on the expert axis
EXPERT_SHARD_DIM = {"w_up": 0, "w_gate": 0, "w_down": 0}


@dataclasses.dataclass(frozen=True)
class Shard:
    """One rank's part of a model on a mesh of ranks: rank ``pp_rank * tp +
    tp_rank`` of a serving (pp, tp) mesh, or model index ``tp_rank`` of a
    training (data, model) mesh (``axis`` names the mesh axis the splits
    run over).  The rank holds the layers of pipeline stage ``pp_rank`` of
    ``pp``, and slice ``tp_rank`` of each split tensor: the attention heads
    over ``tp``, the dense FFN's columns over ``ffn_tp``, an untied head's
    vocab over ``head_tp`` (both default to ``tp``), the routed experts
    over ``ep`` (padded to a multiple, as the reference's ``init_moe``
    pads them) and the shared experts' columns over ``shared_tp``.
    ``comm`` runs the split blocks' collectives (an
    :class:`~repro_torch.launch.mesh.AxisComm`: ``enter``/``exit`` around
    the split blocks; a serving mesh's also ``all_gather_last`` over the
    stage's tp ranks and ``pp_ring`` over the stages); None for a shard
    that is only built or loaded, never run."""
    tp: int = 1
    pp: int = 1
    tp_rank: int = 0
    pp_rank: int = 0
    comm: Any = None
    ffn_tp: int | None = None
    head_tp: int | None = None
    ep: int = 1
    shared_tp: int = 1
    axis: str = "tp"

    def __post_init__(self):
        for name in ("ffn_tp", "head_tp"):
            if getattr(self, name) is None:
                object.__setattr__(self, name, self.tp)

    def stage_layers(self, n_layers: int) -> range:
        """The global indices of the layers this rank's stage holds."""
        per = n_layers // self.pp
        return range(self.pp_rank * per, (self.pp_rank + 1) * per)


def local_spec(spec, shard: Shard | int):
    """The per-rank model geometry a shard computes with (the reference's
    ``sharded.local_spec``, whose argument is a serving shard's ``tp``):
    heads and kv heads over ``tp``, the FFN width over ``ffn_tp``."""
    if isinstance(shard, int):
        shard = Shard(tp=shard)
    if shard.tp == 1 and shard.ffn_tp == 1:
        return spec
    return dataclasses.replace(spec, n_heads=spec.n_heads // shard.tp,
                               n_kv_heads=spec.n_kv_heads // shard.tp,
                               d_ff=spec.d_ff // shard.ffn_tp)


def tag_shards(module: torch.nn.Module, shard: Shard) -> None:
    """Mark every parameter of ``module`` (a model, or one of its layers)
    that ``shard`` splits with ``tp_shard = (dim, parts, tp_rank)``, which
    :func:`full_shape`, the inits and ``Model.param_placements`` read."""

    def tag(m, parts: int, dims: dict[str, int]) -> None:
        if m is None or parts == 1:
            return
        for name, p in m.named_parameters(recurse=False):
            if name in dims:
                p.tp_shard = (dims[name], parts, shard.tp_rank)

    for layer in getattr(module, "layers", [module]):
        if layer.cls.kind == "attn":
            tag(layer.mixer, shard.tp, TP_SHARD_DIM)
        if layer.ffn is None:
            continue
        if layer.cls.is_moe:
            tag(layer.ffn, shard.ep, EXPERT_SHARD_DIM)
            tag(layer.ffn.shared, shard.shared_tp, TP_SHARD_DIM)
        else:
            tag(layer.ffn, shard.ffn_tp, TP_SHARD_DIM)
    tag(module, shard.head_tp, {"lm_head": 1})


def full_shape(w: torch.Tensor) -> tuple[int, ...]:
    """The unsharded shape of ``w`` (its own shape unless it is a tp
    slice)."""
    shape = list(w.shape)
    shard = getattr(w, "tp_shard", None)
    if shard is not None:
        dim, tp, _ = shard
        shape[dim] *= tp
    return tuple(shape)


def mesh_shard(spec, mesh, rules) -> Shard:
    """The :class:`Shard` of ``mesh``'s rank of a (data, model) training
    mesh for ``spec`` under the sharding ``rules``: the attention heads
    over ``model`` when the rules map ``heads`` and ``kv_heads`` to it and
    both divide, the dense FFN when ``mlp`` maps to it and d_ff divides,
    the shared experts likewise, and the routed experts always (the
    reference's ``init_moe`` pads to, and ``_moe_shardmap`` splits over,
    the model axis whatever the rules say).  Attention and FFN stay whole
    in a stack with Mamba or RWKV layers.  Everything else is replicated:
    the embedding and head, the norms, the router (``train_2d``'s FSDP
    storage of ``embed`` over ``data`` and its vocab split are layout only
    in the reference, and not copied)."""
    m = mesh.size("model") if "model" in mesh.axis_names else 1
    if m == 1:
        return Shard(axis="model")

    def over_model(logical: str, *dims: int) -> int:
        axes = entry_axes(logical_spec((logical,), rules, mesh)[0])
        return m if "model" in axes and all(x % m == 0 for x in dims) else 1

    plain = all(k == "attn" for k in spec.layer_kinds())
    attn = over_model("heads", spec.n_heads) \
        if plain and over_model("kv_heads", spec.n_kv_heads) > 1 else 1
    ffn = over_model("mlp", spec.d_ff) if plain and spec.d_ff else 1
    shared = ep = 1
    if spec.moe is not None:
        ep = m
        if spec.moe.shared_experts:
            shared = over_model(
                "mlp", spec.moe.shared_experts * spec.moe.d_ff_expert)
    return Shard(tp=attn, tp_rank=mesh.index("model"),
                 comm=AxisComm(mesh, "model"), ffn_tp=ffn, head_tp=1,
                 ep=ep, shared_tp=shared, axis="model")
