"""JSON codec for the scenario layer.

Type-tagged recursive encoding of the (frozen) dataclasses that make up a
:class:`~repro_torch.scenario.Scenario` /
:class:`~repro_torch.scenario.Report`: every
dataclass becomes ``{"__type__": <class name>, <field>: <encoded>, ...}``
and tuples become ``{"__tuple__": [...]}`` so the round trip restores the
exact Python value (``Scenario.from_json(s.to_json()) == s``).

Only the whitelisted types below are decodable — the payloads stay plain
data, never arbitrary object graphs.
"""

from __future__ import annotations

import dataclasses

from ..core.hardware import NPU, MemoryLevel, PowerModel
from ..core.modelspec import AttnSpec, ModelSpec, MoESpec, SSMSpec
from ..core.network import NetworkDim, Platform
from ..core.operators import Optimizations
from ..core.parallelism import ParallelismConfig
from ..core.stages import Workload
from .scenario import ChunkedSpec, DisaggSpec, Scenario, SpeculativeSpec

_TYPES: dict[str, type] = {cls.__name__: cls for cls in (
    Workload, ParallelismConfig, Optimizations,
    AttnSpec, MoESpec, SSMSpec, ModelSpec,
    MemoryLevel, NPU, PowerModel, NetworkDim, Platform,
    ChunkedSpec, SpeculativeSpec, DisaggSpec, Scenario,
)}


def register(cls: type) -> type:
    """Register an additional dataclass (used by report.py)."""
    _TYPES[cls.__name__] = cls
    return cls


def encode(obj):
    """Python value -> JSON-able value (dicts/lists/scalars only)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        name = type(obj).__name__
        if name not in _TYPES:
            raise TypeError(f"unregistered dataclass {name!r}")
        out = {"__type__": name}
        for f in dataclasses.fields(obj):
            out[f.name] = encode(getattr(obj, f.name))
        return out
    if isinstance(obj, tuple):
        return {"__tuple__": [encode(x) for x in obj]}
    if isinstance(obj, list):
        return [encode(x) for x in obj]
    if isinstance(obj, dict):
        bad = [k for k in obj if not isinstance(k, str)]
        if bad:
            # stringifying would silently break the decode round trip
            raise TypeError(f"dict keys must be str for a lossless JSON "
                            f"round trip; got {bad[:3]!r}")
        return {k: encode(v) for k, v in obj.items()}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"cannot encode {type(obj).__name__}: {obj!r}")


def decode(obj):
    """Inverse of :func:`encode`."""
    if isinstance(obj, dict):
        if "__tuple__" in obj:
            return tuple(decode(x) for x in obj["__tuple__"])
        if "__type__" in obj:
            name = obj["__type__"]
            try:
                cls = _TYPES[name]
            except KeyError:
                raise ValueError(
                    f"unknown payload type {name!r}; decodable types: "
                    f"{sorted(_TYPES)}") from None
            kw = {k: decode(v) for k, v in obj.items() if k != "__type__"}
            return cls(**kw)
        return {k: decode(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [decode(x) for x in obj]
    return obj
