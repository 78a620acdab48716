"""Logical axis -> mesh axis translation (MaxText-style sharding rules): a
copy of ``repro.sharding.axes`` without JAX.

A mesh here is anything with ``axis_names`` (a tuple of names) and
``shape`` (a mapping of name -> size), as
:class:`repro_torch.launch.mesh.DeviceMesh` has.  A partition spec is a
tuple with one entry per tensor dimension: None (replicated), a mesh axis
name, or a tuple of names (the dimension split over their product, in
that order).
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

#: Maps a logical axis name to a mesh axis, a tuple of mesh axes, or None.
AxisRules = Mapping[str, Any]

#: one dimension's entry of a partition spec
SpecEntry = str | tuple[str, ...] | None


def _mesh_axes(rules: AxisRules, mesh, logical: str | None) -> SpecEntry:
    if logical is None:
        return None
    if logical not in rules:
        raise KeyError(f"no sharding rule for logical axis {logical!r}")
    target = rules[logical]
    if target is None:
        return None
    if isinstance(target, str):
        target = (target,)
    present = tuple(a for a in target if a in mesh.axis_names)
    if not present:
        return None
    return present if len(present) > 1 else present[0]


def logical_spec(logical_axes: Sequence[str | None], rules: AxisRules,
                 mesh) -> tuple[SpecEntry, ...]:
    """('batch','seq','embed') -> (('pod','data'), None, None)"""
    return tuple(_mesh_axes(rules, mesh, ax) for ax in logical_axes)


def entry_axes(entry: SpecEntry) -> tuple[str, ...]:
    """A spec entry as a tuple of axis names (() for None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def fit_sharding(shape: tuple[int, ...], spec: Sequence[SpecEntry],
                 mesh) -> tuple[SpecEntry, ...]:
    """Make a partition spec legal for ``shape``: the trailing axes of an
    entry whose product does not divide its dimension are dropped, down to
    a replicated dimension (e.g. 8 GQA kv-heads or 40 RWKV heads on a
    16-way model axis, or a 504-entry codebook vocab).  The resulting
    replication is deliberate baseline waste, as in the reference."""
    new_spec: list[SpecEntry] = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            new_spec.append(entry)
            continue
        axes_t = entry_axes(entry)
        while axes_t:
            total = 1
            for a in axes_t:
                total *= mesh.shape[a]
            if shape[i] % total == 0:
                break
            axes_t = axes_t[:-1]
        if not axes_t:
            new_spec.append(None)
        elif len(axes_t) == 1:
            new_spec.append(axes_t[0])
        else:
            new_spec.append(axes_t)
    return tuple(new_spec)

