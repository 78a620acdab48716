"""The kernel wrappers' launch counters, taken together.

Each wrapper module counts the calls that reach the card (``launches``)
and, where it has two routes, the calls of each (``routes``): plain Python
integers that the wrapper bumps where it launches its kernel.  A CUDA-graph
replay runs the captured launches without running the wrappers, so the
step graph (:mod:`repro_torch.serving.step_graph`) snapshots the counters
before and after a capture, restores the first snapshot (a capture runs no
work) and adds the difference on every replay.
"""

from __future__ import annotations

from . import (decode_attention, expert_gemm, flash_attention,
               paged_decode_attention, ragged_attention, rwkv6_scan)

MODULES = (ragged_attention, paged_decode_attention, flash_attention,
           expert_gemm, rwkv6_scan, decode_attention)

#: {module name: (launches, {route: calls})}
Counts = dict[str, tuple[int, dict[str, int]]]


def snapshot() -> Counts:
    return {m.__name__: (m.launches, dict(getattr(m, "routes", {})))
            for m in MODULES}


def restore(counts: Counts) -> None:
    for m in MODULES:
        n, routes = counts[m.__name__]
        m.launches = n
        for route, calls in routes.items():
            m.routes[route] = calls


def diff(after: Counts, before: Counts) -> Counts:
    return {name: (n - before[name][0],
                   {r: c - before[name][1][r] for r, c in routes.items()})
            for name, (n, routes) in after.items()}


def add(delta: Counts) -> None:
    for m in MODULES:
        n, routes = delta[m.__name__]
        m.launches += n
        for route, calls in routes.items():
            m.routes[route] += calls
