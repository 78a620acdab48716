"""Sweep executor: evaluate Scenarios against a backend, in parallel.

``run`` is the single entry point unifying the two halves of the repo:

    run(scenarios, backend="analytical")   # GenZ prediction (parallel)
    run(scenarios, backend="engine")       # real ServeEngine measurement

The analytical backend is pure Python (no torch), so sweeps fan out over a
forked process pool — the paper's figures are thousands of independent
cells and evaluate embarrassingly parallel.  Order is preserved:
``reports[i]`` corresponds to ``scenarios[i]``.  The engine backend runs
serially (one card, one engine at a time).  Fork no pool once CUDA is up
in the process: pass ``max_workers=1`` there.
"""

from __future__ import annotations

import os
from typing import Iterable, Sequence

from .report import Report
from .scenario import Scenario
from .sweep import Sweep

BACKENDS = ("analytical", "engine")

#: below this many cells a process pool costs more than it saves
_PARALLEL_THRESHOLD = 8


def _as_list(scenarios) -> list[Scenario]:
    if isinstance(scenarios, Scenario):
        return [scenarios]
    if isinstance(scenarios, Sweep):
        return scenarios.scenarios()
    out = list(scenarios)
    for sc in out:
        if not isinstance(sc, Scenario):
            raise TypeError(f"expected Scenario, got {type(sc).__name__}")
    return out


def run(scenarios: Scenario | Sweep | Iterable[Scenario], *,
        backend: str = "analytical", max_workers: int | None = None,
        engine_kw: dict | None = None) -> list[Report]:
    """Evaluate scenarios; returns one Report per scenario, same order.

    ``max_workers``: process-pool width for the analytical backend
    (default: CPU count; 0/1 forces serial).  ``engine_kw`` forwards
    engine-lowering overrides (``max_slots``, ``max_seq``, ``max_prompt``,
    ``max_new``, ``n_requests``, ``seed``...) to the engine backend.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; valid: "
                         f"{list(BACKENDS)}")
    scs = _as_list(scenarios)
    if not scs:
        return []
    if backend == "engine":
        from . import engine_backend
        return [engine_backend.evaluate(sc, **(engine_kw or {})) for sc in scs]
    return _run_analytical(scs, max_workers)


def _run_analytical(scs: Sequence[Scenario],
                    max_workers: int | None) -> list[Report]:
    from . import analytical
    workers = (os.cpu_count() or 1) if max_workers is None else max_workers
    workers = min(workers, len(scs))
    if workers <= 1 or len(scs) < _PARALLEL_THRESHOLD:
        return [analytical.evaluate(sc) for sc in scs]
    try:
        return _pool_map(scs, workers)
    except Exception:  # noqa: BLE001 - no fork / broken pool / restricted host
        _shutdown_pool()
        return [analytical.evaluate(sc) for sc in scs]


# The worker pool is cached across run() calls: sweeps are often issued
# figure-by-figure and a fresh fork per call would cost more than the
# cells.  Workers are forked snapshots — scenarios travel by pickle, so
# inline specs/platforms are always current; only mutations of module
# globals made *after* the first parallel run would be invisible to them.
_POOL = None
_POOL_WORKERS = 0


def _get_pool(workers: int):
    global _POOL, _POOL_WORKERS
    if _POOL is None or _POOL_WORKERS != workers:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor
        _shutdown_pool()
        try:
            ctx = mp.get_context("fork")
        except ValueError:
            ctx = mp.get_context()
        _POOL = ProcessPoolExecutor(max_workers=workers, mp_context=ctx)
        _POOL_WORKERS = workers
    return _POOL


def _shutdown_pool() -> None:
    global _POOL, _POOL_WORKERS
    if _POOL is not None:
        _POOL.shutdown(wait=False, cancel_futures=True)
        _POOL, _POOL_WORKERS = None, 0


def warm_pool(workers: int | None = None) -> None:
    """Pre-fork the analytical worker pool (optional; benches call this so
    timing runs exclude one-time pool creation)."""
    workers = workers or (os.cpu_count() or 1)
    pool = _get_pool(workers)
    list(pool.map(int, range(workers)))


def _pool_map(scs: Sequence[Scenario], workers: int) -> list[Report]:
    from .analytical import evaluate
    chunk = max(1, len(scs) // (workers * 4))
    pool = _get_pool(workers)
    return list(pool.map(evaluate, scs, chunksize=chunk))
