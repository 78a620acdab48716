"""Cartesian sweep builder over Scenario axes, with constraint pruning.

    >>> from repro_torch.scenario import Scenario, Sweep
    >>> base = Scenario.make("llama3-8b", use_case="chat", batch=4)
    >>> grid = Sweep(base).over(model=["llama3-8b", "llama3-70b"],
    ...                         tp=[1, 2, 4, 8], mode=["monolithic"])
    >>> len(grid)  # infeasible tp x NPU combos already dropped
    8

Axis names may be Scenario fields (``model``, ``platform``, ``mode``,
``workload``, ``opt`` ...), ParallelismConfig fields (``tp``, ``ep``,
``pp``, ``dp``, ``sp``, ``micro_batches``), Workload fields (``batch``,
``tau_p``, ``tau_d``, ``beam``) plus ``use_case`` (resolves a Table-III
workload, keeping the current batch), and Optimizations fields
(``weight_dtype``, ``kv_dtype``, ...).

Pruning drops combinations that can never be evaluated — parallelism
degree exceeding the platform NPU count, ``pp`` deeper than the layer
stack, ``ep`` wider than the expert count (the same checks
``repro_torch.core.parallelism.validate`` applies).  Feasible-but-OOM points are
*kept*: running out of memory is a result (paper Fig. 17), not a
constraint violation.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Iterable, Iterator

from ..core.parallelism import ParallelismConfig, validate
from ..core.stages import Workload
from ..core.operators import Optimizations
from .scenario import Scenario

_SC_FIELDS = {f.name for f in dataclasses.fields(Scenario)}
_PAR_FIELDS = {f.name for f in dataclasses.fields(ParallelismConfig)}
_WL_FIELDS = {f.name for f in dataclasses.fields(Workload)} - {"name"}
_OPT_FIELDS = {f.name for f in dataclasses.fields(Optimizations)}
_VALID_AXES = (_SC_FIELDS | _PAR_FIELDS | _WL_FIELDS | _OPT_FIELDS
               | {"use_case"})


class Sweep:
    """Chainable cartesian grid of Scenarios around a base point."""

    def __init__(self, base: Scenario):
        if not isinstance(base, Scenario):
            raise TypeError(f"Sweep base must be a Scenario, got "
                            f"{type(base).__name__}")
        self.base = base
        self._axes: dict[str, list] = {}
        self._preds: list = []

    def over(self, **axes) -> "Sweep":
        """Add sweep axes; values are iterables.  Returns self (chainable)."""
        for key, values in axes.items():
            if key not in _VALID_AXES:
                raise ValueError(
                    f"unknown sweep axis {key!r}; valid axes: "
                    f"{sorted(_VALID_AXES)}")
            values = list(values)
            if not values:
                raise ValueError(f"sweep axis {key!r} has no values")
            self._axes[key] = values
        return self

    def where(self, fn) -> "Sweep":
        """Add a user predicate ``Scenario -> bool``; grid points it
        rejects are pruned like infeasible parallelism combos (they never
        reach a backend).  Use it to cut points that would only ever
        produce degenerate results — e.g. capacity grids where the prompt
        exceeds the sequence budget::

            Sweep(base).over(tau_p=[1024, 8192, 65536]) \\
                       .where(lambda sc: sc.workload.tau_p <= max_seq)

        Chainable; multiple predicates AND together.
        """
        if not callable(fn):
            raise TypeError(f"where() needs a callable Scenario -> bool, "
                            f"got {type(fn).__name__}")
        self._preds.append(fn)
        return self

    def _keep(self, sc: Scenario) -> bool:
        return feasible(sc) and all(p(sc) for p in self._preds)

    # -- grid construction ---------------------------------------------------
    @property
    def size_unpruned(self) -> int:
        n = 1
        for v in self._axes.values():
            n *= len(v)
        return n

    def _build_one(self, combo: dict) -> Scenario:
        sc = self.base
        # whole-object axes replace the sub-object before field-level
        # shortcuts (use_case, tau_p, tp, weight_dtype, ...) refine it
        wl = combo.get("workload", sc.workload)
        if "use_case" in combo:
            from ..core import usecases
            wl = usecases.use_case(combo["use_case"], batch=wl.batch)
        wl_over = {k: v for k, v in combo.items() if k in _WL_FIELDS}
        if wl_over:
            wl = dataclasses.replace(wl, **wl_over)
        par = combo.get("parallelism", sc.parallelism)
        par_over = {k: v for k, v in combo.items() if k in _PAR_FIELDS}
        if par_over:
            par = dataclasses.replace(par, **par_over)
        opt = combo.get("opt", sc.opt)
        opt_over = {k: v for k, v in combo.items() if k in _OPT_FIELDS}
        if opt_over:
            opt = dataclasses.replace(opt, **opt_over)
        sc_over = {k: v for k, v in combo.items()
                   if k in _SC_FIELDS - {"workload", "parallelism", "opt"}}
        return sc.replace(workload=wl, parallelism=par, opt=opt, **sc_over)

    def _combos(self) -> Iterator[dict]:
        keys = list(self._axes)
        for values in itertools.product(*(self._axes[k] for k in keys)):
            yield dict(zip(keys, values))

    def scenarios(self, prune: bool = True) -> list[Scenario]:
        out = [self._build_one(c) for c in self._combos()]
        if prune:
            out = [sc for sc in out if self._keep(sc)]
        return out

    def partition(self) -> tuple[list[Scenario], list[Scenario]]:
        """-> (kept, pruned) without dropping anything (pruned covers both
        infeasible combos and points a ``where`` predicate rejected)."""
        all_ = [self._build_one(c) for c in self._combos()]
        keep = [sc for sc in all_ if self._keep(sc)]
        drop = [sc for sc in all_ if not self._keep(sc)]
        return keep, drop

    def __iter__(self) -> Iterator[Scenario]:
        return iter(self.scenarios())

    def __len__(self) -> int:
        return len(self.scenarios())


def feasible(sc: Scenario) -> bool:
    """Static feasibility: the parallelism mapping must fit the platform
    and the model (OOM is *not* checked here — it is a result).

    Unknown model/platform refs *raise* rather than prune: a typo'd name
    silently emptying a sweep grid would be far worse than an error."""
    spec = sc.resolve_model()
    plat = sc.resolve_platform()
    if sc.mode == "speculative":
        from .platforms import resolve_model
        resolve_model(sc.speculative.draft)
    try:
        validate(sc.parallelism, plat.num_npus, spec.n_layers,
                 spec.moe.num_experts if spec.moe else None)
    except ValueError:
        return False
    return True


def sweep(base: Scenario, **axes) -> list[Scenario]:
    """One-shot helper: ``sweep(base, tp=[1,2,4])`` == ``Sweep(base).over(
    tp=[1,2,4]).scenarios()``."""
    return Sweep(base).over(**axes).scenarios()
