"""Parallelism strategy description (paper §III-C, Fig. 4).

GenZ supports the five parallelism strategies used for distributed LLM
serving: Data (DP), Tensor (TP), Pipeline (PP), Expert (EP) and Sequence (SP)
parallelism.  The *order* describes the physical placement: with the paper's
default TP:EP:PP, TP groups occupy the innermost (fastest) network dimension,
EP groups the next, PP the outermost.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ParallelismConfig:
    tp: int = 1
    ep: int = 1
    pp: int = 1
    dp: int = 1
    sp: int = 1  # sequence parallelism degree (shares NPUs with tp)
    #: physical placement order, innermost first (paper default "tp,ep,pp").
    order: str = "tp,ep,pp,dp"
    micro_batches: int = 1  # PP microbatching

    @property
    def total(self) -> int:
        return self.tp * self.ep * self.pp * self.dp

    def degree(self, kind: str) -> int:
        return {"tp": self.tp, "ep": self.ep, "pp": self.pp,
                "dp": self.dp, "sp": self.sp}[kind]

    def inner_skip(self, kind: str) -> int:
        """Stride (in NPUs) between members of a `kind` group: the product of
        the degrees of all parallelism kinds placed inside it."""
        skip = 1
        for k in self.order.split(","):
            k = k.strip()
            if k == kind:
                return skip
            skip *= self.degree(k)
        raise ValueError(f"{kind} not in order {self.order!r}")

    def with_(self, **kw) -> "ParallelismConfig":
        return replace(self, **kw)

    def describe(self) -> str:
        parts = [f"{k.upper()}={self.degree(k)}"
                 for k in ("tp", "ep", "pp", "dp", "sp") if self.degree(k) > 1]
        return "x".join(parts) if parts else "single-NPU"


def validate(par: ParallelismConfig, num_npus: int, n_layers: int,
             num_experts: int | None) -> None:
    if par.total > num_npus:
        raise ValueError(
            f"parallelism {par.describe()} needs {par.total} NPUs, platform "
            f"has {num_npus}")
    if par.pp > n_layers:
        raise ValueError(f"pp={par.pp} exceeds n_layers={n_layers}")
    if par.ep > 1 and (num_experts is None or num_experts < par.ep):
        raise ValueError(f"ep={par.ep} exceeds experts={num_experts}")
