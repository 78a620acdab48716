"""The one declarative request object of the repo (paper Fig. 2, unified).

A :class:`Scenario` pins down everything the paper's tool maps to inference
metrics — (model x use case x platform x parallelism x serving
optimization) — in a single frozen, JSON-round-trippable record:

    >>> from repro_torch.scenario import Scenario, run
    >>> sc = Scenario.make("llama3-70b", use_case="chat", batch=16,
    ...                    platform="hgx-h100x8", parallelism=dict(tp=8))
    >>> rep, = run([sc], backend="analytical")
    >>> rep.ttft_s, rep.tpot_s, rep.throughput_tok_s

The ``mode`` union selects the serving strategy the paper studies:

  monolithic    : plain prefill + decode (paper §II-B/C)
  chunked       : fused chunked-prefill iterations (§IV-A)
  speculative   : draft/target speculative decoding (§IV-B)
  disaggregated : split prefill/decode pools (§IX / DistServe-style)

``model`` and ``platform`` are usually string refs (resolved against the
paper-model table, the arch registry and the named-platform catalog) but
inline ``ModelSpec`` / ``Platform`` objects are accepted and survive the
JSON round-trip, so ad-hoc design-space points need no registry entry.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

from ..core.modelspec import ModelSpec
from ..core.network import Platform
from ..core.operators import Optimizations
from ..core.parallelism import ParallelismConfig
from ..core.stages import Workload

MODES = ("monolithic", "chunked", "speculative", "disaggregated")


@dataclass(frozen=True)
class ChunkedSpec:
    """Chunked-prefill iteration shape (paper §IV-A)."""

    chunk: int = 512
    decode_batch: int = 1
    decode_ctx: int | None = None


@dataclass(frozen=True)
class SpeculativeSpec:
    """Draft/target speculative decoding (paper §IV-B)."""

    draft: str | ModelSpec = ""
    n: int = 4
    gamma: float = 0.8  # per-token acceptance probability (analytical)


@dataclass(frozen=True)
class DisaggSpec:
    """Disaggregated prefill/decode pool planning (paper §IX)."""

    total_npus: int | None = None  # defaults to the platform size
    inter_pool_bw: float = 100e9
    tp_options: tuple[int, ...] = (1, 2, 4, 8, 16, 32)
    # chunked-colocated baseline the plan is compared against
    colocated_tp: int = 8
    colocated_chunk: int = 512


@dataclass(frozen=True)
class Scenario:
    """One declarative inference request: everything needed to price (or
    actually run) a serving configuration."""

    model: str | ModelSpec
    workload: Workload
    platform: str | Platform = "hgx-h100x8"
    parallelism: ParallelismConfig = field(default_factory=ParallelismConfig)
    opt: Optimizations = field(default_factory=Optimizations)
    mode: str = "monolithic"
    chunked: ChunkedSpec | None = None
    speculative: SpeculativeSpec | None = None
    disaggregated: DisaggSpec | None = None
    #: decode context override (None -> tau_p + tau_d/2, like stages.decode)
    context: int | None = None
    tag: str = ""  # free-form label carried into Reports

    def __post_init__(self):
        # ergonomic coercion: parallelism/opt accept plain dicts everywhere
        # (Scenario(...), .replace(...), Sweep axes)
        if isinstance(self.parallelism, dict):
            object.__setattr__(self, "parallelism",
                               ParallelismConfig(**self.parallelism))
        if isinstance(self.opt, dict):
            object.__setattr__(self, "opt", Optimizations(**self.opt))
        if self.mode not in MODES:
            raise ValueError(
                f"unknown mode {self.mode!r}; valid modes: {list(MODES)}")
        if self.mode == "chunked" and self.chunked is None:
            object.__setattr__(self, "chunked", ChunkedSpec())
        if self.mode == "disaggregated" and self.disaggregated is None:
            object.__setattr__(self, "disaggregated", DisaggSpec())
        if self.mode == "speculative":
            if self.speculative is None or not self.speculative.draft:
                raise ValueError(
                    "mode='speculative' needs speculative=SpeculativeSpec("
                    "draft=<model ref>, n=..., gamma=...)")

    # -- construction --------------------------------------------------------
    @staticmethod
    def make(model: str | ModelSpec, *, use_case: str | None = None,
             workload: Workload | None = None, batch: int | None = None,
             platform: str | Platform = "hgx-h100x8", parallelism=None,
             opt: Optimizations | dict | None = None,
             mode: str = "monolithic", **kw) -> "Scenario":
        """Ergonomic constructor mirroring the old ``GenZ.estimate``
        signature: ``use_case=`` resolves a Table-III workload, ``batch=``
        overrides its batch (omit it to keep an explicit workload's own
        batch), ``parallelism=`` accepts a dict."""
        from ..core import usecases
        if workload is None:
            if use_case is None:
                raise ValueError("provide workload= or use_case=")
            workload = usecases.use_case(use_case, batch=batch or 1)
        elif batch is not None and batch != workload.batch:
            workload = dataclasses.replace(workload, batch=batch)
        if isinstance(parallelism, dict):
            parallelism = ParallelismConfig(**parallelism)
        if isinstance(opt, dict):
            opt = Optimizations(**opt)
        return Scenario(model=model, workload=workload, platform=platform,
                        parallelism=parallelism or ParallelismConfig(),
                        opt=opt or Optimizations(), mode=mode, **kw)

    def replace(self, **kw) -> "Scenario":
        return dataclasses.replace(self, **kw)

    # -- resolution ----------------------------------------------------------
    def resolve_model(self) -> ModelSpec:
        from .platforms import resolve_model
        return resolve_model(self.model)

    def resolve_platform(self) -> Platform:
        from .platforms import resolve_platform
        return resolve_platform(self.platform)

    # -- names (for rows / labels) -------------------------------------------
    @property
    def model_name(self) -> str:
        return self.model if isinstance(self.model, str) else self.model.name

    @property
    def platform_name(self) -> str:
        return (self.platform if isinstance(self.platform, str)
                else self.platform.name)

    def describe(self) -> str:
        return (f"{self.model_name} on {self.platform_name} "
                f"[{self.parallelism.describe()}] {self.workload.name} "
                f"b{self.workload.batch} mode={self.mode}")

    # -- serialization -------------------------------------------------------
    def to_dict(self) -> dict:
        from .codec import encode
        return encode(self)

    @staticmethod
    def from_dict(d: dict) -> "Scenario":
        from .codec import decode
        sc = decode(d)
        if not isinstance(sc, Scenario):
            raise ValueError(f"not a Scenario payload: {type(sc).__name__}")
        return sc

    def to_json(self, **kw) -> str:
        import json
        return json.dumps(self.to_dict(), **kw)

    @staticmethod
    def from_json(s: str) -> "Scenario":
        import json
        return Scenario.from_dict(json.loads(s))
