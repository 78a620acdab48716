"""GenZ facade — DEPRECATED in favor of :mod:`repro_torch.scenario`.

The one-stop API tying profiler + NPU + platform together (paper Fig. 2)
now lives behind the declarative :class:`repro_torch.scenario.Scenario` object
and its ``run()`` executor; the methods below are thin shims that build a
Scenario and route it through the same analytical backend, so old callers
keep working for one release while emitting a :class:`DeprecationWarning`.

Old:

    >>> g = genz.GenZ.hgx_h100(8)
    >>> rep = g.estimate("llama3-70b", use_case="chat", batch=16,
    ...                  parallelism=dict(tp=8))

New:

    >>> from repro_torch.scenario import Scenario, run
    >>> sc = Scenario.make("llama3-70b", use_case="chat", batch=16,
    ...                    platform="hgx-h100x8", parallelism=dict(tp=8))
    >>> rep, = run([sc], backend="analytical")
"""

from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass

from .modelspec import ModelSpec
from .network import Platform
from .operators import Optimizations
from .stages import InferenceReport, StageResult, Workload


#: methods that already warned this process — the shims are one release
#: from removal, and a sweep calling an old method thousands of times
#: should nag once, not thousands of times
_WARNED: set[str] = set()


def reset_deprecation_warnings() -> None:
    """Re-arm the one-shot warnings (tests)."""
    _WARNED.clear()


def _deprecated(method: str, repl: str) -> None:
    if method in _WARNED:
        return
    _WARNED.add(method)
    warnings.warn(
        f"GenZ.{method}() is deprecated; use repro_torch.scenario.Scenario + "
        f"run() ({repl}). The shim will be removed one release after the "
        "Scenario API landed.", DeprecationWarning, stacklevel=3)


def _scenario(platform: Platform, opt: Optimizations, model, *, use_case,
              workload, batch, parallelism, **kw):
    from ..scenario import Scenario
    return Scenario.make(model, use_case=use_case, workload=workload,
                         batch=batch, platform=platform,
                         parallelism=parallelism, opt=opt, **kw)


def _evaluate(sc):
    """Route through the scenario analytical backend; surface hard errors
    the way the old direct-call API did (raise, don't report)."""
    from ..scenario import analytical
    rep, detail = analytical.evaluate_detailed(sc)
    if rep.status in ("infeasible", "error") and rep.error:
        raise ValueError(rep.error)
    return rep, detail


@dataclass(frozen=True)
class GenZ:
    """Analytical LLM-inference platform analyzer (deprecated facade)."""

    platform: Platform
    opt: Optimizations = Optimizations()

    # -- constructors --------------------------------------------------------
    @staticmethod
    def hgx_h100(n_gpus: int = 8, eff: float | None = None) -> "GenZ":
        from ..scenario import platforms
        return GenZ(platforms.hgx_h100(n_gpus, eff))

    @staticmethod
    def tpu_v5e_pod(data: int = 16, model: int = 16, pods: int = 1) -> "GenZ":
        """The production mesh of this repo: (pod, data, model) over v5e
        chips with ~50 GB/s ICI links and a slower inter-pod DCN."""
        from ..scenario import platforms
        return GenZ(platforms.tpu_v5e_pod(data, model, pods))

    @staticmethod
    def gb200_node(n: int = 8) -> "GenZ":
        from ..scenario import platforms
        return GenZ(platforms.gb200_node(n))

    def with_opt(self, **kw) -> "GenZ":
        return dataclasses.replace(self, opt=dataclasses.replace(self.opt, **kw))

    def with_platform(self, platform: Platform) -> "GenZ":
        return dataclasses.replace(self, platform=platform)

    # -- estimation (deprecated shims over repro_torch.scenario) ------------
    def estimate(self, model: ModelSpec | str, *, use_case: str | None = None,
                 workload: Workload | None = None, batch: int = 1,
                 parallelism=None) -> InferenceReport:
        _deprecated("estimate", "Scenario.make(...) + run(...)")
        sc = _scenario(self.platform, self.opt, model, use_case=use_case,
                       workload=workload, batch=batch,
                       parallelism=parallelism)
        return _evaluate(sc)[1]["report"]

    def prefill(self, model, *, workload=None, use_case=None, batch=1,
                parallelism=None) -> StageResult:
        _deprecated("prefill", "mode='monolithic', Report.extra['prefill']")
        from .stages import prefill as stage_prefill
        sc = _scenario(self.platform, self.opt, model, use_case=use_case,
                       workload=workload, batch=batch,
                       parallelism=parallelism)
        # single-stage: don't pay for the decode half of the estimate
        return stage_prefill(sc.resolve_model(), sc.resolve_platform(),
                             sc.parallelism, sc.opt, sc.workload)

    def decode(self, model, *, workload=None, use_case=None, batch=1,
               parallelism=None, context=None) -> StageResult:
        _deprecated("decode", "mode='monolithic', Report.extra['decode']")
        from .stages import decode as stage_decode
        sc = _scenario(self.platform, self.opt, model, use_case=use_case,
                       workload=workload, batch=batch,
                       parallelism=parallelism, context=context)
        return stage_decode(sc.resolve_model(), sc.resolve_platform(),
                            sc.parallelism, sc.opt, sc.workload,
                            context=sc.context)

    def chunked(self, model, *, chunk: int, decode_batch: int, workload=None,
                use_case=None, batch=1, parallelism=None,
                decode_ctx=None) -> StageResult:
        _deprecated("chunked", "mode='chunked' + ChunkedSpec")
        from ..scenario import ChunkedSpec
        sc = _scenario(self.platform, self.opt, model, use_case=use_case,
                       workload=workload, batch=batch,
                       parallelism=parallelism, mode="chunked",
                       chunked=ChunkedSpec(chunk=chunk,
                                           decode_batch=decode_batch,
                                           decode_ctx=decode_ctx))
        return _evaluate(sc)[1]["stage"]

    def speculative(self, target, draft, *, n: int, gamma: float,
                    workload=None, use_case=None, batch=1,
                    parallelism=None) -> StageResult:
        _deprecated("speculative", "mode='speculative' + SpeculativeSpec")
        from ..scenario import SpeculativeSpec
        sc = _scenario(self.platform, self.opt, target, use_case=use_case,
                       workload=workload, batch=batch,
                       parallelism=parallelism, mode="speculative",
                       speculative=SpeculativeSpec(draft=draft, n=n,
                                                   gamma=gamma))
        return _evaluate(sc)[1]["stage"]
