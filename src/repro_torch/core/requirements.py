"""Platform requirements estimation (paper §VI).

Given a use case + model, derive the platform-level resources needed to meet
the SLOs, studying each requirement in isolation (the others assumed not to
be the bottleneck):

  memory capacity  :  weights + KV cache                      (§VI-A)
  compute          :  prefill FLOPs / TTFT                    (§VI-B)
  memory bandwidth :  (active weights + KV) / TPOT            (§VI-C)

With ``opt.paged_kv`` the KV term is paged: each request occupies whole
``kv_page_size``-token pages (fragmentation <= one page per request), and
:func:`max_concurrency_req` inverts the capacity formula into the number
of concurrent requests a memory budget supports — the quantity the paged
serving engine actually measures.
"""

from __future__ import annotations

from dataclasses import dataclass

from .modelspec import ModelSpec
from .operators import Optimizations
from .parallelism import ParallelismConfig
from .profiler import PassSpec, model_ops, pass_flops
from .stages import Workload, _page_round, concurrency_from_kv_budget


@dataclass(frozen=True)
class PlatformRequirements:
    mem_capacity: float  # bytes (weights + KV)
    weights_bytes: float
    kv_bytes: float
    compute: float  # FLOP/s to meet TTFT
    mem_bw: float  # bytes/s to meet TPOT

    @property
    def mem_capacity_gb(self) -> float:
        return self.mem_capacity / 1e9

    @property
    def compute_pflops(self) -> float:
        return self.compute / 1e15

    @property
    def mem_bw_tbps(self) -> float:
        return self.mem_bw / 1e12


def memory_capacity_req(spec: ModelSpec, wl: Workload,
                        opt: Optimizations) -> tuple[float, float]:
    """-> (weight bytes, kv bytes).  MEM-CAP ∝ ModelSize + KVcache;
    KV ∝ B (tau_p + S_b tau_d), rounded up to whole pages when paged."""
    w = spec.param_count() * opt.wbytes()
    kv = spec.kv_cache_bytes(
        wl.batch, _page_round(wl.tau_p + wl.beam * wl.tau_d, opt), 0,
        dtype=opt.kv_dtype)
    return w, kv


def max_concurrency_req(spec: ModelSpec, wl: Workload, opt: Optimizations,
                        capacity_bytes: float,
                        reserved_ctx: int | None = None) -> int:
    """Concurrent requests a ``capacity_bytes`` memory budget supports
    (§VI-A inverted).  Dense engines reserve ``reserved_ctx`` tokens per
    slot (their ``max_seq``; default: the workload's full context); paged
    engines occupy only the pages the actual context needs.

    This is the budget form — one aggregate memory pool, like the other
    §VI requirement estimators (parallelism assumed not to be the
    bottleneck).  For a platform + parallelism mapping use
    :func:`repro_torch.core.stages.max_concurrency`, which shards weights
    and KV
    before delegating to the same core."""
    w = spec.param_count() * opt.wbytes()
    return concurrency_from_kv_budget(spec, opt, wl,
                                      max(capacity_bytes - w, 0.0),
                                      reserved_ctx=reserved_ctx)


def compute_req(spec: ModelSpec, wl: Workload, opt: Optimizations) -> float:
    """FLOP/s so prefill finishes within the TTFT SLO.
    TFLOPS ∝ B tau_p / TTFT (fixed model)."""
    assert wl.ttft_slo, "use case must define a TTFT SLO"
    ops = model_ops(spec, PassSpec(wl.batch, wl.tau_p, wl.tau_p, True),
                    ParallelismConfig(), opt)
    return pass_flops(ops) / wl.ttft_slo


def mem_bw_req(spec: ModelSpec, wl: Workload, opt: Optimizations) -> float:
    """bytes/s so each decode step meets the TPOT SLO.
    BW ∝ (ActiveModel + KVcache) / TPOT."""
    assert wl.tpot_slo, "use case must define a TPOT SLO"
    active_w = spec.active_param_count() * opt.wbytes()
    kv = spec.kv_cache_bytes(wl.batch, wl.tau_p, wl.tau_d, beam=wl.beam,
                             dtype=opt.kv_dtype)
    return (active_w + kv) / wl.tpot_slo


def platform_requirements(spec: ModelSpec, wl: Workload,
                          opt: Optimizations | None = None
                          ) -> PlatformRequirements:
    opt = opt or Optimizations(weight_dtype="fp8", act_dtype="fp8",
                               kv_dtype="fp8")
    w, kv = memory_capacity_req(spec, wl, opt)
    return PlatformRequirements(
        mem_capacity=w + kv, weights_bytes=w, kv_bytes=kv,
        compute=compute_req(spec, wl, opt),
        mem_bw=mem_bw_req(spec, wl, opt))


def scenario_requirements(scenario) -> PlatformRequirements:
    """§VI requirements for a declarative
    :class:`repro_torch.scenario.Scenario`
    (the workload must define both SLOs).  The scenario's own dtype
    optimizations are honored — build the Scenario with fp8 opts to match
    the paper's §VI assumptions."""
    spec = scenario.resolve_model()
    return platform_requirements(spec, scenario.workload, scenario.opt)
