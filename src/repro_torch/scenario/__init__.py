"""The declarative request layer: one object, one sweep builder, one
executor, two backends (the port's copy of ``repro.scenario``; its engine
backend lowers onto the port's engines, on the card by default).

The paper's core contribution is a single tool mapping (model x use case x
platform x parallelism x serving optimization) to inference metrics.  This
package is that tool's surface:

  * :class:`Scenario`      — frozen, JSON-round-trippable request record
                             (mode union: monolithic | chunked |
                             speculative | disaggregated)
  * :class:`Sweep`         — cartesian grid builder with constraint pruning
  * :func:`run`            — parallel executor over two backends:
                             ``analytical`` (GenZ roofline prediction) and
                             ``engine`` (real ServeEngine measurement)
  * :class:`Report`        — the unified result schema both backends emit
  * :func:`compare`        — predicted-vs-measured relative error

Quickstart::

    from repro_torch.scenario import Scenario, Sweep, run

    base = Scenario.make("llama3-70b", use_case="chat", batch=16,
                         platform="hgx-h100x8",
                         opt=dict(weight_dtype="fp8", act_dtype="fp8",
                                  kv_dtype="fp8"))
    reports = run(Sweep(base).over(tp=[1, 2, 4, 8]))
    for r in reports:
        print(r.scenario.parallelism.tp, r.ttft_s, r.tpot_s, r.status)
"""

from .platforms import (platform_names, resolve_model, resolve_platform,
                        table7_platforms)
from .report import METRIC_FIELDS, Report, compare
from .runner import BACKENDS, run, warm_pool
from .scenario import (MODES, ChunkedSpec, DisaggSpec, Scenario,
                       SpeculativeSpec)
from .sweep import Sweep, feasible, sweep

__all__ = [
    "Scenario", "Sweep", "sweep", "feasible", "run", "warm_pool", "Report",
    "compare",
    "ChunkedSpec", "SpeculativeSpec", "DisaggSpec", "MODES", "BACKENDS",
    "METRIC_FIELDS", "platform_names", "resolve_model", "resolve_platform",
    "table7_platforms",
]
