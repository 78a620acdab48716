"""The unified result record both backends return.

One schema for analytical predictions and measured engine runs, so
predicted-vs-measured comparison (the paper's validation methodology,
max geomean error 5.82%) is a one-liner::

    err = compare(run([sc], backend="analytical")[0],
                  run([sc], backend="engine")[0])

``extra`` carries backend/mode-specific detail (stage breakdowns, engine
summaries, disaggregation plans) as plain JSON-able data.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .codec import decode, encode, register
from .scenario import Scenario

#: every Report carries these top-level metric fields (None = not
#: applicable for the mode/backend); the schema the two backends share.
#: ``max_concurrency`` is the §VI-A capacity question: how many concurrent
#: requests fit the memory budget (analytical: weights + per-request KV
#: reservation inverted; engine: peak concurrent decode slots measured).
METRIC_FIELDS = ("ttft_s", "tpot_s", "latency_s", "throughput_tok_s",
                 "energy_j", "energy_per_token_j", "max_concurrency")

STATUSES = ("ok", "oom", "infeasible", "unsupported", "error")


@register
@dataclass(frozen=True)
class Report:
    """Unified inference metrics for one scenario."""

    scenario: Scenario
    backend: str  # analytical | engine
    status: str  # ok | oom | infeasible | unsupported | error
    ttft_s: float | None = None
    tpot_s: float | None = None
    latency_s: float | None = None
    throughput_tok_s: float | None = None
    energy_j: float | None = None
    energy_per_token_j: float | None = None
    max_concurrency: float | None = None
    fits_memory: bool | None = None
    meets_slo: bool | None = None
    error: str | None = None
    extra: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.status not in STATUSES:
            raise ValueError(f"unknown status {self.status!r}; valid: "
                             f"{list(STATUSES)}")

    @property
    def ok(self) -> bool:
        return self.status == "ok"

    def metrics(self) -> dict:
        """The shared metric schema as a flat dict."""
        return {f: getattr(self, f) for f in METRIC_FIELDS}

    # -- serialization -------------------------------------------------------
    def to_dict(self) -> dict:
        return encode(self)

    @staticmethod
    def from_dict(d: dict) -> "Report":
        rep = decode(d)
        if not isinstance(rep, Report):
            raise ValueError(f"not a Report payload: {type(rep).__name__}")
        return rep

    def to_json(self, **kw) -> str:
        import json
        return json.dumps(self.to_dict(), **kw)

    @staticmethod
    def from_json(s: str) -> "Report":
        import json
        return Report.from_dict(json.loads(s))


def compare(predicted: Report, measured: Report) -> dict:
    """Relative error of the analytical prediction against a measured run,
    per shared metric (skipping metrics either side lacks)."""
    out = {}
    for f in METRIC_FIELDS:
        p, m = getattr(predicted, f), getattr(measured, f)
        if p is None or m is None or m == 0:
            continue
        out[f] = abs(p - m) / abs(m)
    return out
