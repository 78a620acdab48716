"""Representative LLM use cases (paper Table III)."""

from __future__ import annotations

from .stages import Workload

USE_CASES: dict[str, Workload] = {
    "question_answering": Workload(tau_p=1000, tau_d=200, beam=4,
                                   ttft_slo=0.2, tpot_slo=0.010,
                                   name="question_answering"),
    "chat": Workload(tau_p=3000, tau_d=1000, beam=2, ttft_slo=0.2,
                     tpot_slo=0.010, name="chat"),
    "qa_rag": Workload(tau_p=10000, tau_d=200, beam=4, ttft_slo=0.4,
                       tpot_slo=0.010, name="qa_rag"),
    "summarization": Workload(tau_p=15000, tau_d=1000, beam=4, ttft_slo=2.0,
                              tpot_slo=0.020, name="summarization"),
    "code_generation": Workload(tau_p=20000, tau_d=50, beam=4, ttft_slo=0.5,
                                tpot_slo=0.020, name="code_generation"),
}


def use_case(name: str, batch: int = 1) -> Workload:
    import dataclasses
    try:
        wl = USE_CASES[name]
    except KeyError:
        raise ValueError(
            f"unknown use case {name!r}; valid use cases: "
            f"{sorted(USE_CASES)}") from None
    return dataclasses.replace(wl, batch=batch)
