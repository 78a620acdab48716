"""GenZ analytical core: the port's copy of ``repro.core``.

Layout (paper Fig. 2), modules of ``repro_torch.core``:
  - ``modelspec``     — model profiler inputs (Table IV)
  - ``profiler``      — operator graphs per stage/parallelism
  - ``hardware``      — NPU characterizer (Eq. 1 inputs)
  - ``network``       — platform characterizer + collectives
  - ``roofline``      — Eq. (1) timing + Eq. (2) energy
  - ``stages``        — prefill / decode / chunked / speculative
  - ``requirements``  — §VI platform requirement estimation
  - ``disagg``        — disaggregated prefill/decode planner
  - ``genz``          — deprecated facade (use the scenario layer)

The same pure-Python arithmetic as the reference, so a prediction here
equals the reference's bit for bit.  The user-facing surface is
:mod:`repro_torch.scenario`.  The names below load on first use, so that
the model and engine, which read only ``modelspec``, import none of the
analytical modules.
"""

import importlib

_EXPORTS = {
    "GenZ": "genz",
    "NPU": "hardware", "MemoryLevel": "hardware", "PowerModel": "hardware",
    "get_npu": "hardware",
    "AttnSpec": "modelspec", "ModelSpec": "modelspec", "MoESpec": "modelspec",
    "PAPER_MODELS": "modelspec", "SSMSpec": "modelspec",
    "paper_model": "modelspec",
    "Collective": "network", "NetworkDim": "network", "Platform": "network",
    "collective_time": "network", "make_platform": "network",
    "Operator": "operators", "Optimizations": "operators",
    "ParallelismConfig": "parallelism",
    "InferenceReport": "stages", "StageResult": "stages",
    "Workload": "stages",
    "USE_CASES": "usecases", "use_case": "usecases",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    try:
        module = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}") from None
    value = getattr(importlib.import_module(f".{module}", __name__), name)
    globals()[name] = value
    return value


def __dir__() -> list[str]:
    return sorted(set(globals()) | set(__all__))
