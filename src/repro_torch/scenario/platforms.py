"""Named platform catalog + model/platform reference resolution.

The scenario layer refers to platforms by name so a Scenario stays a plain
record.  The catalog covers the platforms the paper's case studies use:

  hgx-h100x<N>        : HGX node, N H100-SXM GPUs on an NVLink switch
  gb200x<N>           : GB200-class node (+ 4-way scale-out dim)
  v5e-<P>x<D>x<M>     : TPU v5e pods, (pod, data, model) ICI/DCN mesh
  gpus / sram_wafer / sram_chips / asics
                      : the four Table-VII platform architectures (Fig. 17)

``resolve_platform`` accepts either a catalog name or an inline
:class:`~repro_torch.core.network.Platform`; ``resolve_model`` accepts a paper
Table-IV name, an assigned-architecture registry id, or an inline
:class:`~repro_torch.core.modelspec.ModelSpec`.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable

from ..core import hardware
from ..core.hardware import GB, PB, TB, NPU, PowerModel
from ..core.modelspec import PAPER_MODELS, ModelSpec
from ..core.network import NetworkDim, Platform


# ---------------------------------------------------------------------------
# builders (previously hard-coded inside GenZ constructors / paper_figures)
# ---------------------------------------------------------------------------

def hgx_h100(n_gpus: int = 8, eff: float | None = None) -> Platform:
    npu = hardware.h100_sxm()
    if eff is not None:
        npu = dataclasses.replace(npu, eff_compute=eff)
    dims = (NetworkDim("nvlink", n_gpus, 450 * GB, 0.5e-6,
                       efficiency=0.75, topology="switch"),)
    return Platform(npu=npu, dims=dims,
                    power=PowerModel(10.2e3 * n_gpus / 8),
                    name=f"hgx-h100x{n_gpus}")


def tpu_v5e_pod(data: int = 16, model: int = 16, pods: int = 1) -> Platform:
    """The production mesh of this repo: (pod, data, model) over v5e chips
    with ~50 GB/s ICI links and a slower inter-pod DCN."""
    npu = hardware.tpu_v5e()
    dims = [NetworkDim("ici-model", model, 50 * GB, 1e-6, topology="ring"),
            NetworkDim("ici-data", data, 50 * GB, 1e-6, topology="ring")]
    if pods > 1:
        dims.append(NetworkDim("dcn-pod", pods, 25 * GB, 10e-6,
                               topology="switch"))
    return Platform(npu=npu, dims=tuple(dims),
                    power=PowerModel(200.0 * data * model * pods),
                    name=f"v5e-{pods}x{data}x{model}")


def gb200_node(n: int = 8) -> Platform:
    npu = hardware.gb200_like()
    dims = (NetworkDim("nvl", n, 900 * GB, 0.5e-6, topology="switch"),
            NetworkDim("scaleout", 4, 900 * GB, 0.5e-6, topology="switch"))
    return Platform(npu=npu, dims=dims, power=PowerModel(57.2e3),
                    name=f"gb200x{n}")


def table7_platforms() -> dict[str, Platform]:
    """The four §VII platform architectures (Fig. 17 / Table VII)."""
    from ..core.hardware import (cs3_like, gb200_like, groqchip_like,
                                 soho_like)
    gpu = Platform(
        npu=gb200_like(),
        dims=(NetworkDim("nvl", 8, 900 * GB, 0.5e-6, topology="switch"),
              NetworkDim("so", 4, 900 * GB, 0.5e-6, topology="switch")),
        power=PowerModel(57.2e3), name="gpus")
    wafer = Platform(
        npu=cs3_like(),
        dims=(NetworkDim("wafer", 1, 214 * PB, 1e-7),),
        power=PowerModel(23e3), name="sram_wafer")
    chips = Platform(
        npu=groqchip_like(),
        dims=(NetworkDim("fc", 64, 3.2 * TB, 2e-7, topology="fc"),
              NetworkDim("ring", 16, 256 * GB, 1e-6, topology="ring")),
        power=PowerModel(276.8e3), name="sram_chips")
    asic = Platform(
        npu=soho_like(),
        dims=(NetworkDim("nvl", 8, 900 * GB, 0.5e-6, topology="switch"),
              NetworkDim("so", 4, 900 * GB, 0.5e-6, topology="switch")),
        power=PowerModel(96e3), name="asics")
    return {p.name: p for p in (gpu, wafer, chips, asic)}


def scaled_out(plat: Platform, tp: int = 32) -> Platform:
    """Fig. 17's big-model variant: append a slow scale-out dimension so a
    TP-32 group fits (used for 405B+ models on the 8-NPU node platforms)."""
    return dataclasses.replace(
        plat, dims=plat.dims + (NetworkDim("scale", 4, 100 * GB, 2e-6,
                                           topology="switch"),),
        name=f"{plat.name}-scaled{tp}")


_FIXED: dict[str, Callable[[], Platform]] = {
    "hgx-h100x8": hgx_h100,
    "gb200x8": gb200_node,
    "v5e-1x16x16": tpu_v5e_pod,
    **{name: (lambda n=name: table7_platforms()[n])
       for name in ("gpus", "sram_wafer", "sram_chips", "asics")},
}

_PARAM_PATTERNS: tuple[tuple[re.Pattern, Callable[..., Platform]], ...] = (
    (re.compile(r"^hgx-h100x(\d+)$"), lambda n: hgx_h100(int(n))),
    (re.compile(r"^gb200x(\d+)$"), lambda n: gb200_node(int(n))),
    (re.compile(r"^v5e-(\d+)x(\d+)x(\d+)$"),
     lambda p, d, m: tpu_v5e_pod(data=int(d), model=int(m), pods=int(p))),
)


def platform_names() -> list[str]:
    """Catalog names (parameterized families shown with their defaults)."""
    return sorted(_FIXED)


def resolve_platform(ref: str | Platform) -> Platform:
    if isinstance(ref, Platform):
        return ref
    if not isinstance(ref, str):
        raise TypeError(f"platform ref must be str or Platform, got "
                        f"{type(ref).__name__}")
    for pat, build in _PARAM_PATTERNS:
        m = pat.match(ref)
        if m:
            return build(*m.groups())
    try:
        return _FIXED[ref]()
    except KeyError:
        raise ValueError(
            f"unknown platform {ref!r}; named platforms: {platform_names()} "
            f"(parameterized: 'hgx-h100x<N>', 'gb200x<N>', "
            f"'v5e-<pods>x<data>x<model>')") from None


def resolve_model(ref: str | ModelSpec) -> ModelSpec:
    if isinstance(ref, ModelSpec):
        return ref
    if not isinstance(ref, str):
        raise TypeError(f"model ref must be str or ModelSpec, got "
                        f"{type(ref).__name__}")
    if ref in PAPER_MODELS:
        return PAPER_MODELS[ref]
    from ..configs import registry
    return registry.get_spec(ref)
