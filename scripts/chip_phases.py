"""Run chosen phases of ``chip_smoke.py``, from this checkout or another.

    python3 scripts/chip_phases.py [--root DIR] [--profile] PHASE [PHASE ...]

PHASE is one of ``chip_smoke.TRAIN_STACKS`` (``train_moe``,
``train_rwkv``, ``train_jamba``), ``kernel_check:NAME[,NAME...]`` (the
named kernels' checks), or a phase that ``chip_smoke`` runs as
``phase_PHASE(torch)`` alone (``mesh_parity``, ``train_mesh``, ``train``,
``train_parity``, ``train_restart``, ``tp_parity``).  With ``--root DIR`` the ``chip_smoke.py`` and
``src/`` of the checkout at DIR run instead, for example an unpacked
``git archive`` of a parent commit under ``build/``, so that two commits'
phases compare in one run on one card.  Every kernel source of that
checkout is built first, in parallel; each phase prints its own JSON
lines, and the last line is the card's name and power limit.  With
``--profile`` each phase runs under ``torch.profiler`` and a ``device``
line follows it: the summed device time of every kernel the phase ran
(``device_ms``), the TOP kernels by it, and the named kernels' own sums
(``wkv_bwd``, ``wkv_`` and so on: the kernels whose name holds the key).
Unlike a phase's own times, which a slow host stretches when it cannot
enqueue work fast enough, these sums count only the card's work.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path


TOP = 12
#: kernel name parts whose device time a profiled phase also sums apart
KEYS = ("wkv_bwd", "wkv", "gemm", "elementwise", "reduce")
#: chip_smoke phases that take only ``torch``
STANDALONE = ("mesh_parity", "train_mesh", "train", "train_parity",
              "train_restart", "tp_parity")


def device_times(prof) -> dict:
    """Device ms of each kernel a profiled run launched, by name."""
    from torch.autograd import DeviceType
    out: dict[str, float] = {}
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        out[ev.key] = out.get(ev.key, 0.0) + us / 1e3
    return out


def main(argv: list[str]) -> int:
    root = Path(__file__).resolve().parents[1]
    if argv[:1] == ["--root"] and len(argv) > 1:
        root, argv = Path(argv[1]).resolve(), argv[2:]
    profile = argv[:1] == ["--profile"]
    argv = argv[1:] if profile else argv
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path[:0] = [str(root), str(root / "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        print("chip_phases: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    names = sorted({Path(m.SOURCE).stem
                    for m in cs.kernel_modules().values()})
    t0 = time.perf_counter()
    build.build_all(names)
    cs.emit("build", root=str(root), sources=names,
            seconds=time.perf_counter() - t0)
    for phase in argv:
        if phase.startswith("kernel_check:"):
            def run(phase=phase):
                cs.phase_kernel_check(torch,
                                      set(phase.split(":")[1].split(",")))
        elif phase in cs.TRAIN_STACKS:
            def run(phase=phase):
                cs.phase_train_stack(torch, phase)
        elif phase in STANDALONE:
            def run(phase=phase):
                getattr(cs, f"phase_{phase}")(torch)
        else:
            print(f"chip_phases: unknown phase {phase!r}", file=sys.stderr)
            return 2
        if not profile:
            run()
            continue
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            run()
            torch.cuda.synchronize()
        ms = device_times(prof)
        top = sorted(ms.items(), key=lambda kv: -kv[1])[:TOP]
        cs.emit("device", root=str(root), of=phase,
                device_ms=sum(ms.values()),
                top={name[:120]: t for name, t in top},
                keys={key: sum(t for name, t in ms.items() if key in name)
                      for key in KEYS})
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
