"""Run chosen phases of ``chip_smoke.py``, from this checkout or another.

    python3 scripts/chip_phases.py [--root DIR] PHASE [PHASE ...]

PHASE is one of ``chip_smoke.TRAIN_STACKS`` (``train_moe``,
``train_rwkv``, ``train_jamba``) or ``kernel_check:NAME[,NAME...]`` (the
named kernels' checks).  With ``--root DIR`` the ``chip_smoke.py`` and
``src/`` of the checkout at DIR run instead, for example an unpacked
``git archive`` of a parent commit under ``build/``, so that two commits'
phases compare in one run on one card.  Every kernel source of that
checkout is built first, in parallel; each phase prints its own JSON
lines, and the last line is the card's name and power limit.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path


def main(argv: list[str]) -> int:
    root = Path(__file__).resolve().parents[1]
    if argv[:1] == ["--root"] and len(argv) > 1:
        root, argv = Path(argv[1]).resolve(), argv[2:]
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
            cs.phase_kernel_check(torch, set(phase.split(":")[1].split(",")))
        elif phase in cs.TRAIN_STACKS:
            cs.phase_train_stack(torch, phase)
        else:
            print(f"chip_phases: unknown phase {phase!r}", file=sys.stderr)
            return 2
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
