"""Serving launcher: the port's serving engine as a CLI.

    PYTHONPATH=src python -m repro_torch.launch.serve --full --arch minitron-8b
    PYTHONPATH=src python -m repro_torch.launch.serve --full \
        --arch deepseek-moe-16b
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --requests 4
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --layout dense --two-dispatch
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch rwkv6-3b --layout paged --two-dispatch

Serves random-weight models (weights drawn from seed 0).  By default
through the unified paged engine, ``EngineConfig(cache_layout="paged",
unified=True)``; ``--two-dispatch`` selects the two-dispatch engine in the
``--layout`` given (``dense`` is the only layout that serves
sliding-window models; the attention-free rwkv6-3b needs
``--two-dispatch``: the engine refuses it in the unified step, as the
reference does).  The reduced config by default; ``--full`` serves the
published width.  Runs on the card unless ``--device cpu`` is given
(the CPU serves in float32).  Prints per-request outputs and the engine's
metrics.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..configs import registry
from ..device import resolve_device
from ..models import build_model
from ..serving import EngineConfig, Request, SamplingConfig, ServeEngine


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="minitron-8b", choices=registry.ARCH_IDS)
    ap.add_argument("--full", action="store_true",
                    help="serve the published width (default: reduced)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=2048)
    ap.add_argument("--chunk", type=int, default=128)
    ap.add_argument("--layout", default="paged", choices=("paged", "dense"),
                    help="KV cache layout (dense needs --two-dispatch)")
    ap.add_argument("--two-dispatch", action="store_true",
                    help="separate prefill and decode dispatches (default: "
                         "the unified token-packed step)")
    ap.add_argument("--temperature", type=float, default=0.0)
    args = ap.parse_args(argv)

    spec = registry.get_spec(args.arch) if args.full \
        else registry.get_reduced(args.arch)
    dev = resolve_device(args.device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    model = build_model(spec, device=dev, dtype=dtype, seed=0)
    eng = ServeEngine(model, EngineConfig(
        max_slots=args.slots, chunk_size=args.chunk, max_seq=args.max_seq,
        cache_layout=args.layout, unified=not args.two_dispatch),
        device=dev, seed=0)

    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, spec.vocab,
                                        size=int(rng.integers(16, 257))
                                        ).tolist(),
                    max_new_tokens=args.max_new,
                    sampling=SamplingConfig(temperature=args.temperature,
                                            top_k=40))
            for _ in range(args.requests)]
    t0 = time.perf_counter()
    eng.serve(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    for r in reqs:
        print(f"req {r.rid}: {len(r.prompt)} tok prompt -> "
              f"{r.output[:10]}{'...' if len(r.output) > 10 else ''}")
    toks = sum(len(r.output) for r in reqs)
    print(f"\n{spec.name} on {dev} ({dtype}): {len(reqs)} requests, {toks} "
          f"tokens, {dt:.2f}s, {eng.steps} engine steps")
    print(json.dumps(eng.metrics.summary(reqs)))


if __name__ == "__main__":
    main()
