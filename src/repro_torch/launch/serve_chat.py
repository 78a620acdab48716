"""End-to-end serving example of the port (the counterpart of the
reference's ``examples/serve_chat.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve_chat
    PYTHONPATH=src python -m repro_torch.launch.serve_chat --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_chat --device cpu --beam
    PYTHONPATH=src python -m repro_torch.launch.serve_chat --device cpu \
        --speculative

Builds the reduced configuration of ``--arch`` with random weights (seed 0)
and drives the continuous-batching engine (the two-dispatch dense engine
with ``--prefill-rows`` concurrent chunked prefills, sampled at temperature
0.8, top-k 40) over a batch of mixed-length requests, then reports each
request's TTFT and the engine's throughput.  ``--speculative`` routes one
request through the batch-1 speculative decoder (draft = the same model);
``--beam`` through beam search (4 beams).  Runs on the card unless
``--device cpu`` is given (the CPU serves in float32, the card in
bfloat16).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import registry
from ..device import resolve_device
from ..models import build_model
from ..serving import (BeamSearcher, EngineConfig, Request, SamplingConfig,
                       ServeEngine, SpeculativeDecoder)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b",
                    choices=registry.ARCH_IDS)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--prefill-rows", type=int, default=2,
                    help="concurrent chunked prefills (scratch rows)")
    ap.add_argument("--speculative", action="store_true")
    ap.add_argument("--beam", action="store_true")
    args = ap.parse_args(argv)

    spec = registry.get_reduced(args.arch)
    dev = resolve_device(args.device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    print(f"arch={args.arch} (reduced: d={spec.d_model}, L={spec.n_layers}, "
          f"vocab={spec.vocab}) on {dev} ({dtype})")
    model = build_model(spec, device=dev, dtype=dtype, seed=0)
    n = sum(p.numel() for p in model.parameters())
    print(f"params: {n / 1e6:.2f}M")

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, spec.vocab,
                            size=int(rng.integers(4, 24))).tolist()
               for _ in range(args.requests)]

    if args.beam:
        bs = BeamSearcher(model, beam_size=4, max_seq=256)
        t0 = time.perf_counter()
        toks, score = bs.search(prompts[0], args.max_new)
        print(f"beam search: {toks[:12]}... score/len {score:.3f} "
              f"({time.perf_counter() - t0:.1f}s)")
        return

    if args.speculative:
        sd = SpeculativeDecoder(model, model, n_spec=4, max_seq=256,
                                temperature=0.7)
        t0 = time.perf_counter()
        out = sd.generate(prompts[0], args.max_new)
        dt = time.perf_counter() - t0
        print(f"speculative: {len(out)} tokens in {dt:.1f}s | acceptance "
              f"{sd.stats.acceptance_rate:.2f} | "
              f"{sd.stats.tokens_per_pass:.2f} tok/target-pass")
        return

    eng = ServeEngine(model, EngineConfig(max_slots=4, max_seq=256,
                                          chunk_size=16,
                                          prefill_rows=args.prefill_rows),
                      device=dev, seed=1)
    reqs = [Request(prompt=p, max_new_tokens=args.max_new,
                    sampling=SamplingConfig(temperature=0.8, top_k=40))
            for p in prompts]
    t0 = time.perf_counter()
    eng.serve(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    toks = sum(len(r.output) for r in reqs)
    print(f"\nserved {len(reqs)} requests / {toks} tokens in {dt:.1f}s "
          f"({toks / dt:.1f} tok/s, {eng.steps} engine steps)")
    m = eng.metrics.summary(reqs)
    if "ttft_s_p50" in m:  # absent when no request finished
        print(f"metrics: ttft p50 {m['ttft_s_p50'] * 1e3:.0f}ms "
              f"p95 {m['ttft_s_p95'] * 1e3:.0f}ms | "
              f"tpot {m['tpot_s_mean'] * 1e3:.1f}ms | "
              f"occupancy {m['mean_slot_occupancy']:.2f} | "
              f"{m['prefill_calls']} prefill calls")
    for r in reqs[:4]:
        print(f"  req {r.rid}: prompt {len(r.prompt):3d} tok -> "
              f"{r.output[:8]}... (ttft_step={r.ttft_steps}, "
              f"ttft={r.ttft_s * 1e3:.0f}ms)")


if __name__ == "__main__":
    main()
