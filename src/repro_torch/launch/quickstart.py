"""Quickstart: the declarative Scenario API of the port (paper Fig. 2; the
counterpart of the reference's ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.launch.quickstart

One ``Scenario`` object describes (model x use case x platform x
parallelism x serving optimization); ``Sweep`` builds grids around it and
``run()`` prices every cell through the analytical backend — the same
object lowers onto the port's ``ServeEngine`` on the card via
``run(..., backend="engine")``.  This script estimates TTFT / TPOT /
throughput / energy for LLaMA3-70B chat serving on an HGX-H100 node,
sweeps tensor parallelism, prints the §VI platform requirements for
GPT-4-class models, and prices chunked-prefill iterations (§IV-A).
"""

from __future__ import annotations

from ..core import Workload
from ..scenario import ChunkedSpec, Scenario, Sweep, run

FP8 = dict(weight_dtype="fp8", act_dtype="fp8", kv_dtype="fp8")


def main(argv: list[str] | None = None) -> None:
    base = Scenario.make("llama3-70b", use_case="chat", batch=16,
                         platform="hgx-h100x8", opt=FP8)

    print("== llama3-70b, chat (3000 in / 1000 out), batch 16 ==")
    for rep in run(Sweep(base).over(tp=[2, 4, 8])):
        fits = "fits" if rep.fits_memory else "OOM "
        print(f"  TP={rep.scenario.parallelism.tp}:  "
              f"TTFT {rep.ttft_s*1e3:7.1f} ms | "
              f"TPOT {rep.tpot_s*1e3:6.2f} ms | "
              f"{rep.throughput_tok_s:7.0f} tok/s | "
              f"{rep.energy_per_token_j:5.2f} J/tok | {fits}")

    print("\n== decode runtime breakdown (TP=8) ==")
    rep, = run([base.replace(parallelism=dict(tp=8))])
    for part, t in rep.extra["decode"]["breakdown"].items():
        print(f"  {part:12s} {t*1e3:7.2f} ms")

    print("\n== §VI platform requirements, QA+RAG use case ==")
    reqs = Sweep(Scenario.make("llama3-8b", use_case="qa_rag", batch=1,
                               opt=FP8)).over(
        model=["llama3-8b", "llama3-70b", "gpt3-175b", "gpt4-1.8t"])
    for rep in run(reqs):
        q = rep.extra["requirements"]
        print(f"  {rep.scenario.model_name:12s} "
              f"{q['mem_capacity_gb']:8.0f} GB | "
              f"{q['compute_pflops']:6.1f} PFLOPS | "
              f"{q['mem_bw_tbps']:5.1f} TB/s")

    print("\n== chunked prefill (paper §IV-A), llama3-70b ==")
    for dec_b in (1, 32, 128):
        sc = Scenario.make(
            "llama3-70b", workload=Workload(batch=dec_b, tau_p=4096,
                                            tau_d=1024),
            batch=dec_b, platform="hgx-h100x8", parallelism=dict(tp=8),
            opt=FP8, mode="chunked",
            chunked=ChunkedSpec(chunk=512, decode_batch=dec_b))
        rep, = run([sc])
        br = rep.extra["chunked"]["breakdown"]
        print(f"  decode_batch={dec_b:3d}: "
              f"iter {rep.extra['chunked']['time_s']*1e3:6.2f} ms "
              f"(linear {br['linear']*1e3:5.2f}, "
              f"attn {br['attention']*1e3:5.2f})")

    print("\n== same Scenario, JSON round trip ==")
    blob = base.to_json()
    assert Scenario.from_json(blob) == base
    print(f"  Scenario.from_json(to_json()) == scenario "
          f"({len(blob)} bytes)")


if __name__ == "__main__":
    main()
