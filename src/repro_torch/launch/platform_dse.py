"""Design-space exploration (paper §VII; the counterpart of the
reference's ``examples/platform_dse.py``): compare platform architectures
for a workload you pick, then print the winner per metric — the paper's
"which platform should I build/buy?" loop, one Scenario per platform
priced by the port's analytical backend.

    PYTHONPATH=src python -m repro_torch.launch.platform_dse \
        --model llama3-405b --input 8192 --output 1024 --batch 8
"""

from __future__ import annotations

import argparse

from ..core import Workload
from ..scenario import Scenario, run, table7_platforms

FP8 = dict(weight_dtype="fp8", act_dtype="fp8", kv_dtype="fp8")

PARS = {"gpus": dict(tp=32), "sram_wafer": dict(),
        "sram_chips": dict(tp=64, pp=16), "asics": dict(tp=32)}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="llama3-405b")
    ap.add_argument("--input", type=int, default=8192)
    ap.add_argument("--output", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args(argv)

    wl = Workload(batch=args.batch, tau_p=args.input, tau_d=args.output)
    scs = []
    for name, plat in table7_platforms().items():
        par = dict(PARS[name])
        total = 1
        for v in par.values():
            total *= v
        if total > plat.num_npus:
            par = dict(tp=plat.num_npus)
        scs.append(Scenario.make(args.model, workload=wl, batch=args.batch,
                                 platform=plat, parallelism=par, opt=FP8,
                                 tag=name))

    print(f"workload: {args.model}, {args.input}/{args.output} tokens, "
          f"batch {args.batch} (fp8)\n")
    print(f"{'platform':12s} {'TTFT s':>8s} {'TPOT ms':>9s} "
          f"{'tok/s':>9s} {'tok/kWh':>10s} {'fits':>5s}")
    results = []
    for rep in run(scs):
        name = rep.scenario.tag
        if rep.status in ("infeasible", "error"):
            print(f"{name:12s} config error: {rep.error}")
            continue
        dec = rep.extra["decode"]
        fits = rep.fits_memory
        thr = dec["tokens_per_s"] if fits else 0.0
        e_tok = dec["energy_j"] / max(wl.batch, 1)
        tpkwh = 3.6e6 / e_tok if (fits and e_tok) else 0.0
        results.append((name, thr, tpkwh))
        print(f"{name:12s} {rep.ttft_s:8.2f} {dec['tpot']*1e3:9.2f} "
              f"{thr:9.0f} {tpkwh:10.0f} {'Y' if fits else 'OOM':>5s}")

    if results:
        best_perf = max(results, key=lambda r: r[1])
        best_eff = max(results, key=lambda r: r[2])
        print(f"\nbest throughput : {best_perf[0]}")
        print(f"best perf/energy: {best_eff[0]}")


if __name__ == "__main__":
    main()
