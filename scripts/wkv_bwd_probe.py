"""Measure the design choices of the WKV scan's backward on the card.

Run from the repository root on a machine with an H100 and the CUDA
toolkit:

    python3 scripts/wkv_bwd_probe.py [VARIANT ...]

At ``chip_smoke.py``'s timed ``rwkv6_scan_bwd`` profiles (bf16) it prints
one JSON line per profile and source:

* ``stages``: the device time of each of the call's three kernels
  (``wkv_bwd_local``, ``wkv_bwd_carry``, ``wkv_bwd_walk``), summed by
  ``torch.profiler`` over LAUNCHES back-to-back calls of the committed
  source (L2 warm), and the call's median as ``chip_smoke.median_ms``
  times it (L2 flushed before every call);
* ``sources``: edited copies of the source (the named VARIANTS, all of
  them without arguments), built into ``build/wkv_bwd_variants/`` and
  held against the plain backward at ``chip_smoke.py``'s tolerances, each
  with its median time beside the committed source's, in turns (source,
  variant, source).

The last line is the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import rwkv6_scan_bwd as wb  # noqa: E402

LAUNCHES = 20
VARIANT_DIR = ROOT / "build" / "wkv_bwd_variants"
REVERSE = ("#pragma unroll\n    for (int tt = kSub - 1; tt >= 0; --tt) {\n"
           "      if (tt >= ns) continue;\n")
W64 = "RT = 4, THREADS = 256, SUB = 4, SEG = 8, MIN_BLOCKS = 2;"
BATCH = "constexpr int kCarryBatch = 16;"


def shape(rows, threads, sub, seg, per_sm):
    """The walk at N = 64 on another block: the source's Walk<64> and the
    wrapper's WALK[64] both changed."""
    return dict(edits=[(W64, f"RT = {rows}, THREADS = {threads}, SUB = "
                             f"{sub}, SEG = {seg}, MIN_BLOCKS = {per_sm};")],
                walk=(rows, threads, sub, seg, per_sm))


#: each variant: the source edits (text in the source, its stand-in) and
#: the walk shape at N = 64 the wrapper plans for (None: WALK's)
VARIANTS = {
    # 8-step sub-chunks, one block an SM
    "sub8_1sm": shape(4, 256, 8, 8, 1),
    # 2 x 4 elements a thread, 512 threads, one block an SM
    "rt2_t512_sub8_1sm": shape(2, 512, 8, 8, 1),
    # the reverse walk's steps two at a time (a loop, not unrolled whole)
    "reverse_unroll2": dict(edits=[(REVERSE, "#pragma unroll 2\n    for "
                                    "(int tt = ns - 1; tt >= 0; --tt) {\n")]),
    # the carry's loads 8 chunks at a time
    "carry_batch8": dict(edits=[(BATCH, BATCH.replace("16", "8"))]),
    # the carry launched after the local stage completes, and the walk
    # after the carry
    "no_pdl": dict(edits=[("  carry_cfg.numAttrs = items > 0 ? 1 : 0;",
                           "  carry_cfg.numAttrs = 0;"),
                          ("  cfg.numAttrs = 1;", "  cfg.numAttrs = 0;")]),
}


def emit(part, profile, **kw):
    print(json.dumps({"part": part, "profile": profile, **kw}), flush=True)


def build_variant(name, edits):
    """The entry point of a copy of the source with ``edits`` applied."""
    d = VARIANT_DIR / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(build.CSRC, d)
    src = d / "rwkv6_scan_bwd.cu"
    text = src.read_text()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{name}: the source no longer has {old!r}")
        text = text.replace(old, new)
    src.write_text(text)
    lib = d / "lib.so"
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o",
                           str(lib), str(src)], check=True,
                          capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).rwkv6_scan_bwd_launch
    fn.argtypes, fn.restype = list(wb._ARGTYPES), ctypes.c_int
    regs = [ln.strip() for ln in proc.stderr.splitlines()
            if "Used" in ln or "stack frame" in ln]
    return fn, regs


def with_entry(fn, walk, call):
    """``call()`` with the backward's entry point swapped for ``fn`` and,
    when ``walk`` is given, the wrapper planning the walk at N = 64 on
    that block."""
    entry, planned = build.entry, wb.WALK[64]
    build.entry = (lambda name, symbol, argtypes: fn
                   if name == "rwkv6_scan_bwd"
                   else entry(name, symbol, argtypes))
    wb.WALK[64] = walk or planned
    try:
        return call()
    finally:
        build.entry, wb.WALK[64] = entry, planned


def check(name, prof, got, want):
    errs = []
    for gname, g, w in zip(("dr", "dk", "dv", "dw", "du", "dstate0"), got,
                           want):
        rtol = cs.BF16_RTOL if gname in ("dr", "dk", "dv") else 0.0
        errs.append(cs._compare(f"{name}/{prof}/{gname}", g, w, rtol,
                                max(1.0, cs._amax(w))))
    return max(errs)


def stage_times(call):
    """Device ms per call of each kernel, summed by torch.profiler."""
    call()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(LAUNCHES):
            call()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if "wkv_bwd_" in ev.key and us:
            stage = ev.key.split("wkv_bwd_")[1].split("<")[0]
            out[stage] = out.get(stage, 0.0) + us / 1e3 / LAUNCHES
    return out


def main(argv):
    names = argv or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        print(f"wkv_bwd_probe: unknown variants {unknown}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("wkv_bwd_probe: no CUDA device", file=sys.stderr)
        return 1
    build.build_all(["rwkv6_scan_bwd"])
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        built = dict(zip(names, pool.map(
            lambda n: build_variant(n, VARIANTS[n]["edits"]), names)))
    for name in names:
        emit("build", name, ptxas=built[name][1])
    for prof_name in cs.RWKV_BWD_TIMED:
        prof = cs.RWKV_BWD_PROFILES[prof_name]
        case = cs.make_rwkv_bwd_case(torch, prof, torch.bfloat16,
                                     seed=prof["t"])
        args = [case[k] for k in ("r", "k", "v", "w", "u", "bounds",
                                  "dout", "dstate")]

        def call():
            return wb.rwkv6_scan_bwd_cuda(*args, chunk=case["chunk"])

        want = ref.rwkv6_bwd_reference(*args, chunk=case["chunk"])
        err = check("source", prof_name, call(), want)
        emit("stages", prof_name, max_abs_err=err,
             ms=cs.median_ms(torch, call, cs.TIMED_LAUNCHES),
             stage_ms=stage_times(call), plan=vars(wb._plan(
                 *cs.rwkv_dims(prof))), **cs.work_rwkv_bwd(prof, 2))
        for name in names:
            fn, walk = built[name][0], VARIANTS[name].get("walk")

            def variant():
                return with_entry(fn, walk, call)

            err = check(name, prof_name, variant(), want)
            again = variant()
            torch.cuda.synchronize()
            bitwise = all(torch.equal(x, y)
                          for x, y in zip(variant(), again))
            times = [cs.median_ms(torch, f, cs.TIMED_LAUNCHES)
                     for f in (call, variant, call)]
            emit("sources", prof_name, variant=name, max_abs_err=err,
                 bitwise_equal=bitwise, ms_source_variant_source=times,
                 stage_ms=stage_times(variant))
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
