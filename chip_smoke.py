#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``repro_torch``), one H100.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises and exits non-zero):

  build         build (or load) every CUDA kernel of the serving path from
                ``src/repro_torch/csrc`` with nvcc for sm_90a
  kernel_check  each kernel against its plain PyTorch version on the card,
                at minitron-8b's attention shapes (Hq=32, Hkv=8, D=128,
                page_size=16): the decode profile (max_q=1, 8 slots, kv_len
                1..2048) and the prefill profile (max_q=128, full and
                partial chunks, idle rows, pages past kv_len); float32
                within 1e-4, bfloat16 within one bf16 ulp plus 1e-4 on
                valid rows; median time of each over 50 launches with L2
                flushed in between
  serve_full    minitron-8b at its published width (32 layers, random bf16
                weights drawn on the card from a seed) served through
                ServeEngine(EngineConfig(cache_layout="paged", unified=True)):
                8 greedy requests of 100-1500 prompt tokens, 32 new tokens
                each; the ragged kernel's launch count must equal
                n_layers x (2 x mixed steps + decode-only steps)
  serve_profile the same model and engine under torch.profiler for a
                short serve: device time by kernel class, the device's
                busy share of the wall clock
  serve_parity  minitron-8b widths at 2 layers in float32, served twice
                (through the kernel, then with the plain attention selected
                explicitly): greedy outputs token-identical, or diverging
                only at a genuine tie (top-2 logit gap < 1e-4)

then the card's name and power limit (nvidia-smi), one JSON line listing
every kernel (launches on the main path, error, times, bound), and last
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1 and
prints no result.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

F32_ATOL = 1e-4  # kernel vs plain, float32: f32 sums in different orders
# kernel vs plain, bfloat16: both accumulate in f32 (within F32_ATOL) and
# round once, so an element may differ by one bf16 ulp (<= 2^-7 |want|)
# more; never more than BF16_ATOL in all
BF16_RTOL = 2.0 ** -7
BF16_ATOL = 2e-2
TIE_GAP = 1e-4  # serve_parity: a divergence is a tie below this gap
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor rate, published
TIMED_LAUNCHES = 50
PLAIN_LAUNCHES = 20
SPIN_CYCLES = 5_000_000  # ~3 ms at H100 clocks: longer than any enqueue
DEV = "cuda"


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# kernel_check
# ---------------------------------------------------------------------------

HQ, HKV, D, PS, MAX_PAGES = 32, 8, 128, 16, 128  # minitron-8b attention

# (q_len, kv_len) segments in the engine's fixed layouts: the decode
# sub-batch (8 slots at offsets 0..7, one idle) and the prefill sub-batch
# (2 rows of a 128-token chunk each)
PROFILES = {
    "decode": dict(max_q=1, segs=[(1, 1), (1, 17), (1, 255), (0, 0),
                                  (1, 640), (1, 1024), (1, 1500),
                                  (1, 2048)]),
    "prefill": dict(max_q=128, segs=[(128, 1500), (37, 293)]),
    "prefill_idle": dict(max_q=128, segs=[(100, 100), (0, 0)]),
}
TIMED = ("decode", "prefill")  # profiles the main path launches


def make_case(torch, segs, max_q, dtype, seed):
    """Packed inputs on the card: random pages per segment; every table
    entry past a segment's kv_len points at a junk page filled with 1e4, so
    a kernel that reads past kv_len disagrees loudly."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    need = [-(-kl // PS) for _, kl in segs]
    n_junk = 16
    n_pool = 1 + sum(need) + n_junk
    kp = torch.randn((n_pool, HKV, PS, D), generator=gen, device=DEV)
    vp = torch.randn((n_pool, HKV, PS, D), generator=gen, device=DEV)
    junk = list(range(n_pool - n_junk, n_pool))
    kp[junk] = 1e4
    vp[junk] = 1e4
    perm = (torch.randperm(n_pool - 1 - n_junk, generator=gen,
                           device=DEV) + 1).tolist()
    pt = torch.tensor([junk[(i + j) % n_junk] for i in range(len(segs))
                       for j in range(MAX_PAGES)],
                      dtype=torch.int32).reshape(len(segs), MAX_PAGES)
    for i, n in enumerate(need):
        pt[i, :n] = torch.tensor(perm[:n], dtype=torch.int32)
        perm = perm[n:]
    q_start = torch.arange(len(segs), dtype=torch.int32) * max_q
    t = len(segs) * max_q
    q = torch.randn((t, HQ, D), generator=gen, device=DEV)
    return dict(q=q.to(dtype), k_pool=kp.to(dtype), v_pool=vp.to(dtype),
                seg_page_table=pt.to(DEV), q_start=q_start.to(DEV),
                q_len=torch.tensor([s[0] for s in segs], dtype=torch.int32,
                                   device=DEV),
                kv_len=torch.tensor([s[1] for s in segs], dtype=torch.int32,
                                    device=DEV))


def valid_rows(segs, max_q):
    rows = []
    for i, (ql, _) in enumerate(segs):
        rows.extend(range(i * max_q, i * max_q + ql))
    return rows


def work(segs, max_q, itemsize):
    """Least bytes and operations of one launch.  Bytes: the live q rows
    (q_len of each segment) read once, the whole (T, Hq, D) output written
    once (gap rows are zero-filled), K+V of the valid tokens read once, and
    the table entries the walk reads (q_start/q_len/kv_len of every
    segment, ceil(kv_len / page) page ids of each live one).  Operations:
    4 D per visible query-key pair per head."""
    live = [(ql, kl) for ql, kl in segs if ql > 0]
    t = len(segs) * max_q
    nbytes = (sum(ql for ql, _ in live) * HQ * D * itemsize
              + t * HQ * D * itemsize
              + sum(2 * kl * HKV * D * itemsize for _, kl in live)
              + (3 * len(segs) + sum(-(-kl // PS) for _, kl in live)) * 4)
    pairs = sum(kl - ql + i + 1 for ql, kl in live for i in range(ql))
    flops = 4 * D * HQ * pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return dict(bytes=nbytes, flops=flops,
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def median_ms(torch, fn, n):
    """Median device time of one call over n calls, each after a 64 MiB
    write that evicts the 50 MB L2 (the serving step finds the pools
    cold: a whole layer runs between two launches).  A spin of SPIN_CYCLES
    before each call keeps the card busy while the host enqueues it, so
    the events time the device's work, not the host's Python."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)
    fn()  # warm-up
    torch.cuda.synchronize()
    events = []
    for _ in range(n):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def phase_kernel_check(torch) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.ragged_attention import \
        ragged_paged_attention_cuda

    results = {}
    for name, prof in PROFILES.items():
        segs, max_q = prof["segs"], prof["max_q"]
        rows = valid_rows(segs, max_q)
        res = {"max_q": max_q, "segments": segs}
        for dtype, rtol, atol, tag in (
                (torch.float32, 0.0, F32_ATOL, "f32"),
                (torch.bfloat16, BF16_RTOL, F32_ATOL, "bf16")):
            case = make_case(torch, segs, max_q, dtype, seed=len(segs))
            got = ragged_paged_attention_cuda(**case, max_q=max_q)
            want = ref.ragged_paged_reference(**case, max_q=max_q)
            torch.cuda.synchronize()
            g, w = got[rows].float(), want[rows].float()
            diff = (g - w).abs()
            err = float(diff.max())
            gap = sorted(set(range(got.shape[0])) - set(rows))
            if gap and bool(got[gap].ne(0).any()):
                raise AssertionError(f"{name}/{tag}: gap rows not zero")
            # written so that NaN fails too
            if not (bool((diff <= rtol * w.abs() + atol).all())
                    and err <= BF16_ATOL):
                raise AssertionError(f"{name}/{tag}: max abs err {err} over "
                                     f"{rtol} |want| + {atol}")
            res[f"max_abs_err_{tag}"] = err
            if tag == "bf16" and name in TIMED:
                res["ms"] = median_ms(torch, lambda: (
                    ragged_paged_attention_cuda(**case, max_q=max_q)),
                    TIMED_LAUNCHES)
                res["plain_ms"] = median_ms(torch, lambda: (
                    ref.ragged_paged_reference(**case, max_q=max_q)),
                    PLAIN_LAUNCHES)
                res.update(work(segs, max_q, 2))
            del case, got, want
        results[name] = res
        emit("kernel_check", profile=name, atol_f32=F32_ATOL,
             rtol_bf16=BF16_RTOL, atol_bf16=F32_ATOL, **res)
    return results


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

GEOMETRY = dict(max_slots=8, prefill_rows=2, chunk_size=128, page_size=16,
                max_seq=2048, cache_layout="paged", unified=True)


def make_requests(spec, n, max_new, seed):
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, spec.vocab,
                                        size=int(rng.integers(100, 1501))
                                        ).tolist(),
                    max_new_tokens=max_new) for _ in range(n)]


def phase_serve_full(torch) -> int:
    from repro_torch.configs import get_spec
    from repro_torch.kernels import ragged_attention
    from repro_torch.models import build_model
    from repro_torch.serving import EngineConfig, Request, ServeEngine

    spec = get_spec("minitron-8b")
    t0 = time.perf_counter()
    model = build_model(spec, device=DEV, dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    cfg = EngineConfig(**GEOMETRY)
    # warm-up on a throwaway engine (cuBLAS handles, first launches)
    ServeEngine(model, cfg, device=DEV).serve(
        [Request(prompt=list(range(1, 40)), max_new_tokens=2)])
    eng = ServeEngine(model, cfg, device=DEV)
    reqs = make_requests(spec, 8, 32, seed=0)
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    ragged_attention.launches = 0
    t0 = time.perf_counter()
    eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ragged_attention.launches
    m = eng.metrics
    for r in reqs:
        if r.state != "done":
            raise AssertionError(f"request {r.rid} not done ({r.state})")
        hit_eos_or_cap = len(r.output) < 32 and (
            len(r.prompt) + len(r.output) >= cfg.max_seq - 1)
        if len(r.output) != 32 and not hit_eos_or_cap:
            raise AssertionError(f"request {r.rid}: {len(r.output)} tokens")
        if any(not 0 <= t < spec.vocab for t in r.output):
            raise AssertionError(f"request {r.rid}: token out of range")
    if m.transfers_d2h != m.dispatches:
        raise AssertionError(f"{m.transfers_d2h} transfers != "
                             f"{m.dispatches} dispatches")
    mixed = m.prefill_calls
    decode_only = m.dispatches - mixed
    want = spec.n_layers * (2 * mixed + decode_only)
    if launches != want:
        raise AssertionError(f"ragged kernel launched {launches} times, "
                             f"expected {want}")
    s = m.summary(reqs)
    emit("serve_full", model=spec.name, params=n_params,
         weight_gb=n_params * 2 / 1e9, init_s=init_s,
         requests=len(reqs),
         prompt_tokens=sum(len(r.prompt) for r in reqs),
         generated_tokens=m.generated_tokens, steps=m.steps,
         mixed_steps=mixed, decode_only_steps=decode_only,
         preemptions=m.preemptions, wall_s=wall,
         tokens_per_s=m.generated_tokens / wall,
         ttft_s_mean=s["ttft_s_mean"], tpot_s_mean=s["tpot_s_mean"],
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         ragged_launches=launches, ragged_launches_expected=want)
    phase_serve_profile(torch, model, spec, cfg)
    del model, eng
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _kernel_class(name: str) -> str:
    n = name.lower()
    if "ragged_paged_attention" in n:
        return "ragged_attention"
    if any(k in n for k in ("gemm", "gemv", "cutlass", "xmma", "cublas",
                            "nvjet")):
        return "matmul"
    if "sort" in n or "radix" in n:
        return "sampling_sort"
    if "index" in n or "scatter" in n or "gather" in n:
        return "index"
    if "memcpy" in n or "memset" in n:
        return "copy"
    return "other"


def phase_serve_profile(torch, model, spec, cfg) -> None:
    """Where a step's time goes: torch.profiler over a short serve (8
    requests of 100-1500 prompt tokens, 8 new tokens each), device time
    summed by kernel class, against the wall clock of the same steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import ServeEngine

    eng = ServeEngine(model, cfg, device=DEV)
    reqs = make_requests(spec, 8, 8, seed=2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.serve(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_class: dict[str, float] = {}
    launches = 0
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue  # host-side ops and runtime calls
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        cls = _kernel_class(ev.key)
        by_class[cls] = by_class.get(cls, 0.0) + dev_us / 1e3
        launches += ev.count
    busy = sum(by_class.values())
    m = eng.metrics
    emit("serve_profile", steps=m.steps, mixed_steps=m.prefill_calls,
         decode_only_steps=m.dispatches - m.prefill_calls,
         wall_ms=wall * 1e3, device_busy_ms=busy,
         device_busy_share=busy / (wall * 1e3),
         kernel_launches=launches,
         device_ms_by_class=dict(sorted(by_class.items(),
                                        key=lambda kv: -kv[1])))


def _last_logits(torch, model, tokens):
    """Logits after ``tokens`` through the packed step alone: one prefill
    segment walked chunk by chunk on a fresh cache (plain attention)."""
    from repro_torch.models.attention import PackedSegs
    chunk, ps = GEOMETRY["chunk_size"], GEOMETRY["page_size"]
    max_pages = GEOMETRY["max_seq"] // ps
    cache = model.init_cache(1, GEOMETRY["max_seq"], page_size=ps,
                             n_pages=max_pages + 1)
    ptab = torch.arange(1, max_pages + 1, dtype=torch.int32,
                        device=DEV)[None]
    logits = None
    for lo in range(0, len(tokens), chunk):
        w = min(chunk, len(tokens) - lo)
        packed = PackedSegs(
            q_start=torch.zeros(1, dtype=torch.int32, device=DEV),
            q_len=torch.tensor([w], dtype=torch.int32, device=DEV),
            kv_len=torch.tensor([lo + w], dtype=torch.int32, device=DEV),
            page_table=ptab, max_q=chunk)
        toks = torch.tensor(tokens[lo:lo + w], device=DEV)
        pos = torch.arange(lo, lo + w, dtype=torch.int32, device=DEV)
        logits, cache = model.unified_step(cache, toks, pos, packed)
    return logits[0].float()


def phase_serve_parity(torch) -> None:
    from repro_torch.configs import get_spec
    from repro_torch.models import build_model
    from repro_torch.serving import EngineConfig, ServeEngine

    spec = get_spec("minitron-8b").scaled(name="minitron-8b-2l",
                                          n_layers=2)
    model = build_model(spec, device=DEV, dtype=torch.float32, seed=1)
    outs = {}
    for impl in ("kernel", "plain"):
        model.attn_impl = impl
        reqs = make_requests(spec, 8, 16, seed=1)
        ServeEngine(model, EngineConfig(**GEOMETRY), device=DEV).serve(reqs)
        outs[impl] = [r.output for r in reqs]
        prompts = [r.prompt for r in reqs]
    model.attn_impl = "plain"
    ties = []
    for i, (a, b) in enumerate(zip(outs["kernel"], outs["plain"])):
        if a == b:
            continue
        j = next(k for k in range(min(len(a), len(b))) if a[k] != b[k])
        top2 = _last_logits(torch, model, prompts[i] + a[:j]).topk(2).values
        gap = float(top2[0] - top2[1])
        ties.append({"request": i, "position": j, "kernel": a[j],
                     "plain": b[j], "top2_gap": gap})
        if not gap < TIE_GAP:
            raise AssertionError(f"serve_parity: request {i} diverges at "
                                 f"token {j} with top-2 gap {gap}")
    emit("serve_parity", model=spec.name, dtype="float32",
         requests=len(prompts),
         identical=sum(a == b for a, b in zip(outs["kernel"],
                                              outs["plain"])),
         tokens=sum(len(o) for o in outs["kernel"]), ties=ties)
    del model
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build, ragged_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()

    t0 = time.perf_counter()
    built = build.build("ragged_paged_attention")
    build.load("ragged_paged_attention")
    ptxas = [ln.strip() for ln in built.log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=time.perf_counter() - t0,
         compile_seconds=built.seconds,
         library=str(built.path.relative_to(ROOT)), ptxas=ptxas,
         nvidia_smi=smi)

    checks = phase_kernel_check(torch)
    launches = phase_serve_full(torch)
    phase_serve_parity(torch)

    dec = checks["decode"]
    kernels = [{
        "name": "ragged_paged_attention",
        "route": "cuda",
        "source": ragged_attention.SOURCE,
        "replaces": ragged_attention.REPLACES,
        "launches": launches,
        # the decode profile: the launch every serving step makes per layer
        "max_abs_err": max(c["max_abs_err_bf16"] for c in checks.values()),
        "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": None,
        "profiles": {name: {k: checks[name][k] for k in
                            ("ms", "plain_ms", "bound_ms", "bound_by",
                             "max_abs_err_f32", "max_abs_err_bf16")}
                     for name in TIMED},
    }]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
