#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``repro_torch``), one H100.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises and exits non-zero):

  build         build every CUDA kernel of the serving paths from
                ``src/repro_torch/csrc`` with nvcc for sm_90a, one nvcc per
                source, all at once
  kernel_check  each kernel against its plain PyTorch version on the card,
                at minitron-8b's attention shapes (Hq=32, Hkv=8, D=128,
                page_size=16) and deepseek-moe-16b's (Hq=Hkv=16; experts
                E=64, D=2048 <-> F=1408), float32 within 1e-4, bfloat16
                within one bf16 ulp plus 1e-4 (under a 2e-2 ceiling), each
                relative to the output's scale where that is not 1 (the
                expert GEMM); median time of each over 50 launches with L2
                flushed in between, beside the plain version's, the bound,
                and one PyTorch call's where one computes the same
                function (flash: scaled_dot_product_attention; expert GEMM:
                torch.bmm):
                  ragged       decode (8 slots, kv_len 1..2048), prefill
                               (max_q=128), idle rows; decode and prefill
                               again at deepseek's G=1
                  paged decode 8 slots, lengths 0..2048
                  flash        prefill (2 rows x 128 queries), partial
                               chunk (37 queries), dense decode (8 slots,
                               Sq=1), sliding window (mistral-7b-swa's
                               W=4096 at 8192 keys)
                  expert GEMM  a mixed step's up/gate (C=264 packed tokens,
                               x broadcast over the experts) and down
                               products, the decode-only step's (C=8), the
                               mixed shape with distinct per-expert x, and
                               two ragged cases (C, D, F off the tiles)
  serve_full    minitron-8b at its published width (32 layers, random bf16
                weights drawn on the card from a seed) served through
                ServeEngine(EngineConfig(cache_layout="paged", unified=True)):
                8 greedy requests of 100-1500 prompt tokens, 32 new tokens
                each; the ragged kernel's launch count must equal
                n_layers x (2 x mixed steps + decode-only steps)
  serve_profile the same model and engine under torch.profiler for a
                short serve: device time by kernel class, the device's
                busy share of the wall clock
  serve_two_dispatch
                the same model and requests through the two-dispatch
                engine, EngineConfig(cache_layout="paged", unified=False)
                and EngineConfig(cache_layout="dense"); launch counts exact:
                paged decode n_layers x decode steps and flash n_layers x
                prefill calls (paged); flash n_layers x (prefill calls +
                decode steps) (dense)
  serve_parity  minitron-8b widths at 2 layers in float32, each engine mode
                served through the kernels and with the plain versions
                selected explicitly: greedy outputs token-identical between
                the two and across the three modes, or diverging only at a
                genuine tie (top-2 logit gap < 1e-4)
  serve_moe     deepseek-moe-16b at its published width (28 layers, 64
                routed experts top-6 + 2 shared, random bf16 weights drawn
                on the card from a seed) through the unified engine, after
                minitron-8b's weights are freed: the same 8 requests; the
                expert GEMM's launches must equal n_layers x 3 x
                dispatches and the ragged kernel's n_layers x (2 x mixed
                steps + decode-only steps); then serve_profile of it
  serve_parity  again at deepseek-moe-16b widths, 2 layers, float32

then the card's name and power limit (nvidia-smi), one JSON line listing
every kernel (launches summed over the main-path serves, error, times,
bound), and last ``{"ok": true, "device": {...}}``.  Without a CUDA device
it exits 1 and prints no result.  Imports nothing of JAX or of the JAX
package.
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
# the same decode and prefill segments at deepseek-moe-16b's attention
# (16 query heads over 16 KV heads: G = 1)
DS_HEADS = dict(hq=16, hkv=16)
PROFILES["deepseek_decode"] = dict(PROFILES["decode"], **DS_HEADS)
PROFILES["deepseek_prefill"] = dict(PROFILES["prefill"], **DS_HEADS)
TIMED = ("decode", "prefill", "deepseek_decode",
         "deepseek_prefill")  # profiles the main paths launch

# paged decode: the same 8 slots, lengths counting the token just written
DECODE_LENGTHS = [1, 17, 255, 0, 640, 1024, 1500, 2048]

# flash forward: (rows, queries, keys, q_offset per row, window); kv_len =
# q_offset + queries.  The two scratch rows of a full and of a partial
# chunk, the dense decode of 8 slots, and mistral-7b-swa's window.
FLASH_PROFILES = {
    "prefill": dict(b=2, sq=128, skv=2048, q_offset=[1372, 128]),
    "prefill_partial": dict(b=2, sq=37, skv=2048, q_offset=[256, 0]),
    "dense_decode": dict(b=8, sq=1, skv=2048,
                         q_offset=[0, 16, 254, 639, 1023, 1499, 2046, 2047]),
    "window": dict(b=1, sq=128, skv=8192, q_offset=[6000], window=4096),
}


def _pools(torch, gen, kv_lens, hkv=HKV):
    """Paged pools on the card with a page run of ``ceil(kv_len / 16)``
    random pages per row; every table entry past a row's kv_len points at
    a junk page filled with 1e4, so a kernel that reads past kv_len
    disagrees loudly."""
    need = [-(-kl // PS) for kl in kv_lens]
    n_junk = 16
    n_pool = 1 + sum(need) + n_junk
    kp = torch.randn((n_pool, hkv, PS, D), generator=gen, device=DEV)
    vp = torch.randn((n_pool, hkv, PS, D), generator=gen, device=DEV)
    junk = list(range(n_pool - n_junk, n_pool))
    kp[junk] = 1e4
    vp[junk] = 1e4
    perm = (torch.randperm(n_pool - 1 - n_junk, generator=gen,
                           device=DEV) + 1).tolist()
    pt = torch.tensor([junk[(i + j) % n_junk] for i in range(len(kv_lens))
                       for j in range(MAX_PAGES)],
                      dtype=torch.int32).reshape(len(kv_lens), MAX_PAGES)
    for i, n in enumerate(need):
        pt[i, :n] = torch.tensor(perm[:n], dtype=torch.int32)
        perm = perm[n:]
    return kp, vp, pt.to(DEV)


def make_case(torch, segs, max_q, dtype, seed, hq=HQ, hkv=HKV):
    """Packed ragged inputs on the card (see ``_pools``)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    kp, vp, pt = _pools(torch, gen, [kl for _, kl in segs], hkv)
    q_start = torch.arange(len(segs), dtype=torch.int32) * max_q
    q = torch.randn((len(segs) * max_q, hq, D), generator=gen, device=DEV)
    return dict(q=q.to(dtype), k_pool=kp.to(dtype), v_pool=vp.to(dtype),
                seg_page_table=pt, q_start=q_start.to(DEV),
                q_len=torch.tensor([s[0] for s in segs], dtype=torch.int32,
                                   device=DEV),
                kv_len=torch.tensor([s[1] for s in segs], dtype=torch.int32,
                                    device=DEV))


def make_decode_case(torch, lengths, dtype, seed):
    """Paged decode inputs on the card (see ``_pools``)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    kp, vp, pt = _pools(torch, gen, lengths)
    q = torch.randn((len(lengths), 1, HQ, D), generator=gen, device=DEV)
    return dict(q=q.to(dtype), k_pool=kp.to(dtype), v_pool=vp.to(dtype),
                page_table=pt,
                lengths=torch.tensor(lengths, dtype=torch.int32, device=DEV))


def make_flash_case(torch, prof, dtype, seed):
    """Dense inputs on the card; every key at or past a row's kv_len is
    1e4, so a kernel that reads past kv_len disagrees loudly."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    b, sq, skv = prof["b"], prof["sq"], prof["skv"]
    q = torch.randn((b, sq, HQ, D), generator=gen, device=DEV)
    k = torch.randn((b, skv, HKV, D), generator=gen, device=DEV)
    v = torch.randn((b, skv, HKV, D), generator=gen, device=DEV)
    qo = torch.tensor(prof["q_offset"], dtype=torch.int32, device=DEV)
    kl = qo + sq
    past = torch.arange(skv, device=DEV)[None, :] >= kl[:, None]
    k[past] = 1e4
    v[past] = 1e4
    return dict(q=q.to(dtype), k=k.to(dtype), v=v.to(dtype), kv_len=kl,
                q_offset=qo, window=prof.get("window"))


# expert GEMM (E, C, D) @ (E, D, F) at deepseek-moe-16b's experts (E 64,
# D 2048 <-> F 1408): the unified engine's mixed step packs 8 decode slots
# and 2 prefill rows of 128 (C = 264), its decode-only step 8 (C = 8).
# ``broadcast``: x is one (C, D) matrix seen by every expert (stride 0), as
# the dense MoE's up and gate products pass it; the down product's x is
# each expert's own activation.
GEMM_PROFILES = {
    "mixed": dict(e=64, c=264, d=2048, f=1408, broadcast=True),
    "mixed_down": dict(e=64, c=264, d=1408, f=2048, broadcast=False),
    "decode": dict(e=64, c=8, d=2048, f=1408, broadcast=True),
    "decode_down": dict(e=64, c=8, d=1408, f=2048, broadcast=False),
    "mixed_distinct": dict(e=64, c=264, d=2048, f=1408, broadcast=False),
    "ragged": dict(e=3, c=37, d=200, f=136, broadcast=False),
    "ragged_broadcast": dict(e=5, c=70, d=72, f=200, broadcast=True),
}
GEMM_TIMED = ("mixed", "mixed_down", "decode", "decode_down")


def make_gemm_case(torch, prof, dtype, seed):
    """x ~ N(0, 1), w ~ N(0, 1/D) on the card: outputs of unit scale."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    e, c, d, f = prof["e"], prof["c"], prof["d"], prof["f"]
    if prof["broadcast"]:
        x = torch.randn((c, d), generator=gen, device=DEV).to(dtype)
        x = x.expand(e, c, d)
    else:
        x = torch.randn((e, c, d), generator=gen, device=DEV).to(dtype)
    w = torch.randn((e, d, f), generator=gen, device=DEV) / d ** 0.5
    return dict(x=x, w=w.to(dtype))


def work_gemm(prof, itemsize):
    """Least bytes and operations of one expert GEMM: x read once (one
    (C, D) matrix when it is broadcast), every expert's w read once, the
    output written once; 2 E C D F operations."""
    e, c, d, f = prof["e"], prof["c"], prof["d"], prof["f"]
    x_elems = c * d if prof["broadcast"] else e * c * d
    nbytes = (x_elems + e * d * f + e * c * f) * itemsize
    return _bound(nbytes, 2 * e * c * d * f)


def bmm_call(torch, case):
    """The one PyTorch call that computes the expert GEMM (the yardstick;
    the port never calls it)."""
    return lambda: torch.bmm(case["x"], case["w"])


def valid_rows(segs, max_q):
    rows = []
    for i, (ql, _) in enumerate(segs):
        rows.extend(range(i * max_q, i * max_q + ql))
    return rows


def _bound(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return dict(bytes=nbytes, flops=flops,
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def work(segs, max_q, itemsize, hq=HQ, hkv=HKV):
    """Least bytes and operations of one ragged launch.  Bytes: the live q
    rows (q_len of each segment) read once, the whole (T, Hq, D) output
    written once (gap rows are zero-filled), K+V of the valid tokens read
    once, and the table entries the walk reads (q_start/q_len/kv_len of
    every segment, ceil(kv_len / page) page ids of each live one).
    Operations: 4 D per visible query-key pair per head."""
    live = [(ql, kl) for ql, kl in segs if ql > 0]
    t = len(segs) * max_q
    nbytes = (sum(ql for ql, _ in live) * hq * D * itemsize
              + t * hq * D * itemsize
              + sum(2 * kl * hkv * D * itemsize for _, kl in live)
              + (3 * len(segs) + sum(-(-kl // PS) for _, kl in live)) * 4)
    pairs = sum(kl - ql + i + 1 for ql, kl in live for i in range(ql))
    return _bound(nbytes, 4 * D * hq * pairs)


def work_decode(lengths, itemsize):
    """Least bytes and operations of one paged decode call: q read and the
    output written once, K+V of each slot's valid tokens read once, its
    ceil(length / page) page ids and its length; 4 D operations per valid
    key per query head."""
    b = len(lengths)
    nbytes = (2 * b * HQ * D * itemsize
              + sum(2 * n * HKV * D * itemsize for n in lengths)
              + (sum(-(-n // PS) for n in lengths) + b) * 4)
    return _bound(nbytes, 4 * D * HQ * sum(lengths))


def _visible(prof):
    """(keys any query of the row sees, visible query-key pairs) per row."""
    out = []
    for qo in prof["q_offset"]:
        kl, w = qo + prof["sq"], prof.get("window")
        spans = [(max(0, qo + i - w + 1) if w else 0, min(kl, qo + i + 1))
                 for i in range(prof["sq"])]
        keys = max(hi for _, hi in spans) - min(lo for lo, _ in spans)
        out.append((keys, sum(max(0, hi - lo) for lo, hi in spans)))
    return out


def work_flash(prof, itemsize):
    """Least bytes and operations of one flash call: q read and the output
    written once, K+V of the keys some query of the row can see (inside
    kv_len, the causal bound and the window) read once, kv_len and
    q_offset; 4 D operations per visible query-key pair per head."""
    vis = _visible(prof)
    nbytes = (2 * prof["b"] * prof["sq"] * HQ * D * itemsize
              + sum(2 * keys * HKV * D * itemsize for keys, _ in vis)
              + 8 * prof["b"])
    return _bound(nbytes, 4 * D * HQ * sum(pairs for _, pairs in vis))


def sdpa_call(torch, case):
    """The one PyTorch call that computes the flash profile's function
    (the yardstick; the port never calls it): scaled_dot_product_attention
    with the boolean visibility mask and grouped-query heads."""
    q, k, v = (case[n].transpose(1, 2).contiguous() for n in "qkv")
    sq, skv = q.shape[2], k.shape[2]
    qpos = case["q_offset"][:, None] + torch.arange(sq, device=DEV)
    kpos = torch.arange(skv, device=DEV)
    mask = (kpos < case["kv_len"][:, None, None]) \
        & (kpos <= qpos[:, :, None])
    if case["window"]:
        mask &= qpos[:, :, None] - kpos < case["window"]
    mask = mask[:, None]
    f = torch.nn.functional.scaled_dot_product_attention
    return lambda: f(q, k, v, attn_mask=mask, enable_gqa=True)


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


def _compare(what, got, want, rtol, scale=1.0):
    """Max abs error of ``got`` against ``want``; every element within
    rtol |want| + F32_ATOL scale and none above the BF16_ATOL scale
    ceiling (written so that NaN fails too)."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    err = float(diff.max())
    if not (bool((diff <= rtol * w.abs() + F32_ATOL * scale).all())
            and err <= BF16_ATOL * scale):
        raise AssertionError(f"{what}: max abs err {err} over {rtol} |want| "
                             f"+ {F32_ATOL} x {scale}")
    return err


def check_profile(torch, kernel, profile, make, run, plain, work_ms, *,
                  rows=None, library=None, timed=True, scaled=False, **info):
    """One profile of one kernel: float32 and bfloat16 against the plain
    version on the same inputs (only on ``rows`` of the output, the rest
    exactly 0, when given; with ``scaled``, the tolerances relative to the
    output's scale, max(1, max |want|)); then in bfloat16 the kernel's,
    the plain version's and (``library``) the yardstick call's median
    times beside the bound."""
    res = dict(info)
    for dtype, rtol, tag in ((torch.float32, 0.0, "f32"),
                             (torch.bfloat16, BF16_RTOL, "bf16")):
        case = make(dtype)
        got, want = run(case), plain(case)
        torch.cuda.synchronize()
        if rows is not None:
            gap = sorted(set(range(got.shape[0])) - set(rows))
            if gap and bool(got[gap].ne(0).any()):
                raise AssertionError(f"{kernel}/{profile}/{tag}: gap rows "
                                     "not zero")
            got, want = got[rows], want[rows]
        scale = max(1.0, float(want.abs().max())) if scaled else 1.0
        res[f"output_scale_{tag}"] = scale
        res[f"max_abs_err_{tag}"] = _compare(f"{kernel}/{profile}/{tag}",
                                             got, want, rtol, scale)
        if tag == "bf16" and timed:
            res["ms"] = median_ms(torch, lambda: run(case), TIMED_LAUNCHES)
            res["plain_ms"] = median_ms(torch, lambda: plain(case),
                                        PLAIN_LAUNCHES)
            res["library_ms"] = (median_ms(torch, library(torch, case),
                                           TIMED_LAUNCHES)
                                 if library else None)
            res.update(work_ms)
        del case, got, want
    emit("kernel_check", kernel=kernel, profile=profile, atol_f32=F32_ATOL,
         rtol_bf16=BF16_RTOL, atol_bf16=F32_ATOL, **res)
    return res


def phase_kernel_check(torch) -> dict:
    """{kernel: {profile: result}} for the four kernels."""
    from repro_torch.kernels import (expert_gemm, flash_attention,
                                     paged_decode_attention,
                                     ragged_attention, ref)

    out = {"ragged_paged_attention": {}, "paged_decode_attention": {},
           "flash_attention": {}, "expert_gemm": {}}
    for name, prof in PROFILES.items():
        segs, max_q = prof["segs"], prof["max_q"]
        heads = {k: prof[k] for k in ("hq", "hkv") if k in prof}
        out["ragged_paged_attention"][name] = check_profile(
            torch, "ragged_paged_attention", name,
            lambda dt: make_case(torch, segs, max_q, dt, seed=len(segs),
                                 **heads),
            lambda c: ragged_attention.ragged_paged_attention_cuda(
                **c, max_q=max_q),
            lambda c: ref.ragged_paged_reference(**c, max_q=max_q),
            work(segs, max_q, 2, **heads), rows=valid_rows(segs, max_q),
            timed=name in TIMED, max_q=max_q, segments=segs, **heads)
    out["paged_decode_attention"]["decode"] = check_profile(
        torch, "paged_decode_attention", "decode",
        lambda dt: make_decode_case(torch, DECODE_LENGTHS, dt, seed=8),
        lambda c: paged_decode_attention.paged_decode_attention_cuda(**c),
        lambda c: ref.paged_decode_reference(**c),
        work_decode(DECODE_LENGTHS, 2), lengths=DECODE_LENGTHS,
        split_keys=paged_decode_attention.SPLIT_KEYS)
    for name, prof in FLASH_PROFILES.items():
        out["flash_attention"][name] = check_profile(
            torch, "flash_attention", name,
            lambda dt: make_flash_case(torch, prof, dt, seed=prof["sq"]),
            lambda c: flash_attention.flash_attention_cuda(**c),
            lambda c: ref.mha_reference(**c),
            work_flash(prof, 2), library=sdpa_call, **prof)
    for name, prof in GEMM_PROFILES.items():
        out["expert_gemm"][name] = check_profile(
            torch, "expert_gemm", name,
            lambda dt: make_gemm_case(torch, prof, dt, seed=prof["c"]),
            lambda c: expert_gemm.expert_gemm_cuda(**c),
            lambda c: ref.moe_gemm_reference(**c),
            work_gemm(prof, 2), library=bmm_call,
            timed=name in GEMM_TIMED, scaled=True, **prof)
    return out


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

GEOMETRY = dict(max_slots=8, prefill_rows=2, chunk_size=128, page_size=16,
                max_seq=2048)
MODES = {"unified": dict(cache_layout="paged", unified=True),
         "paged": dict(cache_layout="paged", unified=False),
         "dense": dict(cache_layout="dense", unified=False)}
MAX_NEW = 32


def kernel_modules():
    """{kernel name: wrapper module}; each module's ``launches`` counts."""
    from repro_torch.kernels import (expert_gemm, flash_attention,
                                     paged_decode_attention,
                                     ragged_attention)
    return {"ragged_paged_attention": ragged_attention,
            "paged_decode_attention": paged_decode_attention,
            "flash_attention": flash_attention,
            "expert_gemm": expert_gemm}


def expert_launches_per_forward(spec) -> int:
    """Expert GEMM launches of one forward: 3 per MoE layer (up, gate,
    down) with swiglu, 2 without a gate; 0 for a dense model."""
    if spec.moe is None:
        return 0
    per_layer = 3 if spec.act == "swiglu" else 2
    return per_layer * sum(spec.moe.is_moe_layer(i)
                           for i in range(spec.n_layers))


def make_requests(spec, n, max_new, seed):
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, spec.vocab,
                                        size=int(rng.integers(100, 1501))
                                        ).tolist(),
                    max_new_tokens=max_new) for _ in range(n)]


def serve_counted(torch, model, spec, mode):
    """Serve the 8 main-path requests through ``mode`` with every kernel
    count set to 0 just before and read just after; every request must
    finish with MAX_NEW tokens in the vocabulary."""
    from repro_torch.serving import EngineConfig, ServeEngine
    cfg = EngineConfig(**GEOMETRY, **MODES[mode])
    eng = ServeEngine(model, cfg, device=DEV)
    reqs = make_requests(spec, 8, MAX_NEW, seed=0)
    mods = kernel_modules()
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    for mod in mods.values():
        mod.launches = 0
    t0 = time.perf_counter()
    eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: mod.launches for name, mod in mods.items()}
    for r in reqs:
        if r.state != "done":
            raise AssertionError(f"{mode}: request {r.rid} not done "
                                 f"({r.state})")
        if len(r.output) != MAX_NEW:
            raise AssertionError(f"{mode}: request {r.rid}: "
                                 f"{len(r.output)} tokens")
        if any(not 0 <= t < spec.vocab for t in r.output):
            raise AssertionError(f"{mode}: request {r.rid}: token out of "
                                 "range")
    m = eng.metrics
    s = m.summary(reqs)
    stats = dict(mode=mode, requests=len(reqs),
                 prompt_tokens=sum(len(r.prompt) for r in reqs),
                 generated_tokens=m.generated_tokens, steps=m.steps,
                 decode_steps=m.decode_steps, prefill_calls=m.prefill_calls,
                 dispatches=m.dispatches, transfers_d2h=m.transfers_d2h,
                 preemptions=m.preemptions, wall_s=wall,
                 tokens_per_s=m.generated_tokens / wall,
                 ttft_s_mean=s["ttft_s_mean"], tpot_s_mean=s["tpot_s_mean"],
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                 launches=counts)
    return eng, stats


def _expect(mode, counts, want):
    if counts != want:
        raise AssertionError(f"{mode}: kernel launches {counts}, expected "
                             f"{want}")


def phase_serve_unified(torch, model, spec, init_s, phase) -> dict:
    """The unified engine, then its profile (``phase`` names the serve's
    line); returns the serve's kernel launch counts."""
    from repro_torch.serving import EngineConfig, Request, ServeEngine

    cfg = EngineConfig(**GEOMETRY, **MODES["unified"])
    # warm-up on a throwaway engine (cuBLAS handles, first launches)
    ServeEngine(model, cfg, device=DEV).serve(
        [Request(prompt=list(range(1, 40)), max_new_tokens=2)])
    eng, stats = serve_counted(torch, model, spec, "unified")
    m = eng.metrics
    if m.transfers_d2h != m.dispatches:
        raise AssertionError(f"{m.transfers_d2h} transfers != "
                             f"{m.dispatches} dispatches")
    mixed = m.prefill_calls
    decode_only = m.dispatches - mixed
    _expect("unified", stats["launches"], {
        "ragged_paged_attention": spec.n_layers * (2 * mixed + decode_only),
        "paged_decode_attention": 0, "flash_attention": 0,
        "expert_gemm": expert_launches_per_forward(spec) * m.dispatches})
    n_params = sum(p.numel() for p in model.parameters())
    emit(phase, model=spec.name, params=n_params,
         weight_gb=n_params * 2 / 1e9, init_s=init_s, mixed_steps=mixed,
         decode_only_steps=decode_only, **stats)
    del eng
    phase_serve_profile(torch, model, spec, cfg)
    return stats["launches"]


def build_full(torch, arch):
    """``arch`` at its published width, random bf16 weights drawn on the
    card from seed 0; returns (spec, model, seconds to build)."""
    from repro_torch.configs import get_spec
    from repro_torch.models import build_model
    spec = get_spec(arch)
    t0 = time.perf_counter()
    model = build_model(spec, device=DEV, dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    return spec, model, time.perf_counter() - t0


def free(torch):
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve_two_dispatch(torch, model, spec) -> list[dict]:
    """The two-dispatch engine in both layouts; returns each serve's
    kernel launch counts."""
    out = []
    for mode in ("paged", "dense"):
        eng, stats = serve_counted(torch, model, spec, mode)
        m = eng.metrics
        n = spec.n_layers
        want = {"ragged_paged_attention": 0,
                "paged_decode_attention": n * m.decode_steps,
                "flash_attention": n * m.prefill_calls,
                "expert_gemm": expert_launches_per_forward(spec)
                * (m.decode_steps + m.prefill_calls)}
        if mode == "dense":
            want.update(paged_decode_attention=0,
                        flash_attention=n * (m.prefill_calls
                                             + m.decode_steps))
        _expect(mode, stats["launches"], want)
        emit("serve_two_dispatch", model=spec.name, **stats,
             kv=eng.kv_stats())
        out.append(stats["launches"])
        del eng
        free(torch)
    return out


def _kernel_class(name: str) -> str:
    n = name.lower()
    if "ragged_paged_attention" in n:
        return "ragged_attention"
    if "expert_gemm" in n:
        return "expert_gemm"
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
    emit("serve_profile", model=spec.name, steps=m.steps,
         mixed_steps=m.prefill_calls,
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


def _ties(torch, model, prompts, a, b, what):
    """Where outputs ``a`` and ``b`` part, the top-2 logit gap at the first
    differing token; raises unless every divergence is a genuine tie."""
    ties = []
    for i, (x, y) in enumerate(zip(a, b)):
        if x == y:
            continue
        j = next(k for k in range(min(len(x), len(y))) if x[k] != y[k])
        top2 = _last_logits(torch, model, prompts[i] + x[:j]).topk(2).values
        gap = float(top2[0] - top2[1])
        ties.append({"request": i, "position": j, "tokens": [x[j], y[j]],
                     "top2_gap": gap})
        if not gap < TIE_GAP:
            raise AssertionError(f"serve_parity {what}: request {i} "
                                 f"diverges at token {j} with top-2 gap "
                                 f"{gap}")
    return ties


def phase_serve_parity(torch, arch) -> None:
    """``arch``'s widths at 2 layers in float32, every engine mode through
    the kernels and through the plain versions."""
    from repro_torch.configs import get_spec
    from repro_torch.models import build_model
    from repro_torch.serving import EngineConfig, ServeEngine

    spec = get_spec(arch).scaled(name=f"{arch}-2l", n_layers=2)
    model = build_model(spec, device=DEV, dtype=torch.float32, seed=1)
    outs = {}
    for mode, kw in MODES.items():
        for impl in ("kernel", "plain"):
            model.kernel_impl = impl
            reqs = make_requests(spec, 8, 16, seed=1)
            ServeEngine(model, EngineConfig(**GEOMETRY, **kw),
                        device=DEV).serve(reqs)
            outs[mode, impl] = [r.output for r in reqs]
            prompts = [r.prompt for r in reqs]
    model.kernel_impl = "plain"
    pairs = [((mode, "kernel"), (mode, "plain")) for mode in MODES] + [
        (("unified", "kernel"), (mode, "kernel")) for mode in ("paged",
                                                                "dense")]
    comparisons = {}
    for a, b in pairs:
        what = f"{'/'.join(a)} vs {'/'.join(b)}"
        comparisons[what] = {
            "identical": sum(x == y for x, y in zip(outs[a], outs[b])),
            "ties": _ties(torch, model, prompts, outs[a], outs[b], what)}
    emit("serve_parity", model=spec.name, dtype="float32",
         requests=len(prompts),
         tokens=sum(len(o) for o in outs["unified", "kernel"]),
         comparisons=comparisons)
    del model
    free(torch)


def kernel_entry(name, mod, launches, profiles, top):
    """The kernels line's entry of one kernel: ``top`` names the profile
    whose numbers stand at the top level (all timed profiles follow)."""
    timed = {p: r for p, r in profiles.items() if "ms" in r}
    t = timed[top]
    return {"name": name, "route": "cuda", "source": mod.SOURCE,
            "replaces": mod.REPLACES, "launches": launches,
            "max_abs_err": max(r["max_abs_err_bf16"]
                               for r in profiles.values()),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "top_profile": top,
            "profiles": {p: {k: r[k] for k in
                             ("ms", "plain_ms", "library_ms", "bound_ms",
                              "bound_by", "max_abs_err_f32",
                              "max_abs_err_bf16")}
                         for p, r in timed.items()}}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()

    mods = kernel_modules()
    names = [Path(mod.SOURCE).stem for mod in mods.values()]
    t0 = time.perf_counter()
    built = build.build_all(names)
    for name in names:
        build.load(name)
    emit("build", seconds=time.perf_counter() - t0,
         compile_seconds={n: b.seconds for n, b in built.items()},
         libraries=[str(b.path.relative_to(ROOT)) for b in built.values()],
         ptxas={n: [ln.strip() for ln in b.log.splitlines()
                    if "registers" in ln or "spill" in ln]
                for n, b in built.items()},
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    checks = phase_kernel_check(torch)

    spec, model, init_s = build_full(torch, "minitron-8b")
    serves = [phase_serve_unified(torch, model, spec, init_s, "serve_full")]
    serves += phase_serve_two_dispatch(torch, model, spec)
    del model
    free(torch)
    phase_serve_parity(torch, "minitron-8b")

    spec, model, init_s = build_full(torch, "deepseek-moe-16b")
    serves.append(phase_serve_unified(torch, model, spec, init_s,
                                      "serve_moe"))
    del model
    free(torch)
    phase_serve_parity(torch, "deepseek-moe-16b")

    launches = {name: sum(c[name] for c in serves) for name in mods}
    tops = {"ragged_paged_attention": "decode",
            "paged_decode_attention": "decode", "flash_attention": "prefill",
            "expert_gemm": "mixed"}
    kernels = [kernel_entry(name, mod, launches[name], checks[name],
                            tops[name]) for name, mod in mods.items()]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
