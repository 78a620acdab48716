#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``repro_torch``), one H100.

    python3 chip_smoke.py                      # every phase
    python3 chip_smoke.py --kernels NAME,...   # build + kernel_check only

Phases, each printing one JSON line (any failure raises and exits non-zero):

  build         build every CUDA kernel of the serving paths from
                ``src/repro_torch/csrc`` with nvcc for sm_90a, one nvcc per
                source, all at once (six kernels)
  kernel_check  each kernel against its plain PyTorch version on the card,
                at minitron-8b's attention shapes (Hq=32, Hkv=8, D=128,
                page_size=16), deepseek-moe-16b's (Hq=Hkv=16; experts
                E=64, D=2048 <-> F=1408) and rwkv6-3b's (H=40 heads of
                N=64), float32 within 1e-4, bfloat16 within one bf16 ulp
                plus 1e-4 (under a 2e-2 ceiling), each relative to the
                output's scale where that is not 1 (the expert GEMM and the
                WKV scan); median time of each over 50 launches with L2
                flushed in between, beside the plain version's, the bound,
                and one PyTorch call's where one computes the same
                function (flash and dense decode:
                scaled_dot_product_attention; expert GEMM: torch.bmm):
                  ragged       decode (8 slots, kv_len 1..2048), prefill
                               (max_q=128), idle rows; decode and prefill
                               again at deepseek's G=1; untimed, the edges
                               of the paged tensor-core walk: page sizes 8
                               and 128, prefill segments packed back to
                               back, D=64 at G=3, D=16, kv_len off the
                               64-key tiles beside an idle segment, a
                               4096-key table at 2 slots (the split's cap),
                               and D=72, which takes the CUDA-core walk in
                               bf16 too
                  paged decode 8 slots, lengths 0..2048; untimed, the same
                               edges
                  flash        prefill (2 rows x 128 queries), partial
                               chunk (37 queries), dense decode (8 slots,
                               Sq=1), sliding window (mistral-7b-swa's
                               W=4096 at 8192 keys); prefill and decode
                               again at deepseek's G=1; untimed, the
                               tensor-core tile edges: D=64 (Hq 24 over
                               Hkv 8) at 37 queries, D=16, a row with
                               kv_len 0 beside a 24-key window (16
                               queries and a decode), and D=72, which
                               takes the CUDA-core walk in bf16 too
                  expert GEMM  a mixed step's up/gate (C=264 packed tokens,
                               x broadcast over the experts) and down
                               products, the decode-only step's (C=8), the
                               mixed shape with distinct per-expert x, and
                               two ragged cases (C, D, F off the tiles)
                  WKV scan     prefill (2 rows x 128 steps), partial chunk
                               (37 steps), decode (8 rows x 1 step); a
                               non-zero state0 and bonus, decays in
                               (0.45, 0.95); out and final state both held;
                               untimed, the decode in place at N 64,
                               N 16 and 32 at 37 steps; after every other
                               kernel's profiles (so that they are timed
                               as before), the plan's edges: the decode
                               in place at N 16 and 32, 161 steps (ring
                               turns and a ragged tail), one row (80
                               blocks), no step (the final state is
                               state0), decays exp(-exp(x)) for x in
                               [-8, 3]; the line prints the bf16 plan
                  dense decode 8 rows against a 2048-key cache, lengths
                               0..2048, at G=4 and at deepseek's G=1;
                               untimed, G=3 at D=64
                the ragged, paged decode, flash and dense decode lines
                name the route each dtype took (bf16 at D % 16 == 0,
                D <= 128: tensor_core; else cuda_core) and the bf16 launch
                plan
  decode_op     the dense decode's path: kernels.ops.decode_attention, its
                entry point (no model routes to it, as in the reference),
                once per layer of a minitron-8b decode step; its launches
                must equal the calls
  serve_full    minitron-8b at its published width (32 layers, random bf16
                weights drawn on the card from a seed) served through
                ServeEngine(EngineConfig(cache_layout="paged", unified=True)):
                8 greedy requests of 100-1500 prompt tokens, 32 new tokens
                each, first on the eager engine (graphs=False), then on the
                replay engine (the main path: each step one CUDA-graph
                replay), each engine warmed by one short request that binds
                (on the replay engine: captures) both step profiles; in
                each run the ragged kernel's launch count must equal
                n_layers x (2 x mixed steps + decode-only steps), every
                launch on the tensor-core route, and dispatches == d2h
                copies == steps; each line gives TTFT, TPOT, tokens/s, host
                ms per step, the device ms of each step's profile run (CUDA
                events around it), the captures per profile (exactly 1),
                capture seconds and graph-pool MB; an eager_vs_replay line
                holds the two runs' greedy outputs token-identical (or
                parting only at a genuine tie, top-2 logit gap < 1e-4)
  serve_profile the same model and replay engine under torch.profiler for a
                short serve: device time by kernel class (a replay's
                kernels keep their names), graph launches, the device's
                busy share of the wall clock
  serve_two_dispatch
                the same model and requests through the two-dispatch
                engine, EngineConfig(cache_layout="paged", unified=False)
                and EngineConfig(cache_layout="dense"), eager then replay
                (each decode step one replay; the prefill chunks eager);
                launch counts exact in each run: paged decode n_layers x
                decode steps and flash n_layers x prefill calls (paged);
                flash n_layers x (prefill calls + decode steps) (dense),
                every flash and paged decode call on the tensor-core route
                (each line prints the calls of each route); eager_vs_replay
                lines as above; then serve_profile of the dense replay
                engine, where flash launches most
  serve_parity  minitron-8b widths at 2 layers in float32, each engine mode
                served on the replay engine through the kernels and with
                the plain versions selected explicitly, and on the eager
                engine through the kernels: greedy outputs token-identical
                between kernel and plain, replay and eager, and across the
                three modes, or diverging only at a genuine tie (top-2
                logit gap < 1e-4)
  debug_guards  minitron-8b widths at 2 layers in bf16, the unified and the
                paged two-dispatch replay engines with
                EngineConfig(debug_guards=True): token-identical to the
                unguarded engines; a .item() inside the step guard raises
                (torch.cuda.set_sync_debug_mode("error")); binding a
                profile again, or a foreign key, raises "recapture"
  serve_moe     deepseek-moe-16b at its published width (28 layers, 64
                routed experts top-6 + 2 shared, random bf16 weights drawn
                on the card from a seed) through the unified engine, eager
                then replay, after minitron-8b's weights are freed: the same
                8 requests; the expert GEMM's launches must equal n_layers
                x 3 x dispatches and the ragged kernel's n_layers x (2 x
                mixed steps + decode-only steps); then serve_profile of the
                replay engine
  serve_parity  again at deepseek-moe-16b widths, 2 layers, float32
  serve_rwkv    rwkv6-3b at its published width (32 RWKV-6 layers, random
                bf16 weights drawn on the card from a seed, the token-shift
                mixes and the bonus drawn non-zero) through the dense and
                the paged two-dispatch engines, eager then replay, after
                deepseek's weights are freed: the same 8 requests; the WKV
                scan's launches must equal n_layers x (prefill calls +
                decode steps) and every other kernel's 0; then
                serve_profile of the dense replay engine
  serve_parity  again at rwkv6-3b widths, 2 layers, float32, mixes and
                bonus drawn non-zero, in the two two-dispatch layouts

A replay does not run the kernel wrappers: the step graph adds each
capture's launch counts on every replay, so the counts above hold on both
engines with the same formulas.

After the phases: the card's name and power limit (nvidia-smi), one JSON
line listing every kernel (launches summed over its main-path runs,
error, times, bound), and last ``{"ok": true, "device": {...}}``.  Without
a CUDA device it exits 1 and prints no result.  Imports nothing of JAX or
of the JAX package.
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
F32_FLOPS = 67e12  # H100 SXM f32 rate outside the tensor cores, published
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
# untimed, the edges of the paged tensor-core walk: page sizes 8 and 128
# (a page a fraction of a 64-key tile, and two tiles a page); prefill
# segments packed back to back (q_start 0, 37, 137: a row written past
# its segment lands on the next one); granite-moe's D = 64 at G = 3 and
# the reduced configs' D = 16; kv_len off the 64-key tiles beside an idle
# segment; a 4,096-key table at 2 slots, which asks the split for more
# than the combine's 32; and D = 72, which takes the CUDA-core walk in bf16
# too
_EDGE_SEGS = [(16, 200), (1, 33), (5, 5)]
PROFILES.update({
    "page8": dict(PROFILES["decode"], ps=8, max_pages=256),
    "page128": dict(PROFILES["prefill"], ps=128, max_pages=16),
    "tight_prefill": dict(max_q=128, packed=True,
                          segs=[(37, 300), (100, 1100), (5, 64)]),
    "granite_d64": dict(max_q=128, segs=[(1, 700), (37, 293), (0, 0),
                                         (128, 1500)], hq=24, hkv=8, d=64),
    "reduced_d16": dict(max_q=16, packed=True, segs=_EDGE_SEGS, hq=8,
                        hkv=2, d=16),
    "odd_lengths_idle": dict(max_q=64, segs=[(64, 1000), (0, 0), (13, 77),
                                             (1, 65)]),
    "long_pool": dict(max_q=1, segs=[(1, 4096), (1, 2113)], max_pages=256),
    "d72_cuda_core": dict(max_q=16, segs=_EDGE_SEGS, hq=8, hkv=2, d=72),
})
TIMED = ("decode", "prefill", "deepseek_decode",
         "deepseek_prefill")  # profiles the main paths launch

# paged decode: the same 8 slots, lengths counting the token just written;
# untimed, the same edges as the ragged kernel's
DECODE_LENGTHS = [1, 17, 255, 0, 640, 1024, 1500, 2048]
_EDGE_LENGTHS = [1, 40, 0, 300]
PAGED_DECODE_PROFILES = {
    "decode": dict(lengths=DECODE_LENGTHS),
    "page8": dict(lengths=DECODE_LENGTHS, ps=8, max_pages=256),
    "page128": dict(lengths=DECODE_LENGTHS, ps=128, max_pages=16),
    "granite_d64": dict(lengths=DECODE_LENGTHS, hq=24, hkv=8, d=64),
    "reduced_d16": dict(lengths=_EDGE_LENGTHS, hq=8, hkv=2, d=16,
                        max_pages=32),
    "odd_lengths": dict(lengths=[65, 0, 127, 1000, 1, 63]),
    "long_pool": dict(lengths=[4096, 2113], max_pages=256),
    "d72_cuda_core": dict(lengths=_EDGE_LENGTHS, hq=8, hkv=2, d=72,
                          max_pages=32),
}
PAGED_DECODE_TIMED = ("decode",)

# flash forward: (rows, queries, keys, q_offset per row, window); kv_len =
# q_offset + queries unless given.  The two scratch rows of a full and of a
# partial chunk, the dense decode of 8 slots, and mistral-7b-swa's window;
# the same prefill and decode at deepseek-moe-16b's heads (G = 1, the head
# shape of its two-dispatch serve).  Then, untimed, the edges of the
# tensor-core tiles: granite-moe's D = 64 heads (Hq 24 over Hkv 8) at a
# partial chunk, the reduced configs' D = 16, one row with kv_len 0 beside
# a window narrower than one 64-key tile (a 16-query chunk, and a decode),
# and D = 72 (a multiple of 8, not
# of 16), which takes the CUDA-core walk in bf16 too.
FLASH_PROFILES = {
    "prefill": dict(b=2, sq=128, skv=2048, q_offset=[1372, 128]),
    "prefill_partial": dict(b=2, sq=37, skv=2048, q_offset=[256, 0]),
    "dense_decode": dict(b=8, sq=1, skv=2048,
                         q_offset=[0, 16, 254, 639, 1023, 1499, 2046, 2047]),
    "window": dict(b=1, sq=128, skv=8192, q_offset=[6000], window=4096),
    "deepseek_prefill": dict(b=2, sq=128, skv=2048, q_offset=[1372, 128],
                             **DS_HEADS),
    "deepseek_decode": dict(b=8, sq=1, skv=2048,
                            q_offset=[0, 16, 254, 639, 1023, 1499, 2046,
                                      2047], **DS_HEADS),
    "granite_d64_partial": dict(b=2, sq=37, skv=2048, q_offset=[256, 0],
                                hq=24, hkv=8, d=64),
    "reduced_d16": dict(b=2, sq=37, skv=512, q_offset=[300, 0], hq=8, hkv=2,
                        d=16),
    "kv_len0_narrow_window": dict(b=3, sq=16, skv=512,
                                  q_offset=[200, 0, 400],
                                  kv_len=[216, 0, 416], window=24),
    "decode_kv_len0_window": dict(b=3, sq=1, skv=512,
                                  q_offset=[215, 0, 415],
                                  kv_len=[216, 0, 416], window=24),
    "d72_cuda_core": dict(b=2, sq=37, skv=512, q_offset=[300, 0], hq=8,
                          hkv=2, d=72),
}
FLASH_TIMED = ("prefill", "prefill_partial", "dense_decode", "window",
               "deepseek_prefill", "deepseek_decode")


def head_dims(prof):
    """(Hq, Hkv, D) of a profile (minitron-8b's unless it says)."""
    return prof.get("hq", HQ), prof.get("hkv", HKV), prof.get("d", D)


def paged_dims(prof):
    """(Hq, Hkv, D, page size, table width) of a ragged or paged decode
    profile (minitron-8b's heads and the engine's 128 pages of 16 unless
    it says)."""
    return head_dims(prof) + (prof.get("ps", PS),
                              prof.get("max_pages", MAX_PAGES))


def _pools(torch, gen, kv_lens, hkv, d, ps, max_pages):
    """Paged pools on the card with a page run of ``ceil(kv_len / ps)``
    random pages per row; every table entry past a row's kv_len points at
    a junk page filled with 1e4, so a kernel that reads past kv_len
    disagrees loudly."""
    need = [-(-kl // ps) for kl in kv_lens]
    n_junk = 16
    n_pool = 1 + sum(need) + n_junk
    kp = torch.randn((n_pool, hkv, ps, d), generator=gen, device=DEV)
    vp = torch.randn((n_pool, hkv, ps, d), generator=gen, device=DEV)
    junk = list(range(n_pool - n_junk, n_pool))
    kp[junk] = 1e4
    vp[junk] = 1e4
    perm = (torch.randperm(n_pool - 1 - n_junk, generator=gen,
                           device=DEV) + 1).tolist()
    pt = torch.tensor([junk[(i + j) % n_junk] for i in range(len(kv_lens))
                       for j in range(max_pages)],
                      dtype=torch.int32).reshape(len(kv_lens), max_pages)
    for i, n in enumerate(need):
        pt[i, :n] = torch.tensor(perm[:n], dtype=torch.int32)
        perm = perm[n:]
    return kp, vp, pt.to(DEV)


def q_starts(prof):
    """Each segment's first packed row: the engine's fixed layout (segment
    i at i max_q), or back to back when the profile is ``packed``."""
    lens = [ql for ql, _ in prof["segs"]]
    if prof.get("packed"):
        return [sum(lens[:i]) for i in range(len(lens))]
    return [i * prof["max_q"] for i in range(len(lens))]


def make_case(torch, prof, dtype, seed):
    """Packed ragged inputs on the card (see ``_pools``)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    segs = prof["segs"]
    hq, hkv, d, ps, max_pages = paged_dims(prof)
    kp, vp, pt = _pools(torch, gen, [kl for _, kl in segs], hkv, d, ps,
                        max_pages)
    starts = q_starts(prof)
    t = (starts[-1] + segs[-1][0] if prof.get("packed")
         else len(segs) * prof["max_q"])
    q = torch.randn((t, hq, d), generator=gen, device=DEV)
    return dict(q=q.to(dtype), k_pool=kp.to(dtype), v_pool=vp.to(dtype),
                seg_page_table=pt,
                q_start=torch.tensor(starts, dtype=torch.int32, device=DEV),
                q_len=torch.tensor([s[0] for s in segs], dtype=torch.int32,
                                   device=DEV),
                kv_len=torch.tensor([s[1] for s in segs], dtype=torch.int32,
                                    device=DEV))


def make_decode_case(torch, prof, dtype, seed):
    """Paged decode inputs on the card (see ``_pools``)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    lengths = prof["lengths"]
    hq, hkv, d, ps, max_pages = paged_dims(prof)
    kp, vp, pt = _pools(torch, gen, lengths, hkv, d, ps, max_pages)
    q = torch.randn((len(lengths), 1, hq, d), generator=gen, device=DEV)
    return dict(q=q.to(dtype), k_pool=kp.to(dtype), v_pool=vp.to(dtype),
                page_table=pt,
                lengths=torch.tensor(lengths, dtype=torch.int32, device=DEV))


def make_flash_case(torch, prof, dtype, seed):
    """Dense inputs on the card; every key at or past a row's kv_len is
    1e4, so a kernel that reads past kv_len disagrees loudly."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    b, sq, skv = prof["b"], prof["sq"], prof["skv"]
    hq, hkv, d = head_dims(prof)
    q = torch.randn((b, sq, hq, d), generator=gen, device=DEV)
    k = torch.randn((b, skv, hkv, d), generator=gen, device=DEV)
    v = torch.randn((b, skv, hkv, d), generator=gen, device=DEV)
    qo = torch.tensor(prof["q_offset"], dtype=torch.int32, device=DEV)
    kl = (torch.tensor(prof["kv_len"], dtype=torch.int32, device=DEV)
          if "kv_len" in prof else qo + sq)
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


def valid_rows(prof):
    """The packed rows of the profile's live segments."""
    rows = []
    for start, (ql, _) in zip(q_starts(prof), prof["segs"]):
        rows.extend(range(start, start + ql))
    return rows


def _bound(nbytes, flops, peak=BF16_FLOPS):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return dict(bytes=nbytes, flops=flops,
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def work(prof, itemsize):
    """Least bytes and operations of one ragged launch.  Bytes: the live q
    rows (q_len of each segment) read once, the whole (T, Hq, D) output
    written once (gap rows are zero-filled), K+V of the valid tokens read
    once, and the table entries the walk reads (q_start/q_len/kv_len of
    every segment, ceil(kv_len / page) page ids of each live one).
    Operations: 4 D per visible query-key pair per head."""
    segs = prof["segs"]
    hq, hkv, d, ps, _ = paged_dims(prof)
    live = [(ql, kl) for ql, kl in segs if ql > 0]
    t = (sum(ql for ql, _ in segs) if prof.get("packed")
         else len(segs) * prof["max_q"])
    nbytes = (sum(ql for ql, _ in live) * hq * d * itemsize
              + t * hq * d * itemsize
              + sum(2 * kl * hkv * d * itemsize for _, kl in live)
              + (3 * len(segs) + sum(-(-kl // ps) for _, kl in live)) * 4)
    pairs = sum(kl - ql + i + 1 for ql, kl in live for i in range(ql))
    return _bound(nbytes, 4 * d * hq * pairs)


def work_decode(prof, itemsize):
    """Least bytes and operations of one paged decode call: q read and the
    output written once, K+V of each slot's valid tokens read once, its
    ceil(length / page) page ids and its length; 4 D operations per valid
    key per query head."""
    lengths = prof["lengths"]
    hq, hkv, d, ps, _ = paged_dims(prof)
    b = len(lengths)
    nbytes = (2 * b * hq * d * itemsize
              + sum(2 * n * hkv * d * itemsize for n in lengths)
              + (sum(-(-n // ps) for n in lengths) + b) * 4)
    return _bound(nbytes, 4 * d * hq * sum(lengths))


def _visible(prof):
    """(keys any query of the row sees, visible query-key pairs) per row."""
    out = []
    for r, qo in enumerate(prof["q_offset"]):
        kl = prof["kv_len"][r] if "kv_len" in prof else qo + prof["sq"]
        w = prof.get("window")
        spans = [(max(0, qo + i - w + 1) if w else 0, min(kl, qo + i + 1))
                 for i in range(prof["sq"])]
        spans = [(lo, hi) for lo, hi in spans if hi > lo]
        keys = (max(hi for _, hi in spans) - min(lo for lo, _ in spans)
                if spans else 0)
        out.append((keys, sum(hi - lo for lo, hi in spans)))
    return out


def work_flash(prof, itemsize):
    """Least bytes and operations of one flash call: q read and the output
    written once, K+V of the keys some query of the row can see (inside
    kv_len, the causal bound and the window) read once, kv_len and
    q_offset; 4 D operations per visible query-key pair per head."""
    hq, hkv, d = head_dims(prof)
    vis = _visible(prof)
    nbytes = (2 * prof["b"] * prof["sq"] * hq * d * itemsize
              + sum(2 * keys * hkv * d * itemsize for keys, _ in vis)
              + 8 * prof["b"])
    return _bound(nbytes, 4 * d * hq * sum(pairs for _, pairs in vis))


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


# WKV scan at rwkv6-3b's heads (H 40 of N 64): the two-dispatch engine's
# prefill calls (2 scratch rows, a full and a partial chunk) and its decode
# steps (8 slots, one step); then, untimed, the decode step with the final
# state written over state0 (as the engine's decode writes its cache in
# place) and the head sizes of the reduced configs (N 16 and 32); and
# RWKV_EDGES, the edges of the launch plan, which kernel_check runs after
# every other kernel's profiles so that they change no kernel's timing
# conditions: the in-place decode at N 16 and 32, 161 steps (several turns
# of the chunk ring and a ragged tail), one row (a grid of 80 blocks), no
# step at all (the final state is state0), and decays drawn as the model
# draws them, exp(-exp(x)) for x in [-8, 3]: from 2e-9 to 0.9997.
RWKV_H, RWKV_N = 40, 64
RWKV_PROFILES = {
    "prefill": dict(b=2, t=128),
    "prefill_partial": dict(b=2, t=37),
    "decode": dict(b=8, t=1),
    "decode_in_place": dict(b=8, t=1, in_place=True),
    "n16": dict(b=2, t=37, h=4, n=16),
    "n32": dict(b=2, t=37, h=4, n=32),
    "decode_in_place_n16": dict(b=8, t=1, n=16, in_place=True),
    "decode_in_place_n32": dict(b=8, t=1, n=32, in_place=True),
    "t161": dict(b=2, t=161),
    "one_row": dict(b=1, t=128),
    "no_step": dict(b=2, t=0),
    "decay_edge": dict(b=2, t=128, decay="edge"),
}
RWKV_TIMED = ("prefill", "prefill_partial", "decode")
RWKV_EDGES = ("decode_in_place_n16", "decode_in_place_n32", "t161",
              "one_row", "no_step", "decay_edge")


def rwkv_dims(prof):
    return (prof["b"], prof["t"], prof.get("h", RWKV_H),
            prof.get("n", RWKV_N))


def make_rwkv_case(torch, prof, dtype, seed):
    """r, k, v ~ N(0, 1/4) in ``dtype``; w, u and state0 float32: decays in
    (0.45, 0.95) (as tests/test_kernels.py draws them), or exp(-exp(x))
    for x uniform in [-8, 3] with ``decay="edge"``, a non-zero bonus
    u ~ N(0, 0.09) and state0 ~ N(0, 0.04)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    b, t, h, n = rwkv_dims(prof)

    def randn(shape, scale):
        return torch.randn(shape, generator=gen, device=DEV) * scale

    r, k, v = (randn((b, t, h, n), 0.5).to(dtype) for _ in range(3))
    if prof.get("decay") == "edge":
        x = torch.rand((b, t, h, n), generator=gen, device=DEV) * 11 - 8
        w = torch.exp(-torch.exp(x))
    else:
        w = torch.sigmoid(randn((b, t, h, n), 1.0)) * 0.5 + 0.45
    return dict(r=r, k=k, v=v, w=w, u=randn((h, n), 0.3),
                state=randn((b, h, n, n), 0.2))


def run_rwkv_in_place(rwkv6_scan, case):
    """The kernel with its final state written over (a copy of) state0."""
    state = case["state"].clone()
    return rwkv6_scan.rwkv6_scan_cuda(**{**case, "state": state},
                                      state_out=state)


def work_rwkv(prof, itemsize):
    """Least bytes and operations of one WKV scan: r, k, v read and out
    written once in the compute dtype, w, u and state0 read and the final
    state written once in f32; 5 N^2 + 5 N f32 operations per (row, step,
    head): out_j = sum_i r_i S_ij (2 N^2) + v_j * sum_i r_i u_i k_i (3 N
    for the sum, 2 N for the product and the add), and S_ij <- w_i S_ij +
    k_i v_j (3 N^2), at the f32 rate outside the tensor cores."""
    b, t, h, n = rwkv_dims(prof)
    seq = b * t * h * n
    state = b * h * n * n
    nbytes = 4 * seq * itemsize + (seq + h * n + 2 * state) * 4
    return _bound(nbytes, (5 * n * n + 5 * n) * b * t * h, F32_FLOPS)


# dense decode: 8 rows against a 2048-key cache at minitron-8b's heads and
# at deepseek-moe-16b's (G = 1); DECODE_LENGTHS include a length-0 row.
# Untimed: granite-moe's heads (G = 3, D = 64), a tile edge of the
# tensor-core walk; and 2 rows of a 4096-key cache, whose 16 (row, KV
# head) pairs would ask for 64 splits, past the tensor-core combine's 32.
DENSE_DECODE_T = 2048
DENSE_DECODE_PROFILES = {"decode": dict(hq=HQ, hkv=HKV),
                         "deepseek_decode": DS_HEADS,
                         "granite_d64": dict(hq=24, hkv=8, d=64),
                         "long_cache": dict(hq=HQ, hkv=HKV, t=4096,
                                            lengths=[4096, 2113])}
DENSE_DECODE_TIMED = ("decode", "deepseek_decode")


def dense_decode_shape(prof):
    """(row lengths, cache length T) of a dense decode profile."""
    return (prof.get("lengths", DECODE_LENGTHS),
            prof.get("t", DENSE_DECODE_T))


def make_dense_decode_case(torch, prof, dtype, seed):
    """Dense decode inputs on the card; every key at or past a row's length
    is 1e4, so a kernel that reads past the length disagrees loudly."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    lens, t = dense_decode_shape(prof)
    b = len(lens)
    hq, hkv, d = head_dims(prof)
    q = torch.randn((b, 1, hq, d), generator=gen, device=DEV)
    k = torch.randn((b, t, hkv, d), generator=gen, device=DEV)
    v = torch.randn((b, t, hkv, d), generator=gen, device=DEV)
    lengths = torch.tensor(lens, dtype=torch.int32, device=DEV)
    past = torch.arange(t, device=DEV)[None, :] >= lengths[:, None]
    k[past] = 1e4
    v[past] = 1e4
    return dict(q=q.to(dtype), k=k.to(dtype), v=v.to(dtype), lengths=lengths)


def work_dense_decode(prof, itemsize):
    """Least bytes and operations of one dense decode call: q read and the
    output written once, K+V of each row's valid keys read once, and the
    lengths; 4 D operations per valid key per query head."""
    lens, _ = dense_decode_shape(prof)
    b = len(lens)
    hq, hkv, d = head_dims(prof)
    nbytes = (2 * b * hq * d * itemsize
              + sum(2 * n * hkv * d * itemsize for n in lens)
              + 4 * b)
    return _bound(nbytes, 4 * d * hq * sum(lens))


def sdpa_decode_call(torch, case):
    """scaled_dot_product_attention with the length mask and grouped-query
    heads: the dense decode's yardstick (the port never calls it)."""
    q, k, v = (case[n].transpose(1, 2).contiguous() for n in "qkv")
    kpos = torch.arange(k.shape[2], device=DEV)
    mask = (kpos[None, :] < case["lengths"][:, None])[:, None, None]
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
    err = float(diff.max()) if diff.numel() else 0.0
    if not (bool((diff <= rtol * w.abs() + F32_ATOL * scale).all())
            and err <= BF16_ATOL * scale):
        raise AssertionError(f"{what}: max abs err {err} over {rtol} |want| "
                             f"+ {F32_ATOL} x {scale}")
    return err


def _amax(x):
    """max |x|, 0 for an empty tensor (a WKV call of no step)."""
    return float(x.abs().max()) if x.numel() else 0.0


def check_profile(torch, kernel, profile, make, run, plain, work_ms, *,
                  rows=None, library=None, timed=True, scaled=False,
                  module=None, **info):
    """One profile of one kernel: float32 and bfloat16 against the plain
    version on the same inputs (only on ``rows`` of the output, the rest
    exactly 0, when given; with ``scaled``, the tolerances relative to the
    output's scale, max(1, max |want|)); then in bfloat16 the kernel's,
    the plain version's and (``library``) the yardstick call's median
    times beside the bound.  A kernel that returns (out, state) has both
    held, the float32 state within the float32 tolerance in both runs.
    A ``module`` records the bf16 launch plan and, where it has routes,
    the route each dtype took, which must be the one its
    ``tensor_core_route`` names."""
    res = dict(info)
    for dtype, rtol, tag in ((torch.float32, 0.0, "f32"),
                             (torch.bfloat16, BF16_RTOL, "bf16")):
        case = make(dtype)
        got, want = run(case), plain(case)
        torch.cuda.synchronize()
        if module is not None and hasattr(module, "routes"):
            route = module.last_plan.route
            d = case["q"].shape[-1]
            if (route == "tensor_core") != \
                    module.tensor_core_route(dtype, d):
                raise AssertionError(f"{kernel}/{profile}/{tag}: route "
                                     f"{route} at D = {d}")
            res[f"route_{tag}"] = route
        if module is not None and tag == "bf16":
            res["plan_bf16"] = vars(module.last_plan)
        if isinstance(got, tuple):  # (out, final state): the state is f32
            (got, got_state), (want, want_state) = got, want
            scale = max(1.0, _amax(want_state)) if scaled else 1.0
            res[f"state_scale_{tag}"] = scale
            res[f"max_abs_err_state_{tag}"] = _compare(
                f"{kernel}/{profile}/{tag}/state", got_state, want_state,
                0.0, scale)
        if rows is not None:
            gap = sorted(set(range(got.shape[0])) - set(rows))
            if gap and bool(got[gap].ne(0).any()):
                raise AssertionError(f"{kernel}/{profile}/{tag}: gap rows "
                                     "not zero")
            got, want = got[rows], want[rows]
        scale = max(1.0, _amax(want)) if scaled else 1.0
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


def phase_kernel_check(torch, only=None) -> dict:
    """{kernel: {profile: result}} for the six kernels (those ``only``
    names, when given)."""
    from repro_torch.kernels import (decode_attention, expert_gemm,
                                     flash_attention, paged_decode_attention,
                                     ragged_attention, ref, rwkv6_scan)

    def skip(kernel):
        return only is not None and kernel not in only

    out = {name: {} for name in kernel_modules()}
    for name, prof in PROFILES.items():
        if skip("ragged_paged_attention"):
            break
        max_q = prof["max_q"]
        out["ragged_paged_attention"][name] = check_profile(
            torch, "ragged_paged_attention", name,
            lambda dt: make_case(torch, prof, dt, seed=len(prof["segs"])),
            lambda c: ragged_attention.ragged_paged_attention_cuda(
                **c, max_q=max_q),
            lambda c: ref.ragged_paged_reference(**c, max_q=max_q),
            work(prof, 2), rows=valid_rows(prof), timed=name in TIMED,
            module=ragged_attention, segments=prof["segs"],
            **{k: v for k, v in prof.items() if k != "segs"})
    for name, prof in PAGED_DECODE_PROFILES.items():
        if skip("paged_decode_attention"):
            break
        out["paged_decode_attention"][name] = check_profile(
            torch, "paged_decode_attention", name,
            lambda dt: make_decode_case(torch, prof, dt, seed=8),
            lambda c: paged_decode_attention.paged_decode_attention_cuda(
                **c),
            lambda c: ref.paged_decode_reference(**c),
            work_decode(prof, 2), timed=name in PAGED_DECODE_TIMED,
            module=paged_decode_attention, **prof)
    for name, prof in FLASH_PROFILES.items():
        if skip("flash_attention"):
            break
        out["flash_attention"][name] = check_profile(
            torch, "flash_attention", name,
            lambda dt: make_flash_case(torch, prof, dt, seed=prof["sq"]),
            lambda c: flash_attention.flash_attention_cuda(**c),
            lambda c: ref.mha_reference(**c),
            work_flash(prof, 2), library=sdpa_call,
            timed=name in FLASH_TIMED, module=flash_attention, **prof)
    for name, prof in GEMM_PROFILES.items():
        if skip("expert_gemm"):
            break
        out["expert_gemm"][name] = check_profile(
            torch, "expert_gemm", name,
            lambda dt: make_gemm_case(torch, prof, dt, seed=prof["c"]),
            lambda c: expert_gemm.expert_gemm_cuda(**c),
            lambda c: ref.moe_gemm_reference(**c),
            work_gemm(prof, 2), library=bmm_call,
            timed=name in GEMM_TIMED, scaled=True, **prof)
    # the WKV scan: f32 tolerances relative to the output's and the state's
    # scale (sums over N in another order; the state update fused into one
    # multiply-add where the plain version rounds twice, over T steps)
    def check_rwkv(name):
        prof = RWKV_PROFILES[name]
        h, n = rwkv_dims(prof)[2:]
        out["rwkv6_scan"][name] = check_profile(
            torch, "rwkv6_scan", name,
            lambda dt: make_rwkv_case(torch, prof, dt, seed=prof["t"]),
            (lambda c: run_rwkv_in_place(rwkv6_scan, c))
            if prof.get("in_place")
            else (lambda c: rwkv6_scan.rwkv6_scan_cuda(**c)),
            lambda c: ref.rwkv6_reference(**c),
            work_rwkv(prof, 2), timed=name in RWKV_TIMED, scaled=True,
            module=rwkv6_scan, **{"h": h, "n": n, **prof})

    for name in RWKV_PROFILES:
        if skip("rwkv6_scan"):
            break
        if name not in RWKV_EDGES:
            check_rwkv(name)
    for name, prof in DENSE_DECODE_PROFILES.items():
        if skip("decode_attention"):
            break
        out["decode_attention"][name] = check_profile(
            torch, "decode_attention", name,
            lambda dt: make_dense_decode_case(torch, prof, dt,
                                              seed=prof["hq"]),
            lambda c: decode_attention.decode_attention_cuda(**c),
            lambda c: ref.mha_reference(
                c["q"], c["k"], c["v"], causal=False, kv_len=c["lengths"],
                q_offset=c["lengths"].long() - 1),
            work_dense_decode(prof, 2), library=sdpa_decode_call,
            timed=name in DENSE_DECODE_TIMED, module=decode_attention,
            **{"lengths": DECODE_LENGTHS, "t": DENSE_DECODE_T, **prof})
    for name in RWKV_EDGES:
        if skip("rwkv6_scan"):
            break
        check_rwkv(name)
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
    from repro_torch.kernels import (decode_attention, expert_gemm,
                                     flash_attention, paged_decode_attention,
                                     ragged_attention, rwkv6_scan)
    return {"ragged_paged_attention": ragged_attention,
            "paged_decode_attention": paged_decode_attention,
            "flash_attention": flash_attention,
            "expert_gemm": expert_gemm,
            "rwkv6_scan": rwkv6_scan,
            "decode_attention": decode_attention}


def reset_launches() -> None:
    """Every kernel's launch count, and each route's calls, to 0."""
    for mod in kernel_modules().values():
        mod.launches = 0
        for route in getattr(mod, "routes", {}):
            mod.routes[route] = 0


def read_routes() -> dict[str, dict[str, int]]:
    """Calls of each route of the kernels that have two."""
    return {name: dict(mod.routes) for name, mod in kernel_modules().items()
            if hasattr(mod, "routes")}


def read_launches() -> dict[str, int]:
    return {name: mod.launches for name, mod in kernel_modules().items()}


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


def time_steps(torch, eng):
    """Time each step of ``eng`` on the host clock (ms), and the device work
    of its step profile (replayed, or eager with ``graphs=False``) with
    CUDA events around the engine's ``StepGraph.run``; returns the list of
    host times and the list of event pairs, filled as the engine steps."""
    host, spans = [], []
    step, run = eng.step, eng._graphs.run

    def timed_step():
        t0 = time.perf_counter()
        step()
        host.append((time.perf_counter() - t0) * 1e3)

    def timed_run(key):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = run(key)
        e1.record()
        spans.append((e0, e1))
        return out
    eng.step = timed_step
    eng._graphs.run = timed_run
    return host, spans


def serve_counted(torch, model, spec, mode, *, graphs=True):
    """Serve the 8 main-path requests through ``mode`` on an engine that one
    short request has warmed (on a replay engine it captured every step
    profile then), with every kernel count set to 0 just before and read
    just after; every request must finish with MAX_NEW tokens in the
    vocabulary, and no profile may be captured during the serve.  Returns
    the engine, its stats and the outputs."""
    from repro_torch.serving import (EngineConfig, EngineMetrics, Request,
                                     ServeEngine)
    cfg = EngineConfig(**GEOMETRY, **MODES[mode])
    eng = ServeEngine(model, cfg, device=DEV, graphs=graphs)
    eng.serve([Request(prompt=list(range(1, 40)), max_new_tokens=2)])
    eng.metrics = EngineMetrics()
    captures = dict(eng._graphs.captures)
    if captures != dict.fromkeys(eng._graphs.profiles, 1):
        raise AssertionError(f"{mode}: profiles bound {captures}, expected "
                             f"each of {sorted(eng._graphs.profiles)} once")
    host, spans = time_steps(torch, eng)
    reqs = make_requests(spec, 8, MAX_NEW, seed=0)
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    routes = read_routes()
    if eng._graphs.captures != captures:
        raise AssertionError(f"{mode}: a profile was bound during the "
                             f"serve: {eng._graphs.captures}")
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
    runs = m.dispatches if cfg.unified else m.decode_steps
    if len(spans) != runs:
        raise AssertionError(f"{mode}: {len(spans)} step-profile runs, "
                             f"expected {runs}")
    device_ms = [a.elapsed_time(b) for a, b in spans]
    s = m.summary(reqs)
    stats = dict(mode=mode, graphs=graphs, requests=len(reqs),
                 prompt_tokens=sum(len(r.prompt) for r in reqs),
                 generated_tokens=m.generated_tokens, steps=m.steps,
                 decode_steps=m.decode_steps, prefill_calls=m.prefill_calls,
                 dispatches=m.dispatches, transfers_d2h=m.transfers_d2h,
                 preemptions=m.preemptions, wall_s=wall,
                 tokens_per_s=m.generated_tokens / wall,
                 ttft_s_mean=s["ttft_s_mean"], tpot_s_mean=s["tpot_s_mean"],
                 host_ms_per_step=statistics.mean(host),
                 profile_runs=len(spans),
                 device_ms_per_run=statistics.mean(device_ms),
                 captures=captures, capture_s=eng._graphs.capture_s,
                 graph_pool_mb=eng._graphs.pool_bytes / 2 ** 20,
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                 launches=counts, routes=routes)
    return eng, stats, [r.output for r in reqs]


def serve_eager_and_replay(torch, model, spec, mode, phase, expect, **info):
    """``mode`` on the eager engine, then on the replay engine (the main
    path) with the same requests: each run's launch counts as ``expect(m,
    stats)`` asserts them, each run's line, then one line holding the two
    against each other: greedy outputs token-identical, or parting only at
    a genuine tie.  Returns the replay run's launch counts."""
    outs, lines = {}, {}
    for graphs in (False, True):
        eng, stats, outs[graphs] = serve_counted(torch, model, spec, mode,
                                                 graphs=graphs)
        expect(eng.metrics, stats)
        emit(phase, model=spec.name, **info, **stats, kv=eng.kv_stats())
        lines[graphs] = stats
        del eng
        free(torch)
    prompts = [r.prompt for r in make_requests(spec, 8, MAX_NEW, seed=0)]
    what = f"{spec.name} {mode} eager vs replay"
    ties = _ties(torch, model, prompts, outs[False], outs[True], what)
    keys = ("tokens_per_s", "ttft_s_mean", "tpot_s_mean", "host_ms_per_step",
            "device_ms_per_run", "steps", "profile_runs", "dispatches")
    emit("eager_vs_replay", model=spec.name, mode=mode,
         identical=sum(a == b for a, b in zip(outs[False], outs[True])),
         ties=ties, eager={k: lines[False][k] for k in keys},
         replay={k: lines[True][k] for k in keys},
         launches_eager=lines[False]["launches"],
         launches_replay=lines[True]["launches"],
         captures=lines[True]["captures"],
         capture_s=lines[True]["capture_s"],
         graph_pool_mb=lines[True]["graph_pool_mb"])
    return lines[True]["launches"]


def _expect(mode, counts, nonzero):
    """Every kernel's launches are as ``nonzero`` says, every other 0."""
    want = {name: 0 for name in kernel_modules()}
    want.update(nonzero)
    if counts != want:
        raise AssertionError(f"{mode}: kernel launches {counts}, expected "
                             f"{want}")


def _expect_tensor_cores(mode, routes, kernel, n):
    """All ``n`` calls of ``kernel`` (bf16 at D % 16 == 0) took the
    tensor-core route."""
    if routes[kernel] != {"tensor_core": n, "cuda_core": 0}:
        raise AssertionError(f"{mode}: {kernel} routes {routes[kernel]}, "
                             f"expected all {n} on the tensor cores")


def phase_serve_unified(torch, model, spec, init_s, phase) -> dict:
    """The unified engine, eager and replayed, then the replay engine's
    profile (``phase`` names the serves' lines); returns the replay
    serve's kernel launch counts."""
    from repro_torch.serving import EngineConfig

    def expect(m, stats):
        if not m.dispatches == m.transfers_d2h == m.steps:
            raise AssertionError(f"unified: {m.dispatches} dispatches, "
                                 f"{m.transfers_d2h} transfers, {m.steps} "
                                 "steps")
        mixed = m.prefill_calls
        decode_only = m.dispatches - mixed
        n_ragged = spec.n_layers * (2 * mixed + decode_only)
        _expect("unified", stats["launches"], {
            "ragged_paged_attention": n_ragged,
            "expert_gemm": expert_launches_per_forward(spec) * m.dispatches})
        _expect_tensor_cores("unified", stats["routes"],
                             "ragged_paged_attention", n_ragged)
        stats.update(mixed_steps=mixed, decode_only_steps=decode_only)

    n_params = sum(p.numel() for p in model.parameters())
    counts = serve_eager_and_replay(
        torch, model, spec, "unified", phase, expect, params=n_params,
        weight_gb=n_params * 2 / 1e9, init_s=init_s)
    phase_serve_profile(torch, model, spec,
                        EngineConfig(**GEOMETRY, **MODES["unified"]))
    return counts


def build_full(torch, arch):
    """``arch`` at its published width, random bf16 weights drawn on the
    card from seed 0; returns (spec, model, seconds to build)."""
    from repro_torch.configs import get_spec
    from repro_torch.models import build_model
    spec = get_spec(arch)
    t0 = time.perf_counter()
    model = build_model(spec, device=DEV, dtype=torch.bfloat16, seed=0)
    if spec.is_attention_free:
        draw_rwkv_mixes(torch, model, seed=0)
    torch.cuda.synchronize()
    return spec, model, time.perf_counter() - t0


def draw_rwkv_mixes(torch, model, seed) -> None:
    """The reference's init leaves every RWKV layer's token-shift mixes and
    its bonus u at zero, which exercises neither the token shift nor the
    bonus term: draw them on the card from ``seed`` (mixes uniform in
    [0, 1), bonus N(0, 1/4))."""
    from repro_torch.models.ssm import MIXES
    gen = torch.Generator(device=DEV).manual_seed(seed)
    with torch.no_grad():
        for layer in model.layers:
            for name in MIXES:
                p = getattr(layer.mixer, name)
                p.copy_(torch.rand(p.shape, generator=gen, device=DEV))
            u = layer.mixer.u_bonus
            u.copy_(torch.randn(u.shape, generator=gen, device=DEV) * 0.5)


def free(torch):
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve_two_dispatch(torch, model, spec) -> list[dict]:
    """The two-dispatch engine in both layouts, eager and replayed, then the
    dense replay engine's profile; returns each replay serve's kernel
    launch counts.  Every flash call of the bf16 model must take the
    tensor-core route."""
    from repro_torch.serving import EngineConfig
    out = []
    for mode in ("paged", "dense"):
        def expect(m, stats, mode=mode):
            n = spec.n_layers
            want = {"paged_decode_attention": n * m.decode_steps,
                    "flash_attention": n * m.prefill_calls,
                    "expert_gemm": expert_launches_per_forward(spec)
                    * (m.decode_steps + m.prefill_calls)}
            if mode == "dense":
                want.update(paged_decode_attention=0,
                            flash_attention=n * (m.prefill_calls
                                                 + m.decode_steps))
            _expect(mode, stats["launches"], want)
            for kernel in ("flash_attention", "paged_decode_attention"):
                _expect_tensor_cores(mode, stats["routes"], kernel,
                                     want[kernel])
        out.append(serve_eager_and_replay(torch, model, spec, mode,
                                          "serve_two_dispatch", expect))
    phase_serve_profile(torch, model, spec,
                        EngineConfig(**GEOMETRY, **MODES["dense"]))
    return out


def phase_decode_op(torch) -> dict:
    """The dense decode's path: its entry point,
    ``kernels.ops.decode_attention``, once per layer of a minitron-8b
    decode step on the decode profile's bf16 inputs, counts set to 0 just
    before and read just after; returns the counts."""
    from repro_torch.configs import get_spec
    from repro_torch.kernels import ops
    n_layers = get_spec("minitron-8b").n_layers
    case = make_dense_decode_case(torch, DENSE_DECODE_PROFILES["decode"],
                                  torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    outs = [ops.decode_attention(case["q"], case["k"], case["v"],
                                 lengths=case["lengths"])
            for _ in range(n_layers)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    routes = read_routes()["decode_attention"]
    _expect("decode_op", counts, {"decode_attention": n_layers})
    if routes != {"tensor_core": n_layers, "cuda_core": 0}:
        raise AssertionError(f"decode_op: routes {routes}")
    out = outs[-1].float()
    if not bool(out.isfinite().all()):
        raise AssertionError("decode_op: non-finite output")
    zero_rows = [i for i, n in enumerate(DECODE_LENGTHS) if n == 0]
    if bool(out[zero_rows].ne(0).any()):
        raise AssertionError("decode_op: a length-0 row is not zero")
    emit("decode_op", calls=n_layers, wall_ms=wall * 1e3,
         shape=list(case["k"].shape), lengths=DECODE_LENGTHS,
         launches=counts, routes=routes)
    return counts


def phase_serve_rwkv(torch, model, spec, init_s) -> list[dict]:
    """The attention-free stack through the two-dispatch engine in both
    layouts, eager and replayed, then the dense replay engine's profile;
    returns each replay serve's kernel launch counts."""
    from repro_torch.serving import EngineConfig

    def expect(m, stats):
        _expect("rwkv", stats["launches"], {
            "rwkv6_scan": spec.n_layers * (m.prefill_calls
                                           + m.decode_steps)})

    n_params = sum(p.numel() for p in model.parameters())
    weight_gb = sum(p.numel() * p.element_size()
                    for p in model.parameters()) / 1e9
    out = [serve_eager_and_replay(torch, model, spec, mode, "serve_rwkv",
                                  expect, params=n_params,
                                  weight_gb=weight_gb, init_s=init_s)
           for mode in ("dense", "paged")]
    phase_serve_profile(torch, model, spec,
                        EngineConfig(**GEOMETRY, **MODES["dense"]))
    return out


def _kernel_class(name: str) -> str:
    """The class of a device kernel by its name.  The tensor-core attention
    walk (attn_tc_*) names its caller's addressing type: the ragged
    kernel's and the paged decode's contain their names, and the dense one
    counts as flash (no serve calls the dense decode, its other user); the
    CUDA-core split-KV combine belongs to the paged decode."""
    n = name.lower()
    if "ragged_paged" in n:
        return "ragged_attention"
    if "paged_decode" in n or "decode_combine" in n:
        return "paged_decode_attention"
    if "flash_attention" in n or "attn_tc_" in n:
        return "flash_attention"
    if "expert_gemm" in n:
        return "expert_gemm"
    if "rwkv6_scan" in n:
        return "rwkv6_scan"
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
    requests of 100-1500 prompt tokens, 8 new tokens each) through the
    replay engine ``cfg`` names, its profiles captured before by one short
    request; device time summed by kernel class (a replay's kernels keep
    their names), against the wall clock of the same steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import EngineMetrics, Request, ServeEngine

    eng = ServeEngine(model, cfg, device=DEV)
    eng.serve([Request(prompt=list(range(1, 40)), max_new_tokens=2)])
    eng.metrics = EngineMetrics()
    reqs = make_requests(spec, 8, 8, seed=2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.serve(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_class: dict[str, float] = {}
    launches = graph_launches = 0
    for ev in prof.key_averages():
        if ev.key == "cudaGraphLaunch":
            graph_launches += ev.count
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue  # host-side ops and runtime calls
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        cls = _kernel_class(ev.key)
        by_class[cls] = by_class.get(cls, 0.0) + dev_us / 1e3
        launches += ev.count
    busy = sum(by_class.values())
    m = eng.metrics
    if graph_launches < (m.dispatches if cfg.unified else m.decode_steps):
        raise AssertionError(f"serve_profile: {graph_launches} graph "
                             "launches under the profiler")
    steps = (dict(mixed_steps=m.prefill_calls,
                  decode_only_steps=m.dispatches - m.prefill_calls)
             if cfg.unified else dict(decode_steps=m.decode_steps,
                                      prefill_calls=m.prefill_calls))
    emit("serve_profile", model=spec.name, layout=cfg.cache_layout,
         unified=cfg.unified, steps=m.steps, **steps,
         wall_ms=wall * 1e3, device_busy_ms=busy,
         device_busy_share=busy / (wall * 1e3),
         kernel_launches=launches, graph_launches=graph_launches,
         device_ms_by_class=dict(sorted(by_class.items(),
                                        key=lambda kv: -kv[1])))


def _last_logits(torch, model, tokens):
    """Logits after ``tokens`` through the packed step alone: one prefill
    segment walked chunk by chunk on a fresh cache (plain attention).  An
    attention-free stack has no packed step: its chunks run through
    ``prefill_chunk`` on a fresh one-row dense cache."""
    from repro_torch.models.attention import PackedSegs
    chunk, ps = GEOMETRY["chunk_size"], GEOMETRY["page_size"]
    if model.spec.is_attention_free:
        cache = model.init_cache(1, GEOMETRY["max_seq"], layout="dense")
        for lo in range(0, len(tokens), chunk):
            toks = torch.tensor([tokens[lo:lo + chunk]], device=DEV)
            logits, cache = model.prefill_chunk(cache, toks)
        return logits[0].float()
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
    """``arch``'s widths at 2 layers in float32, every engine mode that
    serves it on the replay engine through the kernels and through the
    plain versions, and on the eager engine through the kernels (an
    attention-free stack: the two two-dispatch layouts, its RWKV mixes and
    bonus drawn non-zero)."""
    from repro_torch.configs import get_spec
    from repro_torch.models import build_model
    from repro_torch.serving import EngineConfig, ServeEngine

    spec = get_spec(arch).scaled(name=f"{arch}-2l", n_layers=2)
    model = build_model(spec, device=DEV, dtype=torch.float32, seed=1)
    modes = tuple(MODES)
    if spec.is_attention_free:
        draw_rwkv_mixes(torch, model, seed=1)
        modes = ("dense", "paged")
    outs = {}
    for mode in modes:
        for run, impl, graphs in (("kernel", "kernel", True),
                                  ("plain", "plain", True),
                                  ("eager", "kernel", False)):
            model.kernel_impl = impl
            reqs = make_requests(spec, 8, 16, seed=1)
            ServeEngine(model, EngineConfig(**GEOMETRY, **MODES[mode]),
                        device=DEV, graphs=graphs).serve(reqs)
            outs[mode, run] = [r.output for r in reqs]
            prompts = [r.prompt for r in reqs]
    model.kernel_impl = "plain"
    pairs = [((mode, "kernel"), (mode, other)) for mode in modes
             for other in ("plain", "eager")] + [
        ((modes[0], "kernel"), (mode, "kernel")) for mode in modes[1:]]
    comparisons = {}
    for a, b in pairs:
        what = f"{'/'.join(a)} vs {'/'.join(b)}"
        comparisons[what] = {
            "identical": sum(x == y for x, y in zip(outs[a], outs[b])),
            "ties": _ties(torch, model, prompts, outs[a], outs[b], what)}
    emit("serve_parity", model=spec.name, dtype="float32",
         requests=len(prompts),
         tokens=sum(len(o) for o in outs[modes[0], "kernel"]),
         comparisons=comparisons)
    del model
    free(torch)


def phase_debug_guards(torch) -> None:
    """``debug_guards`` on the card, at minitron-8b's widths and 2 layers in
    bf16, in the unified and the paged two-dispatch replay engines: a
    guarded serve is token-identical to an unguarded one, a ``.item()`` on
    a card tensor inside ``_step_guard()`` raises, and binding a profile
    again, or a key of no profile, raises "recapture"."""
    from repro_torch.configs import get_spec
    from repro_torch.models import build_model
    from repro_torch.serving import EngineConfig, ServeEngine

    spec = get_spec("minitron-8b").scaled(name="minitron-8b-2l",
                                          n_layers=2)
    model = build_model(spec, device=DEV, dtype=torch.bfloat16, seed=1)
    for mode in ("unified", "paged"):
        outs = {}
        for guards in (False, True):
            eng = ServeEngine(model, EngineConfig(
                **GEOMETRY, **MODES[mode], debug_guards=guards), device=DEV)
            reqs = make_requests(spec, 8, 16, seed=3)
            eng.serve(reqs)
            outs[guards] = [r.output for r in reqs]
        if outs[True] != outs[False]:
            raise AssertionError(f"debug_guards {mode}: guarded outputs "
                                 "differ from unguarded ones")
        try:
            with eng._step_guard():
                eng.cache.lengths.sum().item()
        except RuntimeError as e:
            armed = str(e).splitlines()[0]
        else:
            raise AssertionError(f"debug_guards {mode}: .item() inside the "
                                 "step guard did not raise")
        recapture = []
        for key in (sorted(eng._graphs.profiles)[0], "decode/foreign"):
            try:
                eng._graphs.capture(key)
            except AssertionError as e:
                if "recapture" not in str(e):
                    raise
                recapture.append(key)
        if len(recapture) != 2:
            raise AssertionError(f"debug_guards {mode}: binding again did "
                                 f"not raise for {recapture}")
        emit("debug_guards", model=spec.name, mode=mode,
             requests=len(reqs), identical=True, steps=eng.steps,
             captures=eng._graphs.captures, item_raised=armed,
             recapture_raised=recapture)
        del eng
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
                              "max_abs_err_bf16", "max_abs_err_state_f32",
                              "max_abs_err_state_bf16") if k in r}
                         for p, r in timed.items()}}


def main(argv: list[str]) -> int:
    """No arguments: every phase.  ``--kernels a,b``: build, then only the
    kernel_check of the named kernels (no serve, no result line)."""
    only = None
    if argv[:1] == ["--kernels"] and len(argv) == 2:
        only = set(argv[1].split(","))
    elif argv:
        print("usage: chip_smoke.py [--kernels NAME,...]", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    unknown = sorted((only or set()) - set(kernel_modules()))
    if unknown:
        print(f"chip_smoke.py: unknown kernels {unknown}; the kernels are "
              f"{sorted(kernel_modules())}", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()

    mods = kernel_modules()
    names = [Path(mod.SOURCE).stem for name, mod in mods.items()
             if only is None or name in only]
    t0 = time.perf_counter()
    built = build.build_all(names)
    for name in names:
        build.load(name)
    emit("build", seconds=time.perf_counter() - t0,
         compile_seconds={n: b.seconds for n, b in built.items()},
         libraries=[str(b.path.relative_to(ROOT)) for b in built.values()],
         ptxas={n: [ln.strip() for ln in b.log.splitlines()
                    if any(w in ln for w in ("entry function", "registers",
                                             "spill"))]
                for n, b in built.items()},
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    if only is not None:  # a short run: the named kernels' checks alone
        phase_kernel_check(torch, only)
        print(smi, flush=True)
        return 0
    checks = phase_kernel_check(torch)
    serves = [phase_decode_op(torch)]

    spec, model, init_s = build_full(torch, "minitron-8b")
    serves.append(phase_serve_unified(torch, model, spec, init_s,
                                      "serve_full"))
    serves += phase_serve_two_dispatch(torch, model, spec)
    del model
    free(torch)
    phase_serve_parity(torch, "minitron-8b")
    phase_debug_guards(torch)

    spec, model, init_s = build_full(torch, "deepseek-moe-16b")
    serves.append(phase_serve_unified(torch, model, spec, init_s,
                                      "serve_moe"))
    del model
    free(torch)
    phase_serve_parity(torch, "deepseek-moe-16b")

    spec, model, init_s = build_full(torch, "rwkv6-3b")
    serves += phase_serve_rwkv(torch, model, spec, init_s)
    del model
    free(torch)
    phase_serve_parity(torch, "rwkv6-3b")

    launches = {name: sum(c[name] for c in serves) for name in mods}
    idle = [name for name, n in launches.items() if n == 0]
    if idle:
        raise AssertionError(f"kernels never launched on their paths: "
                             f"{idle}")
    tops = {"ragged_paged_attention": "decode",
            "paged_decode_attention": "decode", "flash_attention": "prefill",
            "expert_gemm": "mixed", "rwkv6_scan": "decode",
            "decode_attention": "decode"}
    kernels = [kernel_entry(name, mod, launches[name], checks[name],
                            tops[name]) for name, mod in mods.items()]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
