"""Measure the design choices of the expert GEMM's bf16 backward on the card.

Run from the repository root on a machine with an H100 and the CUDA
toolkit (no arguments):

    python3 scripts/expert_gemm_bwd_probe.py

At granite-moe-3b-a800m's training shapes (``chip_smoke.py``'s timed
``expert_gemm_bwd`` profiles) it prints one JSON line per gradient and
part, each time a median of ``chip_smoke.median_ms`` (L2 flushed before
every launch):

* ``plans``: the kernel of ``csrc/expert_gemm_bwd.cu`` on other plans than
  :func:`repro_torch.kernels.expert_gemm.bwd_plan`'s (tile widths 256,
  128 and 64; the summed dX in 1-16 shares; one block a tile instead of
  one persistent block an SM; 2 and 3 ring slots), each held against the
  plain backward, beside the plan's own, the library's call and the route
  the backward had before it had a kernel of its own (the forward's kernel
  on transposed, padded copies);
* ``sources``: edited copies of the source, built into
  ``build/expert_gemm_bwd_variants/`` and held against the plain
  backward: ``wait0`` (each slot's products waited for before its slot is
  freed, no group in flight), ``m_fastest`` (tiles walked M first),
  ``no_store`` (the epilogue's stores removed: the time without them;
  its outputs are not checked) and ``mn64`` (one 64-wide product per
  MN-major box, not one product across the boxes).

The last line is the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import dataclasses
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
from repro_torch.kernels import expert_gemm as eg  # noqa: E402
from repro_torch.kernels.attention_tc import sm_count  # noqa: E402

LAUNCHES = 20
VARIANT_DIR = ROOT / "build" / "expert_gemm_bwd_variants"

#: the source edits of each variant: (text in the source, its stand-in)
WAIT0 = [("""      wgmma_wait<1>();  // the group before this one has finished
      fence_regs<BN / 2>(acc);
      if (i > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[prev]);""",
          """      wgmma_wait<0>();
      fence_regs<BN / 2>(acc);
      if (threadIdx.x % 128 == 0) mbar_arrive(&empty[s]);"""),
         ("    if (n_k > 0 && threadIdx.x % 128 == 0) "
          "mbar_arrive(&empty[prev]);", "")]
M_FASTEST = [(f"""{ind}const int n0 = (t % n_tiles) * BN;
{ind}const int m0 = (t / n_tiles % m_tiles) * kTileM;""",
              f"""{ind}const int n0 = (t / m_tiles % n_tiles) * BN;
{ind}const int m0 = (t % m_tiles) * kTileM;""") for ind in (" " * 8, " " * 4)]
NO_STORE = [("          if (row < n && pc < m) {", "          if (row < 0) {")]
MN64 = [("""        wgmma_bf16_tn<BN, kMn ? 1 : 0, kMn ? 1 : 0>(
            acc, a0 + off + ks * kStep, b0 + off + ks * kStep);""",
         """        if constexpr (kMn) {
#pragma unroll
          for (int q = 0; q < BN / 64; ++q) {
            wgmma_bf16_tn<64, 1, 1>(acc + 32 * q, a0 + off + ks * kStep,
                                    b0 + off + ks * kStep + q * (kBox >> 4));
          }
        } else {
          wgmma_bf16_tn<BN, 0, 0>(acc, a0 + off + ks * kStep,
                                  b0 + off + ks * kStep);
        }""")]
VARIANTS = {"wait0": WAIT0, "m_fastest": M_FASTEST, "no_store": NO_STORE,
            "mn64": MN64}


def emit(part, profile, **kw):
    print(json.dumps({"part": part, "profile": profile, **kw}), flush=True)


def build_variant(name, edits):
    """The entry point of a copy of the source with ``edits`` applied."""
    d = VARIANT_DIR / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(build.CSRC, d)
    src = d / "expert_gemm_bwd.cu"
    text = src.read_text()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{name}: the source no longer has {old!r}")
        text = text.replace(old, new)
    src.write_text(text)
    lib = d / "lib.so"
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).expert_gemm_bwd_launch
    fn.argtypes, fn.restype = list(eg._BWD_ARGTYPES), ctypes.c_int
    return fn


def with_entry(fn, call):
    """``call()`` with the backward's entry point swapped for ``fn``."""
    entry = build.entry
    build.entry = (lambda name, symbol, argtypes: fn
                   if name == "expert_gemm_bwd"
                   else entry(name, symbol, argtypes))
    try:
        return call()
    finally:
        build.entry = entry


def copies_route(x, w, dy, need_x, need_w):
    """The bf16 backward before it had a kernel of its own: the forward's
    kernel on transposed contiguous copies, C padded to a multiple of 8."""
    e, c, f = dy.shape
    d = w.shape[1]
    dx = dw = None
    if need_w:
        cp = -(-c // 8) * 8
        xt = (eg._pad_rows(x, cp).T.contiguous().expand(e, d, cp)
              if x.dim() == 2 else
              eg._pad_rows(x, cp).transpose(1, 2).contiguous())
        dw, _ = eg._launch(xt, eg._pad_rows(dy, cp))
    if need_x:
        wt = w.transpose(1, 2)
        if x.dim() == 2:
            dx, _ = eg._launch(dy.permute(1, 0, 2).reshape(1, c, e * f),
                               wt.reshape(1, e * f, d))
            dx = dx.view(c, d)
        else:
            dx, _ = eg._launch(dy, wt.contiguous())
    return dx, dw


def plan_with(p, prod, block_n=None, shares=None, stages=None,
              persistent=True):
    """``p`` with another tile width, share count, ring depth or grid."""
    bn = block_n or p.block_n
    sh = shares or p.shares
    slot = eg.bwd_stage_bytes(bn) + 16
    st = stages or min(eg.BWD_MAX_STAGES, (eg.SMEM_LIMIT - eg.ALIGN) // slot)
    n_t = -(-prod.n // bn)
    tiles = n_t * p.m_tiles * sh
    return dataclasses.replace(
        p, block_n=bn, n_tiles=n_t, shares=sh, tiles=tiles, stages=st,
        smem=eg.ALIGN + st * slot,
        grid=(min(tiles, sm_count(0)) if persistent else tiles, 1, 1))


def max_err(got, want):
    """max |got - want| over the gradient's scale, and whether every
    element is within chip_smoke's bf16 tolerance."""
    diff = (got.float() - want).abs()
    scale = max(1.0, float(want.abs().max()))
    ok = bool((diff <= cs.BF16_RTOL * want.abs() + cs.F32_ATOL * scale).all())
    return float(diff.max()) / scale, ok


def case_of(name):
    prof = cs.GEMM_BWD_PROFILES[name]
    case = cs.make_gemm_bwd_case(torch, prof, torch.bfloat16, seed=prof["c"])
    need = dict(need_x="x" in prof["grad"], need_w="w" in prof["grad"])
    want = ref.expert_gemm_bwd_reference(
        **{k: v.float() for k, v in case.items()}, **need)
    want = want[0] if need["need_x"] else want[1]
    prod, = eg.bwd_products(**case, **need)
    return prof, case, need, prod, want


def part_plans(name):
    prof, case, need, prod, want = case_of(name)
    base = eg.bwd_plan(prod.product, prod.e, prod.m, prod.n, prod.k,
                       sm_count(0))
    res = {"plan": dataclasses.asdict(base)}
    res["ms"] = cs.median_ms(torch, lambda: eg._launch_bwd(prod, base),
                             LAUNCHES)
    res["copies_route_ms"] = cs.median_ms(
        torch, lambda: copies_route(**case, **need), LAUNCHES)
    res["library_ms"] = cs.median_ms(
        torch, cs.gemm_bwd_library(torch, prof, case), LAUNCHES)
    plans = {"one_block_a_tile": plan_with(base, prod, persistent=False)}
    plans.update({f"stages{s}": plan_with(base, prod, stages=s)
                  for s in (2, 3)})
    shares = ((1, 2, 4, 5, 8, 16) if prod.product == "dx_sum"
              else (base.shares,))
    for bn in eg.BWD_WIDTHS:
        for sh in shares:
            plans[f"w{bn}_s{sh}"] = plan_with(base, prod, bn, sh)
    for tag, p in plans.items():
        got, _ = eg._launch_bwd(prod, p)
        err, ok = max_err(got, want)
        res[tag] = dict(ms=cs.median_ms(
            torch, lambda: eg._launch_bwd(prod, p), LAUNCHES),
            scaled_err=err, ok=ok)
    res["ms_again"] = cs.median_ms(torch, lambda: eg._launch_bwd(prod, base),
                                   LAUNCHES)
    emit("plans", name, **res)


def part_sources(name, fns):
    _, case, need, prod, want = case_of(name)
    run = lambda: eg.expert_gemm_bwd_cuda(**case, **need)  # noqa: E731
    res = {"ms": cs.median_ms(torch, run, LAUNCHES)}
    for tag, fn in fns.items():
        got = with_entry(fn, run)
        err, ok = max_err(got[0] if need["need_x"] else got[1], want)
        res[tag] = dict(ms=with_entry(fn, lambda: cs.median_ms(
            torch, run, LAUNCHES)), scaled_err=err,
            ok=ok if tag != "no_store" else None)
    res["ms_again"] = cs.median_ms(torch, run, LAUNCHES)
    emit("sources", name, **res)


def main() -> int:
    if not torch.cuda.is_available():
        print("expert_gemm_bwd_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all(["expert_gemm", "expert_gemm_bwd"])
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        fns = dict(zip(VARIANTS, pool.map(build_variant, VARIANTS,
                                          VARIANTS.values())))
    for name in cs.GEMM_BWD_TIMED:
        part_plans(name)
    for name in cs.GEMM_BWD_TIMED:
        part_sources(name, fns)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
