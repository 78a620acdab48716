"""Port parity: the plain PyTorch kernels (``repro_torch.kernels``: ragged
paged attention, paged decode attention, attention over dense K/V with a
window, dense decode attention) against the JAX oracles and the Pallas
kernels in interpret mode, on the cases of ``tests/test_kernels.py`` and
at the edges of the Hopper kernels' tensor-core tiles; and the launch
plans of the four attention wrappers (route, row blocks, key split) and of
the WKV scan (column split, row groups, chunk ring), which are pure
Python.

Inputs are made from numpy seeds and handed to both frameworks; everything
runs in float32 on the CPU.  Rows in packing gaps are unspecified on both
sides and masked.  Tolerance: atol 1e-5 (float32 softmax over at most a
few dozen keys, summed in different orders), 1e-4 against the flash
kernel's blockwise sums over up to 128 keys; the dense decode also runs in
bfloat16, within one bf16 ulp more.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.decode_attention import pallas_decode_attention
from repro.kernels.flash_attention import pallas_flash_attention
from repro_torch.kernels import (attention_tc, decode_attention,
                                 flash_attention, paged_decode_attention,
                                 ragged_attention, rwkv6_scan)
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

ATOL = 1e-5

# one compiled program per case instead of op-by-op dispatch
_jax_ragged = jax.jit(jops.ragged_paged_attention,
                      static_argnames=("max_q", "impl", "interpret"))
_jax_paged_decode = jax.jit(jops.paged_decode_attention,
                            static_argnames=("impl", "interpret"))
_jax_flash = jax.jit(pallas_flash_attention,
                     static_argnames=("causal", "block_q", "block_kv",
                                      "window", "interpret"))


def _ragged_case(segs, hq, hkv, d, ps, mp, seed=0):
    """Packed case from (q_len, kv_len) segments as numpy arrays: segments
    pack back-to-back, each gets a distinct page run (page 0 stays null)."""
    rng = np.random.default_rng(seed)
    s = len(segs)
    p = 1 + sum(-(-kv // ps) for _, kv in segs) + 1
    kp = rng.standard_normal((p, hkv, ps, d), dtype=np.float32)
    vp = rng.standard_normal((p, hkv, ps, d), dtype=np.float32)
    pt = np.zeros((s, mp), np.int32)
    free = list(range(1, p))
    q_start, q_len, kv_len = [], [], []
    off = 0
    for i, (ql, kl) in enumerate(segs):
        q_start.append(off)
        q_len.append(ql)
        kv_len.append(kl)
        for j in range(-(-kl // ps)):
            pt[i, j] = free.pop(0)
        off += ql
    t = max(off, 1)
    q = rng.standard_normal((t, hq, d), dtype=np.float32)
    return (q, kp, vp, pt, np.asarray(q_start, np.int32),
            np.asarray(q_len, np.int32), np.asarray(kv_len, np.int32))


def _valid_rows(q_start, q_len, t):
    valid = np.zeros((t,), bool)
    for s, n in zip(q_start, q_len):
        valid[s:s + n] = True
    return valid


def _torch(args):
    return [torch.from_numpy(a) for a in args]


SEGS = [
    # mixed: two decode slots, an inactive segment, two prefill chunks
    [(1, 7), (1, 13), (0, 0), (8, 8), (5, 11)],
    # decode-only packing (every segment one token)
    [(1, 5), (1, 9), (1, 16), (1, 1)],
    # empty-prefill: idle rows ride along as q_len == 0 segments
    [(1, 6), (0, 0), (0, 0)],
    # prefill-only, partial last pages
    [(7, 7), (3, 15)],
]


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("segs", SEGS, ids=["mixed", "decode", "idle",
                                            "prefill"])
def test_plain_ragged_matches_jax_oracle(segs, g):
    """The port's plain version equals the JAX gather oracle on every row
    of a live segment, for G = 1, 2, 4 query heads per KV head."""
    hkv, d, ps, mp, max_q = 2, 16, 4, 6, 8
    args = _ragged_case(segs, g * hkv, hkv, d, ps, mp)
    want = np.asarray(_jax_ragged(*[jnp.asarray(a) for a in args],
                                  max_q=max_q, impl="gather"))
    got = tops.ragged_paged_attention(*_torch(args), max_q=max_q).numpy()
    valid = _valid_rows(args[4], args[5], args[0].shape[0])
    np.testing.assert_allclose(got[valid], want[valid], atol=ATOL, rtol=0)


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("segs", SEGS[:2] + SEGS[3:],
                         ids=["mixed", "decode", "prefill"])
def test_plain_ragged_matches_pallas_interpret(segs, g):
    """... and the Pallas TPU kernel itself, run in interpret mode."""
    hkv, d, ps, mp, max_q = 2, 16, 4, 6, 8
    args = _ragged_case(segs, g * hkv, hkv, d, ps, mp, seed=1)
    want = np.asarray(_jax_ragged(*[jnp.asarray(a) for a in args],
                                  max_q=max_q, impl="pallas",
                                  interpret=True))
    got = tops.ragged_paged_attention(*_torch(args), max_q=max_q).numpy()
    valid = _valid_rows(args[4], args[5], args[0].shape[0])
    np.testing.assert_allclose(got[valid], want[valid], atol=ATOL, rtol=0)


def test_plain_ragged_gap_rows_are_finite():
    """Rows in packing gaps (the static layout's unused tail of a chunk)
    stay finite: they become K/V written to the null page next layer."""
    hkv, d, ps, mp, max_q = 2, 16, 4, 6, 8
    q, kp, vp, pt, qs, ql, kl = _ragged_case([(1, 7), (3, 9)], 4, hkv, d,
                                             ps, mp)
    q = np.concatenate([q, np.zeros((5, 4, d), np.float32)])  # gap rows
    got = tops.ragged_paged_attention(*_torch((q, kp, vp, pt, qs, ql, kl)),
                                      max_q=max_q)
    assert torch.isfinite(got).all()


def test_plain_ragged_impl_plain_equals_default_on_cpu():
    args = _torch(_ragged_case(SEGS[0], 4, 2, 16, 4, 6))
    a = tops.ragged_paged_attention(*args, max_q=8)
    b = tops.ragged_paged_attention(*args, max_q=8, impl="plain")
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unknown ragged paged impl"):
        tops.ragged_paged_attention(*args, max_q=8, impl="pallas")


def test_paged_gather_and_pack_indices_match_jax():
    q, kp, vp, pt, qs, ql, kl = _ragged_case(SEGS[0], 4, 2, 16, 4, 6)
    np.testing.assert_array_equal(
        tref.paged_gather(torch.from_numpy(kp),
                          torch.from_numpy(pt)).numpy(),
        np.asarray(jref.paged_gather(jnp.asarray(kp), jnp.asarray(pt))))
    for max_q in (1, 4, 8):
        np.testing.assert_array_equal(
            tref.ragged_pack_indices(torch.from_numpy(qs),
                                     torch.from_numpy(ql), q.shape[0],
                                     max_q).numpy(),
            np.asarray(jref.ragged_pack_indices(jnp.asarray(qs),
                                                jnp.asarray(ql), q.shape[0],
                                                max_q)))


@pytest.mark.parametrize("causal", [True, False])
def test_mha_reference_matches_jax(causal):
    """Dense oracle with kv_len masking and a per-row q_offset (the chunked
    prefill shape)."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 5, 8, 16), dtype=np.float32)
    k = rng.standard_normal((2, 12, 2, 16), dtype=np.float32)
    v = rng.standard_normal((2, 12, 2, 16), dtype=np.float32)
    kv_len = np.asarray([9, 12], np.int32)
    q_off = np.asarray([4, 7], np.int32)
    want = np.asarray(jref.mha_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        kv_len=jnp.asarray(kv_len), q_offset=jnp.asarray(q_off)))
    got = tref.mha_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, kv_len=torch.from_numpy(kv_len),
        q_offset=torch.from_numpy(q_off)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_decode_only_matches_jax_paged_decode_oracle():
    """A decode-only packing reproduces the JAX single-token paged decode
    oracle slot for slot."""
    q, kp, vp, pt, qs, ql, kl = _ragged_case([(1, 6), (1, 11), (1, 3)], 4,
                                             2, 8, 4, 4, seed=2)
    want = np.asarray(jref.paged_decode_reference(
        jnp.asarray(q)[:, None], jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(pt), jnp.asarray(kl)))[:, 0]
    got = tops.ragged_paged_attention(*_torch((q, kp, vp, pt, qs, ql, kl)),
                                      max_q=4).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# paged decode attention (the cases of tests/test_kernels.py:134-137)
# ---------------------------------------------------------------------------

def _paged_decode_case(b, hq, hkv, d, p, ps, mp, seed=0):
    """Each slot owns a distinct page run; unused table entries name the
    null page 0.  The last slot is idle (length 0) when pages run out."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, hq, d), dtype=np.float32)
    kp = rng.standard_normal((p, hkv, ps, d), dtype=np.float32)
    vp = rng.standard_normal((p, hkv, ps, d), dtype=np.float32)
    pt = np.zeros((b, mp), np.int32)
    free = list(range(1, p))
    lengths = []
    for i in range(b):
        n_tok = int(rng.integers(1, mp * ps))
        n_pages = min(-(-n_tok // ps), len(free))
        for j in range(n_pages):
            pt[i, j] = free.pop()
        lengths.append(min(n_tok, n_pages * ps))
    return q, kp, vp, pt, np.asarray(lengths, np.int32)


PAGED_DECODE_CASES = [(3, 8, 2, 16, 12, 8, 4), (1, 4, 4, 32, 5, 16, 2),
                      (2, 16, 8, 8, 9, 4, 8)]


@pytest.mark.parametrize("case", PAGED_DECODE_CASES,
                         ids=["g4", "g1", "g2"])
@pytest.mark.parametrize("jimpl", ["pallas", "gather"])
def test_plain_paged_decode_matches_jax(case, jimpl):
    """The port's plain paged decode equals the Pallas page walk (interpret
    mode) and the JAX gather oracle, across partial last pages and
    null-page padding."""
    args = _paged_decode_case(*case)
    want = np.asarray(_jax_paged_decode(*[jnp.asarray(a) for a in args],
                                        impl=jimpl,
                                        interpret=jimpl == "pallas"))
    got = tops.paged_decode_attention(*_torch(args)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_plain_paged_decode_idle_slot_and_impls():
    """A slot of length 0 gets zeros; impl="plain" is the CPU default;
    an unknown impl is refused by name."""
    q, kp, vp, pt, lengths = _torch(_paged_decode_case(3, 8, 2, 16, 12, 8,
                                                       4, seed=3))
    lengths[1] = 0
    out = tops.paged_decode_attention(q, kp, vp, pt, lengths)
    assert torch.equal(out[1], torch.zeros_like(out[1]))
    assert torch.equal(out, tops.paged_decode_attention(q, kp, vp, pt,
                                                        lengths,
                                                        impl="plain"))
    with pytest.raises(ValueError, match="unknown paged decode impl"):
        tops.paged_decode_attention(q, kp, vp, pt, lengths, impl="pallas")


# ---------------------------------------------------------------------------
# attention over dense K/V (the FLASH_CASES of tests/test_kernels.py:29-37
# and the per-row offsets of :83-95)
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # (B, Sq, Skv, Hq, Hkv, D, causal, window)
    (2, 64, 64, 4, 4, 16, True, None),
    (2, 64, 64, 4, 2, 16, True, None),
    (1, 128, 128, 8, 2, 32, False, None),
    (2, 64, 64, 4, 4, 16, True, 24),
    (1, 96, 96, 2, 1, 64, True, None),
    (3, 32, 32, 6, 3, 8, True, None),
    # hubert-xlarge's bidirectional heads: reduced (4 x 16) and the
    # published width's D = 80; yi-34b's G = 7
    (2, 48, 48, 4, 4, 16, False, None),
    (1, 40, 40, 2, 2, 80, False, None),
    (1, 24, 24, 14, 2, 16, True, None),
]
FLASH_ATOL = 1e-4


def _qkv(b, sq, skv, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, hq, d), dtype=np.float32),
            rng.standard_normal((b, skv, hkv, d), dtype=np.float32),
            rng.standard_normal((b, skv, hkv, d), dtype=np.float32))


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_plain_attention_matches_pallas_flash(case):
    """The port's plain attention (causal or not, sliding window) equals the
    Pallas flash kernel in interpret mode."""
    b, sq, skv, hq, hkv, d, causal, win = case
    q, k, v = _qkv(b, sq, skv, hq, hkv, d, seed=sq + d)
    want = np.asarray(_jax_flash(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal, window=win,
                                 block_q=32, block_kv=32, interpret=True))
    got = tops.multi_head_attention(*_torch((q, k, v)), causal=causal,
                                    window=win).numpy()
    np.testing.assert_allclose(got, want, atol=FLASH_ATOL, rtol=0)


@pytest.mark.parametrize("window", [None, 24])
def test_plain_attention_chunked_offsets_match_pallas_flash(window):
    """Chunked prefill: per-row q_offset and kv_len (with and without a
    window), against the Pallas flash kernel and the JAX oracle."""
    q, k, v = _qkv(2, 48, 96, 4, 2, 16, seed=11)
    kv_len = np.asarray([80, 60], np.int32)
    q_off = np.asarray([32, 12], np.int32)
    want = np.asarray(_jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, kv_len=jnp.asarray(kv_len),
        q_offset=jnp.asarray(q_off), block_q=32, block_kv=32,
        interpret=True))
    oracle = np.asarray(jref.mha_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, kv_len=jnp.asarray(kv_len),
        q_offset=jnp.asarray(q_off)))
    got = tops.multi_head_attention(
        *_torch((q, k, v)), causal=True, window=window,
        kv_len=torch.from_numpy(kv_len),
        q_offset=torch.from_numpy(q_off)).numpy()
    np.testing.assert_allclose(got, want, atol=FLASH_ATOL, rtol=0)
    np.testing.assert_allclose(got, oracle, atol=ATOL, rtol=0)


def test_plain_attention_single_query_and_masked_rows():
    """Sq = 1 dense decode (q_offset = lengths, kv_len = lengths + 1, one
    idle slot far past the cache) and rows with no visible key (zeros),
    against the JAX oracle."""
    q, k, v = _qkv(3, 1, 32, 4, 2, 16, seed=5)
    lengths = np.asarray([0, 17, 40], np.int32)
    got = tops.multi_head_attention(
        *_torch((q, k, v)), kv_len=torch.from_numpy(lengths + 1),
        q_offset=torch.from_numpy(lengths)).numpy()
    want = np.asarray(jref.mha_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_len=jnp.asarray(lengths + 1), q_offset=jnp.asarray(lengths)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # a query before every key (q_offset -1, causal) sees nothing: 0
    masked = tops.multi_head_attention(*_torch((q, k, v)), q_offset=-1)
    assert torch.equal(masked, torch.zeros_like(masked))


# the edges of the Hopper kernel's tensor-core tiles (64-key tiles, 16-row
# m16 tiles of flattened (query, head) rows): G = 1, D = 64 and 16, a
# 37-query chunk (148 rows at G = 4: two full 64-row blocks and a partial
# one), a row with kv_len 0, a window narrower than one tile, and a decode
# (Sq = 1) with a window; small Skv, per-row q_offset and kv_len
FLASH_EDGE_CASES = {
    # B, Sq, Skv, Hq, Hkv, D, q_offset, kv_len, window
    "g1": (2, 16, 64, 4, 4, 16, [40, 0], [56, 16], None),
    "d64_sq37": (2, 37, 96, 6, 2, 64, [50, 0], [87, 37], None),
    "d16_sq37_g4": (2, 37, 80, 8, 2, 16, [40, 3], [77, 40], None),
    "kv_len0": (3, 8, 64, 4, 2, 16, [20, 0, 40], [28, 0, 48], None),
    "window_under_tile": (2, 16, 96, 4, 2, 16, [60, 10], [76, 26], 5),
    "decode_window": (3, 1, 64, 8, 2, 32, [30, 0, 63], [31, 0, 64], 7),
}


@pytest.mark.parametrize("name", FLASH_EDGE_CASES)
def test_plain_attention_tile_edges_match_pallas_flash(name):
    """The plain attention at the tile edges of the Hopper kernel, against
    the Pallas flash kernel in interpret mode and the JAX oracle; a row
    with kv_len 0 is exactly 0."""
    b, sq, skv, hq, hkv, d, q_off, kv_len, win = FLASH_EDGE_CASES[name]
    q, k, v = _qkv(b, sq, skv, hq, hkv, d, seed=sq + d + b)
    kv_len = np.asarray(kv_len, np.int32)
    q_off = np.asarray(q_off, np.int32)
    jargs = dict(causal=True, window=win, kv_len=jnp.asarray(kv_len),
                 q_offset=jnp.asarray(q_off))
    want = np.asarray(_jax_flash(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), block_q=32, block_kv=32,
                                 interpret=True, **jargs))
    oracle = np.asarray(jref.mha_reference(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), **jargs))
    got = tops.multi_head_attention(
        *_torch((q, k, v)), causal=True, window=win,
        kv_len=torch.from_numpy(kv_len),
        q_offset=torch.from_numpy(q_off)).numpy()
    np.testing.assert_allclose(got, want, atol=FLASH_ATOL, rtol=0)
    np.testing.assert_allclose(got, oracle, atol=ATOL, rtol=0)
    assert np.all(got[kv_len == 0] == 0)


# tight packing (segments back to back: q_start 0, 37, 137), partial last
# pages at page sizes 8 and 32, and G = 8 query heads per KV head
TIGHT_SEGS = [(37, 45), (100, 130), (5, 140)]


@pytest.mark.parametrize("g", [1, 8])
@pytest.mark.parametrize("ps", [8, 32])
def test_plain_ragged_tight_packing_and_page_sizes_match_pallas(ps, g):
    """The plain version against the Pallas kernel (interpret mode) with
    segments packed with no gaps, at page sizes 8 and 32 and at G = 1 and
    G = 8: every packed row belongs to a segment, so a row written past
    its segment's q_len would land on the next segment's rows."""
    hkv, d, max_q = 2, 16, 100
    mp = -(-max(kl for _, kl in TIGHT_SEGS) // ps)
    args = _ragged_case(TIGHT_SEGS, g * hkv, hkv, d, ps, mp, seed=ps + g)
    assert list(args[4]) == [0, 37, 137]
    assert args[0].shape[0] == sum(ql for ql, _ in TIGHT_SEGS)
    want = np.asarray(_jax_ragged(*[jnp.asarray(a) for a in args],
                                  max_q=max_q, impl="pallas",
                                  interpret=True))
    got = tops.ragged_paged_attention(*_torch(args), max_q=max_q).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the launch plans of the flash and dense decode wrappers (pure Python: the
# CUDA side takes what they return)
# ---------------------------------------------------------------------------

H100_SMS = 132
# minitron-8b's heads (Hq 32 over Hkv 8, D 128) at chip_smoke.py's flash
# profiles: (B, Sq, Skv)
MAIN_FLASH = {"prefill": (2, 128, 2048), "prefill_partial": (2, 37, 2048),
              "dense_decode": (8, 1, 2048), "window": (1, 128, 8192)}


def _flash_plan(shape, hq=32, hkv=8, d=128, dtype=torch.bfloat16):
    b, sq, skv = shape
    return flash_attention._plan(b, sq, skv, hq, hkv, d, dtype, H100_SMS)


def test_flash_plan_at_the_main_path_shapes():
    """bf16 prefill takes the tensor-core route in 64-row blocks and no
    split; the dense decode and the window profile split their keys over
    at least 2 x 132 blocks; the decode's rows fit one 16-row block."""
    pre = _flash_plan(MAIN_FLASH["prefill"])
    assert (pre.route, pre.block_rows, pre.row_blocks, pre.n_split,
            pre.part_rows) == ("tensor_core", 64, 8, 1, 0)
    for name in ("dense_decode", "window"):
        b = MAIN_FLASH[name][0]
        plan = _flash_plan(MAIN_FLASH[name])
        assert plan.route == "tensor_core" and plan.n_split > 1
        assert b * 8 * plan.blocks >= 2 * H100_SMS
        assert plan.part_rows == b * 8 * plan.blocks * plan.block_rows
    assert _flash_plan(MAIN_FLASH["dense_decode"]).block_rows == 16
    assert _flash_plan(MAIN_FLASH["window"]).block_rows == 64
    part = _flash_plan(MAIN_FLASH["prefill_partial"])
    assert (part.block_rows, part.row_blocks) == (64, 3)  # 148 rows


@pytest.mark.parametrize("dtype,d", [(torch.float32, 128),
                                     (torch.bfloat16, 72),
                                     (torch.bfloat16, 256),
                                     (torch.float32, 16)])
def test_flash_plan_cuda_core_route(dtype, d):
    """f32, and bf16 at a D off the 16-wide tiles or above 128, take the
    CUDA-core walk, unsplit and without scratch."""
    for shape in MAIN_FLASH.values():
        plan = _flash_plan(shape, d=d, dtype=dtype)
        assert (plan.route, plan.n_split, plan.part_rows) \
            == ("cuda_core", 1, 0)


@pytest.mark.parametrize("d", [16, 64, 128])
def test_flash_plan_tile_edges(d):
    """Every bf16 D % 16 == 0 up to 128 takes the tensor-core route;
    deepseek's G = 1 decode and prefill split; the split never exceeds the
    key tiles or the combine's bound."""
    for hq, hkv in ((16, 16), (24, 8), (4, 2)):
        for b, sq, skv in ((8, 1, 2048), (2, 128, 2048), (3, 16, 64),
                           (1, 1, 16)):
            plan = _flash_plan((b, sq, skv), hq=hq, hkv=hkv, d=d)
            assert plan.route == "tensor_core"
            assert plan.block_rows == (16 if sq * hq // hkv <= 16 else 64)
            assert 1 <= plan.n_split <= min(flash_attention.MAX_SPLIT,
                                            -(-skv // 64))
    ds_decode = _flash_plan((8, 1, 2048), hq=16, hkv=16, d=d)
    assert 8 * 16 * ds_decode.blocks >= 2 * H100_SMS


def test_plans_at_the_registry_shapes():
    """The shapes this slice adds on the card.  yi-34b (Hq 56 over Hkv 8,
    G = 7, rows per query not a power of two): a 2 x 128 prefill takes 14
    64-row blocks per (row, KV head), 896 rows, unsplit; the 8-slot decode
    one 16-row block (7 rows) split like minitron's; the ragged kernel's
    sub-batches the same.  hubert-xlarge (Hq = Hkv = 16, D = 80,
    bidirectional; the plan never reads ``causal``): 4 x 1,024 frames in
    16 64-row blocks, 1,024 blocks in all, unsplit, on the tensor-core
    route."""
    pre = flash_attention._plan(2, 128, 2048, 56, 8, 128, torch.bfloat16,
                                H100_SMS)
    assert (pre.route, pre.block_rows, pre.row_blocks, pre.n_split) \
        == ("tensor_core", 64, 14, 1)
    assert pre.row_blocks * pre.block_rows >= 128 * 7
    dec = ragged_attention._plan(8, 1, 128, 16, 56, 8, 128, torch.bfloat16,
                                 H100_SMS)
    assert (dec.route, dec.block_rows, dec.row_blocks) \
        == ("tensor_core", 16, 1)
    assert dec == ragged_attention._plan(8, 1, 128, 16, 32, 8, 128,
                                         torch.bfloat16, H100_SMS)
    rpre = ragged_attention._plan(2, 128, 128, 16, 56, 8, 128,
                                  torch.bfloat16, H100_SMS)
    assert (rpre.block_rows, rpre.row_blocks, rpre.n_split) == (64, 14, 1)
    hub = flash_attention._plan(4, 1024, 1024, 16, 16, 80, torch.bfloat16,
                                H100_SMS)
    assert attention_tc.tensor_core_route(torch.bfloat16, 80)
    assert (hub.route, hub.block_rows, hub.row_blocks, hub.n_split,
            hub.part_rows) == ("tensor_core", 64, 16, 1, 0)
    assert flash_attention._plan(4, 1024, 1024, 16, 16, 80, torch.float32,
                                 H100_SMS).route == "cuda_core"


def test_plain_bidirectional_attention_at_hubert_widths_matches_jax():
    """The encoder's full pass: non-causal attention over every frame, at
    the reduced config's heads (4 of 16) and at the published D = 80,
    against the JAX oracle."""
    for hq, d in ((4, 16), (2, 80)):
        q, k, v = _qkv(2, 33, 33, hq, hq, d, seed=d)
        want = np.asarray(jref.mha_reference(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False))
        got = tops.multi_head_attention(*_torch((q, k, v)), causal=False)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
        causal = tops.multi_head_attention(*_torch((q, k, v)))
        assert not np.allclose(causal.numpy()[:, 0], want[:, 0])


def test_decode_plan_at_the_main_path_shapes():
    """The dense decode at minitron's and deepseek's heads (8 rows, a
    2048-key cache): in bf16 the tensor-core route with the flash
    forward's plan at Sq = 1, one 16-row block split over at least
    2 x 132 blocks; f32 and D = 72 take the CUDA-core walk, whose fixed
    64-key-aligned shares always combine, with G rows of scratch."""
    for hq, hkv in ((32, 8), (16, 16)):
        plan = decode_attention._plan(8, 2048, hq, hkv, 128, torch.bfloat16,
                                      H100_SMS)
        assert plan == flash_attention._plan(8, 1, 2048, hq, hkv, 128,
                                             torch.bfloat16, H100_SMS)
        assert (plan.route, plan.block_rows, plan.row_blocks,
                plan.split_keys) == ("tensor_core", 16, 1, 0)
        assert 8 * hkv * plan.n_split >= 2 * H100_SMS
        assert plan.part_rows == 8 * hkv * plan.n_split * 16
        for dtype, d in ((torch.float32, 128), (torch.bfloat16, 72)):
            cc = decode_attention._plan(8, 2048, hq, hkv, d, dtype,
                                        H100_SMS)
            assert cc.route == "cuda_core" and cc.split_keys % 64 == 0
            assert cc.n_split == -(-2048 // cc.split_keys)
            assert cc.part_rows == 8 * hkv * cc.n_split * (hq // hkv)
    # a grid that already fills the card is not split, and a one-split
    # tensor-core call writes its rows without scratch
    big = decode_attention._plan(64, 2048, 32, 8, 128, torch.bfloat16,
                                 H100_SMS)
    assert (big.n_split, big.part_rows) == (1, 0)


@pytest.mark.parametrize("b,hkv,t", [(1, 8, 4096), (4, 8, 4096),
                                     (4, 8, 2112), (1, 8, 65536)])
def test_decode_plan_long_cache_stays_within_the_combine(b, hkv, t):
    """A cache longer than 2048 keys at few (row, KV head) pairs (B Hkv = 8
    or 32) would ask for more splits than the tensor-core combine takes
    (one a lane): the plan holds n_split to MAX_SPLIT, with scratch for
    exactly that many."""
    plan = decode_attention._plan(b, t, 32, hkv, 128, torch.bfloat16,
                                  H100_SMS)
    assert plan.route == "tensor_core"
    assert 1 < plan.n_split <= flash_attention.MAX_SPLIT
    assert plan.part_rows == b * hkv * plan.n_split * 16
    cc = decode_attention._plan(b, t, 32, hkv, 128, torch.float32, H100_SMS)
    assert cc.n_split == -(-t // cc.split_keys)


def test_plans_read_no_tensor():
    """The plans are functions of plain ints and a dtype: they never see
    kv_len, q_offset or lengths, which lie on the card (nor, for the WKV
    scan, any tensor)."""
    import inspect
    for fn in (flash_attention._plan, decode_attention._plan,
               ragged_attention._plan, paged_decode_attention._plan,
               rwkv6_scan._plan):
        params = inspect.signature(fn).parameters
        assert "kv_len" not in params and "lengths" not in params
        assert "q_len" not in params
        assert all(p.annotation in ("int", "torch.dtype")
                   for p in params.values())


# minitron-8b's heads (Hq 32 over Hkv 8) and deepseek-moe-16b's (16 over
# 16), D 128, at the engine's sub-batches: the decode sub-batch (8 segments,
# max_q 1) and the prefill sub-batch (2 rows of a 128-token chunk), over
# tables of 128 pages of 16 keys
RAGGED_MAIN = {
    # (S, max_q, Hq, Hkv): (block rows, row blocks, n_split)
    (8, 1, 32, 8): (16, 1, 17),
    (2, 128, 32, 8): (64, 8, 1),
    (8, 1, 16, 16): (16, 1, 9),
    (2, 128, 16, 16): (64, 2, 9),
}


@pytest.mark.parametrize("shape", list(RAGGED_MAIN),
                         ids=["decode", "prefill", "deepseek_decode",
                              "deepseek_prefill"])
def test_ragged_plan_at_the_main_path_shapes(shape):
    """bf16 takes the tensor-core route with the shared plan at B = S,
    Sq = max_q, Skv = max_pages x page_size: the decode sub-batch one
    16-row block per (segment, KV head), split 17 ways (9 at G = 1); the
    prefill sub-batch 64-row blocks, unsplit at G = 4 and split 9 ways at
    G = 1; scratch for every split block's rows."""
    s, max_q, hq, hkv = shape
    plan = ragged_attention._plan(s, max_q, 128, 16, hq, hkv, 128,
                                  torch.bfloat16, H100_SMS)
    assert plan == attention_tc.plan(s, max_q, 128 * 16, hq, hkv, 128,
                                     torch.bfloat16, H100_SMS)
    assert plan.route == "tensor_core"
    assert (plan.block_rows, plan.row_blocks, plan.n_split) \
        == RAGGED_MAIN[shape]
    want_rows = s * hkv * plan.blocks * plan.block_rows
    assert plan.part_rows == (want_rows if plan.n_split > 1 else 0)


@pytest.mark.parametrize("hq,hkv", [(32, 8), (16, 16), (24, 8)])
def test_paged_decode_plan_is_the_ragged_plan_at_max_q_1(hq, hkv):
    """The paged decode is the ragged function at q_len = 1: in bf16 its
    plan is the ragged plan of a max_q = 1 sub-batch over the same table,
    with no fixed key shares."""
    for b, mp, ps in ((8, 128, 16), (2, 256, 16), (3, 16, 128),
                      (5, 64, 8)):
        plan = paged_decode_attention._plan(b, mp, ps, hq, hkv, 128,
                                            torch.bfloat16, H100_SMS)
        assert plan == ragged_attention._plan(b, 1, mp, ps, hq, hkv, 128,
                                              torch.bfloat16, H100_SMS)
        assert (plan.route, plan.block_rows, plan.split_keys) \
            == ("tensor_core", 16, 0)
    main = paged_decode_attention._plan(8, 128, 16, 32, 8, 128,
                                        torch.bfloat16, H100_SMS)
    assert (main.n_split, main.part_rows) == (17, 8 * 8 * 17 * 16)


@pytest.mark.parametrize("s,max_q", [(1, 1), (2, 1), (1, 128), (1, 37)])
def test_ragged_and_paged_decode_plans_long_pool(s, max_q):
    """A 65,536-key table at few (segment, KV head) pairs asks for more
    splits than the tensor-core combine takes (one a lane): both plans hold
    n_split to MAX_SPLIT, with scratch for exactly that many."""
    plan = ragged_attention._plan(s, max_q, 4096, 16, 32, 8, 128,
                                  torch.bfloat16, H100_SMS)
    assert 1 < plan.n_split <= attention_tc.MAX_SPLIT
    assert plan.part_rows == s * 8 * plan.blocks * plan.block_rows
    pd = paged_decode_attention._plan(s, 4096, 16, 32, 8, 128,
                                      torch.bfloat16, H100_SMS)
    assert pd.n_split == attention_tc.MAX_SPLIT


@pytest.mark.parametrize("dtype,d", [(torch.float32, 128),
                                     (torch.bfloat16, 72),
                                     (torch.bfloat16, 256),
                                     (torch.float32, 64)])
def test_ragged_and_paged_decode_plans_cuda_core_route(dtype, d):
    """f32, and bf16 at a D off the 16-wide tiles or above 128, keep the
    CUDA-core kernels: the ragged one unsplit without scratch, the paged
    decode's in fixed shares of SPLIT_KEYS keys with G rows of scratch for
    every share."""
    for s, max_q in ((8, 1), (2, 128)):
        plan = ragged_attention._plan(s, max_q, 128, 16, 32, 8, d, dtype,
                                      H100_SMS)
        assert (plan.route, plan.n_split, plan.part_rows) \
            == ("cuda_core", 1, 0)
    pd = paged_decode_attention._plan(8, 128, 16, 32, 8, d, dtype, H100_SMS)
    assert pd.route == "cuda_core"
    assert pd.split_keys == paged_decode_attention.SPLIT_KEYS
    assert pd.n_split == -(-128 * 16 // paged_decode_attention.SPLIT_KEYS)
    assert pd.part_rows == 8 * 8 * pd.n_split * 4


# ---------------------------------------------------------------------------
# dense decode attention (the Pallas ``_decode_kernel``'s function)
# ---------------------------------------------------------------------------

_jax_decode = jax.jit(pallas_decode_attention,
                      static_argnames=("block_kv", "interpret"))
# (B, T, Hq, Hkv, D, Pallas block_kv): the cases of tests/test_kernels.py
DECODE_CASES = [(3, 96, 8, 2, 16, 32), (1, 64, 4, 4, 32, 16),
                (2, 128, 16, 8, 8, 64),
                # the Hopper kernel's tile edges: G = 1 at D = 64, G = 3
                # at D = 64 (granite-moe's heads), G = 4 at D = 16
                (3, 80, 4, 4, 64, 16), (2, 96, 6, 2, 64, 32),
                (4, 64, 8, 2, 16, 16)]
BF16_ULP = 2.0 ** -7


def _decode_case(b, t, hq, hkv, d, seed, dtype):
    """q, k, v as numpy (rounded to bf16 and widened back for bf16)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((b, 1, hq, d), (b, t, hkv, d), (b, t, hkv, d))]
    if dtype == "bfloat16":
        arrs = [torch.from_numpy(a).bfloat16().float().numpy() for a in arrs]
    return arrs


def _check_decode(got, want, dtype):
    """float32: atol 1e-5 (softmax sums in another order); bfloat16: both
    sides sum in f32 and round once, so one bf16 ulp more."""
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    ulp = BF16_ULP * np.abs(want) if dtype == "bfloat16" else 0.0
    assert np.all(np.abs(got - want) <= ATOL + ulp), \
        float(np.abs(got - want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=lambda c: "x".join(map(str, c[:5])))
def test_plain_decode_attention_matches_jax(case, dtype):
    """ops.decode_attention (plain on the CPU) against the JAX oracle as
    tests/test_kernels.py defines it and the Pallas kernel in interpret
    mode, on the reference test's lengths."""
    b, t, hq, hkv, d, bk = case
    q, k, v = _decode_case(b, t, hq, hkv, d, seed=t, dtype=dtype)
    lengths = (np.arange(1, b + 1) * (t // (b + 1)) + 1).astype(np.int32)
    jdt = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    oracle = jref.mha_reference(jq, jk, jv, causal=False,
                                kv_len=jnp.asarray(lengths),
                                q_offset=jnp.asarray(lengths) - 1)
    pallas = _jax_decode(jq, jk, jv, lengths=jnp.asarray(lengths),
                         block_kv=bk, interpret=True)
    tdt = getattr(torch, dtype)
    got = tops.decode_attention(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
        lengths=torch.from_numpy(lengths))
    assert got.dtype == tdt and got.shape == (b, 1, hq, d)
    _check_decode(got, oracle, dtype)
    _check_decode(got, pallas, dtype)


def test_plain_decode_attention_length_zero_row():
    """A row of length 0 is zeros, as the Pallas kernel's l_safe makes it;
    a row past the cache sees every key."""
    b, t, hq, hkv, d = 3, 64, 8, 2, 16
    q, k, v = _decode_case(b, t, hq, hkv, d, seed=7, dtype="float32")
    lengths = np.asarray([0, 5, t], np.int32)
    pallas = _jax_decode(*(jnp.asarray(x) for x in (q, k, v)),
                         lengths=jnp.asarray(lengths), block_kv=16,
                         interpret=True)
    got = tops.decode_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                lengths=torch.from_numpy(lengths))
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    _check_decode(got, pallas, "float32")
    plain = tops.decode_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                  lengths=torch.from_numpy(lengths),
                                  impl="plain")
    assert torch.equal(got, plain)


# ---------------------------------------------------------------------------
# the WKV scan's launch plan (pure Python: the CUDA side takes what it
# returns and refuses a combination it does not build)
# ---------------------------------------------------------------------------

# rwkv6-3b's 40 heads of 64 at the two-dispatch engine's calls: (B, T)
WKV_MAIN = {"prefill": (2, 128), "prefill_partial": (2, 37),
            "decode": (8, 1)}


@pytest.mark.parametrize("name", list(WKV_MAIN))
def test_wkv_plan_at_the_main_path_shapes(name):
    """At the main path's shapes the grid gives every one of the 132 SMs
    a block, 4 columns a thread over 8 row groups; a prefill call stages
    32-step chunks through both ring slots, a decode step one step in
    one slot."""
    b, t = WKV_MAIN[name]
    plan = rwkv6_scan._plan(b, t, 40, 64, torch.bfloat16, H100_SMS)
    assert plan.grid >= H100_SMS
    assert plan.grid == b * 40 * (64 // plan.cols)
    assert (plan.cpt, plan.row_groups) == (4, 8)
    assert plan.threads == plan.row_groups * plan.cols // plan.cpt
    if t == 1:
        assert (plan.chunk, plan.ring) == (1, 1)
    else:
        assert (plan.chunk, plan.ring) == (32, 2)


H100_SMEM_PER_BLOCK = 232_448  # dynamic shared memory a block may ask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n", rwkv6_scan.HEAD_SIZES)
def test_wkv_plan_fits_the_card(n, dtype):
    """For every head size, both dtypes and shapes from an idle row to
    long prompts: the block the source builds for the head size, at most
    1024 threads in whole warps, row groups that divide the head into
    groups of a multiple of 4 rows, shared memory within an H100 block's
    232,448 bytes, and a second ring slot exactly when T spans more than
    one chunk."""
    for b in (1, 2, 8, 64):
        for t in (0, 1, 2, 31, 32, 33, 37, 128, 161, 2048):
            for h in (4, 40):
                plan = rwkv6_scan._plan(b, t, h, n, dtype, H100_SMS)
                assert (plan.cols, plan.cpt, plan.row_groups) == \
                    rwkv6_scan.SHAPES[n]
                assert plan.threads <= 1024 and plan.threads % 32 == 0
                assert n % plan.row_groups == 0
                assert (n // plan.row_groups) % 4 == 0
                assert plan.smem <= H100_SMEM_PER_BLOCK
                assert plan.smem % 16 == 0
                assert 1 <= plan.chunk <= max(t, 1)
                assert plan.ring == (2 if t > plan.chunk else 1)
                assert plan.grid == b * h * (n // plan.cols)


@pytest.mark.parametrize("b", [2, 5, 64])
def test_wkv_plan_chunk_depends_on_t_alone(b):
    """The chunk is min(32, T) whatever the grid: a prefill of many rows
    queues its blocks at the chunk a 2-row prefill takes, and the SM count
    changes nothing."""
    for t in (1, 7, 32, 37, 128, 2048):
        plans = {rwkv6_scan._plan(b, t, 40, 64, torch.bfloat16, sms)
                 for sms in (1, H100_SMS, 1024)}
        assert len(plans) == 1
        (plan,) = plans
        assert plan.chunk == min(rwkv6_scan.CHUNK, t)
