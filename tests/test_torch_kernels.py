"""Port parity: the plain PyTorch ragged paged attention
(``repro_torch.kernels``) against the JAX oracle and the Pallas kernel in
interpret mode, on the segment mixes of ``tests/test_kernels.py``.

Inputs are made from numpy seeds and handed to both frameworks; everything
runs in float32 on the CPU.  Rows in packing gaps are unspecified on both
sides and masked.  Tolerance: atol 1e-5 (float32 softmax over at most a
few dozen keys, summed in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

ATOL = 1e-5

# one compiled program per case instead of op-by-op dispatch
_jax_ragged = jax.jit(jops.ragged_paged_attention,
                      static_argnames=("max_q", "impl", "interpret"))


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
