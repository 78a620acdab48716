"""The WKV backward's three-stage decomposition and launch plan, on the CPU.

``csrc/rwkv6_scan_bwd.cu`` runs only on the card.  Its arithmetic is
written out here in plain torch, :func:`staged_bwd`, stage by stage as the
kernel runs it and driven by :func:`rwkv6_scan_bwd._plan`'s chunk and
sub-chunk: ``local`` (each chunk's walk from a zero gradient as one
product of prefix-scaled r and dout, the decays' product, du's share),
``carry`` (the state gradient carried over the chunks only) and ``walk``
(each chunk re-run from its boundary state, the sub-chunk starts kept,
each sub-chunk re-run and walked back from the carried gradient).  It is
held against the plain version, ``ref.rwkv6_bwd_reference``, and against
``jax.vjp`` of the reference's ``rwkv6_scan`` within 1e-5 of each
gradient's scale (the same f32 recurrence, sums in another order): 48 and
77 steps (a partial chunk), with and without a final-state gradient,
decays exp(-exp(x)) for x in [-8, 3], and decays exactly 0.  The plan at
rwkv6-3b's training shape must fill the H100 and fit its shared memory,
and the wrapper's constants and C signature must match the source's.
One torch thread, small shapes: a few seconds in all.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import build
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv6_scan
from repro_torch.kernels import rwkv6_scan_bwd as wb

N_SM = 132  # the H100's SMs
SMEM_SM = 233472  # shared memory an SM holds (228 KB), 1 KB a block reserved
SMEM_BLOCK = 232448  # a block's most (227 KB)
SRC = (build.CSRC / "rwkv6_scan_bwd.cu").read_text()


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def const(name):
    """An integer constant of the source."""
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC)[1])


# ---------------------------------------------------------------------------
# the decomposition
# ---------------------------------------------------------------------------

def _advance(s, kt, vt, wt):
    return wt[..., :, None] * s + kt[..., :, None] * vt[..., None, :]


def staged_bwd(r, k, v, w, u, bounds, dout, dstate, plan):
    """The kernel's three stages in f32 torch; returns what
    ``ref.rwkv6_bwd_reference`` returns."""
    rf, kf, vf, wf, df = (x.float() for x in (r, k, v, w, dout))
    uf = u.float()
    b, t, h, n = r.shape
    size, sub, seg = plan.chunk, plan.sub, plan.seg
    dot = (df * vf).sum(-1)  # (B, T, H)
    bu = (rf * uf * kf).sum(-1)

    # local: L_c = sum_t (r_t prod_{s < t} w_s)^T dout_t, P_c, du's share
    carry = torch.zeros((b, plan.chunks, h, n, n))
    decay = torch.zeros((b, plan.chunks, h, n))
    du_part = torch.zeros((b, plan.chunks, h, n))
    for c in range(plan.chunks):
        t0, t1 = c * size, min(t, (c + 1) * size)
        prod, scaled = torch.ones((b, h, n)), []
        for tt in range(t0, t1):
            du_part[:, c] += rf[:, tt] * kf[:, tt] * dot[:, tt, :, None]
            scaled.append(rf[:, tt] * prod)
            prod = prod * wf[:, tt]
        a = torch.stack(scaled, dim=1)
        carry[:, c] = torch.einsum("bthi,bthj->bhij", a, df[:, t0:t1])
        decay[:, c] = prod

    # carry: G_out(c - 1) = L_c + P_c G_out(c), each G_out(c) over L_c
    g = torch.zeros((b, h, n, n)) if dstate is None else dstate.float()
    for c in reversed(range(plan.chunks)):
        lc = carry[:, c].clone()
        carry[:, c] = g
        g = decay[:, c, :, :, None] * g + lc
    dstate0 = g
    du = du_part.sum((0, 1))

    # walk: each chunk from its boundary state; the states every `seg`
    # steps kept; each sub-chunk, last first, re-run from its segment's
    # state and walked back from the carried gradient
    dr, dk, dv, dw = (torch.zeros_like(rf) for _ in range(4))
    for c in range(plan.chunks):
        t0 = c * size
        nt = min(size, t - t0)
        n_seg = -(-nt // seg)
        s, starts = bounds[:, c].float(), [bounds[:, c].float()]
        for tt in range((n_seg - 1) * seg):
            s = _advance(s, kf[:, t0 + tt], vf[:, t0 + tt], wf[:, t0 + tt])
            if (tt + 1) % seg == 0:
                starts.append(s)
        g = carry[:, c]
        for sc in reversed(range(-(-nt // sub))):
            st = t0 + sc * sub
            ns = min(sub, t0 + nt - st)
            s, hist = starts[sc * sub // seg], []
            for x in range(t0 + sc * sub // seg * seg, st):
                s = _advance(s, kf[:, x], vf[:, x], wf[:, x])
            for tt in range(ns):
                hist.append(s)
                s = _advance(s, kf[:, st + tt], vf[:, st + tt],
                             wf[:, st + tt])
            for tt in reversed(range(ns)):
                x = st + tt
                rt, kt, vt, wt, dt = (y[:, x] for y in (rf, kf, vf, wf, df))
                sx = hist[tt]
                dr[:, x] = (torch.einsum("bhij,bhj->bhi", sx, dt)
                            + uf * kt * dot[:, x, :, None])
                dk[:, x] = (torch.einsum("bhij,bhj->bhi", g, vt)
                            + rt * uf * dot[:, x, :, None])
                dv[:, x] = (torch.einsum("bhij,bhi->bhj", g, kt)
                            + dt * bu[:, x, :, None])
                dw[:, x] = (g * sx).sum(-1)
                g = wt[..., :, None] * g + rt[..., :, None] * dt[..., None, :]
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw, du, dstate0)


def _case(t, seed, *, b=2, h=None, n=None, zeros=False):
    """48 steps at N = 16 (2 heads), 77 at N = 64 (one head): each head
    size's walk shape."""
    n = n or (16 if t == 48 else 64)
    h = h or (2 if n == 16 else 1)
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, t, h, n)) * 0.5 for _ in range(3))
    w = np.exp(-np.exp(rng.uniform(-8.0, 3.0, (b, t, h, n))))
    if zeros:  # some decays exactly 0, whole rows of a step among them
        w[rng.random((b, t, h, n)) < 0.1] = 0.0
        w[:, t // 2] = 0.0
    u = rng.standard_normal((h, n)) * 0.3
    state = rng.standard_normal((b, h, n, n)) * 0.2
    dout = rng.standard_normal((b, t, h, n))
    dstate = rng.standard_normal((b, h, n, n))
    return [a.astype(np.float32)
            for a in (r, k, v, w, u, state, dout, dstate)]


@functools.lru_cache(maxsize=None)
def _jax_grads(t, seed, zeros):
    """jax.vjp of the reference's rwkv6_scan (its plain recurrence: T is
    within its default chunk, so nothing is padded), applied to the
    output's gradient with and without the final state's: {True: ...,
    False: ...}."""
    *inputs, dout, dstate = _case(t, seed, zeros=zeros)
    _, vjp = jax.vjp(lambda *a: jops.rwkv6_scan(*a),
                     *(jnp.asarray(a) for a in inputs))
    return {grad: [np.asarray(g) for g in vjp((jnp.asarray(dout),
                                               jnp.asarray(ds)))]
            for grad, ds in ((True, dstate), (False, 0 * dstate))}


def _scale_close(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=0)


@pytest.mark.parametrize("t", [48, 77], ids=["t48", "t77_partial_chunk"])
@pytest.mark.parametrize("with_state_grad", [True, False],
                         ids=["state_grad", "no_state_grad"])
@pytest.mark.parametrize("zeros", [False, True], ids=["edge", "zero_decays"])
def test_stages_match_plain_and_jax_vjp(t, with_state_grad, zeros):
    r, k, v, w, u, state, dout, dstate = (
        torch.from_numpy(a) for a in _case(t, seed=t, zeros=zeros))
    dstate = dstate if with_state_grad else None
    plan = wb._plan(*r.shape)
    assert (plan.chunk, plan.chunks) == (32, -(-t // 32))
    _, _, bounds = tref.rwkv6_fwd_reference(r, k, v, w, u, state,
                                            chunk=plan.chunk)
    got = staged_bwd(r, k, v, w, u, bounds, dout, dstate, plan)
    want = tref.rwkv6_bwd_reference(r, k, v, w, u, bounds, dout, dstate,
                                    chunk=plan.chunk)
    jgot = _jax_grads(t, t, zeros)[with_state_grad]
    for name, g, wnt, jwnt in zip(("dr", "dk", "dv", "dw", "du", "dstate0"),
                                  got, want, jgot):
        assert g.dtype == wnt.dtype and g.shape == wnt.shape, name
        assert bool(torch.isfinite(g).all()), name
        _scale_close(g.numpy(), wnt.numpy())
        _scale_close(g.numpy(), jwnt)


def test_stages_with_one_short_chunk():
    """T below the chunk: one chunk of T steps (two segments, four
    sub-chunks at N = 64's walk; one short sub-chunk at N = 16's)."""
    for n in (16, 64):
        r, k, v, w, u, state, dout, dstate = (
            torch.from_numpy(a) for a in _case(13, seed=3, h=1, n=n))
        plan = wb._plan(*r.shape)
        assert (plan.chunk, plan.chunks) == (13, 1)
        _, _, bounds = tref.rwkv6_fwd_reference(r, k, v, w, u, state,
                                                chunk=13)
        got = staged_bwd(r, k, v, w, u, bounds, dout, dstate, plan)
        want = tref.rwkv6_bwd_reference(r, k, v, w, u, bounds, dout,
                                        dstate, chunk=13)
        for g, wnt in zip(got, want):
            _scale_close(g.numpy(), wnt.numpy())


# ---------------------------------------------------------------------------
# the plan and the source
# ---------------------------------------------------------------------------

def test_plan_fills_the_card_at_the_training_shape():
    """rwkv6-3b's micro-batch: 1 x 1,024 steps, 40 heads of 64."""
    p = wb._plan(1, 1024, 40, 64)
    assert (p.chunk, p.chunks) == (32, 32)
    assert (p.rows, p.cols, p.walk_threads, p.sub, p.seg) == (4, 4, 256, 4,
                                                              8)
    assert p.local_grid == p.walk_grid == 1280 >= 2 * N_SM
    assert p.carry_grid == 160 + 10
    assert p.walk_smem == 115200 and p.local_smem == 41088
    # two walk blocks an SM: 16 warps, and their shared memory fits
    assert p.walk_blocks_per_sm == 2
    assert p.walk_blocks_per_sm * (p.walk_smem + 1024) <= SMEM_SM
    assert p.walk_blocks_per_sm * p.walk_threads // 32 >= 16
    # L_c / G_out(c) a chunk, P_c and du's share: 21.6 MB, no per-step
    # partials and no per-step states in device memory
    assert p.scratch_bytes == 4 * (1280 * 64 * 64 + 2 * 1280 * 64) \
        == 21_626_880


@pytest.mark.parametrize("n", rwkv6_scan.HEAD_SIZES)
def test_plan_is_a_function_of_the_shapes(n):
    rows, threads, sub, seg, per_sm = wb.WALK[n]
    for b, t, h in ((1, 1024, 40), (2, 77, 3), (3, 5, 1), (2, 0, 4)):
        p = wb._plan(b, t, h, n)
        assert p == wb._plan(b, t, h, n)
        chunks = -(-t // rwkv6_scan.bound_chunk(t))
        assert p.chunks == chunks and p.chunk == rwkv6_scan.bound_chunk(t)
        assert p.local_grid == p.walk_grid == b * h * chunks
        assert (p.rows, p.walk_threads, p.sub, p.seg) == (rows, threads,
                                                          sub, seg)
        assert p.cols == n // 16 and p.rows * p.cols * threads == n * n
        assert seg % sub == 0 and 32 % seg == 0
        assert p.walk_smem == 4 * (5 * 32 * n + sub * n * n
                                   + sub * threads // 32 * n + n + 64)
        assert per_sm * (p.walk_smem + 1024) <= SMEM_SM
        assert p.carry_grid == -(-b * h * n * n // 1024) + -(-h * n // 256)
        assert p.scratch_bytes == 4 * b * chunks * h * (n * n + 2 * n)


def test_source_constants_and_signature_match_the_wrapper():
    assert const("kLanes") == wb.LANES
    assert const("kLocalThreads") == wb.LOCAL_THREADS
    assert const("kCarryThreads") == wb.CARRY_THREADS
    assert const("kCarryVec") == wb.CARRY_VEC
    assert const("kMaxChunk") == rwkv6_scan.CHUNK
    assert const("kSmemLimit") == SMEM_BLOCK
    walks = re.findall(r"struct Walk<(\d+)> \{\s*static constexpr int RT = "
                       r"(\d+), THREADS = (\d+), SUB = (\d+), SEG = (\d+), "
                       r"MIN_BLOCKS = (\d+);", SRC)
    assert {int(n): tuple(map(int, rest)) for n, *rest in walks} == wb.WALK
    sig = re.search(r'extern "C" int rwkv6_scan_bwd_launch\((.*?)\)',
                    SRC, re.S)[1]
    params = [p.strip() for p in sig.split(",")]
    kinds = [ctypes_kind(p) for p in params]
    assert kinds == ["p" if a.__name__ == "c_void_p" else "i"
                     for a in wb._ARGTYPES]


def ctypes_kind(param):
    return "p" if "*" in param else "i"


def test_three_stages_no_atomics_no_division_by_a_decay():
    """The three stages and nothing of the per-step partials' combine;
    no atomics; the decays only multiply."""
    for kernel in ("wkv_bwd_local", "wkv_bwd_carry", "wkv_bwd_walk"):
        assert f"__global__ void __launch_bounds__" in SRC
        assert re.search(rf"\n{kernel}\(", SRC), kernel
    assert "wkv_bwd_combine" not in SRC and "du_sum" not in SRC
    code = "\n".join(ln.split("//")[0] for ln in SRC.splitlines())
    assert "atomic" not in code
    assert "fdividef" not in code and "rcp" not in code
    assert not re.search(r"/\s*\(?\s*(w|ws|ww|wt|wi|prod|pc|decay)\b", code)
