"""Speculative decoding (paper §IV-B; the port of
``repro.serving.speculative``): a draft model proposes K tokens
autoregressively, the target verifies all K+1 positions in one pass, and
rejection sampling keeps the target's distribution exact (Leviathan et
al.).

Two implementations, as in the reference:

**PackedSpeculator** — the engine's path.  With
``ServeEngine(unified=True, n_spec=K)`` every decode slot contributes a
K+1-token verify window (its committed feed token followed by K draft
proposals, causal within the window, reading the slot's pages through its
page-table row) to the packed batch, beside the chunked prefill segments.
The draft runs its own packed steps over the same slot layout against a
page-mirrored KV pool (same page ids, the engine's one allocator; the
prefill chunks run through both models, so prefix-cache hits and
preemption recompute hold for the draft too).  The whole round, draft
catch-up, K-1 proposal sub-steps, target verify, accept/reject and the
completing prefills' first tokens, is one ``StepGraph`` profile (one
CUDA-graph replay on the card), and the accepted tokens, per-slot counts
and first tokens come back in the step's one device-to-host copy.
Rollback of rejected tokens is length bookkeeping, written in place into
both caches' ``lengths`` tensors: the stale K/V past the accepted frontier
is masked by kv_len until overwritten.

**SpeculativeDecoder** — the batch-1 oracle on dense caches.

Both models and both KV pools stay resident (the paper's §IV-B memory
cost), and the target's verify processes K+1 tokens per slot.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..models import transformer as T
from ..models.attention import PackedSegs
from ..models.model import Model, ModelCache
from .sampling import _categorical, sample_slots


@dataclass
class SpecDecodeStats:
    proposed: int = 0
    accepted: int = 0
    target_passes: int = 0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / max(self.proposed, 1)

    @property
    def tokens_per_pass(self) -> float:
        return (self.accepted + self.target_passes) / max(self.target_passes,
                                                          1)


def _inv_cdf(pdf: np.ndarray, u: float) -> int:
    """Inverse-CDF draw from an unnormalized host distribution using one
    pre-pulled uniform."""
    c = np.cumsum(pdf, dtype=np.float64)
    return int(min(np.searchsorted(c, u * c[-1], side="right"),
                   len(pdf) - 1))


# ---------------------------------------------------------------------------
# device-side rejection sampling (the verify step's accept/reject core)
# ---------------------------------------------------------------------------

def rejection_accept(dec_logits: torch.Tensor, d_probs: torch.Tensor,
                     d_toks: torch.Tensor, temps: torch.Tensor,
                     widths: torch.Tensor, u_acc: torch.Tensor,
                     u_fin: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Vectorized Leviathan accept/reject over a batch of verify windows.

    ``dec_logits``: (B, K+1, V) target logits at each window position
    (position i predicts the token after draft i; position K is the bonus
    position).  ``d_probs``: (B, K, V) the draft's proposal distributions;
    ``d_toks``: (B, K) its proposals.  ``temps``: (B,) per-slot sampling
    temperature — rows at temp <= 0 use the greedy rule (accept draft i
    iff it equals the target argmax; final token = target argmax at the
    rejection/bonus position), which makes greedy outputs token-identical
    to non-speculative decoding for any draft.  ``widths``: (B,) the
    usable window width w <= K+1 (w-1 drafts are eligible; 0 = inactive
    slot).  ``u_acc``: (B, K) accept uniforms; ``u_fin``: (B,) one
    residual/bonus draw per row.

    Returns int32 ``(accepted (B,), out_toks (B, K+1), n_emit (B,))``:
    ``out_toks[:, :accepted]`` are the accepted drafts, position
    ``accepted`` holds the residual resample (or the bonus draw when every
    eligible draft was accepted), and ``n_emit = accepted + 1`` tokens are
    committed per active row (0 on an inactive one).
    """
    b, k = d_toks.shape
    v = dec_logits.shape[-1]
    i32 = torch.int32
    dt = d_toks.long()
    tt = temps.float().clamp(min=1e-4)[:, None, None]
    greedy = temps <= 0.0
    p_t = torch.softmax(dec_logits.float() / tt, -1)
    p_t_d = p_t[:, :k].gather(-1, dt[..., None])[..., 0]
    p_d_d = d_probs.gather(-1, dt[..., None])[..., 0]
    ratio_ok = u_acc < (p_t_d / p_d_d.clamp(min=1e-20)).clamp(max=1.0)
    greedy_ok = dt == dec_logits[:, :k].argmax(-1)
    acc = torch.where(greedy[:, None], greedy_ok, ratio_ok)
    eligible = torch.arange(k, device=acc.device)[None, :]
    acc &= eligible < (widths - 1)[:, None]
    # accepted count = length of the all-accepted prefix
    a = acc.to(i32).cumprod(dim=1).sum(dim=1)
    al = a.long()
    p_t_a = p_t.gather(1, al[:, None, None].expand(b, 1, v))[:, 0]
    p_d_a = d_probs.gather(1, al.clamp(max=k - 1)[:, None, None]
                           .expand(b, 1, v))[:, 0]
    # every eligible draft accepted -> bonus draw straight from the
    # target; otherwise resample the rejection position's residual
    full = a >= (widths - 1).clamp(min=0)
    resid = (p_t_a - torch.where(full[:, None], 0.0, p_d_a)).clamp(min=0.0)
    resid = torch.where(resid.sum(-1, keepdim=True) > 0, resid, p_t_a)
    cdf = resid.cumsum(-1)
    # the first index whose cdf reaches the draw
    draw = (cdf >= u_fin[:, None] * cdf[:, -1:]).to(i32).argmax(-1)
    logits_a = dec_logits.gather(1, al[:, None, None].expand(b, 1, v))[:, 0]
    final = torch.where(greedy, logits_a.argmax(-1), draw).to(i32)
    out = torch.cat([d_toks.to(i32), torch.zeros((b, 1), dtype=i32,
                                                  device=d_toks.device)], 1)
    out.scatter_(1, al[:, None], final[:, None])
    n_emit = torch.where(widths > 0, a + 1, 0).to(i32)
    return a.to(i32), out, n_emit


# ---------------------------------------------------------------------------
# the engine's batched draft/verify component
# ---------------------------------------------------------------------------

class PackedSpeculator:
    """Batched draft/verify for the unified engine.

    Owns the draft model's paged KV pool (page-id-mirrored with the
    target's: the engine's one ``PageAllocator`` governs both, and prefill
    and verify write both pools at the same page ids), the host mirror of
    per-slot draft-consumed lengths, and the round of the engine's two spec
    profiles (mixed decode+prefill, decode-only): :meth:`staged_fields` is
    the layout of a profile's staged inputs, :meth:`step_fn` its step.  The
    engine stages the host-side layout, runs the profile (one replay, one
    device-to-host copy) and commits lengths through :meth:`commit_slot`.

    Packed layouts (all static: no capture across accept churn):

    * draft catch-up: slot s's <= 2 unconsumed tokens at offset 2s
      (1 token steady-state; 2 after a fully-accepted round's bonus),
      prefill row r's chunk at ``2 * max_slots + r * chunk_size``;
    * draft proposals: K-1 single-token layouts (slot s at s);
    * target verify: slot s's K+1-token window (feed + K drafts) at
      offset ``s * (K+1)``, prefill row r's chunk at
      ``max_slots * (K+1) + r * chunk_size``.
    """

    def __init__(self, target: Model, draft: Model, *, n_spec: int,
                 max_slots: int, max_seq: int, chunk_size: int,
                 prefill_rows: int, page_size: int, n_pages: int):
        if n_spec < 1:
            raise ValueError("PackedSpeculator needs n_spec >= 1")
        if draft.spec.vocab != target.spec.vocab:
            raise ValueError(
                f"draft vocab {draft.spec.vocab} != target vocab "
                f"{target.spec.vocab}: verification compares distributions "
                "over one shared vocabulary")
        if any(kind == "ssm" for kind in draft.spec.layer_kinds()):
            raise ValueError(
                "the packed draft step supports attention-only stacks; "
                f"{draft.spec.name!r} has SSM layers")
        if draft.spec.attn.kind == "swa":
            raise ValueError("the packed draft step has no sliding-window "
                             "masking in the ragged kernel yet")
        self.target = target
        self.draft = draft
        self.k = n_spec
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.chunk = chunk_size
        self.rows = prefill_rows
        self.max_pages = max_seq // page_size
        # page-id-mirrored pool: same n_pages as the target, so the
        # engine's page-table rows address both pools unchanged
        self.d_cache = draft.init_cache(max_slots, max_seq, layout="paged",
                                        page_size=page_size, n_pages=n_pages)
        # host mirror: tokens whose K/V the draft pool holds, per slot
        self.d_lens = np.zeros((max_slots,), np.int64)

    # -- host bookkeeping ---------------------------------------------------
    def install_slot(self, slot: int, length: int) -> None:
        """A prompt promoted into ``slot``: the packed prefill ran through
        both models, so the draft pool holds exactly the first ``length``
        tokens."""
        self.d_lens[slot] = length

    def catch_up(self, slot: int, src: list[int]) -> tuple[int, list[int]]:
        """The slot's unconsumed draft feed: ``(g, tokens)`` with
        g in {1, 2} — the tokens of ``src`` past the draft frontier, ending
        with the committed feed token ``src[-1]``."""
        tail = src[int(self.d_lens[slot]):]
        return len(tail), tail

    def commit_slot(self, slot: int, length: int, emitted: int,
                    proposal_steps: int) -> None:
        """Post-round rollback bookkeeping, mirroring the device update:
        the draft consumed its catch-up plus ``proposal_steps`` in-bounds
        proposals, then rolls back to the committed frontier
        ``length + emitted`` (stale K/V of rejected proposals is masked by
        kv_len until overwritten)."""
        consumed = length + 1 + proposal_steps
        self.d_lens[slot] = min(consumed, length + emitted)

    def release_slot(self, slot: int) -> None:
        self.d_lens[slot] = 0

    def proposal_steps(self, length: int) -> int:
        """How many of the K-1 proposal sub-steps stay in bounds for a slot
        at committed length ``length`` (position L+i must fit the
        page-table row)."""
        return sum(1 for i in range(1, self.k)
                   if length + i <= self.max_seq - 1)

    # -- the round ------------------------------------------------------------
    def staged_fields(self, mixed: bool
                      ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
        """The staged inputs of a spec profile (the reference's ``dispatch``
        arguments): per slot the committed feed token, the draft's
        unconsumed tokens, the committed length, the draft gap and the
        verify width, the slot page table; per sampled segment its
        temperature, top-k and top-p; with ``mixed`` the prefill rows'
        packed chunks and segment table."""
        b, mp, i32, f32 = self.max_slots, self.max_pages, torch.int32, \
            torch.float32
        n_samp = b + self.rows if mixed else b
        out = {"feed": ((b,), i32), "d_feed": ((b, 2), i32),
               "lengths": ((b,), i32), "gaps": ((b,), i32),
               "widths": ((b,), i32), "ptab": ((b, mp), i32),
               "temps": ((n_samp,), f32), "topks": ((n_samp,), i32),
               "topps": ((n_samp,), f32)}
        if mixed:
            t = self.rows * self.chunk
            out.update({"pre_tokens": ((t,), i32),
                        "pre_positions": ((t,), i32),
                        "pre_q_len": ((self.rows,), i32),
                        "pre_kv_len": ((self.rows,), i32),
                        "pre_ptab": ((self.rows, mp), i32)})
        return out

    def n_out(self, mixed: bool) -> int:
        """Length of a profile's flat int32 output: ``out_toks`` (B, K+1),
        ``n_emit`` (B,) and, mixed, the prefill rows' first tokens."""
        b = self.max_slots
        return b * (self.k + 1) + b + (self.rows if mixed else 0)

    def split(self, pulled: np.ndarray
              ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """A profile's pulled output -> (out_toks, n_emit, pre_sampled)."""
        b, w1 = self.max_slots, self.k + 1
        return (pulled[:b * w1].reshape(b, w1), pulled[b * w1:b * (w1 + 1)],
                pulled[b * (w1 + 1):])

    def step_fn(self, cache: ModelCache, inp: dict[str, torch.Tensor],
                generator: torch.Generator, *, mixed: bool
                ) -> Callable[[], torch.Tensor]:
        """A spec profile's step on the staged inputs ``inp``: the whole
        round, the target pool ``cache`` and the draft pool written in
        place; returns the flat int32 output (see :meth:`n_out`)."""
        return lambda: self._step(cache, inp, generator, mixed=mixed)

    def _step(self, cache: ModelCache, inp: dict[str, torch.Tensor],
              generator: torch.Generator, *, mixed: bool) -> torch.Tensor:
        k, w1, b = self.k, self.k + 1, self.max_slots
        csize, rows = self.chunk, self.rows
        i32 = torch.int32
        dev = cache.lengths.device
        lengths, gaps, widths, ptab = (inp[n] for n in
                                       ("lengths", "gaps", "widths", "ptab"))
        temps = inp["temps"]
        active = gaps > 0
        tt = temps[:b].clamp(min=1e-4)[:, None]
        greedy = temps[:b] <= 0.0
        slots = torch.arange(b, dtype=i32, device=dev)
        row_q = torch.arange(rows, dtype=i32, device=dev) * csize

        def propose(logits):
            """Per-slot draft proposal + its distribution (greedy rows
            propose the argmax; the distribution is only consulted by the
            stochastic accept rule)."""
            lg = logits.float() / tt
            tok = torch.where(greedy, logits.argmax(-1).to(i32),
                              _categorical(lg, generator))
            return tok, torch.softmax(lg, -1)

        def packed(q_start, q_len, kv_len, table, *, max_q, decode_q):
            if mixed:  # the prefill rows ride along after the slots
                return PackedSegs(
                    torch.cat([q_start, q_start.shape[0] * decode_q + row_q]),
                    torch.cat([q_len, inp["pre_q_len"]]),
                    torch.cat([kv_len, inp["pre_kv_len"]]),
                    torch.cat([table, inp["pre_ptab"]]),
                    max_q=max(csize, max_q), n_decode=b, decode_q=decode_q)
            return PackedSegs(q_start, q_len, kv_len, table, max_q=max_q,
                              n_decode=0, decode_q=decode_q)

        def with_prefill(tokens, positions):
            if mixed:
                return (torch.cat([tokens, inp["pre_tokens"]]),
                        torch.cat([positions, inp["pre_positions"]]))
            return tokens, positions

        # ---- draft phase 1: catch-up (+ the same prefill chunks) ----------
        # slot s consumes its <= 2 unconsumed tokens (ending with the
        # committed feed) at offset 2s; prefill rows ride along so the
        # draft pool holds every prompt the target pool holds
        cpos = (lengths[:, None] + torch.arange(2, dtype=i32, device=dev)
                - (gaps - 1)[:, None]).clamp(min=0).reshape(-1)
        d_logits, _ = self.draft.unified_step(
            self.d_cache, *with_prefill(inp["d_feed"].reshape(-1), cpos),
            packed(slots * 2, gaps, lengths + active.to(i32), ptab,
                   max_q=2, decode_q=2))
        tok, p = propose(d_logits[:b])
        d_toks, d_probs = [tok], [p]

        # ---- draft phase 2: K-1 single-token proposal sub-steps -----------
        for i in range(1, k):
            pos_i = lengths + i
            ql_i = (active & (pos_i < self.max_seq)).to(i32)
            lg, _ = self.draft.unified_step(
                self.d_cache, d_toks[-1], pos_i,
                PackedSegs(slots, ql_i, pos_i + 1, ptab, max_q=1))
            tok, p = propose(lg[:b])
            d_toks.append(tok)
            d_probs.append(p)
        d_toks_a = torch.stack(d_toks, dim=1)  # (B, K)
        d_probs_a = torch.stack(d_probs, dim=1)  # (B, K, V)

        # ---- target verify: feed + K drafts per slot, causal in-window ----
        t_tok = torch.cat([inp["feed"][:, None], d_toks_a], 1).reshape(-1)
        t_pos = (lengths[:, None] + torch.arange(w1, dtype=i32, device=dev)
                 ).reshape(-1)
        dec_logits, seg_logits, _ = self.target.verify_step(
            cache, *with_prefill(t_tok, t_pos),
            packed(slots * w1, widths, lengths + widths, ptab, max_q=w1,
                   decode_q=w1),
            n_decode=b, width=w1)

        # ---- device-side accept/reject ------------------------------------
        u_acc = torch.rand((b, k), generator=generator, device=dev)
        u_fin = torch.rand((b,), generator=generator, device=dev)
        _, out_toks, n_emit = rejection_accept(
            dec_logits, d_probs_a, d_toks_a, temps[:b], widths, u_acc, u_fin)
        outs = [out_toks.reshape(-1), n_emit]

        # ---- completing prefills sample their first token as usual --------
        if mixed:
            outs.append(sample_slots(seg_logits[b:], temps[b:],
                                     inp["topks"][b:], inp["topps"][b:],
                                     generator))

        # ---- rollback = length bookkeeping, in place in both caches -------
        # target frontier: committed + emitted; draft frontier: consumed
        # catch-up + in-bounds proposals, rolled back to the target's
        proposal_ok = sum((active & (lengths + i < self.max_seq)).to(i32)
                          for i in range(1, k))
        d_fin = torch.minimum(lengths + 1 + proposal_ok, lengths + n_emit)
        cache.lengths.copy_(torch.where(active, lengths + n_emit,
                                        cache.lengths))
        self.d_cache.lengths.copy_(torch.where(active, d_fin,
                                               self.d_cache.lengths))
        return torch.cat(outs)


# ---------------------------------------------------------------------------
# batch-1 oracle
# ---------------------------------------------------------------------------

class SpeculativeDecoder:
    """Speculative decoding for a single stream — the verification oracle
    the packed engine path is tested against.  Dense caches on the
    target's device; ``seed`` seeds its generator."""

    def __init__(self, target: Model, draft: Model, n_spec: int = 4,
                 max_seq: int = 512, temperature: float = 1.0,
                 seed: int = 0):
        if draft.spec.vocab != target.spec.vocab:
            raise ValueError(f"draft vocab {draft.spec.vocab} != target "
                             f"vocab {target.spec.vocab}")
        self.target, self.draft = target, draft
        self.n = n_spec
        self.temp = max(temperature, 1e-4)
        self.device = target.device
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed)
        self.t_cache = target.init_cache(1, max_seq, layout="dense")
        self.d_cache = draft.init_cache(1, max_seq, layout="dense")
        self.stats = SpecDecodeStats()
        # host mirrors of the cache lengths: stop conditions and feed
        # slicing never need a device sync
        self._t_len = 0
        self._d_len = 0

    def _probs(self, logits: torch.Tensor) -> torch.Tensor:
        return torch.softmax(logits.float() / self.temp, -1)

    def _draw(self, p: torch.Tensor) -> torch.Tensor:
        return _categorical(torch.log(p), self.generator)

    def _tokens(self, toks: list[int]) -> torch.Tensor:
        return torch.tensor([toks], dtype=torch.int32, device=self.device)

    def prefill(self, prompt: list[int]) -> int:
        """Consume the prompt in both models; returns the first token.
        Invariant from here on: each cache holds exactly ``seq[:-1]`` —
        everything but the newest token, which the next round consumes."""
        toks = self._tokens(prompt)
        t_logits, self.t_cache = self.target.prefill_chunk(self.t_cache,
                                                           toks)
        _, self.d_cache = self.draft.prefill_chunk(self.d_cache, toks)
        self._t_len = self._d_len = len(prompt)
        tok = int(self._draw(self._probs(t_logits))[0])
        self.seq = list(prompt) + [tok]
        return tok

    def decode_round(self) -> list[int]:
        """One draft-propose / target-verify cycle; returns >= 1 newly
        accepted tokens (appended to ``self.seq``).  One device->host
        copy per round."""
        n = self.n
        seq = self.seq

        # --- draft catch-up + n autoregressive proposals ------------------
        # feed whatever the draft hasn't consumed yet (>= 1 token: the
        # newest; +1 more after a fully-accepted round with bonus token);
        # each proposal feeds the next decode step on the device
        logits, self.d_cache = self.draft.prefill_chunk(
            self.d_cache, self._tokens(seq[self._d_len:]))
        self._d_len = len(seq)
        d_toks, d_probs = [], []
        for i in range(n):
            p = self._probs(logits)[0]
            tok = self._draw(p[None])
            d_toks.append(tok)
            d_probs.append(p)
            if i < n - 1:
                logits, self.d_cache = self.draft.decode_step(
                    self.d_cache, tok[None])
                self._d_len += 1
        self.stats.proposed += n

        # --- target verifies [unconsumed seq suffix, d_1 .. d_n] ----------
        gap = seq[self._t_len:]  # >= 1 tokens, ends with seq[-1]
        d_toks_t = torch.cat(d_toks)
        verify = torch.cat([self._tokens(gap)[0], d_toks_t])[None]
        t_logits_all, new_t_cache = self._verify_logits(verify)
        self.stats.target_passes += 1
        base = len(gap) - 1  # logits index predicting d_1

        # --- the round's single device->host copy -------------------------
        p_t_all = self._probs(t_logits_all[base:base + n + 1])
        us = torch.rand((n + 1,), generator=self.generator,
                        device=self.device)
        v = p_t_all.shape[-1]
        pulled = torch.cat([torch.stack(d_probs).reshape(-1),
                            p_t_all.reshape(-1), us,
                            d_toks_t.float()]).cpu().numpy()
        d_probs_h = pulled[:n * v].reshape(n, v)
        p_t_h = pulled[n * v:(2 * n + 1) * v].reshape(n + 1, v)
        us_h = pulled[(2 * n + 1) * v:(2 * n + 1) * v + n + 1]
        d_toks_h = pulled[(2 * n + 1) * v + n + 1:].astype(np.int64)

        # --- accept/reject on the host copies -----------------------------
        accepted: list[int] = []
        for i in range(n):
            d_tok = int(d_toks_h[i])
            p_t, p_d = p_t_h[i], d_probs_h[i]
            if us_h[i] < min(1.0, float(p_t[d_tok])
                             / max(float(p_d[d_tok]), 1e-20)):
                accepted.append(d_tok)
                self.stats.accepted += 1
            else:
                # resample from the residual distribution with the spare
                # uniform (us_h[n] is spent on at most one draw per round)
                resid = np.maximum(p_t.astype(np.float64)
                                   - p_d.astype(np.float64), 0.0)
                if resid.sum() <= 0:
                    resid = p_t.astype(np.float64)
                accepted.append(_inv_cdf(resid, float(us_h[n])))
                break
        else:
            # all n accepted: bonus token from the target's last position
            accepted.append(_inv_cdf(p_t_h[n].astype(np.float64),
                                     float(us_h[n])))

        self._commit(seq, accepted, new_t_cache)
        return accepted

    def _commit(self, seq, accepted, new_t_cache) -> None:
        """Roll back to the accepted frontier: caches hold ``seq[:-1]``
        (accepted[:-1] were consumed and match seq; positions beyond are
        stale K/V of rejected proposals, masked off by the truncation)."""
        self.seq = seq + accepted
        frontier = len(self.seq) - 1
        self._t_len = frontier
        self._d_len = min(self._d_len, frontier)
        self.t_cache = self._truncate(new_t_cache, self._t_len)
        self.d_cache = self._truncate(self.d_cache, self._d_len)

    def _truncate(self, cache: ModelCache, length: int) -> ModelCache:
        return ModelCache(layers=cache.layers,
                          lengths=torch.tensor([length], dtype=torch.int32,
                                               device=self.device))

    @torch.no_grad()
    def _verify_logits(self, tokens: torch.Tensor
                       ) -> tuple[torch.Tensor, ModelCache]:
        """Target logits for every position of the verify chunk (the flash
        kernel at Sq = gap + K on the card), its K/V written in place."""
        model, cache = self.target, self.t_cache
        s = tokens.shape[1]
        positions = cache.lengths[:, None].long() + torch.arange(
            s, device=self.device)
        x = T.apply_stack(model.spec, model.layers,
                          model.embed[tokens.long()], positions,
                          cache.layers, lengths=cache.lengths,
                          impl=model.kernel_impl)
        return model._logits(x)[0], ModelCache(layers=cache.layers,
                                               lengths=cache.lengths + s)

    def generate(self, prompt: list[int], max_new_tokens: int) -> list[int]:
        out = [self.prefill(prompt)]
        while len(out) < max_new_tokens:
            out.extend(self.decode_round())
        return out[:max_new_tokens]
