"""Beam-search decoding (the port of ``repro.serving.beam``): S_b parallel
hypotheses share the prompt's prefill, each appending its own suffix to a
row of a dense cache.  Each step decodes all beams, expands by top-k over
the joint (beam x vocab) scores, and reorders the cache rows by gathering
on the batch axis.

It runs eagerly, like the batch-1 ``SpeculativeDecoder``: the prefill is
one ``Model.prefill_chunk`` over the whole prompt and every step one
``Model.decode_step``, both on the dense cache (on the card, the flash
kernel); the scoring is the reference's, in numpy on the host."""

from __future__ import annotations

from dataclasses import fields, replace

import numpy as np
import torch

from ..models.model import Model, ModelCache


def _gather_rows(cache: ModelCache, order: torch.Tensor) -> ModelCache:
    """The cache whose row i is old row ``order[i]``, in every tensor of
    every layer (K/V and, quantized, their scales) and in ``lengths``,
    as the reference's ``jnp.take`` on the batch axis (``order`` repeats
    a row that several new beams extend)."""
    layers = [replace(layer, **{f.name: t.index_select(0, order)
                                for f in fields(layer)
                                if (t := getattr(layer, f.name)) is not None})
              for layer in cache.layers]
    return ModelCache(layers=layers,
                      lengths=cache.lengths.index_select(0, order),
                      views=cache.views)


def _log_softmax(logits: torch.Tensor) -> np.ndarray:
    """Float32 log-probabilities on the host."""
    return torch.log_softmax(logits.float(), -1).cpu().numpy()


class BeamSearcher:
    """Beam search over ``model`` (which carries its weights and device)
    with ``beam_size`` hypotheses, a dense cache of ``max_seq`` tokens per
    beam and the length penalty ``len ** length_penalty``."""

    def __init__(self, model: Model, beam_size: int = 4,
                 max_seq: int = 512, length_penalty: float = 0.6):
        self.model = model
        self.sb = beam_size
        self.alpha = length_penalty
        self.max_seq = max_seq

    @torch.no_grad()
    def search(self, prompt: list[int], max_new_tokens: int,
               eos_id: int | None = None) -> tuple[list[int], float]:
        sb, dev = self.sb, self.model.device
        cache = self.model.init_cache(sb, self.max_seq, layout="dense")
        toks = torch.tensor([prompt] * sb, dtype=torch.int32, device=dev)
        logits, cache = self.model.prefill_chunk(cache, toks)

        logp = _log_softmax(logits)
        # first expansion: the top S_b distinct continuations of beam 0
        top = np.argsort(-logp[0], kind="stable")[:sb]
        scores = logp[0][top]
        beams = [[int(t)] for t in top]
        last = top.astype(np.int32)[:, None]
        done: list[tuple[float, list[int]]] = []

        for _ in range(max_new_tokens - 1):
            logits, cache = self.model.decode_step(
                cache, torch.from_numpy(last).to(dev))
            logp = _log_softmax(logits)
            joint = scores[:, None] + logp  # (S_b, V)
            flat = joint.reshape(-1)
            top = np.argsort(-flat)[: 2 * sb]  # over-sample for eos exits
            new_beams, new_scores, order, new_last = [], [], [], []
            for idx in top:
                b, t = divmod(int(idx), logp.shape[1])
                cand = beams[b] + [t]
                if eos_id is not None and t == eos_id:
                    lp = len(cand) ** self.alpha
                    done.append((flat[idx] / lp, cand))
                    continue
                new_beams.append(cand)
                new_scores.append(flat[idx])
                order.append(b)
                new_last.append(t)
                if len(new_beams) == sb:
                    break
            if not new_beams:
                break
            beams, scores = new_beams, np.asarray(new_scores)
            last = np.asarray(new_last, np.int32)[:, None]
            cache = _gather_rows(cache, torch.tensor(order, dtype=torch.long,
                                                     device=dev))

        for b, s in zip(beams, scores):
            done.append((s / (len(b) ** self.alpha), b))
        done.sort(key=lambda x: -x[0])
        return done[0][1], float(done[0][0])
