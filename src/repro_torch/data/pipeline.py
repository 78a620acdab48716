"""Deterministic, shardable, resumable token pipeline: the port's copy of
``repro.data.pipeline`` (numpy only; the port keeps its own copy and
imports nothing of the JAX package).  ``batch_at(step)`` gives the
reference's batches exactly.

Production properties the fault-tolerance story depends on:

  * **deterministic**: batch ``i`` is a pure function of (seed, i, shard) —
    a restarted job that resumes from step ``s`` consumes exactly the
    batches it would have seen, with no state files to lose;
  * **host-sharded**: each data-parallel host reads only its shard
    (``shard_id / num_shards``), matching the (pod, data) mesh axes;
  * **resumable**: ``state_dict()`` is just the step counter, checkpointed
    alongside the model;
  * **file or synthetic**: a binary token file (uint16/uint32 memmap) or a
    seeded synthetic corpus with Zipfian unigram structure + induction
    patterns, so a ~100M-param model shows a real, decreasing loss.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    shard_id: int = 0
    num_shards: int = 1
    path: str | None = None  # token memmap; None => synthetic

    @property
    def local_batch(self) -> int:
        assert self.global_batch % self.num_shards == 0
        return self.global_batch // self.num_shards


def synthetic_corpus(vocab: int, n_tokens: int, seed: int = 0) -> np.ndarray:
    """Zipfian tokens with planted copy patterns (learnable structure)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1)
    probs = 1.0 / ranks
    probs /= probs.sum()
    toks = rng.choice(vocab, size=n_tokens, p=probs).astype(np.int32)
    # plant induction patterns: [a b ... a -> b]
    for _ in range(n_tokens // 64):
        i = rng.integers(0, n_tokens - 8)
        j = rng.integers(0, n_tokens - 8)
        toks[j:j + 4] = toks[i:i + 4]
    return toks


class TokenPipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.step = 0
        if cfg.path is not None:
            dtype = np.uint32 if cfg.vocab > 65535 else np.uint16
            self.tokens = np.memmap(Path(cfg.path), dtype=dtype, mode="r")
        else:
            self.tokens = synthetic_corpus(cfg.vocab, 1 << 20, cfg.seed)
        self.n = len(self.tokens)

    # -- resumability ------------------------------------------------------------
    def state_dict(self) -> dict:
        return {"step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])

    # -- batches ------------------------------------------------------------------
    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """Batch for global step ``step`` on this shard — pure function."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 65_537 + cfg.shard_id)
        starts = rng.integers(0, self.n - cfg.seq_len - 1,
                              size=cfg.local_batch)
        idx = starts[:, None] + np.arange(cfg.seq_len + 1)[None, :]
        window = np.asarray(self.tokens[idx % self.n], np.int32)
        return {"x": window[:, :-1] % cfg.vocab,
                "targets": window[:, 1:] % cfg.vocab}

    def __next__(self) -> dict[str, np.ndarray]:
        batch = self.batch_at(self.step)
        self.step += 1
        return batch

    def __iter__(self):
        return self
