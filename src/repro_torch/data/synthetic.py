"""Deterministic, seekable synthetic token stream (restart-safe); a copy
of the JAX package's ``data/synthetic.py``, which is numpy only.

Real pods stream from a sharded store; for a self-contained repro we
generate structured synthetic text (a char-level Markov-ish mixture with
copy motifs so a ~100M model visibly learns).  Every batch is a pure
function of (seed, step) — a restart at step k reproduces the exact
stream, which the checkpoint/restart test asserts.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        return make_batch(self.vocab, self.seq_len, self.batch,
                          self.seed, step)


def make_batch(vocab: int, seq_len: int, batch: int, seed: int,
               step: int) -> Dict[str, np.ndarray]:
    """Structured sequences: period-p repeats + local n-gram correlations.

    tokens[t] depends on tokens[t-p] (copy motif) and a position-mixed
    hash — learnable structure, deterministic in (seed, step).
    """
    rng = np.random.default_rng(np.uint64(seed * 1_000_003 + step))
    p = int(rng.integers(3, 17))
    base = rng.integers(0, vocab, size=(batch, seq_len), dtype=np.int64)
    t = np.arange(seq_len)
    copy_mask = (t % p) >= (p // 2)
    shifted = np.roll(base, p // 2, axis=1)
    tokens = np.where(copy_mask[None, :], shifted, base) % vocab
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1  # no target for the last position
    return {"tokens": tokens.astype(np.int32),
            "labels": labels.astype(np.int32)}
