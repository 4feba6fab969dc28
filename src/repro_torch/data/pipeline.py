"""Markov-chain token source (copy of ``repro.data.pipeline.SyntheticLM``).

NumPy only and seeded, so the port's serving CLI and ``chip_smoke.py``
draw the same prompts as the reference's ``serve`` CLI for a given seed.
"""

from __future__ import annotations

import numpy as np

__all__ = ["SyntheticLM"]


class SyntheticLM:
    """Each symbol ``v`` prefers a small successor set (``branching``
    choices drawn once from the seed)."""

    def __init__(self, vocab: int, *, seed: int = 0, branching: int = 4):
        self.vocab = int(vocab)
        self.seed = seed
        self.k = branching
        rng = np.random.RandomState(seed)
        self._succ = rng.randint(0, self.vocab,
                                 size=(min(self.vocab, 4096), branching))

    def tokens(self, step: int, batch: int, seq: int) -> np.ndarray:
        rng = np.random.RandomState((self.seed * 1_000_003 + step) % 2**31)
        out = np.empty((batch, seq + 1), np.int64)
        cur = rng.randint(0, self.vocab, size=batch)
        out[:, 0] = cur
        choice = rng.randint(0, self.k, size=(batch, seq))
        for t in range(seq):
            row = self._succ[cur % self._succ.shape[0], choice[:, t]]
            cur = row % self.vocab
            out[:, t + 1] = cur
        return out
