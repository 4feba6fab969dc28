"""Synthetic batches (copy of ``SyntheticLM`` and ``make_batch`` of
``repro.data.pipeline``).

NumPy only and seeded, so the port's serving CLI and ``chip_smoke.py``
draw the same prompts, and the same stub encoder frames and image
patch embeddings, as the reference for a given seed.
"""

from __future__ import annotations

import numpy as np

__all__ = ["SyntheticLM", "make_batch"]


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

    def batch(self, step: int, batch: int, seq: int):
        toks = self.tokens(step, batch, seq)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


def make_batch(cfg, step: int, batch: int, seq: int, *, seed: int = 0,
               dtype=np.float32):
    """Family-aware numpy batch: ``encdec`` adds ``enc_input``, stub frame
    embeddings (B, min(seq, enc_len_cap), d_model) * 0.02, and ``vlm``
    adds ``img_embed``, stub patch embeddings (B, n_img_tokens, d_model)
    * 0.02, each from the same ``RandomState`` stream as the
    reference."""
    src = SyntheticLM(cfg.vocab, seed=seed)
    b = src.batch(step, batch, seq)
    rng = np.random.RandomState((seed * 7 + step) % 2**31)
    if cfg.family == "encdec":
        enc_len = min(seq, cfg.enc_len_cap)
        b["enc_input"] = rng.randn(batch, enc_len,
                                   cfg.d_model).astype(dtype) * 0.02
    if cfg.family == "vlm":
        b["img_embed"] = rng.randn(batch, cfg.n_img_tokens,
                                   cfg.d_model).astype(dtype) * 0.02
    return b
