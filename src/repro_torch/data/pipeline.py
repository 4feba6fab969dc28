"""Synthetic batches (copy of ``SyntheticLM``, ``make_batch``,
``batch_struct`` and ``Prefetcher`` of ``repro.data.pipeline``).

NumPy only and seeded, so the port's CLIs and ``chip_smoke.py`` draw the
same prompts and training batches, and the same stub encoder frames and
image patch embeddings, as the reference for a given seed.  A batch is a
pure function of (seed, step): a restored training run replays its data
without any loader state.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

__all__ = ["SyntheticLM", "make_batch", "batch_struct", "Prefetcher"]


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


def batch_struct(cfg, batch: int, seq: int, dtype=torch.bfloat16):
    """Shape-and-dtype stand-ins matching :func:`make_batch`, as tensors on
    the ``meta`` device (no storage: the PyTorch form of the reference's
    ``ShapeDtypeStruct``s, for dry runs)."""
    meta = dict(device="meta")
    s = {"tokens": torch.empty((batch, seq), dtype=torch.int32, **meta),
         "labels": torch.empty((batch, seq), dtype=torch.int32, **meta)}
    if cfg.family == "encdec":
        s["enc_input"] = torch.empty(
            (batch, min(seq, cfg.enc_len_cap), cfg.d_model), dtype=dtype,
            **meta)
    if cfg.family == "vlm":
        s["img_embed"] = torch.empty((batch, cfg.n_img_tokens, cfg.d_model),
                                     dtype=dtype, **meta)
    return s


class Prefetcher:
    """One-step-ahead background batch producer: a thread calls
    ``fn(step)`` for consecutive steps from ``start_step`` and queues
    ``(step, batch)`` (at most ``depth`` ahead); iterate to take them in
    order, :meth:`close` to stop."""

    def __init__(self, fn, start_step: int = 0, depth: int = 2):
        self._fn = fn
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            item = self._fn(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, item), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
