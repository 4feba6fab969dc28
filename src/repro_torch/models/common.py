"""Shared model utilities: the training loss and the position table of
``repro.models.common``, and the in-place tree edits of the recurrent
families' caches."""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["cross_entropy", "sinusoidal_table", "copy_tree", "stack_states"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                  z_loss: float = 1e-4):
    """Token-level cross-entropy in f32 with the z-loss; ``labels < 0``
    are masked.  logits (B, S, V), labels (B, S) ->
    ``(loss, {"nll", "accuracy", "tokens"})``, 0-d tensors.  The label's
    log-probability is a gather (the reference's one-hot contraction,
    which it uses to keep a sharded vocab axis, picks the same value)."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, torch.clamp_min(labels, 0).long()[..., None])[
        ..., 0]
    nll = lse - ll
    mask = (labels >= 0).to(torch.float32)
    denom = torch.clamp_min(torch.sum(mask), 1.0)
    loss = torch.sum(nll * mask) / denom
    if z_loss:
        loss = loss + z_loss * torch.sum(torch.square(lse) * mask) / denom
    with torch.no_grad():
        acc = torch.sum((torch.argmax(lf, -1) == labels) * mask) / denom
    return loss, {"nll": (torch.sum(nll * mask) / denom).detach(),
                  "accuracy": acc, "tokens": torch.sum(mask)}


@functools.lru_cache(maxsize=16)
def sinusoidal_table(length: int, d: int) -> np.ndarray:
    """Sinusoidal position table (whisper encoder), computed in f64 and
    stored as f32: bitwise the reference's."""
    pos = np.arange(length, dtype=np.float64)[:, None]
    dim = np.arange(0, d, 2, dtype=np.float64)[None, :]
    inv = np.exp(-np.log(10000.0) * dim / d)
    tbl = np.zeros((length, d), np.float32)
    tbl[:, 0::2] = np.sin(pos * inv)
    tbl[:, 1::2] = np.cos(pos * inv)
    return tbl


def copy_tree(dst, src) -> None:
    """Copy every tensor of ``src`` into the same leaf of ``dst``, in
    place (``dst`` keeps its addresses; broadcasting as ``copy_``)."""
    if isinstance(dst, dict):
        for k in dst:
            copy_tree(dst[k], src[k])
    else:
        dst.copy_(src)


def stack_states(states):
    """A list of per-layer state dicts -> one dict stacked over layers."""
    return {k: torch.stack([s[k] for s in states]) for k in states[0]}
