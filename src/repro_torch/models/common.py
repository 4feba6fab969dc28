"""Shared model utilities: the training loss and the position table of
``repro.models.common``, and the in-place tree edits of the recurrent
families' caches."""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..dist.constrain import constrain, unshard
from ..dist.sharding import is_dtensor

__all__ = ["cross_entropy", "sinusoidal_table", "copy_tree", "stack_states"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                  z_loss: float = 1e-4):
    """Token-level cross-entropy in f32 with the z-loss; ``labels < 0``
    are masked.  logits (B, S, V), labels (B, S) ->
    ``(loss, {"nll", "accuracy", "tokens"})``, 0-d tensors.  The label's
    log-probability is a gather; under a mesh it is the reference's
    one-hot contraction, which keeps a sharded vocab axis sharded and
    picks the same value (the other terms are exact zeros)."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    if is_dtensor(lf):
        # the reference's one-hot contraction: it keeps a vocab axis
        # sharded over ``model`` where a gather would all-gather it
        vocab = torch.arange(lf.shape[-1], device=lf.device)
        onehot = (torch.clamp_min(labels, 0).long()[..., None]
                  == vocab).to(torch.float32)
        onehot = constrain(onehot, "dp", None, "tp")
        ll = torch.sum(lf * onehot, dim=-1)
    else:
        ll = torch.gather(lf, -1, torch.clamp_min(labels, 0).long()[
            ..., None])[..., 0]
    nll = lse - ll
    mask = (labels >= 0).to(torch.float32)
    denom = torch.clamp_min(torch.sum(mask), 1.0)
    loss = torch.sum(nll * mask) / denom
    if z_loss:
        loss = loss + z_loss * torch.sum(torch.square(lse) * mask) / denom
    with torch.no_grad():
        pred = _argmax_rows(lf) if is_dtensor(lf) else torch.argmax(lf, -1)
        acc = torch.sum((pred == labels) * mask) / denom
    return loss, {"nll": (torch.sum(nll * mask) / denom).detach(),
                  "accuracy": acc, "tokens": torch.sum(mask)}


def _argmax_rows(lf):
    """``argmax`` over the last axis of a DTensor, each rank on its own
    rows (a vocab axis sharded over ``model`` is gathered first)."""
    from torch.distributed.tensor import DTensor
    rows = unshard(lf, -1)
    return DTensor.from_local(torch.argmax(rows.to_local(), -1),
                              rows.device_mesh, rows.placements,
                              run_check=False)


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
