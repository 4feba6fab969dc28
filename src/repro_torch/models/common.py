"""Shared model utilities: the position table of ``repro.models.common``
and the in-place tree edits of the recurrent families' caches."""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["sinusoidal_table", "copy_tree", "stack_states"]


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
