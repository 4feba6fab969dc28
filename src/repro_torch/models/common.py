"""Shared model utilities (copy of the position table of
``repro.models.common``)."""

from __future__ import annotations

import functools

import numpy as np

__all__ = ["sinusoidal_table"]


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
