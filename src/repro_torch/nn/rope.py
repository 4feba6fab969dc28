"""Rotary position embeddings (port of ``repro.nn.rope``).

Inverse frequencies are computed once in NumPy, as in the reference.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["rope_frequencies", "apply_rope"]


@functools.lru_cache(maxsize=64)
def rope_frequencies(rot_dim: int, theta: float) -> np.ndarray:
    """inv_freq (rot_dim // 2,) float32."""
    return (1.0 / (theta ** (np.arange(0, rot_dim, 2, dtype=np.float64)
                             / rot_dim))).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _inv_freq(rot_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """The frequencies on ``device``, copied once (a host-to-device copy
    per call would stall the stream on every layer)."""
    return torch.from_numpy(rope_frequencies(rot_dim, theta).copy()).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10000.0, fraction: float = 1.0) -> torch.Tensor:
    """Rotate the leading ``fraction`` of the head dim of ``x`` (..., S, D);
    pairs split as [even, odd] halves (the llama/neox convention)."""
    d = x.shape[-1]
    rot = int(d * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    inv_freq = _inv_freq(rot, theta, x.device)
    ang = positions[..., None].to(torch.float32) * inv_freq
    cos, sin = torch.cos(ang), torch.sin(ang)
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    out = torch.cat([r1.to(x.dtype), r2.to(x.dtype)], dim=-1)
    if rot < d:
        out = torch.cat([out, xp], dim=-1)
    return out
