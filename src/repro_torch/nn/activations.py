"""Activations, exact path (port of ``repro.nn.activations``).

gelu is the tanh approximation, as ``jax.nn.gelu(approximate=True)``.
The LUT path (``ctx.use_lut``) is refused by :class:`QuantContext`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .context import DEFAULT_CTX, QuantContext

__all__ = ["act_fn"]

_EXACT = {
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softplus": F.softplus,
}


def act_fn(name: str, x: torch.Tensor, ctx: QuantContext = DEFAULT_CTX, *,
           path: str = "") -> torch.Tensor:
    """Apply activation ``name`` (exact transcendental form)."""
    del ctx, path
    return _EXACT[name](x)
