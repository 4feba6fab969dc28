"""Learning-rate schedules (port of ``repro.optim.schedule``)."""

from __future__ import annotations

import math

import torch

__all__ = ["cosine_warmup"]


def cosine_warmup(step, *, peak: float, warmup: int, total: int,
                  floor: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak``, then cosine decay to ``floor * peak``.

    ``step`` is an int or a 0-d tensor; the result is a 0-d f32 tensor on
    ``step``'s device, computed in f32 as the reference computes it."""
    if isinstance(step, torch.Tensor):
        s = step.to(torch.float32)
    else:
        s = torch.tensor(float(step), dtype=torch.float32)
    warm = peak * s / max(warmup, 1)
    frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor * peak + (1 - floor) * peak * 0.5 * (1 + torch.cos(
        math.pi * frac))
    return torch.where(s < warmup, warm, cos)
