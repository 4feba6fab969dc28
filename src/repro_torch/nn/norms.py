"""RMSNorm and LayerNorm with f32 statistics (port of ``repro.nn.norms``)."""

from __future__ import annotations

import torch

__all__ = ["rmsnorm_init", "rmsnorm", "layernorm_init", "layernorm"]


def rmsnorm_init(d: int, dtype=torch.float32, device="cpu"):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x: torch.Tensor, *, eps: float = 1e-6,
            plus_one: bool = False) -> torch.Tensor:
    """RMS normalization; ``plus_one`` is gemma's (1 + scale) form."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    scale = p["scale"].to(torch.float32)
    if plus_one:
        scale = 1.0 + scale
    return (y * scale).to(x.dtype)


def layernorm_init(d: int, dtype=torch.float32, device="cpu"):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """Layer normalization: f32 mean and variance, ``rsqrt``, then scale
    and bias (whisper)."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    return y.to(x.dtype)
