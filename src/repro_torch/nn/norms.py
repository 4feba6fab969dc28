"""RMSNorm and LayerNorm with f32 statistics (port of ``repro.nn.norms``).

RMSNorm's statistic of a row does not depend on the rows around it in
the call (:func:`_row_mean`), so a speculative verify pass normalizes
each position as a decode step does, bit for bit.  LayerNorm (whisper,
which has no verify pass) keeps ``torch.mean``."""

from __future__ import annotations

import torch

__all__ = ["rmsnorm_init", "rmsnorm", "layernorm_init", "layernorm"]


def _sums_of_32(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, keepdim, as sums of at most 32 values, level
    by level (zero-padded): a level of at most 32 values an output sums
    in the same order at any number of rows."""
    while t.shape[-1] > 1:
        n = t.shape[-1]
        w = min(n, 32)
        if n % w:
            t = torch.nn.functional.pad(t, (0, w - n % w))
        t = t.reshape(*t.shape[:-1], -1, w).sum(dim=-1)
    return t


def _row_mean(t: torch.Tensor) -> torch.Tensor:
    """Mean over the last axis, keepdim, that does not depend on how many
    rows the call holds.  On the card through :func:`_sums_of_32`:
    ``torch.mean``'s reduction sizes its thread block from the number of
    rows, so a row would round otherwise in a call of more rows (a verify
    pass's B x (k + 1) against a decode step's B).  The CPU's
    ``torch.mean`` keeps one order at any row count."""
    if not t.is_cuda:
        return torch.mean(t, dim=-1, keepdim=True)
    return _sums_of_32(t) / t.shape[-1]


def rmsnorm_init(d: int, dtype=torch.float32, device="cpu"):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x: torch.Tensor, *, eps: float = 1e-6,
            plus_one: bool = False) -> torch.Tensor:
    """RMS normalization; ``plus_one`` is gemma's (1 + scale) form."""
    xf = x.to(torch.float32)
    var = _row_mean(xf * xf)
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
