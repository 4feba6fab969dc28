"""Token embedding and the tied LM head (port of ``repro.nn.embedding``)."""

from __future__ import annotations

import torch

from .context import DEFAULT_CTX, QuantContext

__all__ = ["embedding_init", "embed", "unembed"]


def embedding_init(gen: torch.Generator, vocab: int, d: int, *,
                   dtype=torch.float32, device="cpu"):
    tbl = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                      device=device) * (d ** -0.5)
    return {"table": tbl.to(dtype)}


def embed(p, tokens: torch.Tensor, ctx: QuantContext = DEFAULT_CTX, *,
          scale_by_dim: bool = False) -> torch.Tensor:
    """tokens (B, S) -> (B, S, D) in the compute dtype; ``scale_by_dim``
    multiplies by sqrt(d) rounded to that dtype first, as the reference
    does (gemma)."""
    tbl = p["table"]
    y = tbl[tokens.to(torch.int64)].to(ctx.compute_dtype)
    if scale_by_dim:
        # torch.full launches a fill; torch.tensor(..., device=) would copy
        # from the host and stall the stream
        y = y * torch.full((), tbl.shape[-1] ** 0.5, dtype=y.dtype,
                           device=y.device)
    return y


def unembed(p, x: torch.Tensor, ctx: QuantContext = DEFAULT_CTX) -> torch.Tensor:
    """(B, S, D) -> logits (B, S, V) against the tied table: a plain
    product (the reference leaves it to XLA)."""
    tbl = p["table"].to(ctx.compute_dtype)
    return torch.matmul(x.to(ctx.compute_dtype), tbl.t())
