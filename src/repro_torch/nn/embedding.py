"""Token embedding and the tied LM head (port of ``repro.nn.embedding``)."""

from __future__ import annotations

import torch

from ..dist.constrain import fsdp_gather
from ..dist.sharding import is_dtensor
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
    if is_dtensor(tbl):
        y = _embed_sharded(tbl, tokens).to(ctx.compute_dtype)
    else:
        y = tbl[tokens.to(torch.int64)].to(ctx.compute_dtype)
    if scale_by_dim:
        # torch.full launches a fill; torch.tensor(..., device=) would copy
        # from the host and stall the stream
        y = y * torch.full((), tbl.shape[-1] ** 0.5, dtype=y.dtype,
                           device=y.device)
    return y


def _embed_sharded(tbl, tokens):
    """The lookup on DTensors, vocab-parallel: the table keeps its vocab
    axis on ``model`` (its feature axis gathered over the data axes, the
    FSDP gather), each rank looks up its rows' tokens that fall in its
    vocab slice, and the result is a partial sum over ``model``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = tbl.device_mesh
    names = list(mesh.mesh_dim_names)
    tok = tokens.to(torch.int64)
    rows = tok.placements                         # the batch on dp
    on_model = ["model" in names
                and isinstance(tbl.placements[names.index("model")], Shard)]
    keep = [Shard(0) if n == "model" and on_model[0] else Replicate()
            for n in names]
    grad = [k if n == "model" else (Partial() if isinstance(r, Shard)
                                    else Replicate())
            for n, k, r in zip(names, keep, rows)]
    tl = tbl.redistribute(mesh, keep).to_local(grad_placements=grad)
    il = tok.to_local()
    if not on_model[0]:
        return DTensor.from_local(tl[il], mesh, rows, run_check=False)
    lo = mesh.get_local_rank("model") * tl.shape[0]
    inside = (il >= lo) & (il < lo + tl.shape[0])
    y = tl[torch.where(inside, il - lo, 0)] * inside[..., None].to(tl.dtype)
    out = [Partial() if n == "model" else r for n, r in zip(names, rows)]
    return DTensor.from_local(y, mesh, out, run_check=False)


def unembed(p, x: torch.Tensor, ctx: QuantContext = DEFAULT_CTX) -> torch.Tensor:
    """(B, S, D) -> logits (B, S, V) against the tied table: a plain
    product (the reference leaves it to XLA)."""
    tbl = fsdp_gather(p["table"]).to(ctx.compute_dtype)
    return torch.matmul(x.to(ctx.compute_dtype), tbl.t())
