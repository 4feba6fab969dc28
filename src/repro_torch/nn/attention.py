"""GQA / MQA attention over the paged KV cache (port of the paged f32
branch of ``repro.nn.attention``).

Each call scatters the new tokens' K/V into their pages through the
block table (write-before-attend), then attends through the table with
``ops.paged_attention``: the Hopper kernel for CUDA tensors, its plain
version for CPU tensors.  Unlike the reference, which gathers pages and
runs an einsum off-TPU, the port always goes through the paged op; the
kernel's knob (``ctx.kv_split`` / ``ctx.pages_per_step``) rides along.

The page pool is updated **in place** (the reference returns a new
pool): a decode step writes ``B`` rows, not a copy of every layer's
pages.  The dense (non-paged) cache, int8 pages, cross-attention and
MLA are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .context import DEFAULT_CTX, QuantContext
from .linear import linear, linear_init
from .rope import apply_rope

__all__ = ["AttnDims", "gqa_init", "gqa_apply", "gqa_paged_cache_spec"]


@dataclasses.dataclass(frozen=True)
class AttnDims:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0
    use_rope: bool = True
    qkv_bias: bool = False
    causal: bool = True


def gqa_init(gen: torch.Generator, d: AttnDims, *, dtype=torch.float32,
             device="cpu"):
    kw = dict(dtype=dtype, device=device)
    return {
        "wq": linear_init(gen, d.d_model, d.n_heads * d.head_dim,
                          bias=d.qkv_bias, **kw),
        "wk": linear_init(gen, d.d_model, d.n_kv_heads * d.head_dim,
                          bias=d.qkv_bias, **kw),
        "wv": linear_init(gen, d.d_model, d.n_kv_heads * d.head_dim,
                          bias=d.qkv_bias, **kw),
        "wo": linear_init(gen, d.n_heads * d.head_dim, d.d_model, **kw),
    }


def gqa_paged_cache_spec(d: AttnDims, batch: int, num_pages: int,
                         page_size: int, table_width: int,
                         dtype=torch.float32, device="cpu"):
    """Shared pool of ``num_pages`` pages plus one trash page (index
    ``num_pages``) that absorbs writes from lanes with no allocation;
    every table entry starts pointing at it."""
    shape = (num_pages + 1, d.n_kv_heads, page_size, d.head_dim)
    return {"pages": {"k": torch.zeros(shape, dtype=dtype, device=device),
                      "v": torch.zeros(shape, dtype=dtype, device=device)},
            "block_table": torch.full((batch, table_width), num_pages,
                                      dtype=torch.int32, device=device)}


def _page_coords(bt: torch.Tensor, pos: torch.Tensor, s: int, page_size: int):
    """(physical page, in-page row) for tokens written at pos..pos+s-1;
    positions past the table clamp to its last entry."""
    tpos = pos.to(torch.int64)[:, None] + torch.arange(s, device=bt.device)[None, :]
    idx = torch.clamp(tpos // page_size, 0, bt.shape[1] - 1)
    return torch.gather(bt.to(torch.int64), 1, idx), tpos % page_size


def _paged_write(pages: torch.Tensor, page: torch.Tensor, row: torch.Tensor,
                 u: torch.Tensor) -> None:
    """Scatter (B, Hkv, s, X) new K/V rows into ``pages`` in place.  Lanes
    never share a (page, row) except on the trash page, whose contents
    are never observed."""
    pages[page, :, row] = u.transpose(1, 2).to(pages.dtype)


def gqa_apply(p, x: torch.Tensor, d: AttnDims, ctx: QuantContext = DEFAULT_CTX,
              *, cache=None, cache_pos: Optional[torch.Tensor] = None,
              path: str = "attn") -> Tuple[torch.Tensor, Optional[dict]]:
    """Self-attention of ``x`` (B, S, D_model) against the paged cache.

    ``cache`` = {"pages": {"k", "v"}, "block_table"} of one layer;
    ``cache_pos`` (B,) is each lane's position before this call.
    Returns ``(y, cache)`` (the cache is updated in place).
    """
    if cache is None or "pages" not in cache:
        raise NotImplementedError(
            "only the paged KV cache is ported; the dense cache and the "
            "cache-free forward are ROADMAP.md queue 1, item 4")
    if not d.causal or not d.use_rope:
        raise NotImplementedError("only causal RoPE self-attention is ported")
    b, s, _ = x.shape
    q = linear(p["wq"], x, ctx, path=f"{path}/wq")
    q = q.reshape(b, s, d.n_heads, d.head_dim)
    k = linear(p["wk"], x, ctx, path=f"{path}/wk")
    k = k.reshape(b, s, d.n_kv_heads, d.head_dim)
    v = linear(p["wv"], x, ctx, path=f"{path}/wv")
    v = v.reshape(b, s, d.n_kv_heads, d.head_dim)

    pos = (torch.zeros((b,), dtype=torch.int32, device=x.device)
           if cache_pos is None else cache_pos)
    positions = (torch.arange(s, device=x.device)[None, :]
                 + pos.to(torch.int64)[:, None])
    q = apply_rope(q.transpose(1, 2), positions[:, None],
                   theta=d.rope_theta, fraction=d.rope_fraction)
    k = apply_rope(k.transpose(1, 2), positions[:, None],
                   theta=d.rope_theta, fraction=d.rope_fraction)
    v = v.transpose(1, 2)                                # (B, Hkv, S, Dh)

    pages, bt = cache["pages"], cache["block_table"]
    page, row = _page_coords(bt, pos, s, pages["k"].shape[2])
    _paged_write(pages["k"], page, row, k)
    _paged_write(pages["v"], page, row, v)
    from ..kernels.ops import paged_attention
    y = paged_attention(q.contiguous(), pages["k"], pages["v"], bt,
                        pos.to(torch.int32), kv_split=ctx.kv_split,
                        pages_per_step=ctx.pages_per_step,
                        backend=ctx.backend)
    y = y.transpose(1, 2).reshape(b, s, d.n_heads * d.head_dim)
    return linear(p["wo"], y, ctx, path=f"{path}/wo"), cache
