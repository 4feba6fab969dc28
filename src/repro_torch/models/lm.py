"""Decoder-only language model, dense GQA body (port of ``repro.models.lm``).

The layer stack keeps the reference's stacked ``(L, ...)`` leaves and
runs as a loop over layers (:func:`repro_torch.nn.blocks.scan_apply`).
Serving runs on either KV cache, as in the reference: the dense cache,
per-layer rows ``(L, B, Hkv, rows, D)``, or the paged cache, per-layer
page pools ``(L, P+1, Hkv, ps, D)`` and per-layer block tables ``(L, B,
NP)`` that the engine keeps identical across layers.  Both come in f32
or int8 (payload plus bf16 per-(token, head) scales).  Without a cache,
:func:`forward` is the cache-free causal forward, through the
``flash_attention`` kernel on the card.  The MoE body is not ported yet
(ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.device import resolve_device
from ..nn.attention import gqa_cache_spec, gqa_paged_cache_spec
from ..nn.blocks import (dense_block_apply, dense_block_init, norm_apply,
                         norm_init, scan_apply, stack_init)
from ..nn.context import DEFAULT_CTX, QuantContext
from ..nn.embedding import embed, embedding_init, unembed

__all__ = ["init", "forward", "init_cache", "init_paged_cache", "prefill",
           "decode_step"]


def _check_dense(cfg) -> None:
    if cfg.family != "lm" or cfg.moe is not None or not cfg.tie_embeddings:
        raise NotImplementedError(
            f"{cfg.name}: only the dense, tied-embedding lm family is ported "
            f"(ROADMAP.md queue 1)")


def init(gen: torch.Generator, cfg, *, dtype=torch.float32, device=None):
    """Random parameters from ``gen``, with the reference's distributions
    (normal * fan_in**-0.5 for matmul weights and the embedding, ones for
    norm scales) -- not its values: JAX's and torch's generators differ.
    ``device`` None is the GPU (:func:`resolve_device`)."""
    _check_dense(cfg)
    device = resolve_device(device)
    return {"embed": embedding_init(gen, cfg.vocab, cfg.d_model, dtype=dtype,
                                    device=device),
            "final_norm": norm_init(cfg, device=device),
            "dense": stack_init(gen, cfg.n_layers,
                                lambda g: dense_block_init(
                                    g, cfg, dtype=dtype, device=device))}


def forward(params, tokens: torch.Tensor, cfg, ctx: QuantContext = DEFAULT_CTX,
            *, cache=None, cache_pos: Optional[torch.Tensor] = None):
    """tokens (B, S) -> (logits (B, S, V), cache, aux_loss)."""
    _check_dense(cfg)
    x = embed(params["embed"], tokens, ctx, scale_by_dim=cfg.embed_scale)

    def body(p_l, x, cache_l):
        return dense_block_apply(p_l, x, cfg, ctx, cache=cache_l,
                                 cache_pos=cache_pos)

    x, _ = scan_apply(params["dense"], x, body, n_layers=cfg.n_layers,
                      per_layer=None if cache is None else cache["dense"])
    x = norm_apply(cfg, params["final_norm"], x)
    logits = unembed(params["embed"], x, ctx)
    return logits, cache, torch.zeros((), device=x.device)


def _stack_layers(tree, n: int):
    """Every leaf of one layer's cache repeated over a leading L axis."""
    if isinstance(tree, dict):
        return {k: _stack_layers(v, n) for k, v in tree.items()}
    return tree[None].repeat(n, *([1] * tree.ndim))


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None):
    """Per-layer dense KV rows (stacked over L); ``torch.int8`` adds the
    bf16 scale rows.  ``device`` None is the GPU."""
    _check_dense(cfg)
    return {"dense": _stack_layers(gqa_cache_spec(
        cfg.attn_dims(), batch, max_len, dtype, resolve_device(device)),
        cfg.n_layers)}


def init_paged_cache(cfg, batch: int, num_pages: int, page_size: int,
                     table_width: int, dtype=torch.float32, device=None):
    """Per-layer KV page pools + per-layer block tables (stacked over L);
    ``torch.int8`` adds the bf16 scale pages.  ``device`` None is the GPU."""
    _check_dense(cfg)
    return {"dense": _stack_layers(gqa_paged_cache_spec(
        cfg.attn_dims(), batch, num_pages, page_size, table_width, dtype,
        resolve_device(device)), cfg.n_layers)}


def prefill(params, tokens: torch.Tensor, cache, cfg,
            ctx: QuantContext = DEFAULT_CTX, *, pos=None,
            full_logits: bool = False):
    """Ingest prompt tokens at per-slot start positions ``pos`` (B,)."""
    b = tokens.shape[0]
    start = (torch.zeros((b,), dtype=torch.int32, device=tokens.device)
             if pos is None else pos)
    logits, new_cache, _ = forward(params, tokens, cfg, ctx, cache=cache,
                                   cache_pos=start)
    return (logits if full_logits else logits[:, -1:]), new_cache


def decode_step(params, tokens: torch.Tensor, cache, pos: torch.Tensor, cfg,
                ctx: QuantContext = DEFAULT_CTX):
    """One decode step.  tokens (B, 1); pos (B,) current cache length."""
    logits, new_cache, _ = forward(params, tokens, cfg, ctx, cache=cache,
                                   cache_pos=pos)
    return logits, new_cache
