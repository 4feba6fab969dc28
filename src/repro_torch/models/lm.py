"""Decoder-only language models: dense (gemma, yi, glm4, command-r) and
MoE (deepseek-v2 with MLA and shared experts, olmoe) (port of
``repro.models.lm``).

The stack is the reference's: optional leading dense layers, then the
MoE body, each run of identical blocks one set of stacked ``(L, ...)``
leaves run as a loop over layers (:func:`repro_torch.nn.blocks.
scan_apply`), with caches keyed ``dense`` and ``moe`` alike.  An untied
config has its own ``head`` projection (``linear(..., path="head")``, so
int8 PTQ makes the unembed a qmatmul at N = vocab); a tied one unembeds
against the embedding table.  Serving runs on either KV cache, as in the
reference: the dense cache, per-layer rows ``(L, B, Hkv, rows, D)``
(MLA: latent rows ``(L, B, rows, lora)``), or the paged cache, per-layer
page pools ``(L, P+1, Hkv, ps, D)`` (MLA: ``(L, P+1, ps, lora)``) and
per-layer block tables ``(L, B, NP)`` that the engine keeps identical
across layers.  GQA caches come in f32 or int8 (payload plus bf16
per-(token, head) scales); an int8 MLA latent is bf16.  Without a cache,
:func:`forward` is the cache-free causal forward, through the
``flash_attention`` kernel on the card (its backward kernel under
autograd), each layer checkpointed under ``cfg.remat``; :func:`loss` is
the training loss, cross-entropy plus the MoE aux term.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.device import resolve_device
from ..dist.constrain import constrain
from ..nn.attention import (gqa_cache_spec, gqa_paged_cache_spec,
                            mla_cache_spec, mla_paged_cache_spec)
from ..nn.blocks import (dense_block_apply, dense_block_init,
                         moe_block_apply, moe_block_init, norm_apply,
                         norm_init, scan_apply, stack_init)
from ..nn.context import DEFAULT_CTX, QuantContext
from ..nn.embedding import embed, embedding_init, unembed
from ..nn.linear import linear, linear_init
from .common import cross_entropy

__all__ = ["init", "forward", "loss", "init_cache", "init_paged_cache",
           "prefill", "decode_step"]


def _split_layers(cfg) -> Tuple[int, int]:
    """(n_dense, n_moe): the leading dense layers, then the MoE body."""
    if cfg.moe is None:
        return cfg.n_layers, 0
    k = cfg.moe.first_k_dense
    return k, cfg.n_layers - k


def init(gen: torch.Generator, cfg, *, dtype=torch.float32, device=None):
    """Random parameters from ``gen``, with the reference's distributions
    (normal * fan_in**-0.5 for matmul weights and the embedding, ones for
    norm scales) -- not its values: JAX's and torch's generators differ.
    ``device`` None is the GPU (:func:`resolve_device`)."""
    device = resolve_device(device)
    n_dense, n_moe = _split_layers(cfg)
    params = {"embed": embedding_init(gen, cfg.vocab, cfg.d_model,
                                      dtype=dtype, device=device),
              "final_norm": norm_init(cfg, device=device)}
    if not cfg.tie_embeddings:
        params["head"] = linear_init(gen, cfg.d_model, cfg.vocab,
                                     dtype=dtype, device=device)
    if n_dense:
        params["dense"] = stack_init(gen, n_dense, lambda g: dense_block_init(
            g, cfg, dtype=dtype, device=device))
    if n_moe:
        params["moe"] = stack_init(gen, n_moe, lambda g: moe_block_init(
            g, cfg, dtype=dtype, device=device))
    return params


def forward(params, tokens: torch.Tensor, cfg, ctx: QuantContext = DEFAULT_CTX,
            *, cache=None, cache_pos: Optional[torch.Tensor] = None):
    """tokens (B, S) -> (logits (B, S, V), cache, aux_loss): the MoE
    layers' aux losses summed (0 for a dense config)."""
    x = embed(params["embed"], tokens, ctx, scale_by_dim=cfg.embed_scale)
    n_dense, n_moe = _split_layers(cfg)
    remat = cfg.remat if cache is None else "none"
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def dense_body(p_l, x, cache_l):
        return dense_block_apply(p_l, x, cfg, ctx, cache=cache_l,
                                 cache_pos=cache_pos)

    def moe_body(p_l, x, cache_l):
        x, _, a = moe_block_apply(p_l, x, cfg, ctx, cache=cache_l,
                                  cache_pos=cache_pos)
        return x, a

    if n_dense:
        x, _ = scan_apply(params["dense"], x, dense_body, n_layers=n_dense,
                          per_layer=None if cache is None else cache["dense"],
                          remat=remat)
    if n_moe:
        x, auxes = scan_apply(params["moe"], x, moe_body, n_layers=n_moe,
                              per_layer=None if cache is None
                              else cache["moe"], remat=remat)
        for a in auxes:
            aux = aux + a
    x = norm_apply(cfg, params["final_norm"], x)
    if cfg.tie_embeddings:
        logits = unembed(params["embed"], x, ctx)
    else:
        logits = linear(params["head"], x, ctx, path="head")
    return constrain(logits, "dp", None, "tp"), cache, aux


def loss(params, batch, cfg, ctx: QuantContext = DEFAULT_CTX):
    """Training loss of ``batch = {"tokens", "labels"}``: cross-entropy
    (with the z-loss) plus ``aux_loss_weight`` times the MoE aux loss."""
    logits, _, aux = forward(params, batch["tokens"], cfg, ctx)
    ce, metrics = cross_entropy(logits, batch["labels"])
    total = ce
    if cfg.moe is not None:
        total = total + cfg.moe.aux_loss_weight * aux
        metrics["moe_aux"] = aux.detach()
    metrics["loss"] = total.detach()
    return total, metrics


def _stack_layers(tree, n: int):
    """Every leaf of one layer's cache repeated over a leading L axis."""
    if isinstance(tree, dict):
        return {k: _stack_layers(v, n) for k, v in tree.items()}
    return tree[None].repeat(n, *([1] * tree.ndim))


def _per_stack(cfg, one):
    """{"dense": ..., "moe": ...} of ``one()`` stacked over each run."""
    cache = {}
    for key, n in zip(("dense", "moe"), _split_layers(cfg)):
        if n:
            cache[key] = _stack_layers(one(), n)
    return cache


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None):
    """Per-layer dense KV rows (stacked over L); ``torch.int8`` adds the
    bf16 scale rows (an MLA latent is bf16 instead).  ``device`` None is
    the GPU."""
    device = resolve_device(device)
    if cfg.attn_kind == "mla":
        return _per_stack(cfg, lambda: mla_cache_spec(
            cfg.mla, batch, max_len, dtype, device))
    return _per_stack(cfg, lambda: gqa_cache_spec(
        cfg.attn_dims(), batch, max_len, dtype, device))


def init_paged_cache(cfg, batch: int, num_pages: int, page_size: int,
                     table_width: int, dtype=torch.float32, device=None):
    """Per-layer KV page pools + per-layer block tables (stacked over L);
    ``torch.int8`` adds the bf16 scale pages (an MLA latent is bf16
    instead).  ``device`` None is the GPU."""
    device = resolve_device(device)
    if cfg.attn_kind == "mla":
        return _per_stack(cfg, lambda: mla_paged_cache_spec(
            cfg.mla, batch, num_pages, page_size, table_width, dtype,
            device))
    return _per_stack(cfg, lambda: gqa_paged_cache_spec(
        cfg.attn_dims(), batch, num_pages, page_size, table_width, dtype,
        device))


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
