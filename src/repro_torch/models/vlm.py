"""Vision-language backbone, llama-3.2-vision-11b (port of
``repro.models.vlm``).

Dense self-attention layers with a gated cross-attention layer after
every ``cross_attn_every - 1`` of them, attending to stub image-patch
embeddings: the vision front end is a stub, as in the reference
(``batch["img_embed"]``, (B, n_img_tokens, D)).  The stack is the
reference's: ``groups`` holds G groups of ``k_self`` self layers as
stacked ``(G, k_self, ...)`` leaves, ``cross`` the G cross blocks as
``(G, ...)`` leaves; each group runs its self layers, then its cross
block.  The unembedding is tied, as in the reference: its ``forward``
unembeds against the embedding table and its ``init`` makes no head,
whatever ``tie_embeddings`` says, so the logits are a plain bf16 (or
f32) product, never a qmatmul.

Serving: the self layers keep dense KV rows per (group, layer), written
in place; the cross K/V are projected from the image once per group at
:func:`prefill` and *copied into the cache's own buffers* (cast to their
dtype), so a captured decode graph stays valid across prefills;
:func:`decode_step` attends to them.  The cache is ``{"self": {"k",
"v"}: (G, k_self, B, Hkv, rows, Dh), "cross_kv": {"k", "v"}: (G, B,
Hkv, n_img_tokens, Dh)}`` (the reference keys ``cross_kv`` as a tuple).
An int8 KV cache is refused: the reference casts the float cross K/V
straight to int8 without scales.  There is no paged VLM cache, as in
the reference.  :func:`loss` is the training loss of the cache-free
forward with the image, the self layers checkpointed under ``cfg.remat``
as in the reference.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.device import resolve_device
from ..dist.constrain import constrain
from ..nn.attention import gqa_apply, gqa_project_kv
from ..nn.blocks import (cross_block_apply, cross_block_init,
                         dense_block_apply, dense_block_init, layer_slice,
                         mlp_apply, norm_apply, norm_init, scan_apply,
                         stack_init)
from ..nn.context import DEFAULT_CTX, QuantContext
from ..nn.embedding import embed, embedding_init, unembed
from .common import cross_entropy

__all__ = ["init", "forward", "loss", "init_cache", "prefill", "decode_step",
           "lane_leaves"]


def _group_structure(cfg):
    """(groups, self layers per group)."""
    k = cfg.cross_attn_every
    return cfg.n_layers // k, k - 1


def init(gen: torch.Generator, cfg, *, dtype=torch.float32, device=None):
    """Random parameters from ``gen`` with the reference's distributions
    (not its values: JAX's and torch's generators differ); the gates are
    0, as the reference's.  ``device`` None is the GPU
    (:func:`resolve_device`)."""
    device = resolve_device(device)
    n_groups, k_self = _group_structure(cfg)
    return {
        "embed": embedding_init(gen, cfg.vocab, cfg.d_model, dtype=dtype,
                                device=device),
        "groups": stack_init(
            gen, n_groups,
            lambda g: stack_init(g, k_self, lambda g2: dense_block_init(
                g2, cfg, dtype=dtype, device=device))),
        "cross": stack_init(gen, n_groups, lambda g: cross_block_init(
            g, cfg, gated=True, dtype=dtype, device=device)),
        "final_norm": norm_init(cfg, device=device),
    }


def _cross_with_cached(p, x, kv, cfg, ctx):
    """The gated cross block over K/V projected once: ``kv`` = (k, v),
    each (B, Hkv, Skv, Dh), attended unmasked with einsums."""
    a, _ = gqa_apply(p["attn"], norm_apply(cfg, p["ln1"], x),
                     cfg.attn_dims(causal=False), ctx, cached_kv=kv,
                     path="cross/attn")
    a = a * torch.tanh(p["gate_attn"]).to(a.dtype)
    x = x + a
    m = mlp_apply(p["mlp"], norm_apply(cfg, p["ln2"], x), cfg.mlp_act, ctx,
                  path="cross/mlp")
    return x + m * torch.tanh(p["gate_mlp"]).to(m.dtype)


def forward(params, tokens: torch.Tensor, img_embed: Optional[torch.Tensor],
            cfg, ctx: QuantContext = DEFAULT_CTX, *, cache=None,
            cache_pos: Optional[torch.Tensor] = None, cross_kv=None):
    """tokens (B, S) -> (logits (B, S, V), cache).

    Each cross block attends to ``cross_kv`` (``{"k", "v"}``, (G, B, Hkv,
    Skv, Dh)) where given, else to K/V projected from ``img_embed`` (B,
    n_img, D), which are also copied into ``cache["cross_kv"]`` when a
    cache is given (the prefill); with neither, text-only, to the text
    itself (non-causal, RoPE, through ``ops.attention``).  The self
    layers attend causally, cache-free through ``ops.attention`` or over
    ``cache["self"]`` (written in place at ``cache_pos``)."""
    n_groups, k_self = _group_structure(cfg)
    x = embed(params["embed"], tokens, ctx)
    img = None if img_embed is None else img_embed.to(ctx.compute_dtype)

    def body(p_l, x, cache_l):
        return dense_block_apply(p_l, x, cfg, ctx, cache=cache_l,
                                 cache_pos=cache_pos)

    for g in range(n_groups):
        x, _ = scan_apply(layer_slice(params["groups"], g), x, body,
                          n_layers=k_self,
                          per_layer=None if cache is None
                          else layer_slice(cache["self"], g),
                          remat=cfg.remat if cache is None else "none")
        p_x = layer_slice(params["cross"], g)
        kv = None
        if cross_kv is not None:
            kv = (cross_kv["k"][g], cross_kv["v"][g])
        elif img is not None:
            kv = gqa_project_kv(p_x["attn"], img, cfg.attn_dims(causal=False),
                                ctx)
            if cache is not None:
                # in place, cast to the cache's dtype (the reference's
                # ``astype``): the buffers keep their addresses
                cache["cross_kv"]["k"][g].copy_(kv[0])
                cache["cross_kv"]["v"][g].copy_(kv[1])
        x = (cross_block_apply(p_x, x, None, cfg, ctx) if kv is None
             else _cross_with_cached(p_x, x, kv, cfg, ctx))
    x = norm_apply(cfg, params["final_norm"], x)
    return constrain(unembed(params["embed"], x, ctx), "dp", None,
                     "tp"), cache


def loss(params, batch, cfg, ctx: QuantContext = DEFAULT_CTX):
    """Training loss of ``batch``: cross-entropy with the z-loss."""
    logits = forward(params, batch["tokens"], batch["img_embed"], cfg, ctx)[0]
    ce, metrics = cross_entropy(logits, batch["labels"])
    metrics["loss"] = ce.detach()
    return ce, metrics


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None):
    """Dense self-attention rows per (group, layer) and the cross K/V
    buffers, zero (the reference's shapes).  ``device`` None is the
    GPU."""
    if dtype == torch.int8:
        raise NotImplementedError(
            "an int8 KV cache for the vlm family (llama-3.2-vision) is "
            "refused: the reference casts the float cross K/V to int8 "
            "without scales (ROADMAP.md section 3); serve it on a float "
            "cache")
    device = resolve_device(device)
    n_groups, k_self = _group_structure(cfg)
    dims = cfg.attn_dims()

    def kv(shape):
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    return {"self": kv((n_groups, k_self, batch, dims.n_kv_heads, max_len,
                        dims.head_dim)),
            "cross_kv": kv((n_groups, batch, dims.n_kv_heads,
                            cfg.n_img_tokens, dims.head_dim))}


def prefill(params, batch, cache, cfg, ctx: QuantContext = DEFAULT_CTX, *,
            pos=None, full_logits: bool = False):
    """Project ``batch["img_embed"]``'s cross K/V once per group into the
    cache (in place), and ingest ``batch["tokens"]`` at ``pos`` (default
    0)."""
    if batch.get("img_embed") is None:
        raise ValueError("a vlm prefill needs batch['img_embed'], the image "
                         "its cross layers attend to")
    tokens = batch["tokens"]
    start = (torch.zeros((tokens.shape[0],), dtype=torch.int32,
                         device=tokens.device) if pos is None else pos)
    logits, cache = forward(params, tokens, batch["img_embed"], cfg, ctx,
                            cache=cache, cache_pos=start)
    return (logits if full_logits else logits[:, -1:]), cache


def decode_step(params, tokens: torch.Tensor, cache, pos: torch.Tensor, cfg,
                ctx: QuantContext = DEFAULT_CTX):
    """One decode step: tokens (B, 1) at ``pos`` (B,) against the
    self-cache (updated in place) and the cached cross K/V."""
    return forward(params, tokens, None, cfg, ctx, cache=cache,
                   cache_pos=pos, cross_kv=cache["cross_kv"])


def lane_leaves(cache):
    """``(tensor, batch axis)`` of every leaf: the self rows carry the
    batch at axis 2 (G, k_self, B, ...), the cross K/V at axis 1."""
    return ([(t, 2) for t in cache["self"].values()]
            + [(t, 1) for t in cache["cross_kv"].values()])
