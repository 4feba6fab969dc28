"""Hybrid SSM + shared-attention model (zamba2-1.2b) (port of
``repro.models.hybrid``).

Zamba2's signature: a *single* shared transformer block (attention +
MLP) whose parameters are re-applied every ``shared_attn_every`` Mamba-2
layers.  The stack is grouped: ``G`` groups of (``k`` mamba layers, then
the shared block), plus a tail of trailing mamba layers (zamba2: 6 groups
of 6, tail 2).  Each application point of the shared block has its own KV
cache (weights shared, state not).  As in the reference, upstream's
embedding concatenation and per-use LoRA deltas are left out.

The serving cache is ``{"ssm": {"groups": {"conv", "ssm"} (G, k, B, ...),
"tail": (L_tail, B, ...) when there is a tail}, "attn": (G, ...)}``: the
recurrent states are dense f32 lanes, and the attention caches are the
``lm`` family's, dense rows or (paged) per-group page pools with block
tables that the Engine keeps identical across groups.  Every call writes
the cache in place: decode steps advance the states, a prefill copies its
final states in (the SSM states are rebuilt from the call's tokens, so a
prefill must hold the whole prompt; ``pos`` offsets only the attention
caches).  Without a cache, :func:`forward` is the cache-free causal
forward, its attention through the ``flash_attention`` kernel on the
card.  :func:`loss` is the training loss of the cache-free forward, the
mamba layers checkpointed under ``cfg.remat`` as in the reference.
"""

from __future__ import annotations

import torch

from ..core.device import resolve_device
from ..dist.constrain import constrain
from ..nn.attention import gqa_cache_spec, gqa_paged_cache_spec
from ..nn.blocks import (dense_block_apply, dense_block_init, layer_slice,
                         mamba_block_apply, mamba_block_init, norm_apply,
                         norm_init, scan_apply, stack_init)
from ..nn.context import DEFAULT_CTX, QuantContext
from ..nn.embedding import embed, embedding_init, unembed
from ..nn.ssm import mamba2_state_spec
from .common import copy_tree, cross_entropy, stack_states

__all__ = ["init", "forward", "loss", "init_cache", "init_paged_cache",
           "prefill", "decode_step", "lane_leaves", "spec_state",
           "spec_restore"]


def _group_structure(cfg):
    """(n_groups, group_size, n_tail) over the mamba layers."""
    k = cfg.shared_attn_every
    n_groups = cfg.n_layers // k
    return n_groups, k, cfg.n_layers - n_groups * k


def init(gen: torch.Generator, cfg, *, dtype=torch.float32, device=None):
    """Random parameters from ``gen`` with the reference's distributions;
    ``device`` None is the GPU."""
    device = resolve_device(device)
    n_groups, k, tail = _group_structure(cfg)
    kw = dict(dtype=dtype, device=device)

    def mamba(g):
        return mamba_block_init(g, cfg, **kw)

    params = {
        "embed": embedding_init(gen, cfg.vocab, cfg.d_model, **kw),
        "groups": stack_init(gen, n_groups,
                             lambda g: stack_init(g, k, mamba)),
        "shared": dense_block_init(gen, cfg, **kw),
        "final_norm": norm_init(cfg, device=device)}
    if tail:
        params["tail"] = stack_init(gen, tail, mamba)
    return params


def forward(params, tokens: torch.Tensor, cfg,
            ctx: QuantContext = DEFAULT_CTX, *, cache=None, cache_pos=None,
            decode: bool = False):
    """tokens (B, S) -> (logits (B, S, V), cache): with a cache, decode
    steps advance its states in place and a prefill copies its final
    states in; the attention caches take the new K/V at ``cache_pos``."""
    n_groups, k, tail = _group_structure(cfg)
    x = embed(params["embed"], tokens, ctx)

    def body(p_l, x, state_l):
        return mamba_block_apply(p_l, x, cfg, ctx, state=state_l,
                                 decode=decode)

    def run(stack, n, x, states):
        x, new = scan_apply(stack, x, body, n_layers=n,
                            per_layer=states if decode else None,
                            remat="none" if decode else cfg.remat)
        return x, (None if decode else stack_states(new))

    ssm = None if cache is None else cache["ssm"]
    groups = []
    for g in range(n_groups):
        x, new = run(layer_slice(params["groups"], g), k, x,
                     None if ssm is None else layer_slice(ssm["groups"], g))
        groups.append(new)
        x, _ = dense_block_apply(
            params["shared"], x, cfg, ctx,
            cache=None if cache is None else layer_slice(cache["attn"], g),
            cache_pos=cache_pos)
    if tail:
        x, tail_states = run(params["tail"], tail, x,
                             None if ssm is None else ssm["tail"])
    x = norm_apply(cfg, params["final_norm"], x)
    logits = constrain(unembed(params["embed"], x, ctx), "dp", None, "tp")
    if cache is not None and not decode:
        copy_tree(ssm["groups"], stack_states(groups))
        if tail:
            copy_tree(ssm["tail"], tail_states)
    return logits, cache


def _ssm_cache(cfg, batch: int, device):
    n_groups, k, tail = _group_structure(cfg)
    one = mamba2_state_spec(cfg.ssm, batch, device)
    ssm = {"groups": {key: v[None, None].repeat(n_groups, k,
                                                 *([1] * v.ndim))
                      for key, v in one.items()}}
    if tail:
        ssm["tail"] = {key: v[None].repeat(tail, *([1] * v.ndim))
                       for key, v in one.items()}
    return ssm


def _per_group(cfg, one):
    """Every leaf of one attention cache repeated over the G groups."""
    n_groups = _group_structure(cfg)[0]

    def rep(t):
        if isinstance(t, dict):
            return {key: rep(v) for key, v in t.items()}
        return t[None].repeat(n_groups, *([1] * t.ndim))
    return rep(one)


def loss(params, batch, cfg, ctx: QuantContext = DEFAULT_CTX):
    """Training loss of ``batch``: cross-entropy with the z-loss."""
    logits = forward(params, batch["tokens"], cfg, ctx)[0]
    ce, metrics = cross_entropy(logits, batch["labels"])
    metrics["loss"] = ce.detach()
    return ce, metrics


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None):
    """Dense f32 SSM lanes and dense per-group KV rows (``torch.int8``
    adds the bf16 scale rows); ``device`` None is the GPU."""
    device = resolve_device(device)
    return {"ssm": _ssm_cache(cfg, batch, device),
            "attn": _per_group(cfg, gqa_cache_spec(
                cfg.attn_dims(), batch, max_len, dtype, device))}


def init_paged_cache(cfg, batch: int, num_pages: int, page_size: int,
                     table_width: int, dtype=torch.float32, device=None):
    """Only the KV axis pages: per-group page pools and block tables; the
    O(1) SSM states keep their dense lanes."""
    device = resolve_device(device)
    return {"ssm": _ssm_cache(cfg, batch, device),
            "attn": _per_group(cfg, gqa_paged_cache_spec(
                cfg.attn_dims(), batch, num_pages, page_size, table_width,
                dtype, device))}


def lane_leaves(cache):
    """(tensor, batch axis) of every per-lane leaf, what invalidation
    zeroes and a looped prefill's merge restores: grouped states carry
    the batch at axis 2 ((G, k, B, ...)), tail states and dense KV rows
    ((G, B, Hkv, R, Dh)) at axis 1.  Paged attention pages carry no
    batch axis: a retired slot's pages are unreachable once its table
    row is reset, and a neighbour's garbage row sits at its own position,
    overwritten before it is attended."""
    out = [(t, 2) for t in cache["ssm"]["groups"].values()]
    out += [(t, 1) for t in cache["ssm"].get("tail", {}).values()]
    if "pages" not in cache["attn"]:
        out += [(t, 1) for t in cache["attn"].values()]
    return out


def spec_state(cache):
    """Only the SSM lanes need speculative checkpoints (the KV caches
    rewind by position): batch-leading views, grouped (G, k, B, ...) ->
    (B, G, k, ...), tail (L, B, ...) -> (B, L, ...)."""
    state = {"groups": {key: t.movedim(2, 0)
                        for key, t in cache["ssm"]["groups"].items()}}
    if "tail" in cache["ssm"]:
        state["tail"] = {key: t.movedim(1, 0)
                         for key, t in cache["ssm"]["tail"].items()}
    return state


def spec_restore(cache, state):
    """Copy a :func:`spec_state` checkpoint back into the cache, in place."""
    copy_tree(spec_state(cache), state)
    return cache


def prefill(params, tokens: torch.Tensor, cache, cfg,
            ctx: QuantContext = DEFAULT_CTX, *, pos=None,
            full_logits: bool = False):
    """``pos`` (B,) offsets only the attention caches; the SSM states are
    rebuilt from this call's tokens (every lane)."""
    b = tokens.shape[0]
    start = (torch.zeros((b,), dtype=torch.int32, device=tokens.device)
             if pos is None else pos)
    logits, cache = forward(params, tokens, cfg, ctx, cache=cache,
                            cache_pos=start)
    return (logits if full_logits else logits[:, -1:]), cache


def decode_step(params, tokens: torch.Tensor, cache, pos: torch.Tensor, cfg,
                ctx: QuantContext = DEFAULT_CTX):
    """One token (B, 1) at ``pos`` (B,); the cache advanced in place."""
    return forward(params, tokens, cfg, ctx, cache=cache, cache_pos=pos,
                   decode=True)
