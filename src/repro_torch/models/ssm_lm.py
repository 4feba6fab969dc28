"""Pure SSM language model (mamba2-370m): a stack of Mamba-2 SSD blocks
(port of ``repro.models.ssm_lm``).

Decode carries an O(1) recurrence state per layer, ``{"conv": (L, B,
K-1, C), "ssm": (L, B, P, N, hd)}`` in f32, which every call writes in
place: a decode step advances it, a whole-prompt prefill copies its final
states into it (the tensors keep their addresses, so captured decode
graphs stay valid).  The state is position-free, so ``pos`` is ignored,
and a prefill rebuilds it from its own tokens: the Engine ingests a
prompt with per-token decode steps instead (``supports_chunked_prefill``
is false).  :func:`loss` is the training loss of the cache-free forward,
each layer checkpointed under ``cfg.remat``.
"""

from __future__ import annotations

import torch

from ..core.device import resolve_device
from ..dist.constrain import constrain
from ..nn.blocks import (mamba_block_apply, mamba_block_init, norm_apply,
                         norm_init, scan_apply, stack_init)
from ..nn.context import DEFAULT_CTX, QuantContext
from ..nn.embedding import embed, embedding_init, unembed
from ..nn.ssm import mamba2_state_spec
from .common import copy_tree, cross_entropy, stack_states

__all__ = ["init", "forward", "loss", "init_cache", "init_paged_cache",
           "prefill", "decode_step", "spec_state", "spec_restore"]


def init(gen: torch.Generator, cfg, *, dtype=torch.float32, device=None):
    """Random parameters from ``gen`` with the reference's distributions;
    ``device`` None is the GPU."""
    device = resolve_device(device)
    return {"embed": embedding_init(gen, cfg.vocab, cfg.d_model, dtype=dtype,
                                    device=device),
            "layers": stack_init(gen, cfg.n_layers, lambda g: mamba_block_init(
                g, cfg, dtype=dtype, device=device)),
            "final_norm": norm_init(cfg, device=device)}


def forward(params, tokens: torch.Tensor, cfg,
            ctx: QuantContext = DEFAULT_CTX, *, state=None,
            decode: bool = False):
    """tokens (B, S) -> (logits (B, S, V), states): decoding, ``state``
    advanced in place; else the per-layer final states, stacked."""
    x = embed(params["embed"], tokens, ctx)

    def body(p_l, x, state_l):
        return mamba_block_apply(p_l, x, cfg, ctx, state=state_l,
                                 decode=decode)

    x, states = scan_apply(params["layers"], x, body, n_layers=cfg.n_layers,
                           per_layer=state if decode else None,
                           remat="none" if decode else cfg.remat)
    x = norm_apply(cfg, params["final_norm"], x)
    logits = constrain(unembed(params["embed"], x, ctx), "dp", None, "tp")
    return logits, (state if decode else stack_states(states))


def loss(params, batch, cfg, ctx: QuantContext = DEFAULT_CTX):
    """Training loss of ``batch``: cross-entropy with the z-loss."""
    logits = forward(params, batch["tokens"], cfg, ctx)[0]
    ce, metrics = cross_entropy(logits, batch["labels"])
    metrics["loss"] = ce.detach()
    return ce, metrics


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None):
    """Per-layer f32 state (O(1) in context length: ``max_len`` and
    ``dtype`` are unused); ``device`` None is the GPU."""
    del max_len, dtype
    device = resolve_device(device)
    one = mamba2_state_spec(cfg.ssm, batch, device)
    return {k: v[None].repeat(cfg.n_layers, *([1] * v.ndim))
            for k, v in one.items()}


def init_paged_cache(cfg, batch: int, num_pages: int, page_size: int,
                     table_width: int, dtype=torch.float32, device=None):
    """There is no KV axis to page: the paged Engine serves this family on
    the dense state (the page pool only meters admission)."""
    del num_pages, page_size, table_width
    return init_cache(cfg, batch, 0, dtype, device)


def spec_state(cache):
    """The whole cache is recurrent state: batch-leading views ((L, B, ...)
    -> (B, L, ...)) of every leaf."""
    return {k: t.movedim(1, 0) for k, t in cache.items()}


def spec_restore(cache, state):
    """Copy a :func:`spec_state` checkpoint back into the cache, in place."""
    copy_tree(spec_state(cache), state)
    return cache


def prefill(params, tokens: torch.Tensor, cache, cfg,
            ctx: QuantContext = DEFAULT_CTX, *, pos=None,
            full_logits: bool = False):
    """Whole-prompt SSD prefill; the final per-layer states are copied into
    ``cache`` (every lane: the state is rebuilt from this call's tokens).
    ``pos`` is ignored (the state is position-free)."""
    del pos
    logits, states = forward(params, tokens, cfg, ctx)
    copy_tree(cache, states)
    return (logits if full_logits else logits[:, -1:]), cache


def decode_step(params, tokens: torch.Tensor, cache, pos, cfg,
                ctx: QuantContext = DEFAULT_CTX):
    """One token (B, 1); ``cache`` advanced in place; ``pos`` ignored."""
    del pos
    return forward(params, tokens, cfg, ctx, state=cache, decode=True)
