"""Encoder-decoder backbone, whisper-base (port of ``repro.models.encdec``).

The audio front end is a stub, as in the reference: ``batch["enc_input"]``
carries frame embeddings (B, S_enc, D).  The encoder adds the sinusoidal
position table and runs non-causal self-attention through the cache-free
path (the ``flash_attention`` kernel on the card); the decoder uses
learned positions (clamped at ``max_position - 1``), causal
self-attention and per-layer cross-attention.

Serving: :func:`prefill` encodes once, projects every decoder layer's
cross K/V at the encoder's actual length and *replaces* the cache's
``cross_kv`` with them; :func:`decode_step` attends over the dense
self-cache (updated in place) and those cross K/V.  The cache is
``{"layers": {"self": {"k", "v"}}, "cross_kv": {"k", "v"}}`` with every
leaf stacked over layers, (L, B, Hkv, rows, Dh); the reference keys
``cross_kv`` as a tuple (k, v).  An int8 KV cache is refused: the
reference casts float cross K/V straight to int8 without scales.
:func:`loss` is the training loss of the teacher-forced forward, encoder
and decoder layers checkpointed under ``cfg.remat``.
"""

from __future__ import annotations

import torch

from ..core.device import resolve_device
from ..dist.constrain import constrain
from ..nn.attention import gqa_apply, gqa_cache_spec, gqa_init, gqa_project_kv
from ..nn.blocks import (dense_block_apply, dense_block_init, layer_slice,
                         mlp_apply, mlp_init, norm_apply, norm_init,
                         scan_apply, stack_init)
from ..nn.context import DEFAULT_CTX, QuantContext
from ..nn.embedding import embed, embedding_init, unembed
from .common import cross_entropy, sinusoidal_table

__all__ = ["init", "encode", "forward", "loss", "init_cache", "prefill",
           "decode_step"]


def _dec_block_init(gen, cfg, dtype, device):
    kw = dict(dtype=dtype, device=device)
    return {"ln1": norm_init(cfg, device=device),
            "ln_x": norm_init(cfg, device=device),
            "ln2": norm_init(cfg, device=device),
            "self": gqa_init(gen, cfg.attn_dims(causal=True), **kw),
            "cross": gqa_init(gen, cfg.attn_dims(causal=False), **kw),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, gated=cfg.mlp_gated,
                            **kw)}


def _dec_block_apply(p, x, enc, cfg, ctx, *, cache=None, cache_pos=None,
                     cross_kv=None):
    a, new_c = gqa_apply(p["self"], norm_apply(cfg, p["ln1"], x),
                         cfg.attn_dims(causal=True), ctx, cache=cache,
                         cache_pos=cache_pos, path="dec/self")
    x = x + a
    c, _ = gqa_apply(p["cross"], norm_apply(cfg, p["ln_x"], x),
                     cfg.attn_dims(causal=False), ctx,
                     kv_input=enc if cross_kv is None else None,
                     cached_kv=(None if cross_kv is None
                                else (cross_kv["k"], cross_kv["v"])),
                     path="dec/cross")
    x = x + c
    m = mlp_apply(p["mlp"], norm_apply(cfg, p["ln2"], x), cfg.mlp_act, ctx,
                  path="dec/mlp")
    return x + m, new_c


def init(gen: torch.Generator, cfg, *, dtype=torch.float32, device=None):
    """Random parameters from ``gen`` with the reference's distributions
    (not its values: JAX's and torch's generators differ).  ``device``
    None is the GPU (:func:`resolve_device`)."""
    device = resolve_device(device)
    pos = torch.randn((cfg.max_position, cfg.d_model), generator=gen,
                      dtype=torch.float32, device=device) * 0.01
    return {
        "embed": embedding_init(gen, cfg.vocab, cfg.d_model, dtype=dtype,
                                device=device),
        "pos": pos.to(dtype),
        "encoder": stack_init(gen, cfg.enc_layers,
                              lambda g: dense_block_init(
                                  g, cfg, causal=False, dtype=dtype,
                                  device=device)),
        "enc_norm": norm_init(cfg, device=device),
        "decoder": stack_init(gen, cfg.n_layers,
                              lambda g: _dec_block_init(g, cfg, dtype,
                                                        device)),
        "dec_norm": norm_init(cfg, device=device),
    }


def encode(params, enc_input: torch.Tensor, cfg,
           ctx: QuantContext = DEFAULT_CTX) -> torch.Tensor:
    """Frame embeddings (B, S_enc, D) -> encoder states, in the compute
    dtype."""
    s = enc_input.shape[1]
    pos = torch.from_numpy(sinusoidal_table(s, cfg.d_model)).to(
        enc_input.device)
    x = enc_input.to(ctx.compute_dtype) + pos.to(ctx.compute_dtype)

    def body(p_l, x, _):
        return dense_block_apply(p_l, x, cfg, ctx, causal=False)

    x, _ = scan_apply(params["encoder"], x, body, n_layers=cfg.enc_layers,
                      remat=cfg.remat)
    return norm_apply(cfg, params["enc_norm"], x)


def _decode(params, tokens, enc, cfg, ctx, *, cache=None, cache_pos=None,
            cross_kv=None):
    b, s = tokens.shape
    start = (torch.zeros((b,), dtype=torch.int32, device=tokens.device)
             if cache_pos is None else cache_pos)
    pos_ids = (start.to(torch.int64)[:, None]
               + torch.arange(s, device=tokens.device)[None, :])
    x = embed(params["embed"], tokens, ctx)
    # gather, then cast: the same values as casting the whole table first
    x = x + params["pos"][torch.clamp_max(pos_ids, cfg.max_position - 1)] \
        .to(x.dtype)

    def body(p_l, x, per_layer):
        return _dec_block_apply(p_l, x, enc, cfg, ctx,
                                cache=per_layer["self"], cache_pos=cache_pos,
                                cross_kv=per_layer["cross"])

    x, _ = scan_apply(params["decoder"], x, body, n_layers=cfg.n_layers,
                      per_layer={"self": cache, "cross": cross_kv},
                      remat=cfg.remat if cache is None else "none")
    x = norm_apply(cfg, params["dec_norm"], x)
    return constrain(unembed(params["embed"], x, ctx), "dp", None, "tp")


def forward(params, batch, cfg, ctx: QuantContext = DEFAULT_CTX):
    """Cache-free teacher-forced logits (B, S, V) of ``batch["tokens"]``
    against ``batch["enc_input"]``."""
    enc = encode(params, batch["enc_input"], cfg, ctx)
    return _decode(params, batch["tokens"], enc, cfg, ctx)


def loss(params, batch, cfg, ctx: QuantContext = DEFAULT_CTX):
    """Training loss of ``batch``: cross-entropy with the z-loss."""
    logits = forward(params, batch, cfg, ctx)
    ce, metrics = cross_entropy(logits, batch["labels"])
    metrics["loss"] = ce.detach()
    return ce, metrics


def init_cache(cfg, batch: int, max_len: int, dtype=torch.float32,
               device=None):
    """Dense self-attention rows per decoder layer, and cross K/V buffers
    of ``min(enc_len_cap, max_len)`` rows (the reference's shapes;
    :func:`prefill` replaces them).  Every leaf is (L, B, Hkv, rows, Dh).
    ``device`` None is the GPU."""
    if dtype == torch.int8:
        raise NotImplementedError(
            "an int8 KV cache for the encdec family (whisper) is refused: "
            "the reference casts float cross K/V to int8 without scales "
            "(ROADMAP.md section 3); serve whisper on a float cache")
    device = resolve_device(device)
    dims = cfg.attn_dims()
    enc_len = min(cfg.enc_len_cap, max_len)

    def stacked(rows):
        shape = (cfg.n_layers, batch, dims.n_kv_heads, rows, dims.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    return {"layers": {"self": stacked(max_len)}, "cross_kv": stacked(enc_len)}


def prefill(params, batch, cache, cfg, ctx: QuantContext = DEFAULT_CTX, *,
            pos=None, full_logits: bool = False):
    """Encode ``batch["enc_input"]``, project every decoder layer's cross
    K/V once, and ingest ``batch["tokens"]`` at ``pos`` (default 0)."""
    enc = encode(params, batch["enc_input"], cfg, ctx)
    dims = cfg.attn_dims(causal=False)
    dtype = cache["cross_kv"]["k"].dtype
    kv = [gqa_project_kv(layer_slice(params["decoder"], l)["cross"], enc,
                         dims, ctx) for l in range(cfg.n_layers)]
    cross_kv = {"k": torch.stack([k for k, _ in kv]).to(dtype),
                "v": torch.stack([v for _, v in kv]).to(dtype)}
    tokens = batch["tokens"]
    start = (torch.zeros((tokens.shape[0],), dtype=torch.int32,
                         device=tokens.device) if pos is None else pos)
    logits = _decode(params, tokens, None, cfg, ctx,
                     cache=cache["layers"]["self"], cache_pos=start,
                     cross_kv=cross_kv)
    out = logits if full_logits else logits[:, -1:]
    return out, {"layers": cache["layers"], "cross_kv": cross_kv}


def decode_step(params, tokens: torch.Tensor, cache, pos: torch.Tensor, cfg,
                ctx: QuantContext = DEFAULT_CTX):
    """One decode step: tokens (B, 1) at ``pos`` (B,) against the self-cache
    (updated in place) and the cached cross K/V."""
    logits = _decode(params, tokens, None, cfg, ctx,
                     cache=cache["layers"]["self"], cache_pos=pos,
                     cross_kv=cache["cross_kv"])
    return logits, cache
