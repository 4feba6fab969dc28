"""Dense and MoE transformer blocks and the layer loop (port of
``repro.nn.blocks``).

A block attends with GQA or MLA (``cfg.attn_kind``); command-r's
``parallel_block`` shares ``ln1`` between attention and the MLP (no
``ln2``) and returns ``x + a + m``.  A MoE block routes its second norm's
output through :func:`~repro_torch.nn.moe.moe_apply` (dropless when it
serves from a cache) and adds deepseek's shared experts, one gated MLP of
``n_shared * d_ff_expert`` beside the routed ones.

A cross block (the VLM's image layers) has no self-attention: it
attends its norm's output to K/V projected from ``kv`` (the image
stream), or, text-only (``kv`` None), to itself, non-causally and with
RoPE, as the reference does; ``gated`` blocks scale the attention and
the MLP by ``tanh`` of a scalar gate each.

A Mamba-2 block (the recurrent families) is a pre-norm residual around
:func:`~repro_torch.nn.ssm.mamba2_apply` or, decoding, around
:func:`~repro_torch.nn.ssm.mamba2_decode_step`, which advances the
layer's state in place.

Stacks of identical blocks keep the reference's stacked ``(L, ...)``
parameter leaves; :func:`scan_apply` is the ``lax.scan`` counterpart, a
Python loop over the layers of every leaf, unbound once into per-layer
views (no copies; under autograd one node per leaf, whose backward
stacks the layers' gradients once, where a view per layer would add L
full-size gradients).
Its ``remat`` is the reference's activation rematerialization: under
"full" (or "dots", which the port runs as "full") each layer runs under
``torch.utils.checkpoint`` while autograd records, so a training step
keeps each layer's input and recomputes the rest in the backward.
Under a mesh the residual stream is pinned to ``("dp", None, None)``
before and after each layer, outside the checkpoint (the reference's
pins), and a stacked leaf whose layer axis is sharded (a stacked 2-D
leaf such as a norm scale, ``(L, d)`` on ``("dp", "tp")``) is gathered
along it once before the unbind.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.utils.checkpoint

from ..core.qtypes import QTensor
from ..core.tables import GATED_FORMS
from ..core.tree import tree_map
from ..dist.constrain import constrain, unshard
from .attention import gqa_apply, gqa_init, mla_apply, mla_init
from .context import DEFAULT_CTX, QuantContext
from .linear import act_table, int8_qtype, linear, linear_init
from .moe import MoEDims, moe_apply, moe_init
from .norms import layernorm, layernorm_init, rmsnorm, rmsnorm_init
from .ssm import mamba2_apply, mamba2_decode_step, mamba2_init

__all__ = ["norm_init", "norm_apply", "mlp_init", "mlp_apply",
           "dense_block_init", "dense_block_apply", "moe_dims_of",
           "moe_block_init", "moe_block_apply", "cross_block_init",
           "cross_block_apply", "mamba_block_init",
           "mamba_block_apply", "stack_init", "layer_slice", "scan_apply"]


def norm_init(cfg, d: Optional[int] = None, device="cpu"):
    d = d or cfg.d_model
    return (rmsnorm_init(d, device=device) if cfg.norm_type == "rmsnorm"
            else layernorm_init(d, device=device))


def norm_apply(cfg, p, x):
    if cfg.norm_type == "rmsnorm":
        return rmsnorm(p, x, eps=cfg.norm_eps, plus_one=cfg.norm_plus_one)
    return layernorm(p, x, eps=cfg.norm_eps)


def mlp_init(gen, d_model: int, d_ff: int, *, gated: bool = True,
             dtype=torch.float32, device="cpu"):
    kw = dict(dtype=dtype, device=device)
    p = {"up": linear_init(gen, d_model, d_ff, **kw),
         "down": linear_init(gen, d_ff, d_model, **kw)}
    if gated:
        p["gate"] = linear_init(gen, d_model, d_ff, **kw)
    return p


def mlp_apply(p, x, act: str, ctx: QuantContext = DEFAULT_CTX, *,
              path: str = "mlp"):
    """Gated MLP: ``down(act(gate(x)) * up(x))``, or plain ``down(act(up(x)))``.

    Under ``ctx.use_lut`` a gated GELU or SiLU on a float gate projection
    runs ``act(g) * up`` as one table pass (``ops.lut_gated_mul``: the
    lookup and both products, the ``lut_gated_mul`` kernel on the card),
    with the table ``act_fn`` would pick; an int8 gate keeps the table in
    qmatmul's epilogue, and every other activation goes through
    ``linear``'s ``act_fn``.
    """
    if "gate" in p:
        up = linear(p["up"], x, ctx, path=f"{path}/up")
        if ctx.use_lut and act in GATED_FORMS \
                and int8_qtype(p["gate"], ctx, f"{path}/gate") is None:
            from ..kernels.ops import lut_gated_mul
            g = linear(p["gate"], x, ctx, path=f"{path}/gate")
            spec, _ = act_table(act, ctx, f"{path}/act")
            h = lut_gated_mul(g, up, spec, backend=ctx.backend)
        else:
            g = linear(p["gate"], x, ctx, path=f"{path}/gate", act=act,
                       act_path=f"{path}/act")
            h = g * up
    else:
        h = linear(p["up"], x, ctx, path=f"{path}/up", act=act,
                   act_path=f"{path}/act")
    return linear(p["down"], h, ctx, path=f"{path}/down")


def _attn_init(gen, cfg, causal: bool, dtype, device):
    if cfg.attn_kind == "mla":
        return mla_init(gen, cfg.mla, dtype=dtype, device=device)
    return gqa_init(gen, cfg.attn_dims(causal=causal), dtype=dtype,
                    device=device)


def _attn_apply(p, h, cfg, ctx, causal: bool, cache, cache_pos, path: str):
    if cfg.attn_kind == "mla":
        return mla_apply(p, h, cfg.mla, ctx, cache=cache, cache_pos=cache_pos,
                         path=path)
    return gqa_apply(p, h, cfg.attn_dims(causal=causal), ctx, cache=cache,
                     cache_pos=cache_pos, path=path)


def dense_block_init(gen, cfg, *, causal: bool = True, dtype=torch.float32,
                     device="cpu"):
    p = {"ln1": norm_init(cfg, device=device),
         "attn": _attn_init(gen, cfg, causal, dtype, device),
         "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, gated=cfg.mlp_gated,
                         dtype=dtype, device=device)}
    if not cfg.parallel_block:
        p["ln2"] = norm_init(cfg, device=device)
    return p


def dense_block_apply(p, x, cfg, ctx: QuantContext = DEFAULT_CTX, *,
                      causal: bool = True, cache=None, cache_pos=None,
                      path: str = "block"):
    h = norm_apply(cfg, p["ln1"], x)
    a, new_cache = _attn_apply(p["attn"], h, cfg, ctx, causal, cache,
                               cache_pos, f"{path}/attn")
    if cfg.parallel_block:     # command-r: attention and MLP share ln1
        m = mlp_apply(p["mlp"], h, cfg.mlp_act, ctx, path=f"{path}/mlp")
        return x + a + m, new_cache
    x = x + a
    m = mlp_apply(p["mlp"], norm_apply(cfg, p["ln2"], x), cfg.mlp_act, ctx,
                  path=f"{path}/mlp")
    return x + m, new_cache


def moe_dims_of(cfg) -> MoEDims:
    m = cfg.moe
    return MoEDims(d_model=cfg.d_model, d_ff=m.d_ff_expert,
                   n_experts=m.n_experts, top_k=m.top_k,
                   capacity_factor=m.capacity_factor,
                   renormalize=m.renormalize, act=cfg.mlp_act,
                   routed_scale=m.routed_scale)


def moe_block_init(gen, cfg, *, dtype=torch.float32, device="cpu"):
    p = {"ln1": norm_init(cfg, device=device),
         "ln2": norm_init(cfg, device=device),
         "attn": _attn_init(gen, cfg, True, dtype, device),
         "moe": moe_init(gen, moe_dims_of(cfg), dtype=dtype, device=device)}
    if cfg.moe.n_shared:
        p["shared"] = mlp_init(gen, cfg.d_model,
                               cfg.moe.n_shared * cfg.moe.d_ff_expert,
                               gated=True, dtype=dtype, device=device)
    return p


def moe_block_apply(p, x, cfg, ctx: QuantContext = DEFAULT_CTX, *,
                    cache=None, cache_pos=None, path: str = "moe_block"):
    """-> (x', cache, aux loss)."""
    h = norm_apply(cfg, p["ln1"], x)
    a, new_cache = _attn_apply(p["attn"], h, cfg, ctx, True, cache,
                               cache_pos, f"{path}/attn")
    x = x + a
    h2 = norm_apply(cfg, p["ln2"], x)
    y, aux = moe_apply(p["moe"], h2, moe_dims_of(cfg), ctx,
                       path=f"{path}/moe", dropless=cache is not None)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], h2, cfg.mlp_act, ctx,
                          path=f"{path}/shared")
    return x + y, new_cache, aux


def cross_block_init(gen, cfg, *, gated: bool = False, dtype=torch.float32,
                     device="cpu"):
    """Self-attention-free cross block (llama-vision style when
    ``gated``: the gates start at 0, so the block adds nothing at init,
    as in the reference)."""
    p = {"ln1": norm_init(cfg, device=device),
         "attn": gqa_init(gen, cfg.attn_dims(causal=False), dtype=dtype,
                          device=device),
         "ln2": norm_init(cfg, device=device),
         "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, gated=cfg.mlp_gated,
                         dtype=dtype, device=device)}
    if gated:
        p["gate_attn"] = torch.zeros((), dtype=torch.float32, device=device)
        p["gate_mlp"] = torch.zeros((), dtype=torch.float32, device=device)
    return p


def cross_block_apply(p, x, kv, cfg, ctx: QuantContext = DEFAULT_CTX, *,
                      path: str = "cross"):
    """``x`` attends to K/V projected from ``kv`` (B, Skv, D), or to itself
    when ``kv`` is None (non-causal, RoPE: the cache-free path, the
    ``flash_attention`` kernel on the card)."""
    a, _ = gqa_apply(p["attn"], norm_apply(cfg, p["ln1"], x),
                     cfg.attn_dims(causal=False), ctx, kv_input=kv,
                     path=f"{path}/attn")
    if "gate_attn" in p:
        a = a * torch.tanh(p["gate_attn"]).to(a.dtype)
    x = x + a
    m = mlp_apply(p["mlp"], norm_apply(cfg, p["ln2"], x), cfg.mlp_act, ctx,
                  path=f"{path}/mlp")
    if "gate_mlp" in p:
        m = m * torch.tanh(p["gate_mlp"]).to(m.dtype)
    return x + m


def mamba_block_init(gen, cfg, *, dtype=torch.float32, device="cpu"):
    return {"ln": norm_init(cfg, device=device),
            "ssm": mamba2_init(gen, cfg.ssm, dtype=dtype, device=device)}


def mamba_block_apply(p, x, cfg, ctx: QuantContext = DEFAULT_CTX, *,
                      state=None, decode: bool = False,
                      path: str = "mamba"):
    """-> (x', new state): decoding, ``state`` itself, advanced in place;
    else the whole sequence's final state (``state`` is not read)."""
    h = norm_apply(cfg, p["ln"], x)
    if decode:
        y = mamba2_decode_step(p["ssm"], h, state, cfg.ssm, ctx,
                               path=f"{path}/ssm")
        return x + y, state
    y, new_state = mamba2_apply(p["ssm"], h, cfg.ssm, ctx,
                                path=f"{path}/ssm")
    return x + y, new_state


def stack_init(gen, n: int, init_fn: Callable):
    """Stacked params for ``n`` identical blocks (leading L axis).  One
    block's leaves gain the axis as views, not copies (a full-width
    deepseek MoE layer holds 15 GB of f32 banks); several blocks are
    copied into the stack as each is drawn, so the stack and one block
    are in memory at once, never every block and their stack
    (llama-3.2-vision's eight groups of four layers hold 28 GB in f32)."""
    first = init_fn(gen)
    if n == 1:
        return tree_map(lambda t: t[None], first)
    out = tree_map(lambda t: t.new_empty((n, *t.shape)), first)
    _copy_into(out, first, 0)
    del first
    for i in range(1, n):
        _copy_into(out, init_fn(gen), i)
    return out


def _copy_into(out, tree, i: int) -> None:
    """Write one block's leaves into entry ``i`` of the stack ``out``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _copy_into(out[k], v, i)
    else:
        out[i].copy_(tree)


def layer_slice(tree, l: int):
    """Layer ``l`` of a stacked tree (QTensor payload and scale together)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, l) for k, v in tree.items()}
    if isinstance(tree, (torch.Tensor, QTensor)):
        return tree[l]
    return tree


def _unbind(tree, n: int):
    """The ``n`` per-layer trees of a stacked tree, each leaf unbound once
    along its leading axis (QTensor payload and scale together)."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: parts[k][l] for k in parts} for l in range(n)]
    if isinstance(tree, torch.Tensor):
        return unshard(tree, 0).unbind(0)   # a sharded dim cannot unbind
    if isinstance(tree, QTensor):
        return [QTensor(d, s, tree.qtype)
                for d, s in zip(tree.data.unbind(0), tree.scale.unbind(0))]
    return [tree] * n


def scan_apply(stacked, x, body: Callable, *, n_layers: int, per_layer=None,
               remat: str = "none"):
    """Run ``body(params_l, x, per_layer_l) -> (x', y_l)`` over the stack.

    Returns ``(x_final, [y_l])``.  ``remat`` other than "none" checkpoints
    each layer when autograd records (the values do not change).
    """
    ckpt = remat != "none" and torch.is_grad_enabled()
    layers = _unbind(stacked, n_layers)
    ys = []
    for l in range(n_layers):
        extra = None if per_layer is None else layer_slice(per_layer, l)
        p_l = layers[l]
        if x.ndim == 3:     # pin the residual stream's batch sharding
            x = constrain(x, "dp", None, None)
        if ckpt:
            x, y = torch.utils.checkpoint.checkpoint(
                body, p_l, x, extra, use_reentrant=False,
                preserve_rng_state=False)
        else:
            x, y = body(p_l, x, extra)
        if x.ndim == 3:
            x = constrain(x, "dp", None, None)
        ys.append(y)
    return x, ys
