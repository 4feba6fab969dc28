"""Dense transformer block and the layer loop (port of ``repro.nn.blocks``).

Stacks of identical blocks keep the reference's stacked ``(L, ...)``
parameter leaves; :func:`scan_apply` is the ``lax.scan`` counterpart, a
Python loop that slices layer ``l`` out of every leaf (views, no copies).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core.qtypes import QTensor
from ..core.tables import GATED_FORMS
from .attention import gqa_apply, gqa_init
from .context import DEFAULT_CTX, QuantContext
from .linear import act_table, int8_qtype, linear, linear_init
from .norms import layernorm, layernorm_init, rmsnorm, rmsnorm_init

__all__ = ["norm_init", "norm_apply", "mlp_init", "mlp_apply",
           "dense_block_init", "dense_block_apply", "stack_init",
           "layer_slice", "scan_apply"]


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


def dense_block_init(gen, cfg, *, causal: bool = True, dtype=torch.float32,
                     device="cpu"):
    if cfg.attn_kind != "gqa" or cfg.parallel_block:
        raise NotImplementedError("only the sequential GQA block is ported")
    return {"ln1": norm_init(cfg, device=device),
            "attn": gqa_init(gen, cfg.attn_dims(causal=causal), dtype=dtype,
                             device=device),
            "ln2": norm_init(cfg, device=device),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, gated=cfg.mlp_gated,
                            dtype=dtype, device=device)}


def dense_block_apply(p, x, cfg, ctx: QuantContext = DEFAULT_CTX, *,
                      causal: bool = True, cache=None, cache_pos=None,
                      path: str = "block"):
    h = norm_apply(cfg, p["ln1"], x)
    a, new_cache = gqa_apply(p["attn"], h, cfg.attn_dims(causal=causal), ctx,
                             cache=cache, cache_pos=cache_pos,
                             path=f"{path}/attn")
    x = x + a
    m = mlp_apply(p["mlp"], norm_apply(cfg, p["ln2"], x), cfg.mlp_act, ctx,
                  path=f"{path}/mlp")
    return x + m, new_cache


def stack_init(gen, n: int, init_fn: Callable):
    """Stacked params for ``n`` identical blocks (leading L axis)."""
    layers = [init_fn(gen) for _ in range(n)]

    def stack(items):
        if isinstance(items[0], dict):
            return {k: stack([it[k] for it in items]) for k in items[0]}
        return torch.stack(items)

    return stack(layers)


def layer_slice(tree, l: int):
    """Layer ``l`` of a stacked tree (QTensor payload and scale together)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, l) for k, v in tree.items()}
    if isinstance(tree, (torch.Tensor, QTensor)):
        return tree[l]
    return tree


def scan_apply(stacked, x, body: Callable, *, n_layers: int, per_layer=None):
    """Run ``body(params_l, x, per_layer_l) -> (x', y_l)`` over the stack.

    Returns ``(x_final, [y_l])``.
    """
    ys = []
    for l in range(n_layers):
        extra = None if per_layer is None else layer_slice(per_layer, l)
        x, y = body(layer_slice(stacked, l), x, extra)
        ys.append(y)
    return x, ys
