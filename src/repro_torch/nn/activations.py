"""Activation dispatch: exact transcendentals or the paper's LUT path
(port of ``repro.nn.activations``).

gelu is the tanh approximation, as ``jax.nn.gelu(approximate=True)``.
Under ``ctx.use_lut`` every activation but relu goes through
``ops.lut_activation`` -- the Hopper ``lut_activation`` kernel for CUDA
tensors -- and :func:`softmax` through the paper's exp / invert tables.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.tables import (GATED_FORMS, TableSpec, softmax_table_policy,
                           table_softmax)
from .context import DEFAULT_CTX, QuantContext

__all__ = ["act_fn", "softmax"]

_EXACT = {
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softplus": F.softplus,
}

#: LUT input domains per activation (shared with the fused qmatmul epilogue)
_LUT_DOMAIN = {"gelu": (-8.0, 8.0), "silu": (-10.0, 10.0),
               "tanh": (-6.0, 6.0), "sigmoid": (-10.0, 10.0),
               "softplus": (-16.0, 16.0), "relu": (-8.0, 8.0)}


def act_fn(name: str, x: torch.Tensor, ctx: QuantContext = DEFAULT_CTX, *,
           path: str = "") -> torch.Tensor:
    """Apply activation ``name`` under the context (exact or table-based).

    The LUT forms keep the reference's casts: the table lookup comes back
    in ``x``'s dtype from the kernel (f32 from the ``ref`` backend), the
    gated product ``x * lut(x)`` is taken in the promoted dtype and the
    result is cast to ``x``'s dtype.
    """
    if not ctx.use_lut or name == "relu":
        return _EXACT[name](x)
    from ..kernels.ops import lut_activation as lut_op  # backend-dispatched

    prec = ctx.policy.resolve(path)
    n = prec.table_n or ctx.table_n
    qt = prec.table_qtype
    lo, hi = _LUT_DOMAIN[name]
    if name in GATED_FORMS:
        spec = TableSpec(GATED_FORMS[name], n, lo, hi, qt, ctx.table_indexing)
        return (x * lut_op(x, spec, backend=ctx.backend)).to(x.dtype)
    spec = TableSpec(name, n, lo, hi, qt, ctx.table_indexing)
    y = lut_op(x, spec, backend=ctx.backend)
    if name == "softplus":
        # softplus(x) -> x for large x; keep the asymptote exact
        y = torch.where(x >= hi, x, y)
    return y.to(x.dtype)


def softmax(x: torch.Tensor, ctx: QuantContext = DEFAULT_CTX,
            axis: int = -1) -> torch.Tensor:
    """Softmax -- exact, or through the paper's exp/invert constant tables."""
    if not ctx.use_lut:
        return torch.softmax(x, dim=axis)
    pol = softmax_table_policy(ctx.act_qtype,
                               respect_user_type=ctx.respect_user_type,
                               n=ctx.table_n,
                               exact_divide=ctx.softmax_exact_divide,
                               indexing=ctx.table_indexing)
    return table_softmax(x, axis=axis, policy=pol)
