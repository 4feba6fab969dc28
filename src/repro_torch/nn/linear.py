"""Linear layers with pluggable numerics (port of ``repro.nn.linear``).

* ``none`` -- ``torch.matmul`` in ``compute_dtype`` (the reference leaves
  this product to XLA; a plain library matmul is its counterpart).
* ``fake`` -- the weight (and the activation, where the policy gives a
  type) fake-quantized in f32 with the straight-through gradient
  (:func:`repro_torch.core.quantize.fake_quant`), then the same
  ``torch.matmul``: the reference computes this product outside any
  kernel too.  A layer whose policy has no weight type runs as ``none``.
* ``int8`` -- per-row dynamic activation quantization (the
  ``quantize_rows`` kernel, one launch), then the ``qmatmul`` kernel on
  the pre-quantized weight (a :class:`QTensor` from
  :func:`repro_torch.core.quantize.ptq_params`), or on a weight quantized
  per call when the policy asks for int8 but the weight is float.

Under ``ctx.use_lut`` an int8 projection with a fusable activation
(sigmoid, tanh, gelu, silu) runs bias and the activation table inside the
``qmatmul`` kernel's epilogue (:func:`act_table` picks the same table as
``act_fn``); every other path applies the identical ``act_fn`` after the
product.  Under a mesh a float weight is gathered over the data axes
before its product (FSDP), its ``model`` sharding kept.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.precision import LayerPrecision
from ..core.qtypes import FixedPointType, QTensor
from ..core.quantize import calibrate_scale, fake_quant
from ..dist.constrain import fsdp_gather
from ..core.tables import GATED_FORMS, TableSpec
from .activations import _LUT_DOMAIN, act_fn
from .context import DEFAULT_CTX, QuantContext

__all__ = ["linear_init", "linear", "int8_qtype", "act_table"]

#: activations the fused LUT epilogue supports (relu is cheaper exact;
#: softplus needs its asymptote)
_FUSABLE_ACTS = ("sigmoid", "tanh", "gelu", "silu")


def linear_init(gen: torch.Generator, d_in: int, d_out: int, *,
                bias: bool = False, dtype=torch.float32, device="cpu",
                scale: Optional[float] = None):
    std = scale if scale is not None else d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device) * std
    p = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def act_table(act: str, ctx: QuantContext,
              path: str) -> Tuple[TableSpec, bool]:
    """TableSpec + gated flag matching act_fn's LUT selection exactly."""
    prec = ctx.policy.resolve(path)
    n = prec.table_n or ctx.table_n
    lo, hi = _LUT_DOMAIN[act]
    gated = act in GATED_FORMS
    fn = GATED_FORMS[act] if gated else act
    return TableSpec(fn, n, lo, hi, prec.table_qtype, ctx.table_indexing), gated


def _int8_matmul(x2: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                 qt: FixedPointType, ctx: QuantContext, *, bias=None,
                 act_spec=None, act_gated=False) -> torch.Tensor:
    """(T, K) @ (K, N) through the int8 kernel; only the activation is
    quantized here (per-row dynamic scale, in f32 from ``x2``'s f32 or
    bf16 values)."""
    from ..kernels.ops import qmatmul, quantize_rows
    xq, sx = quantize_rows(x2, qt, backend=ctx.backend)   # (T, K), (T, 1)
    return qmatmul(xq, wq, sx, sw, bias=bias, act_spec=act_spec,
                   act_gated=act_gated, out_dtype=ctx.compute_dtype,
                   backend=ctx.backend)


def _quantize_weight(w: torch.Tensor, qt: FixedPointType):
    """Dynamic per-column weight quantization (the non-PTQ fallback)."""
    sw = calibrate_scale(w, qt, channel_axes=(1,))           # (1, N)
    wq = torch.clamp(torch.round(w / sw), qt.int_min, qt.int_max).to(qt.dtype)
    return wq, sw


def int8_qtype(p, ctx: QuantContext,
               path: str = "") -> Optional[FixedPointType]:
    """The fixed-point type of ``p``'s int8 product under ``ctx``, or None
    when :func:`linear` multiplies in floating point."""
    w = p["w"]
    prec: LayerPrecision = ctx.policy.resolve(path)
    prequant = isinstance(w, QTensor)
    if ctx.mode != "int8" or (not prequant and prec.weights is None):
        return None
    qt = w.qtype if prequant else prec.weights
    return qt if isinstance(qt, FixedPointType) and qt.width <= 8 else None


def linear(p, x: torch.Tensor, ctx: QuantContext = DEFAULT_CTX, *,
           path: str = "", act: Optional[str] = None,
           act_path: Optional[str] = None) -> torch.Tensor:
    """``act(x @ w (+ b))`` under the context's numeric mode."""
    w = p["w"]
    prequant = isinstance(w, QTensor)
    qt = int8_qtype(p, ctx, path)
    wq = sw = None
    if qt is not None and prequant:
        wq, sw = w.data, w.scale.reshape(1, -1)

    bias = p.get("b")
    act_done = False
    if qt is not None:
        t_shape = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        if wq is None:
            wq, sw = _quantize_weight(w.to(torch.float32), qt)
        fuse_act = act in _FUSABLE_ACTS and ctx.use_lut
        spec, gated = (act_table(act, ctx, act_path or f"{path}/act")
                       if fuse_act else (None, False))
        fb = None if bias is None else bias.to(torch.float32)
        y = _int8_matmul(x2, wq, sw, qt, ctx, bias=fb, act_spec=spec,
                         act_gated=gated)
        y = y.reshape(*t_shape, wq.shape[-1])
        bias, act_done = None, fuse_act
    else:
        if prequant:
            w = w.dequantize(ctx.compute_dtype)
        prec = ctx.policy.resolve(path)
        # as the reference: a float weight without a type runs as "none"
        fake = ctx.mode == "fake" and (prequant or prec.weights is not None)
        if fake and prec.weights is not None:
            w = fake_quant(w.to(torch.float32), prec.weights)
        if fake and prec.activations is not None:
            x = fake_quant(x.to(torch.float32), prec.activations)
        y = torch.matmul(x.to(ctx.compute_dtype),
                         fsdp_gather(w).to(ctx.compute_dtype))
    if bias is not None:
        y = y + bias.to(y.dtype)
    if act is not None and not act_done:
        y = act_fn(act, y, ctx, path=act_path or f"{path}/act")
    return y
