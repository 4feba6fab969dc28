"""Quantizers (port of ``repro.core.quantize``): straight-through fake
quantization (QAT, PTQ accuracy studies) and dynamic-range int8.

:func:`fake_quant` round-trips a tensor through a fixed-point or
minifloat type; its gradient is the clipping straight-through estimator,
``g * (lo <= x <= hi)`` over the type's representable range, as the
reference's ``custom_vjp``.

For the int8 path: same op order as the reference, so payloads and scales are bitwise
equal on the same weights: max-abs over the reduced axes,
``max(., 1e-12)``, ``/ int_max`` in float32, then ``round(x / scale)``
as a true division with half-to-even rounding (``torch.round`` and
``jnp.round`` agree) and a saturating clip.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from .precision import PrecisionPolicy
from .qtypes import FixedPointType, MiniFloatType, QTensor

__all__ = ["fake_quant", "calibrate_scale", "quantize_dynamic", "ptq_params",
           "dequantize_params"]

QType = Union[FixedPointType, MiniFloatType]


class _FakeQuant(torch.autograd.Function):
    """Forward: the already-quantized ``q``; backward: the clipping STE."""

    @staticmethod
    def forward(ctx, x, q, lo: float, hi: float):
        ctx.save_for_backward(x)
        ctx.bounds = (lo, hi)
        return q

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        lo, hi = ctx.bounds
        mask = ((x >= lo) & (x <= hi)).to(g.dtype)
        return g * mask, None, None, None


def fake_quant(x: torch.Tensor, qtype: QType) -> torch.Tensor:
    """Round-trip ``x`` through ``qtype`` (in x's dtype) with the
    straight-through gradient: 1 inside ``[lo, hi]``, 0 outside."""
    if isinstance(qtype, FixedPointType):
        lo, hi = qtype.min_value, qtype.max_value
    else:
        hi = qtype.max_value
        lo = -hi
    with torch.no_grad():
        q = qtype.quantize(x).to(x.dtype)
    return _FakeQuant.apply(x, q, lo, hi)


def calibrate_scale(x: torch.Tensor, qtype: FixedPointType,
                    channel_axes: Sequence[int] = ()) -> torch.Tensor:
    """Max-abs scale; ``channel_axes`` are the axes *kept* (per-channel)."""
    kept = tuple(a % x.ndim for a in channel_axes)
    reduce_axes = tuple(a for a in range(x.ndim) if a not in kept)
    amax = torch.amax(torch.abs(x), dim=reduce_axes, keepdim=True) \
        if reduce_axes else torch.abs(x)
    # maximum, not clamp_min: at a tie with the floor its gradient is 0.5,
    # as jnp.maximum's (the weights' per-column scale is differentiated
    # under --quant int8)
    amax = torch.maximum(amax, torch.full_like(amax, 1e-12))
    # the divisor as a tensor: PyTorch's CUDA division by a host scalar
    # multiplies by its reciprocal, an ulp away from the reference's
    # (and the CPU's) correctly rounded quotient
    return (amax / torch.full_like(amax, qtype.int_max)).to(torch.float32)


def quantize_dynamic(x: torch.Tensor, qtype: FixedPointType,
                     channel_axes: Sequence[int] = (),
                     scale: Optional[torch.Tensor] = None) -> QTensor:
    """Quantize with a calibrated (or provided) scale into a QTensor."""
    if scale is None:
        scale = calibrate_scale(x, qtype, channel_axes)
    # one temporary of x's size: round and clamp in place
    data = torch.div(x, scale).round_().clamp_(qtype.int_min, qtype.int_max)
    return QTensor(data.to(qtype.dtype), scale, qtype)


#: leaf keys that feed matmul consumers and can therefore carry a QTensor
_MATMUL_WEIGHT_KEYS = frozenset({"w", "w_gate", "w_up", "w_down"})


def _is_weight(path: Tuple[str, ...], leaf) -> bool:
    """Matmul weights only: embedding tables (gathered, not multiplied),
    routers, norms and biases stay float."""
    if not isinstance(leaf, torch.Tensor) or leaf.ndim < 2:
        return False
    joined = "/".join(str(p) for p in path).lower()
    if "embed" in joined or "router" in joined:
        return False
    name = str(path[-1]) if path else ""
    return name in _MATMUL_WEIGHT_KEYS


def _weight_channel_axes(ndim: int) -> Tuple[int, ...]:
    """Keep every axis except the contraction axis (-2): per-out-channel
    scales that also keep leading layer-stack axes."""
    return tuple(a for a in range(ndim) if a != ndim - 2)


def ptq_params(params, policy, *, channel_axes: Optional[Sequence[int]] = None,
               predicate=_is_weight):
    """Post-training-quantize a nested dict of tensors.

    ``policy`` is a :class:`PrecisionPolicy` or a single qtype applied
    uniformly.  Weight matrices become :class:`QTensor`; everything else
    passes through (the same objects, not copies).
    """
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (str(k),)) for k, v in node.items()}
        if not predicate(path, node):
            return node
        qt = (policy.resolve("/".join(path)).weights
              if isinstance(policy, PrecisionPolicy) else policy)
        if qt is None:
            return node
        if isinstance(qt, MiniFloatType):
            return qt.quantize(node)
        axes = (channel_axes if channel_axes is not None
                else _weight_channel_axes(node.ndim))
        return quantize_dynamic(node, qt, channel_axes=axes)

    return walk(params, ())



def dequantize_params(qparams, dtype=torch.float32):
    """Inverse of :func:`ptq_params` (for accuracy-loss measurement):
    every :class:`QTensor` leaf dequantized to ``dtype``."""
    if isinstance(qparams, dict):
        return {k: dequantize_params(v, dtype) for k, v in qparams.items()}
    if isinstance(qparams, QTensor):
        return qparams.dequantize(dtype)
    return qparams
