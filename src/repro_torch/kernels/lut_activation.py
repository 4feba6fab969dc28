"""Elementwise lookup-table activation (the paper's constant tables).

Port of ``repro.kernels.lut_activation`` (TPU: ``lut_activation_pallas``).
The Hopper kernels are in ``csrc/lut_activation.cu``:

* :func:`lut_activation`, the table alone; plain version
  :func:`repro_torch.kernels.ref.lut_activation_plain`, which indexes as
  the kernel does (``(x - lo) * step_inv``, see
  :func:`~repro_torch.kernels.ref.apply_table`);
* :func:`lut_gated_mul`, the gated MLP's table pass ``((g * T(g)).to(dt))
  * up`` in one launch (the lookup and the two products that follow it
  in the reference); plain version
  :func:`~repro_torch.kernels.ref.lut_gated_mul_plain`.

Each is its kernel's wrapper: for CPU tensors it runs the plain version
(that is how the CPU tests reach it), for CUDA tensors it launches the
kernel or raises -- it never falls back.

Training under ``--lut`` differentiates both through
:class:`LutActivationFn` and :class:`LutGatedMulFn`, autograd functions
over a backend's forward and backward (:mod:`repro_torch.kernels.ops`
picks them): here the backward kernels' wrappers
:func:`lut_activation_bwd` (``dx`` of the table) and
:func:`lut_gated_mul_bwd` (``dg`` and ``dup`` of the gated pass), whose
plain versions are :func:`~repro_torch.kernels.ref.
lut_activation_bwd_plain` and :func:`~repro_torch.kernels.ref.
lut_gated_mul_bwd_plain`.  Both are stateless and deterministic, so a
checkpointed layer's recomputation gives the same bits.
"""

from __future__ import annotations

import torch

from ..core.tables import INDEXING, TableSpec, get_table
from . import _cuda
from .ref import (lut_activation_bwd_plain, lut_activation_plain,
                  lut_gated_mul_bwd_plain, lut_gated_mul_plain)

__all__ = ["lut_activation", "lut_activation_plain", "lut_gated_mul",
           "lut_gated_mul_plain", "lut_activation_bwd", "lut_gated_mul_bwd",
           "LutActivationFn", "LutGatedMulFn", "MAX_TABLE"]

#: longest table the kernel stages in shared memory (16 KB of f32)
MAX_TABLE = 4096


def lut_activation(x: torch.Tensor, spec: TableSpec) -> torch.Tensor:
    """Apply the table described by ``spec`` to ``x`` (any shape, f32 or
    bf16 on the card); the result has ``x``'s shape and dtype."""
    if x.device.type == "cpu":
        return lut_activation_plain(x, spec)
    if x.device.type != "cuda":
        raise ValueError(f"lut_activation: unsupported device {x.device}")
    _check_table(x, spec, "lut_activation")
    xc = x.contiguous()
    out = torch.empty_like(xc)
    if xc.numel() == 0:
        return out
    lib = _cuda.library("lut_activation")
    err = lib.lut_activation_launch(
        xc.data_ptr(), get_table(spec).values(x.device).data_ptr(),
        out.data_ptr(), xc.numel(), *_table_args(spec),
        int(x.dtype == torch.bfloat16), _cuda.sm_count(x.device),
        _cuda.stream_of(out))
    _cuda.check(lib, err, "lut_activation")
    _cuda.LAUNCHES["lut_activation"] += 1
    return out


def lut_gated_mul(g: torch.Tensor, up: torch.Tensor,
                  spec: TableSpec) -> torch.Tensor:
    """The gated MLP's table pass, ``((g * T(g)).to(g.dtype)) * up`` with
    ``T`` the table of ``spec`` (a gated form, ``gelu_gate`` or
    ``silu_gate``): one launch over ``g`` and ``up`` of one shape and
    dtype (f32 or bf16 on the card); the result has ``g``'s shape and
    dtype."""
    if g.device.type == "cpu":
        return lut_gated_mul_plain(g, up, spec)
    if g.device.type != "cuda":
        raise ValueError(f"lut_gated_mul: unsupported device {g.device}")
    _check_table(g, spec, "lut_gated_mul")
    if up.dtype != g.dtype or up.shape != g.shape or up.device != g.device:
        raise ValueError(f"lut_gated_mul: up {tuple(up.shape)} {up.dtype} "
                         f"on {up.device} is not like g {tuple(g.shape)} "
                         f"{g.dtype} on {g.device}")
    gc, uc = g.contiguous(), up.contiguous()
    out = torch.empty_like(gc)
    if gc.numel() == 0:
        return out
    lib = _cuda.library("lut_activation")
    err = lib.lut_gated_mul_launch(
        gc.data_ptr(), uc.data_ptr(),
        get_table(spec).values(g.device).data_ptr(), out.data_ptr(),
        gc.numel(), *_table_args(spec), int(g.dtype == torch.bfloat16),
        _cuda.sm_count(g.device), _cuda.stream_of(out))
    _cuda.check(lib, err, "lut_gated_mul")
    _cuda.LAUNCHES["lut_gated_mul"] += 1
    return out


def lut_activation_bwd(x: torch.Tensor, dy: torch.Tensor,
                       spec: TableSpec) -> torch.Tensor:
    """``dx`` of :func:`lut_activation` at ``x`` given ``dy`` (both of
    ``x``'s shape; ``dy`` is cast to ``x``'s dtype), in ``x``'s dtype."""
    if x.device.type == "cpu":
        return lut_activation_bwd_plain(x, dy, spec)
    if x.device.type != "cuda":
        raise ValueError(f"lut_activation_bwd: unsupported device {x.device}")
    _check_table(x, spec, "lut_activation_bwd")
    xc = x.contiguous()
    dyc = _like(dy, xc, "lut_activation_bwd")
    dx = torch.empty_like(xc)
    if xc.numel() == 0:
        return dx
    lib = _cuda.library("lut_activation")
    err = lib.lut_activation_bwd_launch(
        xc.data_ptr(), dyc.data_ptr(),
        get_table(spec).values(x.device).data_ptr(), dx.data_ptr(),
        xc.numel(), *_table_args(spec), int(x.dtype == torch.bfloat16),
        _cuda.sm_count(x.device), _cuda.stream_of(dx))
    _cuda.check(lib, err, "lut_activation_bwd")
    _cuda.LAUNCHES["lut_activation_bwd"] += 1
    return dx


def lut_gated_mul_bwd(g: torch.Tensor, up: torch.Tensor, dh: torch.Tensor,
                      spec: TableSpec):
    """``(dg, dup)`` of :func:`lut_gated_mul` given ``dh`` (cast to
    ``g``'s dtype), in ``g``'s dtype: one launch."""
    if g.device.type == "cpu":
        return lut_gated_mul_bwd_plain(g, up, dh, spec)
    if g.device.type != "cuda":
        raise ValueError(f"lut_gated_mul_bwd: unsupported device {g.device}")
    _check_table(g, spec, "lut_gated_mul_bwd")
    gc = g.contiguous()
    uc = _like(up, gc, "lut_gated_mul_bwd")
    dhc = _like(dh, gc, "lut_gated_mul_bwd")
    dg, dup = torch.empty_like(gc), torch.empty_like(gc)
    if gc.numel() == 0:
        return dg, dup
    lib = _cuda.library("lut_activation")
    err = lib.lut_gated_mul_bwd_launch(
        gc.data_ptr(), uc.data_ptr(), dhc.data_ptr(),
        get_table(spec).values(g.device).data_ptr(), dg.data_ptr(),
        dup.data_ptr(), gc.numel(), *_table_args(spec),
        int(g.dtype == torch.bfloat16), _cuda.sm_count(g.device),
        _cuda.stream_of(dg))
    _cuda.check(lib, err, "lut_gated_mul_bwd")
    _cuda.LAUNCHES["lut_gated_mul_bwd"] += 1
    return dg, dup


class LutActivationFn(torch.autograd.Function):
    """``fwd(x, spec)`` with the gradient ``bwd(x, dy, spec)``: a backend's
    table forward and backward (the kernels' wrappers, or the plain
    versions), chosen by :func:`repro_torch.kernels.ops.lut_activation`."""

    @staticmethod
    def forward(ctx, x, spec, fwd, bwd):
        ctx.save_for_backward(x)
        ctx.spec, ctx.bwd = spec, bwd
        return fwd(x, spec)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        return ctx.bwd(x, dy, ctx.spec), None, None, None


class LutGatedMulFn(torch.autograd.Function):
    """``fwd(g, up, spec)`` with the gradients ``bwd(g, up, dh, spec) ->
    (dg, dup)`` (see :class:`LutActivationFn`)."""

    @staticmethod
    def forward(ctx, g, up, spec, fwd, bwd):
        ctx.save_for_backward(g, up)
        ctx.spec, ctx.bwd = spec, bwd
        return fwd(g, up, spec)

    @staticmethod
    def backward(ctx, dh):
        g, up = ctx.saved_tensors
        dg, dup = ctx.bwd(g, up, dh, ctx.spec)
        return dg, dup, None, None, None


def _like(t: torch.Tensor, x: torch.Tensor, what: str) -> torch.Tensor:
    """``t`` as a contiguous tensor of ``x``'s dtype, shape and device."""
    if t.shape != x.shape or t.device != x.device:
        raise ValueError(f"{what}: {tuple(t.shape)} on {t.device} is not "
                         f"like {tuple(x.shape)} on {x.device}")
    return t.to(x.dtype).contiguous()


def _check_table(x: torch.Tensor, spec: TableSpec, what: str) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what} takes f32 or bf16, not {x.dtype}")
    if spec.n > MAX_TABLE:
        raise ValueError(f"activation table of {spec.n} entries exceeds the "
                         f"{what} kernel's {MAX_TABLE}")


def _table_args(spec: TableSpec):
    """(n, lo, step_inv, indexing) as the kernels take them; ``step_inv``
    is rounded to f32 once, on the host, as the plain versions do."""
    return (spec.n, spec.lo, 1.0 / spec.step, INDEXING.index(spec.indexing))
