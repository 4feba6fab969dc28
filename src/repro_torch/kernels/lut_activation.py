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
"""

from __future__ import annotations

import torch

from ..core.tables import INDEXING, TableSpec, get_table
from . import _cuda
from .ref import lut_activation_plain, lut_gated_mul_plain

__all__ = ["lut_activation", "lut_activation_plain", "lut_gated_mul",
           "lut_gated_mul_plain", "MAX_TABLE"]

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
