"""Elementwise lookup-table activation (the paper's constant tables).

Port of ``repro.kernels.lut_activation`` (TPU: ``lut_activation_pallas``).
The Hopper kernel is ``csrc/lut_activation.cu``; its plain version is
:func:`repro_torch.kernels.ref.lut_activation_plain`, which indexes as
the kernel does (``(x - lo) * step_inv``, see
:func:`~repro_torch.kernels.ref.apply_table`).

:func:`lut_activation` is the kernel's wrapper: for CPU tensors it runs
the plain version (that is how the CPU tests reach it), for CUDA tensors
it launches the kernel or raises -- it never falls back.
"""

from __future__ import annotations

import torch

from ..core.tables import INDEXING, TableSpec, get_table
from . import _cuda
from .ref import lut_activation_plain

__all__ = ["lut_activation", "lut_activation_plain", "MAX_TABLE"]

#: longest table the kernel stages in shared memory (16 KB of f32)
MAX_TABLE = 4096


def lut_activation(x: torch.Tensor, spec: TableSpec) -> torch.Tensor:
    """Apply the table described by ``spec`` to ``x`` (any shape, f32 or
    bf16 on the card); the result has ``x``'s shape and dtype."""
    if x.device.type == "cpu":
        return lut_activation_plain(x, spec)
    if x.device.type != "cuda":
        raise ValueError(f"lut_activation: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"lut_activation takes f32 or bf16, not {x.dtype}")
    if spec.n > MAX_TABLE:
        raise ValueError(f"activation table of {spec.n} entries exceeds the "
                         f"lut_activation kernel's {MAX_TABLE}")
    dev = x.device
    xc = x.contiguous()
    out = torch.empty_like(xc)
    if xc.numel() == 0:
        return out
    table = get_table(spec).values(dev)
    lib = _cuda.library("lut_activation")
    err = lib.lut_activation_launch(
        xc.data_ptr(), table.data_ptr(), out.data_ptr(), xc.numel(), spec.n,
        spec.lo, 1.0 / spec.step, INDEXING.index(spec.indexing),
        int(x.dtype == torch.bfloat16), _cuda.sm_count(dev),
        _cuda.stream_of(out))
    _cuda.check(lib, err, "lut_activation")
    _cuda.LAUNCHES["lut_activation"] += 1
    return out
