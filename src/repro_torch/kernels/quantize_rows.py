"""Per-row dynamic int8 quantization of a projection's activations.

The reference leaves this chain to one XLA fusion before every int8
projection (``repro.nn.linear._int8_matmul``: ``calibrate_scale``, round,
clip, cast); it has no Pallas kernel.  The Hopper kernel is
``csrc/quantize_rows.cu``, one launch where eager PyTorch took about
nine; its plain version is :func:`repro_torch.kernels.ref.
quantize_rows_ref`.

:func:`quantize_rows` is the kernel's wrapper: for CPU tensors it runs
the plain version (that is how the CPU tests reach it), for CUDA tensors
it launches the kernel or raises -- it never falls back.
"""

from __future__ import annotations

import torch

from ..core.qtypes import FixedPointType
from . import _cuda
from .ref import quantize_rows_ref as quantize_rows_plain

__all__ = ["quantize_rows", "quantize_rows_plain"]


def quantize_rows(x: torch.Tensor, qtype: FixedPointType):
    """``x`` (T, K), f32 or bf16 on the card -> ``(q, s)``: ``q`` (T, K) in
    ``qtype``'s storage type (int8), ``s`` (T, 1) f32, with ``s = max(max
    |x_row|, 1e-12) / int_max`` and ``q = clamp(round(x / s))``."""
    if x.device.type == "cpu":
        return quantize_rows_plain(x, qtype)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_rows: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quantize_rows takes f32 or bf16, not {x.dtype}")
    if x.ndim != 2 or x.shape[1] == 0:
        raise ValueError(f"quantize_rows takes (T, K >= 1), not "
                         f"{tuple(x.shape)}")
    if qtype.dtype != torch.int8 or not qtype.signed:
        raise TypeError(f"quantize_rows writes signed int8, not {qtype}")
    rows, k = x.shape
    xc = x.contiguous()
    q = torch.empty((rows, k), dtype=torch.int8, device=x.device)
    s = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    if rows == 0:
        return q, s
    lib = _cuda.library("quantize_rows")
    err = lib.quantize_rows_launch(
        xc.data_ptr(), q.data_ptr(), s.data_ptr(), rows, k,
        float(qtype.int_max), float(qtype.int_min), float(qtype.int_max),
        int(x.dtype == torch.bfloat16), _cuda.sm_count(x.device),
        _cuda.stream_of(q))
    _cuda.check(lib, err, "quantize_rows")
    _cuda.LAUNCHES["quantize_rows"] += 1
    return q, s
