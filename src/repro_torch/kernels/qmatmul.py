"""int8 x int8 -> int32 quantized matmul with the fused epilogue.

Port of ``repro.kernels.qmatmul`` (TPU: ``qmatmul_pallas``).  The Hopper
kernel is ``csrc/qmatmul.cu``; its plain version is
:func:`repro_torch.kernels.ref.qmatmul_ref`, re-exported here as
:func:`qmatmul_plain`.

:func:`qmatmul` is the kernel's wrapper: for CPU tensors it runs the
plain version (that is how the CPU tests reach it), for CUDA tensors it
launches the kernel or raises -- it never falls back.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.tables import INDEXING, TableSpec, get_table
from . import _cuda
from .ref import qmatmul_ref as qmatmul_plain

__all__ = ["qmatmul", "qmatmul_plain", "MAX_TABLE"]

#: longest activation table the kernel keeps in shared memory
MAX_TABLE = 8192
#: the kernel's output tile (columns) and K stage (bytes): decode (M <= 16)
#: and the 128-row tiling
_BN, _BK_DECODE, _BK = 128, 128, 64


def _splitk_plan(m: int, n: int, k: int, sms: int) -> int:
    """How many blocks share one output tile's K range (measured on the
    H100, PERF.md section 6).

    Decode (M <= 16, bound by the weight stream and, for the small
    projections, by latency): ~1 block per SM when fewer tiles than half
    the SMs exist, down to one K stage per block; a K of <= 4 stages is
    not split.  M > 16 (128 x 128 tiles, whose 16K int32 atomics per
    block cost more than a short K saves): only a long K (>= 128 stages)
    on fewer tiles than half the SMs, ~1 block per SM with >= 32 stages
    each.
    """
    tiles = -(-n // _BN)
    if m <= 16:
        stages = -(-k // _BK_DECODE)
        if 2 * tiles >= sms or stages <= 4:
            return 1
        return max(1, min(-(-sms // tiles), stages))
    tiles *= -(-m // 128)
    stages = -(-k // _BK)
    if 2 * tiles >= sms or stages < 128:
        return 1
    return max(1, min(-(-sms // tiles), stages // 32))


def _workspace(dev, m: int, n: int, splitk: int):
    """Null pointers for an unsplit launch; else the int32 M x N workspace
    and one ticket per output tile, zeroed, which the kernel leaves
    zeroed (:func:`~repro_torch.kernels._cuda.zeroed_scratch`: one pair
    per device and stream, or per call under graph capture)."""
    if splitk == 1:
        return None, None
    tiles = -(-n // _BN) * -(-m // 16)
    return (_cuda.zeroed_scratch("qmatmul_workspace", dev, m * n).data_ptr(),
            _cuda.zeroed_scratch("qmatmul_tickets", dev, tiles).data_ptr())


def _vector(s, n: int, what: str, device) -> torch.Tensor:
    """A scale given as scalar, (n,), (n, 1) or (1, n) -> contiguous (n,) f32."""
    s = torch.as_tensor(s, dtype=torch.float32, device=device)
    if s.numel() == 1:
        return s.reshape(1).expand(n).contiguous()
    if s.numel() != n:
        raise ValueError(f"{what} has {s.numel()} values, expected 1 or {n}")
    return s.reshape(n).contiguous()


def qmatmul(a_data: torch.Tensor, b_data: torch.Tensor, a_scale, b_scale,
            bias: Optional[torch.Tensor] = None, out_dtype=torch.float32, *,
            act_spec: Optional[TableSpec] = None,
            act_gated: bool = False) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 with row/column scales -> (M, N) float.

    ``a_scale`` as (M, 1) or scalar, ``b_scale`` as (1, N) or scalar;
    ``bias`` (N,); ``act_spec`` applies a LUT activation in the epilogue
    (``act_gated``: ``y * table(y)``).  ``out_dtype`` f32 or bf16.
    """
    if a_data.device.type == "cpu":
        return qmatmul_plain(a_data, b_data, a_scale, b_scale, bias,
                             out_dtype, act_spec=act_spec, act_gated=act_gated)
    if a_data.device.type != "cuda":
        raise ValueError(f"qmatmul: unsupported device {a_data.device}")
    dev = a_data.device
    if a_data.dtype != torch.int8 or b_data.dtype != torch.int8:
        raise TypeError(f"qmatmul takes int8 operands, got {a_data.dtype} "
                        f"and {b_data.dtype}")
    if a_data.ndim != 2 or b_data.ndim != 2 \
            or a_data.shape[1] != b_data.shape[0]:
        raise ValueError(f"qmatmul shapes {tuple(a_data.shape)} x "
                         f"{tuple(b_data.shape)} do not chain")
    if b_data.device != dev:
        raise ValueError("qmatmul operands live on different devices")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"qmatmul writes f32 or bf16, not {out_dtype}")
    m, k = a_data.shape
    n = b_data.shape[1]
    a = a_data.contiguous()
    b = b_data.contiguous()
    sa = _vector(a_scale, m, "a_scale", dev)
    sb = _vector(b_scale, n, "b_scale", dev)
    bias_t = None if bias is None else _vector(bias, n, "bias", dev)
    table, table_n, lo, step_inv, indexing = None, 0, 0.0, 0.0, 0
    if act_spec is not None:
        if act_spec.n > MAX_TABLE:
            raise ValueError(f"activation table of {act_spec.n} entries "
                             f"exceeds the kernel's {MAX_TABLE}")
        table = get_table(act_spec).values(dev)
        table_n, lo = act_spec.n, act_spec.lo
        step_inv = 1.0 / act_spec.step          # once, on the host
        indexing = INDEXING.index(act_spec.indexing)
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0 or n == 0:
        return out
    lib = _cuda.library("qmatmul")
    splitk = _splitk_plan(m, n, k, _cuda.sm_count(dev))
    ws, tickets = _workspace(dev, m, n, splitk)
    err = lib.qmatmul_launch(
        a.data_ptr(), b.data_ptr(), sa.data_ptr(), sb.data_ptr(),
        None if bias_t is None else bias_t.data_ptr(),
        None if table is None else table.data_ptr(), out.data_ptr(),
        m, n, k, table_n, lo, step_inv, indexing, int(bool(act_gated)),
        int(out_dtype == torch.bfloat16), splitk, ws, tickets,
        _cuda.stream_of(out))
    _cuda.check(lib, err, "qmatmul")
    _cuda.LAUNCHES["qmatmul"] += 1
    return out
