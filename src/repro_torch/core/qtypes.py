"""Fixed-point formats and quantized tensors (port of ``repro.core.qtypes``).

The int8 subset of the reference: :class:`FixedPointType` (the
``ac_fixed`` analogue) with its integer range and storage dtype, its
NumPy twin ``np_quantize`` (used at table-build time), the canonical
``AC_FIXED_16_6`` / ``AC_FIXED_18_8`` instances, and :class:`QTensor`
(integer payload + per-channel scale).  Minifloat formats are not
ported yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["FixedPointType", "QTensor", "storage_dtype", "AC_FIXED_16_6",
           "AC_FIXED_18_8"]

_ROUNDING_MODES = ("rnd_even", "rnd", "trn")
_OVERFLOW_MODES = ("sat", "wrap")


def storage_dtype(width: int) -> torch.dtype:
    """Narrowest signed integer dtype that can carry ``width`` bits."""
    if width <= 8:
        return torch.int8
    if width <= 16:
        return torch.int16
    if width <= 32:
        return torch.int32
    raise ValueError(f"fixed-point width {width} > 32 unsupported")


@dataclasses.dataclass(frozen=True)
class FixedPointType:
    """``ac_fixed``-style format: value = stored_integer * 2**(int_bits - width)."""

    width: int
    int_bits: int
    signed: bool = True
    rounding: str = "rnd_even"
    overflow: str = "sat"

    def __post_init__(self):
        if self.width < 1:
            raise ValueError("width must be >= 1")
        if self.rounding not in _ROUNDING_MODES:
            raise ValueError(f"rounding must be one of {_ROUNDING_MODES}")
        if self.overflow not in _OVERFLOW_MODES:
            raise ValueError(f"overflow must be one of {_OVERFLOW_MODES}")

    @property
    def lsb(self) -> float:
        return float(2.0 ** (self.int_bits - self.width))

    @property
    def int_min(self) -> int:
        return -(1 << (self.width - 1)) if self.signed else 0

    @property
    def int_max(self) -> int:
        return (1 << (self.width - 1)) - 1 if self.signed else (1 << self.width) - 1

    @property
    def dtype(self) -> torch.dtype:
        return storage_dtype(self.width)

    def np_quantize(self, x: np.ndarray) -> np.ndarray:
        """Round-trip through this format in NumPy (table-build time)."""
        y = np.asarray(x, np.float64) / self.lsb
        if self.rounding == "rnd_even":
            y = np.round(y)
        elif self.rounding == "rnd":
            y = np.trunc(y + np.copysign(0.5, y))
        else:
            y = np.floor(y)
        if self.overflow == "sat":
            y = np.clip(y, self.int_min, self.int_max)
        else:
            span = float(1 << self.width)
            y = np.mod(y - self.int_min, span) + self.int_min
        return (y * self.lsb).astype(np.float32)

    def short_name(self) -> str:
        s = "s" if self.signed else "u"
        return f"fx{s}{self.width}_{self.int_bits}"


class QTensor:
    """Integer payload + broadcastable scale: ``value ~= data * scale``."""

    def __init__(self, data: torch.Tensor, scale: torch.Tensor,
                 qtype: FixedPointType):
        self.data = data
        self.scale = scale
        self.qtype = qtype

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    def __getitem__(self, i) -> "QTensor":
        """Index the leading (layer-stack) axis of payload and scale."""
        return QTensor(self.data[i], self.scale[i], self.qtype)

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return (self.data.to(torch.float32) * self.scale).to(dtype)

    def __repr__(self):
        return f"QTensor({tuple(self.data.shape)}, {self.qtype.short_name()})"


#: hls4ml's classic default model type.
AC_FIXED_16_6 = FixedPointType(16, 6)
#: The paper's softmax-table type (sized for a Xilinx 18k BRAM).
AC_FIXED_18_8 = FixedPointType(18, 8)
