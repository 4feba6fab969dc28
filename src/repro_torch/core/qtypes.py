"""Fixed-point formats and quantized tensors (port of ``repro.core.qtypes``).

:class:`FixedPointType` (the ``ac_fixed`` analogue) with its integer
range, storage dtype, rounding and overflow modes, its tensor round trip
``quantize`` and its NumPy twin ``np_quantize`` (used at table-build
time); :class:`MiniFloatType` (the paper's custom floating-point
formats, IEEE-like or OCP extended range); the canonical ``AC_FIXED_*``,
``E4M3`` and ``E5M2`` instances; and :class:`QTensor` (integer payload
+ per-channel scale).  Every ``quantize`` is bitwise the reference's
(``tests/test_torch_train_ops.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = ["FixedPointType", "MiniFloatType", "QTensor", "storage_dtype",
           "AC_FIXED_16_6", "AC_FIXED_18_8", "AC_FIXED_8_3", "E4M3", "E5M2"]

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
    def frac_bits(self) -> int:
        return self.width - self.int_bits

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
    def min_value(self) -> float:
        return self.int_min * self.lsb

    @property
    def max_value(self) -> float:
        return self.int_max * self.lsb

    @property
    def dtype(self) -> torch.dtype:
        return storage_dtype(self.width)

    def to_int(self, x: torch.Tensor) -> torch.Tensor:
        """Real values -> the stored integers (f32 true division by the
        lsb, the rounding mode, then saturation or wraparound)."""
        y = x.to(torch.float32) / self.lsb
        if self.rounding == "rnd_even":
            y = torch.round(y)
        elif self.rounding == "rnd":
            y = torch.trunc(y + torch.copysign(torch.full_like(y, 0.5), y))
        else:
            y = torch.floor(y)
        if self.overflow == "sat":
            y = torch.clamp(y, self.int_min, self.int_max)
        else:
            span = float(1 << self.width)
            y = torch.remainder(y - self.int_min, span) + self.int_min
        return y.to(self.dtype)

    def from_int(self, i: torch.Tensor) -> torch.Tensor:
        return i.to(torch.float32) * self.lsb

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        """Round-trip a real tensor through this format (values stay f32)."""
        return self.from_int(self.to_int(x))

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


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """``2.0 ** e`` in f32, exactly, for integer ``e`` in [-149, 127], built
    from its bits (normal and subnormal), so that no ``exp2`` rounds."""
    e = e.to(torch.int32)
    normal = torch.clamp(e + 127, 1, 254) << 23
    sub = torch.ones_like(e) << torch.clamp(e + 149, 0, 22)
    return torch.where(e >= -126, normal, sub).view(torch.float32)


@dataclasses.dataclass(frozen=True)
class MiniFloatType:
    """Custom floating-point format with an ``exp_bits``/``man_bits`` split.

    ``ieee_inf=True`` reserves the all-ones exponent for inf/NaN (e.g.
    E5M2); ``False`` is the extended OCP range (E4M3: max finite 448).
    Quantization rounds the mantissa to ``man_bits`` half-to-even at the
    value's exponent, clamped below at the least normal exponent (gradual
    underflow through subnormals), and saturates at ``max_value``; NaN
    stays NaN, inf becomes ``max_value``, zero keeps its sign."""

    exp_bits: int
    man_bits: int
    bias: Optional[int] = None
    ieee_inf: bool = True

    def __post_init__(self):
        if self.exp_bits < 2 or self.exp_bits > 8:
            raise ValueError("exp_bits must be in [2, 8]")
        if self.man_bits < 0 or self.man_bits > 23:
            raise ValueError("man_bits must be in [0, 23]")

    @property
    def _bias(self) -> int:
        return self.bias if self.bias is not None else (1 << (self.exp_bits - 1)) - 1

    @property
    def max_exp(self) -> int:
        """Largest usable unbiased exponent."""
        top = (1 << self.exp_bits) - (2 if self.ieee_inf else 1)
        return top - self._bias

    @property
    def min_normal_exp(self) -> int:
        return 1 - self._bias

    @property
    def max_value(self) -> float:
        if self.ieee_inf:
            frac = 2.0 - 2.0 ** (-self.man_bits)
        else:  # all-ones exponent usable, one NaN encoding: drop one ulp
            frac = 2.0 - 2.0 ** (-self.man_bits) * (2.0 if self.man_bits > 0 else 1.0)
        return float(frac * 2.0**self.max_exp)

    @property
    def min_subnormal(self) -> float:
        return float(2.0 ** (self.min_normal_exp - self.man_bits))

    @property
    def width(self) -> int:
        return 1 + self.exp_bits + self.man_bits

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        """Round-trip through this format, in f32 (the reference's ops:
        ``frexp`` for the exponent, an exact power-of-two quantum)."""
        x = x.to(torch.float32)
        a = torch.abs(x)
        _, e = torch.frexp(a)
        eff = torch.clamp_min(e.to(torch.int32) - 1, self.min_normal_exp)
        quantum = _pow2(eff - self.man_bits)
        q = torch.round(a / quantum) * quantum
        # a tensor bound: an extended 8-bit exponent overflows f32 (inf)
        q = torch.minimum(q, torch.tensor(self.max_value, dtype=torch.float32,
                                          device=q.device))
        return torch.where(a == 0, torch.zeros_like(q),
                           torch.copysign(q, x))

    def np_quantize(self, x: np.ndarray) -> np.ndarray:
        """NumPy twin of :meth:`quantize` (table-build time)."""
        x = np.asarray(x, np.float32)
        a = np.abs(x).astype(np.float64)
        with np.errstate(divide="ignore"):
            _, e = np.frexp(a)
        eff = np.maximum(e - 1, self.min_normal_exp)
        quantum = np.exp2((eff - self.man_bits).astype(np.float64))
        q = np.where(quantum > 0, np.round(
            a / np.where(quantum == 0, 1, quantum)) * quantum, 0.0)
        q = np.minimum(q, self.max_value)
        return np.where(a == 0, 0.0, np.copysign(q, x)).astype(np.float32)

    def short_name(self) -> str:
        return f"e{self.exp_bits}m{self.man_bits}"


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
#: Aggressive edge-inference type.
AC_FIXED_8_3 = FixedPointType(8, 3)
#: OCP fp8 formats (E4M3 uses the extended range, max finite 448).
E4M3 = MiniFloatType(4, 3, ieee_inf=False)
E5M2 = MiniFloatType(5, 2, ieee_inf=True)
