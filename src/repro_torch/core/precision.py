"""Per-layer precision policies (copy of ``repro.core.precision``).

A default :class:`LayerPrecision` plus ordered fnmatch-pattern
overrides over '/'-joined parameter paths, resolved most-specific-last
-- hls4ml's model-then-layer configuration granularity.
"""

from __future__ import annotations

import dataclasses
import fnmatch
from typing import Optional, Tuple, Union

from .qtypes import FixedPointType, MiniFloatType

__all__ = ["LayerPrecision", "PrecisionPolicy", "FP32_PRECISION"]

QType = Optional[Union[FixedPointType, MiniFloatType]]


@dataclasses.dataclass(frozen=True)
class LayerPrecision:
    """Quantization assignment for one layer (None = keep float)."""

    weights: QType = None
    activations: QType = None
    #: activation-table length/format override (None = module default)
    table_n: Optional[int] = None
    table_qtype: QType = None


FP32_PRECISION = LayerPrecision()


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Default precision + ordered (pattern, LayerPrecision) overrides."""

    default: LayerPrecision = FP32_PRECISION
    overrides: Tuple[Tuple[str, LayerPrecision], ...] = ()

    def resolve(self, path: str) -> LayerPrecision:
        hit = self.default
        for pattern, prec in self.overrides:
            if fnmatch.fnmatch(path, pattern):
                hit = prec
        return hit

    def with_override(self, pattern: str, prec: LayerPrecision) -> "PrecisionPolicy":
        return dataclasses.replace(self, overrides=self.overrides + ((pattern, prec),))

    @staticmethod
    def uniform(weights: QType, activations: QType = None) -> "PrecisionPolicy":
        return PrecisionPolicy(default=LayerPrecision(weights=weights,
                                                      activations=activations))
