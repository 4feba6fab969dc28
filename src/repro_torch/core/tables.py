"""Build-time constant tables (port of ``repro.core.tables``).

Tables are computed eagerly in NumPy -- the paper's ``constexpr`` table
generation -- with the same compute functions and the same float64 knot
grid as the reference, so ``get_table(spec).np_values`` is bitwise
equal to the JAX package's.  Only then are they handed to torch (the
qmatmul kernel keeps the table in shared memory).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .qtypes import FixedPointType

__all__ = ["TableSpec", "ConstexprTable", "get_table", "register_compute",
           "table_lookup", "COMPUTE_FNS", "GATED_FORMS", "INDEXING"]

COMPUTE_FNS: Dict[str, Callable[[np.ndarray], np.ndarray]] = {}


def register_compute(name: str):
    def deco(fn):
        COMPUTE_FNS[name] = fn
        return fn
    return deco


@register_compute("sigmoid")
def _sigmoid(x):  # numerically-stable logistic
    return np.where(x >= 0, 1.0 / (1.0 + np.exp(-x)), np.exp(x) / (1.0 + np.exp(x)))


@register_compute("tanh")
def _tanh(x):
    return np.tanh(x)


@register_compute("exp")
def _exp(x):
    return np.exp(x)


@register_compute("invert")
def _invert(x):
    return 1.0 / np.maximum(x, 1e-12)


@register_compute("silu")
def _silu(x):
    return x * _sigmoid(x)


@register_compute("gelu")
def _gelu(x):  # tanh approximation
    return 0.5 * x * (1.0 + np.tanh(0.7978845608028654 * (x + 0.044715 * x**3)))


@register_compute("gelu_gate")
def _gelu_gate(x):  # bounded gate: gelu(x) = x * gelu_gate(x)
    return 0.5 * (1.0 + np.tanh(0.7978845608028654 * (x + 0.044715 * x**3)))


@register_compute("silu_gate")
def _silu_gate(x):  # bounded gate: silu(x) = x * sigmoid(x)
    return _sigmoid(x)


@register_compute("softplus")
def _softplus(x):
    return np.logaddexp(0.0, x)


@register_compute("erf")
def _erf(x):  # Abramowitz & Stegun 7.1.26, as in the reference
    t = 1.0 / (1.0 + 0.3275911 * np.abs(x))
    y = 1.0 - (((((1.061405429 * t - 1.453152027) * t) + 1.421413741) * t
                - 0.284496736) * t + 0.254829592) * t * np.exp(-x * x)
    return np.sign(x) * y


@register_compute("relu")
def _relu(x):
    return np.maximum(x, 0.0)


#: Activations with exact gated forms: f(x) = x * gate(x), gate bounded.
GATED_FORMS = {"silu": "silu_gate", "gelu": "gelu_gate"}

#: indexing modes, in the order the CUDA epilogue numbers them
INDEXING = ("trunc", "nearest", "interp")


@dataclasses.dataclass(frozen=True)
class TableSpec:
    """Fully static description of a constant table (hashable cache key)."""

    fn: str
    n: int = 1024
    lo: float = -8.0
    hi: float = 8.0
    qtype: Optional[FixedPointType] = None
    indexing: str = "trunc"

    def __post_init__(self):
        if self.fn not in COMPUTE_FNS:
            raise KeyError(f"unknown compute fn {self.fn!r}; register it first")
        if self.n < 2:
            raise ValueError("table length must be >= 2")
        if not self.hi > self.lo:
            raise ValueError("need hi > lo")
        if self.indexing not in INDEXING:
            raise ValueError(f"indexing must be one of {INDEXING}")

    @property
    def step(self) -> float:
        return (self.hi - self.lo) / self.n


class ConstexprTable:
    """An ``N``-entry constant array evaluated once, in NumPy."""

    def __init__(self, spec: TableSpec):
        self.spec = spec
        knots = spec.lo + spec.step * np.arange(spec.n, dtype=np.float64)
        vals = COMPUTE_FNS[spec.fn](knots).astype(np.float32)
        if spec.qtype is not None:
            vals = spec.qtype.np_quantize(vals)
        self.np_values: np.ndarray = vals
        self.np_values.setflags(write=False)
        self._on: Dict[torch.device, torch.Tensor] = {}

    def values(self, device) -> torch.Tensor:
        """The table as a float32 tensor on ``device`` (copied once)."""
        device = torch.device(device)
        t = self._on.get(device)
        if t is None:
            t = torch.from_numpy(self.np_values.copy()).to(device)
            self._on[device] = t
        return t

    def __repr__(self):
        return f"ConstexprTable({self.spec})"


@functools.lru_cache(maxsize=256)
def get_table(spec: TableSpec) -> ConstexprTable:
    """Build (or fetch the cached) constant table for ``spec``."""
    return ConstexprTable(spec)


def table_lookup(x: torch.Tensor, values: torch.Tensor, lo: float, hi: float,
                 indexing: str = "trunc") -> torch.Tensor:
    """Map ``x`` into the table domain and gather (optionally interpolate)."""
    n = values.shape[0]
    step = (hi - lo) / n
    pos = (x.to(torch.float32) - lo) / step
    if indexing == "interp":
        pos = torch.clamp(pos, 0.0, n - 1.0)
        i0 = torch.floor(pos)
        frac = pos - i0
        i0 = i0.to(torch.int64)
        i1 = torch.clamp_max(i0 + 1, n - 1)
        return values[i0] * (1.0 - frac) + values[i1] * frac
    if indexing == "nearest":
        idx = torch.clamp(torch.round(pos), 0, n - 1).to(torch.int64)
    else:  # trunc -- hls4ml-faithful
        idx = torch.clamp(torch.floor(pos), 0, n - 1).to(torch.int64)
    return values[idx]
