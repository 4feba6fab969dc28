"""Build-time constant tables (port of ``repro.core.tables``).

Tables are computed eagerly in NumPy -- the paper's ``constexpr`` table
generation -- with the same compute functions and the same float64 knot
grid as the reference, so ``get_table(spec).np_values`` is bitwise
equal to the JAX package's.  Only then are they handed to torch (the
qmatmul and lut_activation kernels keep the table in shared memory).

Also here, as in the reference: the functional :func:`lut_activation`
and the paper's table softmax (:class:`SoftmaxTablePolicy`,
:func:`softmax_table_policy`, :func:`table_softmax`).  All of them index
with :func:`table_lookup`, ``(x - lo) / step``; the kernels' own indexing,
``(x - lo) * step_inv``, is :func:`repro_torch.kernels.ref.apply_table`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .qtypes import AC_FIXED_18_8, FixedPointType

__all__ = ["TableSpec", "ConstexprTable", "get_table", "register_compute",
           "table_lookup", "lut_activation", "SoftmaxTablePolicy",
           "softmax_table_policy", "table_softmax", "COMPUTE_FNS",
           "GATED_FORMS", "INDEXING"]

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

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return table_lookup(x, self.values(x.device), self.spec.lo,
                            self.spec.hi, self.spec.indexing)

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


def lut_activation(x: torch.Tensor, fn: str, *, n: int = 1024,
                   lo: float = -8.0, hi: float = 8.0,
                   qtype: Optional[FixedPointType] = None,
                   indexing: str = "interp", gated: bool = True) -> torch.Tensor:
    """Apply activation ``fn`` via a build-time constant table.

    ``gated=True`` uses the exact gated form for unbounded activations
    (silu/gelu): f(x) = x * gate_table(x).  ``gated=False`` tables f
    directly (hls4ml-faithful; saturates for |x| > hi).
    """
    if gated and fn in GATED_FORMS:
        gate = get_table(TableSpec(GATED_FORMS[fn], n, lo, hi, qtype,
                                   indexing))
        return x * gate(x)
    t = get_table(TableSpec(fn, n, lo, hi, qtype, indexing))
    if fn == "softplus":
        # softplus(x) -> x for large x; keep the asymptote exact
        return torch.where(x >= hi, x, t(x))
    return t(x)


# --------------------------------------------------------------------------
# Softmax -- the hls4ml implementation, and its de-specialized fix.
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SoftmaxTablePolicy:
    n: int = 1024
    qtype: Optional[FixedPointType] = AC_FIXED_18_8
    exp_lo: float = -16.0
    exp_hi: float = 0.0
    inv_hi: float = 64.0          # hls4ml invert-table domain cap
    exact_divide: bool = True     # improved mode: exact div after LUT exp
    indexing: str = "trunc"


def softmax_table_policy(user_qtype: Optional[FixedPointType] = None, *,
                         respect_user_type: bool = False, n: int = 1024,
                         exact_divide: bool = True,
                         indexing: str = "trunc") -> SoftmaxTablePolicy:
    """The paper-documented override: softmax tables are 1024 x 18-bit
    fixed point (one Xilinx 18k BRAM) *regardless* of the user's model
    type -- unless ``respect_user_type`` asks for the de-specialized fix."""
    qtype = user_qtype if respect_user_type else AC_FIXED_18_8
    return SoftmaxTablePolicy(n=n, qtype=qtype, exact_divide=exact_divide,
                              indexing=indexing)


def table_softmax(x: torch.Tensor, axis: int = -1,
                  policy: Optional[SoftmaxTablePolicy] = None) -> torch.Tensor:
    """Softmax whose exp (and optionally 1/x) come from constant tables.

    ``exact_divide=False`` is the fully hls4ml-faithful path: the row sum
    is inverted through a second table over (0, inv_hi] -- accurate only
    while the sum stays inside the table domain.  The improved default
    keeps the LUT exp (the expensive transcendental) and divides exactly.
    """
    p = policy or SoftmaxTablePolicy()
    exp_t = get_table(TableSpec("exp", p.n, p.exp_lo, p.exp_hi, p.qtype,
                                p.indexing))
    z = x - torch.amax(x, dim=axis, keepdim=True).detach()
    z = torch.clamp_min(z, p.exp_lo)  # saturate into the table domain
    e = exp_t(z)
    s = torch.sum(e, dim=axis, keepdim=True)
    if p.exact_divide:
        return e / s
    inv_t = get_table(TableSpec("invert", p.n, 1.0 / p.n, p.inv_hi, p.qtype,
                                p.indexing))
    return e * inv_t(torch.clamp_max(s, p.inv_hi))
