"""Execution context threading the paper's knobs through the model stack
(port of ``repro.nn.context``).

The fields are the reference's.  Of the numeric modes the port runs
``none`` (matmuls in ``compute_dtype``) and ``int8`` (the ``qmatmul``
kernel), each with or without ``use_lut`` (the paper's constant-table
activations and softmax); ``fake`` is refused with an error naming the
ROADMAP.md item that will port it.  ``kv_cache_bits`` is carried as in
the reference, where nothing reads it: the engine's ``kv_bits`` chooses
the cache.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.precision import PrecisionPolicy
from ..core.qtypes import FixedPointType

__all__ = ["QuantContext", "DEFAULT_CTX"]

_MODES = ("none", "int8")


@dataclasses.dataclass(frozen=True)
class QuantContext:
    """Numeric execution configuration for one forward pass.

    ``backend``: registry backend for the hot ops (None = the default,
    ``cuda``; ``ref`` forces the plain versions on any device).
    ``kv_split``/``pages_per_step``: the split-KV knob of paged attention
    (None = the cost model's choice; ``(1, 1)`` = the unsplit kernel).
    """

    mode: str = "none"
    policy: PrecisionPolicy = PrecisionPolicy()
    act_qtype: Optional[FixedPointType] = None
    use_lut: bool = False
    table_n: int = 1024
    table_indexing: str = "interp"
    reuse_factor: int = 1
    backend: Optional[str] = None
    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    softmax_exact_divide: bool = True
    respect_user_type: bool = False
    kv_cache_bits: Optional[int] = None
    kv_split: Optional[int] = None
    pages_per_step: Optional[int] = None
    force_paged_kernel: bool = False

    def __post_init__(self):
        if self.mode == "fake":
            raise NotImplementedError(
                "mode='fake' (straight-through fake quantization) is not "
                "ported yet: ROADMAP.md queue 1, item 2 (core) and item 16")
        if self.mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}")
        if self.reuse_factor < 1:
            raise ValueError("reuse_factor >= 1")
        for knob in ("kv_split", "pages_per_step"):
            v = getattr(self, knob)
            if v is not None and v < 1:
                raise ValueError(f"{knob} must be >= 1 (or None = auto)")


DEFAULT_CTX = QuantContext()
