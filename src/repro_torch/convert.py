"""Turn the JAX package's parameters, given as numpy, into the port's.

The caller (a parity test) does the JAX -> numpy step, so the port never
sees a JAX type.  Input: a nested dict whose leaves are numpy arrays; a
quantized weight arrives as a dict with exactly the keys ``data`` and
``scale`` (the reference ``QTensor``'s payload and scale) and becomes a
:class:`~repro_torch.core.qtypes.QTensor` of ``qtype``.  Stacked
``(L, ...)`` layer leaves stay stacked.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .core.qtypes import FixedPointType, QTensor

__all__ = ["params_from_numpy", "QTENSOR_KEYS"]

QTENSOR_KEYS = frozenset({"data", "scale"})


def params_from_numpy(tree, *, device="cpu",
                      qtype: Optional[FixedPointType] = None):
    """Nested dict of numpy arrays -> nested dict of tensors / QTensors."""
    if isinstance(tree, dict):
        if set(tree) == QTENSOR_KEYS:
            if qtype is None:
                raise ValueError("a quantized leaf needs the qtype it was "
                                 "quantized with (pass qtype=...)")
            return QTensor(_tensor(tree["data"], device),
                           _tensor(tree["scale"], device), qtype)
        return {k: params_from_numpy(v, device=device, qtype=qtype)
                for k, v in tree.items()}
    return _tensor(tree, device)


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if not a.flags.writeable or not a.flags.c_contiguous:
        a = np.ascontiguousarray(a).copy()
    return torch.from_numpy(a).to(device)
