"""Turn the JAX package's parameters, given as numpy, into the port's.

The caller (a parity test) does the JAX -> numpy step, so the port never
sees a JAX type.  Input: a nested dict whose leaves are numpy arrays; a
quantized weight arrives as a dict with exactly the keys ``data`` and
``scale`` (the reference ``QTensor``'s payload and scale) and becomes a
:class:`~repro_torch.core.qtypes.QTensor` of ``qtype``.  Stacked
``(L, ...)`` layer leaves stay stacked.  The reference's whole train
state converts the same way (``params``, the AdamW ``m``, ``v`` and
``count``, ``step``): bf16 moments, which numpy carries as a 2-byte
``bfloat16`` dtype, are taken over bit for bit, and 0-d leaves stay 0-d.
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
    if a.dtype.name == "bfloat16":
        bits = np.array(a, order="C").view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    if not a.flags.writeable or not a.flags.c_contiguous:
        a = np.array(a, order="C")          # keeps a 0-d array 0-d
    return torch.from_numpy(a).to(device)
