"""Backend-pluggable op registry (port of ``repro.core.registry``).

Every hot op is defined once by name and carries lowerings per backend:

* ``ref``  -- plain PyTorch, runs on any device; the numerics oracle.
* ``cuda`` -- the hand-written Hopper kernel's wrapper.  Given a CPU
  tensor the wrapper runs its kernel's plain version (that is how the
  CPU tests reach it); given a CUDA tensor it launches the kernel or
  raises.

Selection: explicit argument > ambient ``use_backend(...)`` > global
default (``cuda``).  Unlike the JAX registry there is **no fallback**:
an (op, backend) pair without a lowering raises ``KeyError``.  A card
that silently ran the plain version would report kernel numbers it
never measured.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Optional

__all__ = ["register_op", "get_impl", "use_backend", "current_backend",
           "BACKENDS"]

BACKENDS = ("ref", "cuda")

_OPS: Dict[str, Dict[str, Callable]] = {}
_state = threading.local()
_DEFAULT_BACKEND = "cuda"


def register_op(name: str, backend: str = "ref"):
    """Decorator: register ``fn`` as the ``backend`` lowering of op ``name``."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")

    def deco(fn):
        _OPS.setdefault(name, {})[backend] = fn
        return fn
    return deco


def current_backend() -> str:
    return getattr(_state, "backend", None) or _DEFAULT_BACKEND


@contextlib.contextmanager
def use_backend(backend: str):
    """Ambiently select a backend for all ops in scope."""
    prev = getattr(_state, "backend", None)
    _state.backend = backend
    try:
        yield
    finally:
        _state.backend = prev


def get_impl(name: str, backend: Optional[str] = None) -> Callable:
    if name not in _OPS:
        raise KeyError(f"op {name!r} is not registered")
    b = backend or current_backend()
    impls = _OPS[name]
    if b not in impls:
        raise KeyError(f"op {name!r} has no {b!r} lowering "
                       f"(available: {sorted(impls)}); the port never "
                       f"falls back to another backend")
    return impls[b]

