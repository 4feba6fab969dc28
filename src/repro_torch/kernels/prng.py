"""Threefry-2x32 random numbers, bit for bit ``jax.random``'s.

A copy of the parts of ``jax.random`` (default ``threefry2x32`` keys,
``jax_threefry_partitionable=True``) that the reference's sampling
calls: ``PRNGKey``, ``fold_in``, ``split``, 32-bit ``random_bits``,
``uniform`` and ``gumbel`` (mode ``"low"``).  The port's sampled streams therefore draw
the same noise as the JAX Engine's from the same seed.

Keys are (2,) int32 tensors holding the two uint32 words of JAX's raw
key as bit patterns (``key.numpy().view(np.uint32)`` is JAX's key), and
``random_bits`` returns int32 bit patterns the same way.  The uint32
arithmetic is int32 arithmetic that wraps: additions wrap on the CPU and
the card, left shifts are shifts of the unsigned pattern in PyTorch, and
right shifts are made logical by a mask.

Nothing here reads a device value on the host: ``fold_in`` takes its
data as a Python int or as a device tensor (a step counter), so a block
of decode steps that folds ``step0 + i`` into the key can be captured in
a CUDA graph with ``step0`` as a static input.  Constants enter as
Python scalars, never as host-to-device copies.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

__all__ = ["PRNGKey", "fold_in", "split", "random_bits", "uniform",
           "gumbel", "threefry2x32"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _i32(v: int) -> int:
    """A Python int's low 32 bits as a signed int32 value."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    """Rotate the uint32 patterns of int32 ``x`` left by ``r`` bits."""
    return (x << r) | ((x >> (32 - r)) & ((1 << r) - 1))


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of counts ``(x0, x1)`` under the
    key words ``(k0, k1)``: int32 tensors (or Python ints for ``x0``,
    ``x1``) that broadcast together.  ``jax._src.prng._threefry2x32_
    lowering``, unrolled."""
    ks = (k0, k1, k0 ^ k1 ^ _i32(_PARITY))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + (i + 1)
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:  # noqa: N802
    """``jax.random.PRNGKey(seed)`` with 32-bit seeds (JAX's default): the
    words ``(0, seed mod 2**32)``, as a (2,) int32 tensor on ``device``."""
    return torch.tensor([0, _i32(int(seed))], dtype=torch.int32,
                        device=device)


def fold_in(key: torch.Tensor, data: Union[int, torch.Tensor]) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the hash of the counts
    ``(0, data)`` under ``key``.  ``data`` is a Python int or an integer
    tensor on ``key``'s device (read by the device, never by the host);
    a tensor of shape S gives the S keys ``fold_in(key, d)`` of its
    elements, shape S + (2,), in one pass."""
    data = (data.to(torch.int32) if isinstance(data, torch.Tensor)
            else _i32(int(data)))
    y0, y1 = threefry2x32(key[0], key[1], 0, data)
    return torch.stack([y0, y1], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``, (num, 2): under the partitionable
    layout key ``i`` hashes the counts ``(0, i)``, which is
    ``fold_in(key, i)``, all ``num`` in one pass."""
    return fold_in(key, torch.arange(num, dtype=torch.int32,
                                     device=key.device))


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) as int32 bit patterns on
    ``key``'s device.  Partitionable layout: element ``i`` of the
    row-major flattening hashes the 64-bit count ``i`` split as
    ``(hi, lo) = (0, i)``, and its bits are the two output words XORed."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if n >= 1 << 31:
        raise ValueError(f"random_bits of {n} elements: counts past 2**31 "
                         f"are not supported")
    lo = torch.arange(n, dtype=torch.int32, device=key.device)
    y0, y1 = threefry2x32(key[0], key[1], 0, lo)
    return (y0 ^ y1).reshape(shape)


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the top
    23 bits as the mantissa of a float in [1, 2), minus 1, scaled to
    ``[minval, maxval)`` in float32, then ``max(minval, .)``."""
    bits = random_bits(key, shape)
    mant = ((bits >> 9) & 0x7FFFFF) | 0x3F800000
    floats = mant.view(torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    span = float(hi - lo)                     # rounded to float32, as JAX
    return torch.clamp_min(floats * span + float(lo), float(lo))


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` (mode ``"low"``):
    ``-log(-log(u))`` with ``u`` uniform on ``[tiny, 1)``."""
    tiny = float(np.finfo(np.float32).tiny)
    return -torch.log(-torch.log(uniform(key, shape, tiny, 1.0)))
