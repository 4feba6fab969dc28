"""Kernels: plain versions (``ref``), Hopper CUDA kernels and their wrappers.

``csrc/`` holds the CUDA sources; :mod:`._cuda` builds them with ``nvcc``
at first use and counts launches (:func:`launch_counts`).  Sampling
(:mod:`.sampling`, threefry noise in :mod:`.prng`) is PyTorch ops, as the
reference leaves it to XLA.
"""

from ._cuda import launch_counts, reset_launch_counts

__all__ = ["launch_counts", "reset_launch_counts"]
