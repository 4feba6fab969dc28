"""PyTorch / CUDA port of :mod:`repro`, for NVIDIA Hopper (sm_90a).

The package mirrors ``src/repro`` module by module and is held against it
by the ``tests/test_torch_*.py`` parity suites.  It imports ``torch`` and
numpy only -- never ``jax`` and nothing of ``repro``: what it needs from
the reference (configs, paging, lifecycle, precision) is copied here.

What is ported so far is the main serving path: int8 paged serving of
the dense ``lm`` family (``launch/serve.py::Engine``), with hand-written
CUDA kernels for the quantized matmul and paged attention under
``kernels/csrc``.  ROADMAP.md lists what is still to come.

Entry points (``Engine``, ``python -m repro_torch.launch.serve``) run on
``cuda`` unless the caller passes ``device="cpu"``; without a GPU and
without that explicit choice they raise.
"""

__all__ = ["core", "kernels", "nn", "models", "configs", "train", "launch",
           "ft", "checkpoint", "convert"]
