"""Where the port's entry points run: the GPU unless the caller names a
device.  The Engine, the CLI and the model and cache constructors all
resolve ``device=None`` here, so a run never lands on the CPU unasked."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names a device; never a silent CPU run."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port serves on the GPU; pass "
                "device='cpu' (CLI: --device cpu) to run the plain kernel "
                "versions on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           f"available")
    return device
