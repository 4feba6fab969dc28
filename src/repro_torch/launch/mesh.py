"""Mesh construction (port of ``repro.launch.mesh``): ``DeviceMesh``\\ es
with the reference's axis names over the process group that ``torchrun``
(or the caller) set up.

The device is the GPU (NCCL) unless the caller asks for the CPU (gloo);
nothing falls back to the CPU or to gloo on its own.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..core.device import resolve_device

__all__ = ["init_distributed", "make_production_mesh", "make_local_mesh",
           "dp_axes"]

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def init_distributed(device=None) -> bool:
    """Join the process group that ``torchrun`` describes in the
    environment (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``/``PORT``):
    NCCL on the card (each rank on ``cuda:LOCAL_RANK``), gloo when
    ``device`` is the CPU.  Returns whether a process group exists (False
    outside ``torchrun``: one process, no mesh)."""
    if dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ:
        return False
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(_BACKEND[dev.type])
    return True


def _device_type(device) -> str:
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a process group: launch under "
                           "torchrun or call init_process_group first")
    return dev.type


def make_local_mesh(model: int = 1, *, device=None):
    """The ``(data, model)`` mesh, ``(world // model, model)``, over every
    rank of the process group.  The process group's backend must be the
    device's (NCCL for the card, gloo for the CPU)."""
    from torch.distributed.device_mesh import init_device_mesh
    dtype = _device_type(device)
    backend = dist.get_backend()
    if backend != _BACKEND[dtype]:
        raise RuntimeError(f"a {dtype} mesh needs the {_BACKEND[dtype]} "
                           f"backend, not {backend}")
    n = dist.get_world_size()
    if model < 1 or n % model:
        raise ValueError(f"--model-parallel {model} does not divide the "
                         f"{n} ranks")
    return init_device_mesh(dtype, (n // model, model),
                            mesh_dim_names=("data", "model"))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16 x 16 = 256 ranks a pod (``data`` x ``model``); ``multi_pod``
    stacks 2 pods = 512 (``pod`` x ``data`` x ``model``)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(_device_type(device), shape, mesh_dim_names=axes)


def dp_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
