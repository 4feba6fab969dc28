"""Compressed cross-pod gradient reduction: a quantized all-reduce, with
and without error feedback (port of ``repro.dist.compression``).

The paper's narrow-operand thesis applied to the interconnect.  As in the
reference the compression is a numerics-faithful emulation: each rank
round-trips its contribution through a ``FixedPointType`` with a dynamic
per-tensor scale before the sum, and the wire still carries f32.
:func:`quantized_psum_ef` carries the quantization residual to the next
step, which removes plain quantization's constant bias.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.distributed as dist

from ..core.qtypes import FixedPointType
from ..core.tree import tree_map
from .constrain import reduce_partial
from .sharding import is_dtensor

__all__ = ["quantized_psum", "quantized_psum_ef", "make_pod_sharded_grad_fn"]


def _round_trip(x: torch.Tensor, qtype: FixedPointType) -> torch.Tensor:
    """``x`` through ``qtype`` with a dynamic per-tensor scale (on a
    DTensor the max is global)."""
    amax = torch.clamp_min(torch.max(torch.abs(x)), 1e-12)
    scale = amax / qtype.int_max
    q = torch.clamp(torch.round(x / scale), qtype.int_min, qtype.int_max)
    return q * scale


def quantized_psum(x: torch.Tensor, axis: str, qtype: FixedPointType, *,
                   mesh) -> torch.Tensor:
    """The sum over ``mesh``'s ``axis`` of every rank's ``x`` (a local
    tensor), each quantized to ``qtype`` first."""
    q = _round_trip(x, qtype)
    dist.all_reduce(q, group=mesh.get_group(axis))
    return q


def quantized_psum_ef(x: torch.Tensor, residual: torch.Tensor, axis: str,
                      qtype: FixedPointType, *, mesh
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error feedback: ``(sum, new residual)``, the residual what this
    rank's quantization dropped from ``x + residual``."""
    t = x + residual
    q = _round_trip(t, qtype)
    r = t - q
    dist.all_reduce(q, group=mesh.get_group(axis))
    return q, r


def make_pod_sharded_grad_fn(grad_fn: Callable, mesh, *,
                             qtype: FixedPointType = None) -> Callable:
    """Wrap ``grad_fn(params, batch) -> (grads, metrics)`` for a mesh with
    a ``pod`` axis: ``grad_fn`` runs on this pod's sub-mesh (``data`` x
    ``model``, DTensor inside the pod) with this pod's batch; the cross-pod
    mean of the gradients goes through :func:`quantized_psum` when
    ``qtype`` is given (a plain all-reduce otherwise), and the metrics are
    averaged over the pods."""
    names = list(mesh.mesh_dim_names)
    npod = mesh.size(names.index("pod"))
    group = mesh.get_group("pod")
    inv = 1.0 / npod

    def reduce_leaf(g):
        if is_dtensor(g):
            from torch.distributed.tensor import DTensor
            g = reduce_partial(g)
            rt = _round_trip(g, qtype) if qtype is not None else g
            local = rt.to_local().clone()
            dist.all_reduce(local, group=group)
            return DTensor.from_local(local * inv, g.device_mesh,
                                      g.placements, run_check=False)
        local = _round_trip(g, qtype) if qtype is not None else g.clone()
        dist.all_reduce(local, group=group)
        return local * inv

    def metric(m):
        m = m.full_tensor() if is_dtensor(m) else m.clone()
        dist.all_reduce(m, group=group)
        return m * inv

    def wrapped(params, batch):
        grads, metrics = grad_fn(params, batch)
        return tree_map(reduce_leaf, grads), tree_map(metric, metrics)

    return wrapped
