"""Mesh context and logical-axis sharding constraints (port of
``repro.dist.constrain``).

Model code never names mesh axes: it pins tensors with the logical labels
``"dp"`` (data parallel) and ``"tp"`` (tensor parallel), which resolve
against the mesh that :func:`use_mesh` made current -- ``("pod",
"data")`` and ``"model"`` on a multi-pod mesh, ``"data"`` and ``"model"``
on one pod.  With no mesh, :func:`constrain` returns its argument, so the
single-process path runs the same code and creates no DTensor.  Under a
mesh it is the reference's ``with_sharding_constraint``: a DTensor is
redistributed to the guarded placements.
"""

from __future__ import annotations

import contextlib
import math
import threading

from .sharding import NamedSharding, P, guard_spec, is_dtensor, mesh_shape

__all__ = ["use_mesh", "current_mesh", "constrain", "mesh_ranks",
           "placements_of", "fsdp_gather", "unshard", "reduce_partial"]

_state = threading.local()

#: logical label -> candidate mesh axis names, in precedence order
_LOGICAL_AXES = {
    "dp": ("pod", "data"),
    "tp": ("model",),
}


def current_mesh():
    """The active ``DeviceMesh``, or None (no mesh: one process)."""
    stack = getattr(_state, "meshes", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` current for every :func:`constrain` in scope."""
    stack = getattr(_state, "meshes", None)
    if stack is None:
        stack = _state.meshes = []
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


def _resolve_axis(label, mesh):
    """A logical label -> the mesh axes it spans (a name, a tuple, None)."""
    if label is None:
        return None
    names = mesh_shape(mesh)
    if label in _LOGICAL_AXES:
        axes = tuple(a for a in _LOGICAL_AXES[label] if a in names)
        if not axes:
            return None
        return axes if len(axes) > 1 else axes[0]
    return label if label in names else None


def mesh_ranks(mesh) -> int:
    """The number of ranks of a ``DeviceMesh``."""
    return math.prod(mesh_shape(mesh).values())


def constrain(t, *labels):
    """Pin ``t`` to the sharding of per-dim logical ``labels`` (missing
    trailing labels: replicated).  A label whose axis size does not divide
    the dim is dropped (the divisibility guard); an all-replicated result
    leaves ``t`` as it is, as the reference does.  Identity without a
    mesh.  Under a mesh of more than one rank ``t`` must be a DTensor: a
    plain tensor there escaped the sharding, and raises."""
    mesh = current_mesh()
    if mesh is None:
        return t
    if not is_dtensor(t):
        if mesh_ranks(mesh) > 1:
            raise TypeError(
                f"constrain{labels}: a plain {tuple(t.shape)} tensor under a "
                f"mesh of {mesh_ranks(mesh)} ranks escaped the sharding")
        return t
    spec = _guarded(t.shape, mesh, labels)
    if all(a is None for a in spec):
        return t
    placements = NamedSharding(mesh, spec).placements
    if tuple(t.placements) == placements:
        return t
    return t.redistribute(mesh, placements)


def _guarded(shape, mesh, labels) -> P:
    resolved = [_resolve_axis(lb, mesh) for lb in labels[:len(shape)]]
    return guard_spec(P(*resolved), shape, mesh)


def placements_of(shape, mesh, *labels) -> tuple:
    """The DTensor placements :func:`constrain` pins a tensor of
    ``shape`` to under ``mesh`` (replicated where the guard drops a
    label)."""
    return NamedSharding(mesh, _guarded(shape, mesh, labels)).placements



def fsdp_gather(w):
    """A weight as its product uses it: a DTensor gathered over the data
    axes (the FSDP all-gather; its gradient comes back as a
    reduce-scatter), its ``model`` sharding kept.  Identity for a plain
    tensor."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate
    names = w.device_mesh.mesh_dim_names
    pl = tuple(Replicate() if n in _LOGICAL_AXES["dp"] else p
               for n, p in zip(names, w.placements))
    return w if pl == tuple(w.placements) else w.redistribute(
        w.device_mesh, pl)


def _replaced(t, hit):
    """``t`` redistributed with the placements ``hit`` picks replicated
    (``t`` itself when there are none)."""
    from torch.distributed.tensor import Replicate
    pl = tuple(Replicate() if hit(p) else p for p in t.placements)
    return t if pl == tuple(t.placements) else t.redistribute(
        t.device_mesh, pl)


def unshard(t, dim: int):
    """A DTensor gathered along tensor dim ``dim`` where a mesh axis
    shards it; a plain tensor as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Shard
    dim %= t.ndim
    return _replaced(t, lambda p: isinstance(p, Shard) and p.dim == dim)


def reduce_partial(t):
    """A DTensor with its partial sums reduced (replicated on those mesh
    axes); a plain tensor as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Partial
    return _replaced(t, lambda p: isinstance(p, Partial))
