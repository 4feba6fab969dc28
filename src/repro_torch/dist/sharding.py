"""Sharding rules: rank/path heuristics -> guarded specs -> DTensor
placements (port of ``repro.dist.sharding``).

A spec (:class:`P`) has the reference's ``PartitionSpec`` meaning: for
each tensor dim, the mesh axis (or tuple of axes, major first) that
shards it, or None.  The rules are the reference's, case for case, and
:func:`guard_spec` drops any assignment whose dim does not divide the
mesh-axis size, so every shard is even:

* 2-D weights ``(d_in, d_out)`` -- FSDP on ``d_in`` (``data``), TP on
  ``d_out`` (``model``);
* stacked 3-D ``(L, d_in, d_out)`` -- the layer axis replicated, then as
  2-D;
* 4-D+ MoE banks ``(L, E, D, F)`` -- experts on ``model``;
* embedding tables ``(V, D)`` -- vocab on ``model``, feature on ``data``;
* batches -- the leading axis on the data axes (``pod`` and ``data``);
* caches -- ``(L, B, ...)``: L replicated, B on data; paged pools and
  block tables replicated.

A :class:`~repro_torch.core.qtypes.QTensor` leaf gets the weight rule on
its payload and a separately guarded spec for its scale, as a QTensor of
specs.  The rules read only a mesh's axis names and sizes: a
``DeviceMesh`` or a ``{axis: size}`` dict.  :func:`named` turns specs
into :class:`NamedSharding`\\ s (DTensor placements on a ``DeviceMesh``)
and :func:`device_put` places a tree with them, each rank cutting its
own shard from the full tensor it holds (no communication).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Sequence

import torch

from ..core.qtypes import QTensor

__all__ = ["P", "NamedSharding", "mesh_shape", "guard_spec", "param_specs",
           "batch_specs", "cache_specs", "named", "device_put",
           "is_dtensor"]


class P(tuple):
    """A partition spec: one entry per leading tensor dim, each a mesh axis
    name, a tuple of names (major first) or None; missing trailing
    entries are replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor (the module is imported only once a
    process group exists)."""
    if not torch.distributed.is_available() \
            or not torch.distributed.is_initialized():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis: size}`` in the mesh's order, of a ``DeviceMesh`` or of a
    ``{axis: size}`` dict."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(_device_mesh_shape(mesh))


@functools.lru_cache(maxsize=64)
def _device_mesh_shape(mesh) -> tuple:
    """(DeviceMesh.mesh rebuilds the rank tensor on each read: the
    constraints of every step ask for the shape, so it is read once.)"""
    return tuple(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _axis_size(shape: Dict[str, int], axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return math.prod(shape[a] for a in axis)
    return shape[axis]


def guard_spec(spec: Sequence, dims: Sequence[int], mesh) -> P:
    """Drop spec axes whose mesh-axis size does not divide the dim."""
    shape = mesh_shape(mesh)
    out = []
    for i, d in enumerate(dims):
        axis = spec[i] if i < len(spec) else None
        if axis is not None and int(d) % _axis_size(shape, axis) != 0:
            axis = None
        out.append(axis)
    return P(*out)


def _dp(names):
    axes = tuple(a for a in ("pod", "data") if a in names)
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def _tp(names):
    return "model" if "model" in names else None


def _param_rule(path: Sequence[str], shape, mesh) -> P:
    ndim = len(shape)
    names = mesh_shape(mesh)
    dp, tp = _dp(names), _tp(names)
    joined = "/".join(path).lower()
    if ndim <= 1:
        return P()
    if "embed" in joined or tuple(path[-1:]) == ("table",):
        # (V, D): vocab on model (logits shard the same way), D on data
        return guard_spec(P(*([None] * (ndim - 2) + [tp, dp])), shape, mesh)
    if ndim == 2:
        return guard_spec(P(dp, tp), shape, mesh)
    if ndim == 3:           # stacked (L, d_in, d_out)
        return guard_spec(P(None, dp, tp), shape, mesh)
    # 4-D+ stacked expert banks (L, E, D, F): expert parallelism
    return guard_spec(P(*([None, tp] + [None] * (ndim - 2))), shape, mesh)


def _map_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not isinstance(tree, P):
        return type(tree)(_map_path(fn, v, path + (f"[{i}]",))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def param_specs(params, mesh):
    """A spec tree like ``params``; a QTensor leaf becomes a QTensor of
    (payload spec, scale spec)."""
    def rule(path, leaf):
        if isinstance(leaf, QTensor):
            spec = _param_rule(path, leaf.data.shape, mesh)
            return QTensor(spec, guard_spec(spec, leaf.scale.shape, mesh),
                           leaf.qtype)
        return _param_rule(path, leaf.shape, mesh)
    return _map_path(rule, params)


def batch_specs(batch, mesh):
    """The leading (batch) axis of every leaf on the data axes."""
    dp = _dp(mesh_shape(mesh))

    def rule(path, leaf):
        if not hasattr(leaf, "shape") or len(leaf.shape) == 0:
            return P()
        return guard_spec(P(*([dp] + [None] * (len(leaf.shape) - 1))),
                          leaf.shape, mesh)
    return _map_path(rule, batch)


def cache_specs(cache, mesh):
    """Cache leaves are stacked (L, B, ...): L replicated, B on data.
    Paged pools (under ``pages``) and block tables are replicated: any
    slot's table may name any page, so the pool has no batch axis."""
    dp = _dp(mesh_shape(mesh))

    def rule(path, leaf):
        if not hasattr(leaf, "shape") or len(leaf.shape) < 2:
            return P()
        if "pages" in path or tuple(path[-1:]) == ("block_table",):
            return P()
        return guard_spec(P(*([None, dp] + [None] * (len(leaf.shape) - 2))),
                          leaf.shape, mesh)
    return _map_path(rule, cache)


class NamedSharding:
    """A spec on a mesh: the DTensor placements it means and the shard
    shape it gives (the reference's ``NamedSharding``)."""

    def __init__(self, mesh, spec: Sequence):
        self.mesh = mesh
        self.spec = P(*spec)

    @property
    def placements(self) -> tuple:
        """One placement per mesh dim: ``Shard(i)`` where the spec puts
        tensor dim ``i`` on that axis, else ``Replicate()``.  A tuple axis
        shards one dim over several mesh dims, which must be in the
        mesh's order (major first, GSPMD's order)."""
        from torch.distributed.tensor import Replicate, Shard
        names = list(mesh_shape(self.mesh))
        out = [Replicate()] * len(names)
        for i, axis in enumerate(self.spec):
            if axis is None:
                continue
            axes = axis if isinstance(axis, (tuple, list)) else (axis,)
            dims = [names.index(a) for a in axes]
            if dims != sorted(dims):
                raise ValueError(f"spec {self.spec}: axes {axes} are not in "
                                 f"the mesh's order {names}")
            for m in dims:
                if not isinstance(out[m], Replicate):
                    raise ValueError(f"spec {self.spec}: mesh axis "
                                     f"{names[m]} named twice")
                out[m] = Shard(i)
        return tuple(out)

    def shard_shape(self, global_shape: Sequence[int]) -> tuple:
        shape = mesh_shape(self.mesh)
        return tuple(int(d) // _axis_size(shape, self.spec[i]
                                          if i < len(self.spec) else None)
                     for i, d in enumerate(global_shape))

    def __eq__(self, other):
        return (isinstance(other, NamedSharding) and other.mesh is self.mesh
                and other.spec == self.spec)

    def __repr__(self):
        return f"NamedSharding({self.spec})"


def named(specs, mesh):
    """A spec tree -> a :class:`NamedSharding` tree (a QTensor of specs ->
    a QTensor of shardings)."""
    def one(s):
        if isinstance(s, QTensor):
            return QTensor(NamedSharding(mesh, s.data),
                           NamedSharding(mesh, s.scale), s.qtype)
        return NamedSharding(mesh, s)
    return _map_path(lambda _, s: one(s), specs)


def _local_shard(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's even shard of the full tensor ``t``: each ``Shard(d)``
    cuts dim ``d`` in mesh-dim order (major first); a copy unless it is
    the whole tensor, so the full one can be freed."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    local = t
    for m, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n = mesh.size(m)
            step = local.shape[pl.dim] // n
            local = local.narrow(pl.dim, coord[m] * step, step)
    return local if local.numel() == t.numel() else local.contiguous().clone()


def shard_tensor(t: torch.Tensor, mesh, placements):
    """The DTensor of placements ``placements`` on ``mesh`` whose global
    value is ``t`` (every rank holds ``t``; nothing is communicated)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(_local_shard(t, mesh, placements), mesh,
                              placements, run_check=False)


def device_put(tree, shardings):
    """Place a tree of full tensors (the same on every rank) with a
    matching :class:`NamedSharding` tree (the reference's
    ``jax.device_put``)."""
    def put(t, sh):
        if isinstance(t, QTensor):
            return QTensor(put(t.data, sh.data), put(t.scale, sh.scale),
                           t.qtype)
        return shard_tensor(t, sh.mesh, sh.placements)
    from ..core.tree import tree_map
    return tree_map(put, tree, shardings)
