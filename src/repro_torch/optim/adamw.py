"""AdamW with decoupled weight decay and global-norm clipping (port of
``repro.optim.adamw``).

States ``m`` and ``v`` mirror the parameter tree (nested dicts of
tensors), in ``m_dtype``/``v_dtype`` or the parameter's dtype.  The
update is the reference's, op for op in f32: clip by the global norm,
the two moments, bias correction, ``mhat / (sqrt(vhat) + eps)``, weight
decay on leaves with ``ndim >= 2`` only, ``p - lr * step``.

The update writes the new parameters and moments into the given
tensors, leaf by leaf (a stacked leaf one layer at a time), instead of
returning new ones: the PyTorch counterpart of the reference's
``launch/train.py`` donating its state to the jitted step, which keeps one copy of a
full-width state on the card (gemma-2b: 10 GB a copy in f32).  Under a
mesh the leaves are DTensors: the norm is one sum over the ranks
(:func:`global_norm`) and each rank updates its own shards in place.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.tree import tree_leaves, tree_map
from ..dist.constrain import reduce_partial
from ..dist.sharding import is_dtensor

__all__ = ["OptConfig", "adamw_init", "adamw_update", "global_norm"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    m_dtype: Optional[torch.dtype] = None      # None = the param's dtype
    v_dtype: Optional[torch.dtype] = None


def adamw_init(params, cfg: OptConfig = OptConfig()):
    """``{"m", "v", "count"}``: zero moments like ``params``, count 0.
    A DTensor leaf's moments are DTensors of its placements, each rank
    allocating its own shards only."""
    def zeros(dt):
        def one(p):
            if is_dtensor(p):
                return torch.zeros_like(p, dtype=dt or p.dtype)
            return torch.zeros(p.shape, dtype=dt or p.dtype, device=p.device)
        return one
    dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros(cfg.m_dtype), params),
            "v": tree_map(zeros(cfg.v_dtype), params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in order) of each leaf's f32 sum of
    squares.  DTensor leaves (on one mesh): each rank sums the squares of
    its shards, counting a shard that is replicated over a mesh axis on
    that axis's first rank only; one sum over the ranks then gives every
    rank the same norm, a replicated 0-d DTensor."""
    leaves = tree_leaves(tree)
    if leaves and is_dtensor(leaves[0]):
        return _global_norm_sharded(leaves)
    total = None
    for leaf in leaves:
        sq = torch.sum(torch.square(leaf.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _owned(leaf) -> bool:
    """Whether this rank counts ``leaf``'s local shard: it is the first
    rank of every mesh axis the leaf is not sharded over."""
    from torch.distributed.tensor import Shard
    coord = leaf.device_mesh.get_coordinate()
    return all(isinstance(p, Shard) or c == 0
               for p, c in zip(leaf.placements, coord))


def _global_norm_sharded(leaves) -> torch.Tensor:
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = leaves[0].device_mesh
    total = torch.zeros((), dtype=torch.float32,
                        device=leaves[0].to_local().device)
    for leaf in leaves:
        leaf = reduce_partial(leaf)
        if _owned(leaf):
            total = total + torch.sum(torch.square(
                leaf.to_local().to(torch.float32)))
    total = DTensor.from_local(total, mesh, [Partial()] * mesh.ndim,
                               run_check=False)
    return torch.sqrt(total.redistribute(mesh, [Replicate()] * mesh.ndim))


@torch.no_grad()
def adamw_update(grads, opt_state, params, lr, cfg: OptConfig = OptConfig()):
    """``(params, opt_state, {"grad_norm"})``: the new values written into
    ``params`` and ``opt_state``, which are returned."""
    count = opt_state["count"] + 1
    sharded = is_dtensor(tree_leaves(params)[0])
    if sharded:
        # each gradient at its parameter's placements (a reduce-scatter
        # where it came back partial), then every update is local
        grads = tree_map(lambda g, p: g if tuple(g.placements) == tuple(
            p.placements) else g.redistribute(p.device_mesh, p.placements),
            grads, params)
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-12),
                            1.0)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=gnorm.device)
    c1 = 1 - torch.pow(cfg.b1, count.to(torch.float32))
    c2 = 1 - torch.pow(cfg.b2, count.to(torch.float32))

    def upd_one(g, m, v, p, decay: bool):
        g = g.to(torch.float32) * scale
        m2 = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g
        v2 = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * g * g
        del g
        step = (m2 / c1) / (torch.sqrt(v2 / c2) + cfg.eps)
        if decay:
            step = step + cfg.weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * step)
        m.copy_(m2)
        v.copy_(v2)

    def upd(g, m, v, p):
        decay = p.ndim >= 2      # decay matrices only (norms, biases exempt)
        if p.ndim >= 3:
            # a stacked leaf one layer at a time: the temporaries of one
            # layer, not of the stack (elementwise, so the same values)
            for i in range(p.shape[0]):
                upd_one(g[i], m[i], v[i], p[i], decay)
        else:
            upd_one(g, m, v, p, decay)

    if sharded:
        # elementwise: each rank updates its own shards in place
        scale, lr, c1, c2 = (t.to_local() if is_dtensor(t) else t
                             for t in (scale, lr, c1, c2))
        tree_map(lambda *ts: upd(*(t.to_local() for t in ts)), grads,
                 opt_state["m"], opt_state["v"], params)
    else:
        tree_map(upd, grads, opt_state["m"], opt_state["v"], params)
    opt_state["count"].copy_(count)
    return params, opt_state, {"grad_norm": gnorm}
