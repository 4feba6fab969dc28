"""Shared helpers of the training parity suites (``test_torch_train_*``):
one family's loss and gradients on both packages from the same
converted weights and the same numpy batch."""

from __future__ import annotations

import numpy as np


def flat(tree, prefix=""):
    """``{path: leaf}`` of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def jax_loss_and_grads(cfg, jparams, jctx, batch):
    """``jax.value_and_grad(repro.models.api.loss_fn)`` jitted, under the
    parity suites' Auto mesh: (loss, metrics, grads as numpy)."""
    import jax
    import jax.numpy as jnp
    from repro.dist.constrain import use_mesh
    from repro.models.api import loss_fn
    from torch_parity import auto_mesh, jax_to_numpy
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with use_mesh(auto_mesh()):
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p, b: loss_fn(p, b, cfg, jctx), has_aux=True))(jparams, jb)
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            jax_to_numpy(grads))


def torch_loss_and_grads(cfg, tparams, tctx, batch):
    """The port's ``loss_fn`` and ``torch.autograd.grad`` over every leaf:
    (loss, metrics, grads as numpy, keyed like the params)."""
    import torch
    from repro_torch.models.api import loss_fn
    leaves = flat(tparams)
    for t in leaves.values():
        t.requires_grad_(True)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    loss, metrics = loss_fn(tparams, tb, cfg, tctx)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    out = {k: (np.zeros(t.shape, np.float32) if g is None else g.numpy())
           for (k, t), g in zip(leaves.items(), grads)}
    for t in leaves.values():
        t.requires_grad_(False)
    return (float(loss.detach()),
            {k: float(v.detach()) for k, v in metrics.items()}, out)
