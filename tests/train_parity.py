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


def jax_qmatmul_kernel_form(a_data, b_data, a_scale, b_scale, bias=None,
                            out_dtype=None, *, act_spec=None,
                            act_gated=False):
    """The reference's ``qmatmul_pallas`` arithmetic as plain, differentiable
    jnp (its ``_kernel`` body, ``src/repro/kernels/qmatmul.py:79-89``):
    the exact int32 product, ``acc * sa * sb (+ bias)``, then the table
    through the kernels' ``apply_table`` (``(y - lo) * step_inv``, the
    interp sum as XLA fuses it).  The reference's ``ref`` lowering indexes
    with ``table_lookup`` instead (``/ step``, two roundings of the
    interp sum), which the port's kernels and plain versions do not
    follow; the train-quant suites register this as the reference's
    ``ref`` qmatmul, modelling its TPU path as they model its attention's."""
    import jax
    import jax.numpy as jnp
    from repro.core.tables import get_table
    from repro.kernels.lut_activation import apply_table
    acc = jax.lax.dot_general(a_data, b_data, (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    y = acc.astype(jnp.float32) * a_scale * b_scale
    if bias is not None:
        y = y + jnp.asarray(bias, jnp.float32).reshape(1, -1)
    if act_spec is not None:
        y = apply_table(y, jnp.asarray(get_table(act_spec).np_values),
                        lo=act_spec.lo, step_inv=1.0 / act_spec.step,
                        n=act_spec.n, indexing=act_spec.indexing,
                        gated=act_gated)
    return y.astype(out_dtype or jnp.float32)


def reference_tpu_branches(mp):
    """On the MonkeyPatch ``mp``: the reference's cache-free attention with
    the exact softmax (its TPU branch, ``flash_attention_pallas``; the
    CPU branch would take the table softmax under ``use_lut``) and its
    ``ref`` qmatmul with the Pallas kernel's epilogue
    (:func:`jax_qmatmul_kernel_form`).  Nothing in ``src/repro`` changes."""
    import dataclasses

    import repro.nn.activations as j_act
    import repro.kernels.ops  # noqa: F401  (registers the lowerings)
    import repro.nn.attention as j_attn
    from repro.core import registry

    def exact_softmax(x, ctx, axis=-1):
        return j_act.softmax(x, dataclasses.replace(ctx, use_lut=False),
                             axis)

    mp.setattr(j_attn, "softmax", exact_softmax)
    mp.setitem(registry._OPS["qmatmul"], "ref", jax_qmatmul_kernel_form)
