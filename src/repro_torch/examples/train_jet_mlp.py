"""The paper's canonical flow end to end (port of
``examples/train_jet_mlp.py``): train the hls4ml jet-tagging MLP (16 -> 64
-> 32 -> 32 -> 5) in f32, then sweep fake quantization over the paper's
design space, four fixed-point and three minifloat formats (weights and
activations), then deploy with the table-based softmax.

Run::

    PYTHONPATH=src python -m repro_torch.examples.train_jet_mlp \\
        [--steps 400] [--device cpu]

Without ``--device`` it runs on the card.  The weights are drawn from a
CPU ``torch.Generator`` (seed 0) and then moved, so the card's run
and the CPU's start from the same weights; ``main(params=...)`` starts
from a given tree instead (the tests pass the reference's
``mlp.init(PRNGKey(0))``, converted, and hold the accuracy table against
the reference flow's).  :func:`main` returns the f32 test accuracy, the
accuracy of each format and the LUT softmax's largest deviation.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.precision import PrecisionPolicy
from ..core.qtypes import FixedPointType, MiniFloatType
from ..models import mlp
from ..nn.context import QuantContext

__all__ = ["jet_data", "FORMATS", "train", "sweep", "main"]

#: the sweep's formats: fixed point (16, 6), (10, 4), (8, 3), (6, 2) and
#: the minifloats E5M2, E4M3 (extended range) and E3M4
FORMATS = (FixedPointType(16, 6), FixedPointType(10, 4),
           FixedPointType(8, 3), FixedPointType(6, 2), MiniFloatType(5, 2),
           MiniFloatType(4, 3, ieee_inf=False), MiniFloatType(3, 4))


def jet_data(n: int, seed: int = 0, device="cpu"):
    """Synthetic jet-tagging-like task, 16 features -> 5 classes: the class
    centres are fixed (the task), ``seed`` draws the noise and labels (the
    reference's numpy stream)."""
    rng_task = np.random.RandomState(0)
    centers = rng_task.randn(5, 16) * 2.0
    rng = np.random.RandomState(seed + 1)
    y = rng.randint(0, 5, n)
    x = centers[y] + rng.randn(n, 16) * 1.0
    return (torch.as_tensor(x.astype(np.float32), device=device),
            torch.as_tensor(y.astype(np.int64), device=device))


def train(params, x, y, steps: int, *, lr: float = 0.05):
    """``steps`` full-batch SGD steps of the f32 loss (the reference's
    jitted ``p - lr * g``) from ``params``; returns the new tree."""
    ctx32 = QuantContext(compute_dtype=torch.float32)
    for i in range(steps):
        leaves = {k: {n: t.detach().requires_grad_(True)
                      for n, t in v.items()}
                  for k, v in params.items()}
        loss, m = mlp.loss(leaves, {"x": x, "y": y}, ctx32)
        flat = [t for v in leaves.values() for t in v.values()]
        grads = iter(torch.autograd.grad(loss, flat))
        with torch.no_grad():
            params = {k: {n: t.detach() - lr * next(grads)
                          for n, t in v.items()}
                      for k, v in leaves.items()}
        if i % 100 == 0:
            print(f"step {i:4d}  loss {float(m['loss']):.4f}  "
                  f"acc {float(m['accuracy']):.3f}")
    return params


@torch.no_grad()
def sweep(params, xt, yt) -> dict:
    """The f32 test accuracy, each format's under fake quantization of
    weights and activations, and the table softmax's largest deviation
    on the first 8 rows."""
    def test_acc(ctx):
        p = mlp.forward(params, xt, ctx)
        return float(torch.mean((torch.argmax(p, -1) == yt).float()))

    ctx32 = QuantContext(compute_dtype=torch.float32)
    acc_fp = test_acc(ctx32)
    print(f"\nfp32 test accuracy: {acc_fp:.4f}\n")
    print(f"{'format':<16s} {'bits':>4s} {'accuracy':>9s} {'delta':>8s}")
    table = {}
    for qt in FORMATS:
        ctx = QuantContext(mode="fake",
                           policy=PrecisionPolicy.uniform(qt, qt),
                           compute_dtype=torch.float32)
        acc = test_acc(ctx)
        table[qt.short_name()] = acc
        print(f"{qt.short_name():<16s} {qt.width:>4d} {acc:>9.4f} "
              f"{acc - acc_fp:>+8.4f}")

    # deployment: the table softmax (1024 x 18-bit override)
    ctx_lut = QuantContext(use_lut=True, compute_dtype=torch.float32)
    probs_lut = mlp.predict(params, xt[:8], ctx_lut)
    probs_fp = mlp.predict(params, xt[:8], ctx32)
    lut_dp = float(torch.abs(probs_lut - probs_fp).max())
    print(f"\nLUT-softmax max |dp| vs exact: {lut_dp:.2e}")
    return {"acc_fp32": acc_fp, "formats": table, "lut_max_dp": lut_dp}


def main(argv=None, *, params=None) -> dict:
    """The flow from ``params`` (a ``{"fc0": {"w", "b"}, ...}`` tree, e.g.
    the reference's init converted with :mod:`repro_torch.convert`), or
    from :func:`repro_torch.models.mlp.init` of a CPU generator seeded
    with 0."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    x, y = jet_data(4096, device=device)
    xt, yt = jet_data(4096, seed=9, device=device)
    if params is None:
        params = mlp.init(torch.Generator().manual_seed(0),
                          device="cpu")
    params = {k: {n: t.to(device) for n, t in v.items()}
              for k, v in params.items()}
    params = train(params, x, y, args.steps)
    return {**sweep(params, xt, yt), "device": str(device)}


if __name__ == "__main__":
    main()
