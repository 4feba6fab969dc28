"""The paper's canonical workload: hls4ml's 3-hidden-layer jet-tagging MLP
(16 -> 64 -> 32 -> 32 -> 5, ReLU + softmax); port of ``repro.models.mlp``.

Every layer is :func:`repro_torch.nn.linear.linear` with a bias: under
``int8`` (dynamic per-call weight quantization, or the PTQ ``QTensor``
leaves of :func:`repro_torch.core.quantize.ptq_params`) each one runs the
``quantize_rows`` and ``qmatmul`` kernels on the card, at K = 16, 64 and
32.  ReLU is exact in every mode, as in the reference; :func:`predict`'s
softmax goes through the paper's exp / invert tables under
``ctx.use_lut``.  The model is consumed directly (no serving family).
:func:`loss` is differentiable: the paper's flow trains it in f32, then
sweeps fake quantization (``repro_torch.examples.train_jet_mlp``).
"""

from __future__ import annotations

import torch

from ..core.device import resolve_device
from ..nn.activations import act_fn, softmax
from ..nn.context import DEFAULT_CTX, QuantContext
from ..nn.linear import linear, linear_init

__all__ = ["init", "forward", "loss", "predict"]


def init(gen: torch.Generator, *, n_features: int = 16, hidden=(64, 32, 32),
         n_classes: int = 5, dtype=torch.float32, device=None):
    """Random ``{"fc0": {"w", "b"}, ...}`` from ``gen`` with the reference's
    distributions (not its values).  ``device`` None is the GPU."""
    device = resolve_device(device)
    dims = (n_features,) + tuple(hidden) + (n_classes,)
    return {f"fc{i}": linear_init(gen, dims[i], dims[i + 1], bias=True,
                                  dtype=dtype, device=device)
            for i in range(len(dims) - 1)}


def forward(params, x: torch.Tensor, ctx: QuantContext = DEFAULT_CTX):
    """x: (B, n_features) -> logits (B, n_classes)."""
    n = len(params)
    for i in range(n):
        x = linear(params[f"fc{i}"], x, ctx, path=f"fc{i}")
        if i < n - 1:
            x = act_fn("relu", x, ctx, path=f"fc{i}/act")
    return x


def predict(params, x: torch.Tensor, ctx: QuantContext = DEFAULT_CTX):
    """Class probabilities; the softmax goes through the paper's tables
    when ``ctx.use_lut`` (including the 1024-entry, 18-bit override)."""
    return softmax(forward(params, x, ctx), ctx, axis=-1)


def loss(params, batch, ctx: QuantContext = DEFAULT_CTX):
    """Mean cross-entropy and accuracy of ``batch = {"x", "y"}``:
    ``(loss, {"loss", "accuracy"})``, 0-d f32 tensors (the metrics
    detached)."""
    logits = forward(params, batch["x"], ctx).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, batch["y"][:, None].long())[:, 0]
    val = torch.mean(lse - ll)
    acc = torch.mean((torch.argmax(logits, -1) == batch["y"])
                     .to(torch.float32))
    return val, {"loss": val.detach(), "accuracy": acc}
