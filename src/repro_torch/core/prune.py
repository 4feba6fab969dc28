"""Weight pruning, the paper's weights compression (port of
``repro.core.prune``).

Training-time sparsity enforcement with masks: ``magnitude_mask`` (global
unstructured top-k, the hls4ml-faithful form), ``nm_mask`` (N:M
structured sparsity along the reduction axis), ``make_masks`` over a
parameter tree and ``apply_masks`` after every optimizer step.  Ties fall
as in the reference: a stable sort (``jnp.argsort`` is stable), the
threshold kept inclusive.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

__all__ = ["magnitude_mask", "nm_mask", "make_masks", "apply_masks",
           "sparsity"]


def magnitude_mask(w: torch.Tensor, sparsity_target: float) -> torch.Tensor:
    """Boolean keep-mask zeroing the smallest ``|w|`` fraction (every entry
    equal to the threshold is kept)."""
    k = int(round(w.numel() * (1.0 - sparsity_target)))
    k = max(k, 1)
    thresh = torch.sort(torch.abs(w).reshape(-1)).values[-k]
    return torch.abs(w) >= thresh


def nm_mask(w: torch.Tensor, n: int = 2, m: int = 4) -> torch.Tensor:
    """N:M mask along the leading (reduction) axis: the ``n`` largest
    ``|w|`` of each group of ``m`` consecutive rows kept; among equal
    magnitudes the later row ranks higher (a stable ascending sort)."""
    d_in = w.shape[0]
    assert d_in % m == 0, (d_in, m)
    a = torch.abs(w.reshape(d_in // m, m, *w.shape[1:]))
    order = torch.argsort(a, dim=1, stable=True)
    ranks = torch.argsort(order, dim=1, stable=True)
    return (ranks >= (m - n)).reshape(w.shape)


def make_masks(params, *, sparsity_target: float = 0.5,
               structured: Optional[tuple] = None,
               min_ndim: int = 2) -> Dict:
    """Mask tree for every weight matrix (None for passthrough leaves)."""
    if isinstance(params, dict):
        return {k: make_masks(v, sparsity_target=sparsity_target,
                              structured=structured, min_ndim=min_ndim)
                for k, v in params.items()}
    leaf = params
    if not isinstance(leaf, torch.Tensor) or leaf.ndim < min_ndim:
        return None
    if structured is not None:
        n, m = structured
        return nm_mask(leaf, n, m) if leaf.shape[0] % m == 0 else None
    return magnitude_mask(leaf, sparsity_target)


def apply_masks(params, masks):
    """Zero the pruned weights (call after each optimizer step)."""
    if isinstance(params, dict):
        return {k: apply_masks(v, masks[k]) for k, v in params.items()}
    return params if masks is None else params * masks.to(params.dtype)


def sparsity(params) -> float:
    """Fraction of exactly-zero entries across the matrix leaves."""
    zeros = total = 0

    def walk(node):
        nonlocal zeros, total
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, torch.Tensor) and node.ndim >= 2:
            zeros += int(torch.sum(node == 0))
            total += node.numel()

    walk(params)
    return zeros / max(total, 1)
