"""Token sampling for the device-resident decode block (port of
``repro.kernels.sampling``).

``sample_tokens_fused`` draws one next-token id per batch slot from
(B, V) logits with per-slot parameters: ``temperature <= 0`` is greedy
(argmax), ``temperature > 0`` samples the softmax at that temperature by
the Gumbel-max trick, and ``top_k > 0`` restricts the draw to the k
highest logits by rank (ties at the k-th place resolve by index, so
exactly k candidates).  The noise is the reference's: threefry Gumbel
noise from :mod:`repro_torch.kernels.prng`, bit for bit ``jax.random``'s
bits, so a key and a step counter give the JAX Engine's draw.

The reference computes all of this in XLA, outside any Pallas kernel,
and so does the port: PyTorch ops on the device, nothing read by the
host, so a decode block that samples can be captured in one CUDA graph.
This is the ``cuda`` lowering of ``ops.sample_tokens``; the ``ref``
lowering (:func:`repro_torch.kernels.ref.sample_tokens_ref`) derives the
same draw the reference's way, with a second argsort for the ranks.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import prng

__all__ = ["sample_tokens_fused", "gumbel_noise"]


def gumbel_noise(key: torch.Tensor, shape) -> torch.Tensor:
    """Shared Gumbel(0, 1) float32 noise: both lowerings perturb the
    logits with the same noise, so their argmaxes agree exactly."""
    return prng.gumbel(key, shape)


def slot_params(temperature, top_k, b: int, device):
    """Per-slot ``temperature`` (B,) f32 and ``top_k`` (B,) int32 on
    ``device`` (device tensors pass through without a copy)."""
    temperature = torch.as_tensor(temperature, dtype=torch.float32,
                                  device=device).reshape(b)
    top_k = torch.as_tensor(top_k, dtype=torch.int32,
                            device=device).reshape(b)
    return temperature, top_k


def sample_tokens_fused(logits: torch.Tensor, temperature=None, top_k=None,
                        key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, V) logits -> (B,) int32 token ids.

    ``temperature`` (B,) f32, ``top_k`` (B,) int32; ``key`` may be None
    only when every slot is greedy (no sort, no noise).  The candidate
    set is the reference's rank test ``rank < clip(top_k, 1, V)`` (all
    of the row when ``top_k <= 0``), ranks by a stable descending
    argsort; the ranks are that argsort's inverse permutation, which a
    scatter computes without the reference's second sort.
    """
    logits = logits.to(torch.float32)
    b, v = logits.shape
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if key is None:
        return greedy
    temperature, top_k = slot_params(temperature, top_k, b, logits.device)
    order = torch.argsort(-logits, dim=-1, stable=True)             # (B, V)
    k_eff = torch.clamp(top_k, 1, v).to(torch.int64)
    in_top = torch.arange(v, device=logits.device)[None, :] < k_eff[:, None]
    candidate = torch.zeros_like(in_top).scatter_(1, order, in_top)
    candidate |= (top_k <= 0)[:, None]
    temp = torch.clamp_min(temperature, 1e-6)[:, None]
    perturbed = torch.where(candidate, logits / temp, -torch.inf) \
        + gumbel_noise(key, (b, v))
    sampled = torch.argmax(perturbed, dim=-1).to(torch.int32)
    return torch.where(temperature > 0, sampled, greedy)
