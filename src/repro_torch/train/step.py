"""Serving step builders (port of ``repro.train.step``: the prefill step
and the fused decode loop).

The reference runs ``steps`` decode steps inside one ``lax.scan``; here
the block is a Python loop of ``steps`` model calls whose tokens,
positions, live mask and fault lane stay on the device.  Nothing in the
loop reads a device value, so the host syncs once per block, when the
engine copies the block's tokens back.  Both steps carry either serving
cache, dense or paged, which the model updates in place.  Greedy decoding only: sampled
streams need the reference's threefry noise (ROADMAP.md queue 1).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..kernels.ops import sample_tokens
from ..models.api import decode_fn, prefill_fn

__all__ = ["build_prefill_step", "build_decode_loop"]


def build_prefill_step(cfg, ctx) -> Callable:
    """(params, batch, cache, pos) -> (chunk_logits, cache): logits at every
    chunk position, so ragged prompt ends can be read per slot."""
    def prefill_step(params, batch, cache, pos=None):
        return prefill_fn(params, batch, cache, cfg, ctx, pos=pos,
                          full_logits=True)
    return prefill_step


def build_decode_loop(cfg, ctx, steps: int) -> Callable:
    """``steps`` greedy decode steps, device-resident.

    ``decode_loop(params, cache, tokens, pos, live, stop_pos, eos_id)
    -> (cache, tokens, pos, live, block_tokens, block_live, fault)``

    * ``tokens`` (B, 1) int32, ``pos`` (B,) int32, ``live`` (B,) bool,
      ``stop_pos`` (B,) int32, ``eos_id`` int (-1 disables).
    * ``block_tokens``/``block_live`` (steps, B): the token each slot
      *emitted* at each step (its input token -- emit, then advance) and
      whether the slot was live then.
    * ``fault`` (B,) bool: a live slot whose logits came back non-finite
      is frozen on the device (its step commits nothing) and flagged.
    """
    def decode_loop(params, cache, tokens, pos, live, stop_pos, eos_id):
        fault = torch.zeros_like(live)
        emitted, emit_live = [], []
        for _ in range(steps):
            logits, cache = decode_fn(params, tokens, cache, pos, cfg, ctx)
            last = logits[:, -1].to(torch.float32)
            bad = live & ~torch.isfinite(last).all(dim=-1)
            ok = live & ~bad
            nxt = sample_tokens(last, backend=ctx.backend)
            emitted.append(tokens[:, 0])
            emit_live.append(ok)
            new_pos = torch.where(ok, pos + 1, pos)
            tokens = torch.where(ok, nxt, tokens[:, 0])[:, None]
            live = ok & (nxt != eos_id) & (new_pos < stop_pos)
            pos = new_pos
            fault = fault | bad
        return (cache, tokens, pos, live, torch.stack(emitted),
                torch.stack(emit_live), fault)

    return decode_loop
