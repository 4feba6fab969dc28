"""Serving step builders (port of ``repro.train.step``: the serve step, the
prefill step and the fused decode loop).

The reference runs ``steps`` decode steps inside one ``lax.scan`` under
one ``jax.jit`` call; here the block is a Python loop of ``steps`` model
calls whose tokens, positions, live mask, fault lane and sampling draws
stay on the device.  Nothing in the loop reads a device value on the
host, so the host syncs once per block, when the engine copies the
block's tokens back, and the whole block can be captured in one CUDA
graph (:mod:`repro_torch.train.graphs`), the port's counterpart of the
reference's single compiled dispatch.  Both steps carry either serving
cache, dense or paged, which the model updates in place.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..kernels.ops import sample_tokens
from ..kernels.prng import fold_in
from ..models.api import decode_fn, prefill_fn

__all__ = ["build_serve_step", "build_prefill_step", "build_decode_loop",
           "LOOP_BUILDS"]

#: decode-loop builds: every call of :func:`build_decode_loop` is one
#: build (the reference counts its trace-and-compiles the same way), so a
#: caller that rebuilds a loop per block shows here; reset by assigning
#: zeros
LOOP_BUILDS = {"decode": 0}


def build_serve_step(cfg, ctx) -> Callable:
    """(params, cache, tokens (B, 1), pos (B,)) -> (logits, cache)."""
    def serve_step(params, cache, tokens, pos):
        return decode_fn(params, tokens, cache, pos, cfg, ctx)
    return serve_step


def build_prefill_step(cfg, ctx) -> Callable:
    """(params, batch, cache, pos) -> (chunk_logits, cache): logits at every
    chunk position, so ragged prompt ends can be read per slot."""
    def prefill_step(params, batch, cache, pos=None):
        return prefill_fn(params, batch, cache, cfg, ctx, pos=pos,
                          full_logits=True)
    return prefill_step


def build_decode_loop(cfg, ctx, steps: int) -> Callable:
    """``steps`` decode steps, device-resident.

    ``decode_loop(params, cache, tokens, pos, live, stop_pos,
    sample_params, key, step0, eos_id)
    -> (cache, tokens, pos, live, block_tokens, block_live, fault)``

    * ``tokens`` (B, 1) int32, ``pos`` (B,) int32, ``live`` (B,) bool,
      ``stop_pos`` (B,) int32.
    * ``sample_params``: ``{"temperature": (B,) f32, "top_k": (B,)
      int32}``; temperature <= 0 is greedy (see
      :mod:`repro_torch.kernels.sampling`).
    * ``key``/``step0``: a :mod:`~repro_torch.kernels.prng` key and the
      global step offset (an int or a 0-d int32 device tensor); step
      ``i`` draws with ``fold_in(key, step0 + i)`` (the block's keys
      folded in one pass), so any split of a generation into blocks
      draws the same noise (``step_many(2); step_many(3)`` ==
      ``step_many(5)``).  ``key`` None (every slot greedy) skips the
      sorts and the noise.
    * ``eos_id``: an int or a 0-d device tensor; sampling it kills the
      slot (-1 disables).
    * ``block_tokens``/``block_live`` (steps, B): the token each slot
      *emitted* at each step (its input token -- emit, then advance) and
      whether the slot was live then.
    * ``fault`` (B,) bool: a live slot whose logits came back non-finite
      is frozen on the device (its step commits nothing) and flagged.
    """
    LOOP_BUILDS["decode"] += 1

    def decode_loop(params, cache, tokens, pos, live, stop_pos,
                    sample_params, key, step0, eos_id):
        temperature = sample_params["temperature"]
        top_k = sample_params["top_k"]
        fault = torch.zeros_like(live)
        emitted, emit_live = [], []
        keys = None if key is None else fold_in(
            key, step0 + torch.arange(steps, dtype=torch.int32,
                                      device=key.device))
        for i in range(steps):
            logits, cache = decode_fn(params, tokens, cache, pos, cfg, ctx)
            last = logits[:, -1].to(torch.float32)
            bad = live & ~torch.isfinite(last).all(dim=-1)
            ok = live & ~bad
            nxt = sample_tokens(last, temperature, top_k,
                                None if keys is None else keys[i],
                                backend=ctx.backend)
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
