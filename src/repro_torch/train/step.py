"""Serving step builders (port of ``repro.train.step``: the serve step, the
prefill step, the fused decode loop and the speculative decode loop).

The reference runs ``steps`` decode steps inside one ``lax.scan`` under
one ``jax.jit`` call; here the block is a Python loop of ``steps`` model
calls whose tokens, positions, live mask, fault lane and sampling draws
stay on the device.  Nothing in the loop reads a device value on the
host, so the host syncs once per block, when the engine copies the
block's tokens back, and the whole block can be captured in one CUDA
graph (:mod:`repro_torch.train.graphs`), the port's counterpart of the
reference's single compiled dispatch.  The speculative loop keeps the
same rule over its draft -> verify rounds.  Every step carries either
serving cache, dense or paged, which the model updates in place.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..kernels.ops import sample_tokens, verify_tokens
from ..kernels.prng import fold_in
from ..kernels.speculative import draft_ngram
from ..models.api import decode_fn, prefill_fn, spec_state_fn

__all__ = ["build_serve_step", "build_prefill_step", "build_decode_loop",
           "build_spec_decode_loop", "LOOP_BUILDS"]

#: loop builds: every call of :func:`build_decode_loop` or
#: :func:`build_spec_decode_loop` is one build (the reference counts its
#: trace-and-compiles the same way), so a caller that rebuilds a loop per
#: block shows here; reset by assigning zeros
LOOP_BUILDS = {"decode": 0, "spec": 0}


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


def _refuse_recurrent(cache, cfg, role: str) -> None:
    """Rollback here is the ``pos`` rewind of a KV cache; a family whose
    cache has recurrent state (``spec_state_fn`` not None) needs per-token
    checkpoints, which come with those families."""
    if spec_state_fn(cache, cfg) is not None:
        raise NotImplementedError(
            f"{role} {cfg.name}: speculative rollback of recurrent state is "
            f"not ported yet (ROADMAP.md queue 1, item 14)")


def build_spec_decode_loop(cfg, ctx, steps: int, k: int, *, drafter="ngram",
                           ngram: int = 2, draft_cfg=None,
                           draft_ctx=None) -> Callable:
    """Speculative decode: ``steps`` draft -> verify rounds, device-resident.

    Each round proposes ``k`` tokens per slot, runs the target ONCE over
    the ``k + 1`` block positions (a chunked call: paged attention at
    S = k + 1, at ``ctx``'s split-KV knob, as plain decode), accepts the
    longest agreeing prefix through ``ops.verify_tokens`` and advances each
    slot by what it committed.  Greedy slots emit the target's argmax
    stream (the plain engine's); sampled slots keep its temperature /
    top-k distribution.  KV rows rewind by the ``pos`` edit alone:
    rejected rows are overwritten before any query attends them.

    ``drafter``: ``"ngram"`` (prompt lookup over the ``hist`` (B, H)
    committed-token buffer), a callable ``(hist, tok, pos) -> (B, k)``
    drafts (a test hook; ``hist`` holds the current token), or
    ``"model"``: ``draft_cfg`` / ``draft_ctx`` (default ``ctx``) draft
    greedily, k + 1 steps a round on their own dense cache, so a fully
    accepted round leaves the drafter one token behind the new input, as
    the target.  Draft models of the ``lm`` family only (item 14 brings
    the recurrent ones).

    ``spec_loop(params, cache, tokens, pos, live, stop_pos, sample_params,
    key, step0, eos_id, hist) -> (cache, tokens, pos, live, hist,
    block_tokens, block_live, accepted, fault)``; the model drafter takes
    ``(draft_params, draft_cache)`` in place of ``hist`` and returns the
    draft cache in its slot.  ``block_tokens``/``block_live`` are
    (steps * (k + 1), B), chronological, masked to the committed prefix
    of live lanes; ``accepted`` (steps, B) counts the drafts each round
    committed (0 for dead lanes).  A committed EOS draft or the slot's
    token budget ends a round early (at least one token is committed);
    a round whose logits are non-finite commits nothing for that slot and
    flags it in ``fault``.  Round ``i`` draws with ``fold_in(key, step0 +
    i)`` (the block's keys folded in one pass), as
    :func:`build_decode_loop`; ``key`` None (every slot greedy) draws
    nothing.
    """
    LOOP_BUILDS["spec"] += 1
    s_blk = k + 1
    model_draft = drafter == "model"
    if model_draft:
        if draft_cfg is None:
            raise ValueError("the model drafter needs draft_cfg")
        if draft_cfg.family != "lm":
            raise NotImplementedError(
                f"draft model {draft_cfg.name} ({draft_cfg.family}): only "
                f"lm drafters are ported (ROADMAP.md queue 1, item 14)")
        draft_ctx = draft_ctx or ctx

    def draft_with_model(draft_params, dcache, tok, pos):
        """k + 1 greedy draft steps; the drafts are the first k."""
        toks = []
        for j in range(s_blk):
            lg, dcache = decode_fn(draft_params, tok, dcache, pos + j,
                                   draft_cfg, draft_ctx)
            tok = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)[:, None]
            toks.append(tok)
        return torch.cat(toks[:k], dim=1), dcache

    def spec_loop(params, cache, tokens, pos, live, stop_pos, sample_params,
                  key, step0, eos_id, *aux):
        temperature = sample_params["temperature"]
        top_k = sample_params["top_k"]
        _refuse_recurrent(cache, cfg, "target")
        if model_draft:
            draft_params, carry = aux
            _refuse_recurrent(carry, draft_cfg, "draft model")
        else:
            (carry,) = aux                               # hist (B, H)
        dev = tokens.device
        lane = torch.arange(tokens.shape[0], device=dev)
        jdraft = torch.arange(k, device=dev)
        fault = torch.zeros_like(live)
        keys = None if key is None else fold_in(
            key, step0 + torch.arange(steps, dtype=torch.int32,
                                      device=key.device))
        seqs, emits, accepted = [], [], []
        for i in range(steps):
            # -- draft -------------------------------------------------
            if model_draft:
                drafts, carry = draft_with_model(draft_params, carry, tokens,
                                                 pos)
            elif callable(drafter):
                carry = carry.index_put((lane, pos.long()),
                                        tokens[:, 0].to(carry.dtype))
                drafts = drafter(carry, tokens, pos).to(torch.int32)
            else:
                drafts, carry = draft_ngram(carry, tokens, pos, k, ngram)
            # -- verify: one target call over the whole block ----------
            seq = torch.cat([tokens, drafts], dim=1)          # (B, k + 1)
            logits, cache = decode_fn(params, seq, cache, pos, cfg, ctx)
            logits = logits.to(torch.float32)
            bad = live & ~torch.isfinite(logits).all(dim=(1, 2))
            ok = live & ~bad
            next_tok, n_adv = verify_tokens(
                logits, drafts, temperature, top_k,
                None if keys is None else keys[i], backend=ctx.backend)
            # -- truncate: a committed EOS draft or the token budget ends
            # the round; the held token is then the next chain token,
            # which is that draft
            is_eos = drafts == eos_id
            limit = torch.where(is_eos.any(dim=1),
                                torch.argmax(is_eos.to(torch.int32), dim=1)
                                + 1, s_blk + 1).to(torch.int32)
            # n_fin >= 1: pos never moves back across rounds
            n_fin = torch.clamp(torch.minimum(torch.minimum(n_adv, limit),
                                              stop_pos - pos), 1, s_blk)
            # (index clamped as JAX's gather clamps it: a full round's
            # n_fin - 1 = k picks nothing, n_fin < n_adv is false there)
            cut = torch.clamp(n_fin - 1, max=k - 1).long()
            next_tok = torch.where(n_fin < n_adv, drafts[lane, cut],
                                   next_tok)
            # -- commit: accepted drafts join the history buffer --------
            if not model_draft:
                widx = torch.clamp(pos[:, None].long() + 1 + jdraft[None, :],
                                   0, carry.shape[1] - 1)
                held = torch.gather(carry, 1, widx)
                wmask = ok[:, None] & (jdraft[None, :] < n_fin[:, None] - 1)
                carry = carry.scatter(1, widx,
                                      torch.where(wmask, drafts, held))
            committed = (torch.arange(s_blk, device=dev)[None, :]
                         < n_fin[:, None])
            seqs.append(seq)
            emits.append(ok[:, None] & committed)
            accepted.append(torch.where(ok, n_fin - 1, 0))
            new_pos = torch.where(ok, pos + n_fin, pos)
            tokens = torch.where(ok, next_tok, tokens[:, 0])[:, None]
            live = ok & (next_tok != eos_id) & (new_pos < stop_pos)
            pos = new_pos
            fault = fault | bad
        # (steps, B, k + 1) -> chronological (steps * (k + 1), B)
        block = torch.stack(seqs).transpose(1, 2).reshape(steps * s_blk, -1)
        block_live = torch.stack(emits).transpose(1, 2) \
            .reshape(steps * s_blk, -1)
        return (cache, tokens, pos, live, carry, block, block_live,
                torch.stack(accepted), fault)

    return spec_loop
