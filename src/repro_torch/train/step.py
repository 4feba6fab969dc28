"""Train and serve step builders (port of ``repro.train.step``: the train
state and step, the serve step, the prefill step, the fused decode loop
and the speculative decode loop).

Training: :func:`init_state` builds ``{"params", "opt", "step"}`` and
:func:`build_train_step` the ``(state, batch) -> (state, metrics)`` step:
the family's loss under autograd (its cache-free attention through the
flash kernel and its backward kernel on the card), gradients accumulated
in f32 over ``microbatches`` slices of the batch with the metrics
``loss`` and ``accuracy`` averaged (the reference's scan), then AdamW
with the learning rate ``lr_fn(step)``.  The update writes into the
state's tensors (the reference's ``launch/train.py`` donates its state
to the jitted step), so a full-width state is held once on the card.
Under a mesh (:func:`repro_torch.dist.use_mesh`) :func:`init_state`
places the state with ``param_specs`` (FSDP x TP DTensors) and the step
takes the global batch on every rank, placing each microbatch's rows
over the data axes; ``grad_specs`` pins the gradients and the f32
accumulator to the parameters' placements under ``flags().grad_specs``.
Under ``int8`` and ``use_lut`` the table passes, the activations' row
quantizer and the int8 products are autograd functions whose backward
runs the backward kernels on the card (:mod:`repro_torch.kernels.ops`):
as in the reference, an int8 projection's input and weight get
gradients only through their scales (no straight-through estimator),
and the cache-free attention keeps the exact softmax.

The reference runs ``steps`` decode steps inside one ``lax.scan`` under
one ``jax.jit`` call; here the block is a Python loop of ``steps`` model
calls whose tokens, positions, live mask, fault lane and sampling draws
stay on the device.  Nothing in the loop reads a device value on the
host, so the host syncs once per block, when the engine copies the
block's tokens back, and the whole block can be captured in one CUDA
graph (:mod:`repro_torch.train.graphs`), the port's counterpart of the
reference's single compiled dispatch.  The speculative loop keeps the
same rule over its draft -> verify rounds.  Every step carries either
serving cache, dense or paged, which the model updates in place; a
recurrent family's speculative rollback copies a per-position checkpoint
back into it, in place too.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..kernels.ops import sample_tokens, verify_tokens
from ..kernels.prng import fold_in
from ..kernels.speculative import draft_ngram
from ..core.device import resolve_device
from ..core.tree import tree_leaves, tree_map, tree_unflatten
from ..dist.constrain import current_mesh, reduce_partial
from ..dist.options import flags
from ..dist.sharding import (batch_specs, device_put, is_dtensor, named,
                             param_specs, shard_tensor)
from ..optim import OptConfig, adamw_init, adamw_update
from ..models.api import (decode_fn, get_family, loss_fn, prefill_fn,
                          spec_restore_fn, spec_state_fn)

__all__ = ["init_state", "build_train_step", "build_serve_step",
           "build_prefill_step", "build_decode_loop",
           "build_spec_decode_loop", "LOOP_BUILDS"]

#: loop builds: every call of :func:`build_decode_loop` or
#: :func:`build_spec_decode_loop` is one build (the reference counts its
#: trace-and-compiles the same way), so a caller that rebuilds a loop per
#: block shows here; reset by assigning zeros
LOOP_BUILDS = {"decode": 0, "spec": 0}


def init_state(gen: torch.Generator, cfg, *, dtype=torch.float32,
               opt_cfg: OptConfig = OptConfig(), device=None):
    """``{"params", "opt", "step"}``: the family's random init from
    ``gen``, zero AdamW moments, step 0 (int32).  ``device`` None is the
    GPU.  Under a mesh every leaf is a DTensor (``param_specs``): the
    params are drawn whole on every rank and cut to its shards, then the
    moments are made as shards, so a rank holds the whole params once,
    during the init, and never the whole moments."""
    device = resolve_device(device)
    params = get_family(cfg).init(gen, cfg, dtype=dtype, device=device)
    mesh = current_mesh()
    if mesh is not None:
        # every rank drew the same params; each keeps its own shards, and
        # the moments are made from them, as shards
        params = device_put(params, named(param_specs(params, mesh), mesh))
    state = {"params": params, "opt": adamw_init(params, opt_cfg),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    if mesh is None:
        return state
    # the counters, replicated like every 0-d leaf
    return tree_map(lambda t, sh: t if is_dtensor(t) else shard_tensor(
        t, mesh, sh.placements), state, named(param_specs(state, mesh), mesh))


def _to_device(batch, device):
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _place_rows(batch, mesh, device):
    """A global batch (the same on every rank) -> DTensors with the rows on
    the data axes (``batch_specs``); DTensor leaves are kept."""
    host = {k: v for k, v in batch.items() if not is_dtensor(v)}
    placed = device_put(_to_device(host, device),
                        named(batch_specs(host, mesh), mesh))
    return {k: placed.get(k, v) for k, v in batch.items()}


def _full(t):
    """A metric as a plain tensor on every rank."""
    return t.full_tensor() if is_dtensor(t) else t


def build_train_step(cfg, ctx, *, lr_fn: Callable,
                     opt_cfg: OptConfig = OptConfig(), microbatches: int = 1,
                     grad_specs=None) -> Callable:
    """``(state, batch) -> (state, metrics)``, the state updated in place.

    ``batch`` holds tensors or numpy arrays with leading dim B (moved to
    the parameters' device); with ``microbatches`` > 1 each leaf is cut
    into (M, B/M, ...) and the f32 gradients of the slices are summed in
    order and scaled by 1/M, as ``loss`` and ``accuracy`` (the only
    metrics kept then).  The metrics add ``grad_norm`` (before clipping)
    and ``lr``, all 0-d tensors.  The step's ``compute_grads(params,
    batch) -> (grads, metrics)`` attribute computes the gradients alone
    (a tree like the params), updating nothing.

    Under a mesh the parameters are DTensors and ``batch`` is the global
    batch on every rank: microbatch ``i`` is rows ``[i * B/M, (i + 1) *
    B/M)``, placed over the data axes on its own (a slice of rows already
    spread over the ranks would gather them); a DTensor batch is taken
    as placed, at ``microbatches`` 1.  ``grad_specs`` (a spec tree like
    the params, :func:`repro_torch.dist.param_specs`) pins each
    microbatch's gradients and the f32 accumulator to those placements
    when ``flags().grad_specs`` is set; otherwise they keep the
    placements DTensor gives them.  The metrics come back as plain
    tensors, the same on every rank.
    """
    if microbatches < 1:
        raise ValueError("microbatches >= 1")

    def _pin(grads, mesh):
        if grad_specs is None or mesh is None or not flags().grad_specs:
            return grads
        return [g.redistribute(mesh, sh.placements) for g, sh in
                zip(grads, tree_leaves(named(grad_specs, mesh)))]

    def grad_of(params, batch, mesh):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        loss, metrics = loss_fn(tree_unflatten(params, leaves), batch, cfg,
                                ctx)
        # a partial loss would seed autograd with 1 on every rank
        loss = reduce_partial(loss)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return _pin(grads, mesh), metrics

    def compute_grads(params, batch):
        first = tree_leaves(params)[0]
        mesh = current_mesh() if is_dtensor(first) else None
        if mesh is None:
            return _compute_grads(params, batch, None, first.device)
        from torch.distributed.tensor.experimental import implicit_replication
        with implicit_replication():
            return _compute_grads(params, batch, mesh,
                                  first.to_local().device)

    def _compute_grads(params, batch, mesh, dev):
        def place(b):
            return (_to_device(b, dev) if mesh is None
                    else _place_rows(b, mesh, dev))
        if microbatches == 1:
            grads, metrics = grad_of(params, place(batch), mesh)
            return (tree_unflatten(params, grads),
                    {k: _full(v) for k, v in metrics.items()})
        if mesh is not None and any(is_dtensor(v) for v in batch.values()):
            raise ValueError("microbatches > 1 under a mesh take the global "
                             "batch (numpy or plain tensors), not DTensors")
        b = next(iter(batch.values())).shape[0]
        if b % microbatches:
            raise ValueError(f"batch {b} is not a multiple of "
                             f"microbatches {microbatches}")
        n = b // microbatches
        # the accumulator takes each gradient's placements: the
        # parameters' when pinned
        gsum = [None] * len(tree_leaves(params))
        msum = {"loss": torch.zeros((), dtype=torch.float32, device=dev),
                "accuracy": torch.zeros((), dtype=torch.float32, device=dev)}
        for i in range(microbatches):
            mb = place({k: v[i * n:(i + 1) * n] for k, v in batch.items()})
            grads, metrics = grad_of(params, mb, mesh)
            for j, g in enumerate(grads):
                g = g.to(torch.float32)
                if gsum[j] is None:
                    gsum[j] = torch.zeros_like(g)
                gsum[j].add_(g)
            del grads
            msum = {k: msum[k] + _full(metrics[k]) for k in msum}
        inv = 1.0 / microbatches
        return (tree_unflatten(params, [g.mul_(inv) for g in gsum]),
                {k: v * inv for k, v in msum.items()})

    def train_step(state, batch):
        grads, metrics = compute_grads(state["params"], batch)
        lr = lr_fn(state["step"])
        params, opt, om = adamw_update(grads, state["opt"], state["params"],
                                       lr, opt_cfg)
        del grads
        metrics = dict(metrics)
        metrics.update({k: _full(v) for k, v in om.items()})
        metrics["lr"] = _full(lr)
        return {"params": params, "opt": opt,
                "step": state["step"] + 1}, metrics

    train_step.compute_grads = compute_grads
    return train_step


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


def _checkpoints(state, steps: int):
    """Empty (steps, ...) buffers for per-position copies of every leaf of
    a :func:`spec_state_fn` tree."""
    if isinstance(state, dict):
        return {k: _checkpoints(v, steps) for k, v in state.items()}
    return state.new_empty((steps, *state.shape))


def _record(buf, state, j: int) -> None:
    """Copy ``state`` (views of the cache) into checkpoint ``j``."""
    if isinstance(buf, dict):
        for k in buf:
            _record(buf[k], state[k], j)
    else:
        buf[j].copy_(state)


def _pick(buf, idx, lane):
    """Per lane, the checkpoint ``idx[lane]``."""
    if isinstance(buf, dict):
        return {k: _pick(v, idx, lane) for k, v in buf.items()}
    return buf[idx, lane]


def build_spec_decode_loop(cfg, ctx, steps: int, k: int, *, drafter="ngram",
                           ngram: int = 2, draft_cfg=None,
                           draft_ctx=None) -> Callable:
    """Speculative decode: ``steps`` draft -> verify rounds, device-resident.

    Each round proposes ``k`` tokens per slot, runs the target ONCE over
    the ``k + 1`` block positions (a chunked call: paged attention at
    S = k + 1, at ``ctx``'s split-KV knob, as plain decode; the einsum
    attention of a dense or int8 cache one position at a time, under
    ``per_position_attention``, so its rows are plain decode's), accepts the
    longest agreeing prefix through ``ops.verify_tokens`` and advances each
    slot by what it committed.  A recurrent family (``ssm``, the hybrid)
    cannot un-consume a token: its verify pass is ``k + 1`` decode steps,
    each followed by a copy of the recurrent state (the checkpoints), and
    after acceptance each lane's state is copied back, in place, from the
    checkpoint of its last committed position.  Greedy slots emit the
    target's argmax stream (the plain engine's); sampled slots keep its
    temperature / top-k distribution.  KV rows rewind by the ``pos`` edit alone:
    rejected rows are overwritten before any query attends them.

    ``drafter``: ``"ngram"`` (prompt lookup over the ``hist`` (B, H)
    committed-token buffer), a callable ``(hist, tok, pos) -> (B, k)``
    drafts (a test hook; ``hist`` holds the current token), or
    ``"model"``: ``draft_cfg`` / ``draft_ctx`` (default ``ctx``) draft
    greedily, k + 1 steps a round on their own dense cache, so a fully
    accepted round leaves the drafter one token behind the new input, as
    the target.  A recurrent draft model is rolled back as the target.

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
    verify_ctx = dataclasses.replace(ctx, per_position_attention=True)
    has_rec = hasattr(get_family(cfg), "spec_state")
    model_draft = drafter == "model"
    if model_draft:
        if draft_cfg is None:
            raise ValueError("the model drafter needs draft_cfg")
        if draft_cfg.family in ("encdec", "vlm"):
            raise NotImplementedError(
                f"draft model {draft_cfg.name}: an {draft_cfg.family} model "
                f"cannot draft (its cross layers need an input a draft "
                f"cache never receives: the encoder's output, the image)")
        draft_ctx = draft_ctx or ctx
        draft_has_rec = hasattr(get_family(draft_cfg), "spec_state")

    def verify(params, seq, cache, pos):
        """Target logits over the block, and the recurrent checkpoints
        (None for a KV-only family: one chunked call, pos rewind)."""
        if not has_rec:
            logits, cache = decode_fn(params, seq, cache, pos, cfg,
                                      verify_ctx)
            return logits, cache, None
        ckpts = _checkpoints(spec_state_fn(cache, cfg), s_blk)
        lgs = []
        for j in range(s_blk):
            lg, cache = decode_fn(params, seq[:, j:j + 1], cache, pos + j,
                                  cfg, ctx)
            lgs.append(lg[:, 0])
            _record(ckpts, spec_state_fn(cache, cfg), j)
        return torch.stack(lgs, dim=1), cache, ckpts

    def draft_with_model(draft_params, dcache, tok, pos):
        """k + 1 greedy draft steps (the drafts are the first k), with a
        recurrent drafter's checkpoints (else None)."""
        toks = []
        ckpts = (_checkpoints(spec_state_fn(dcache, draft_cfg), s_blk)
                 if draft_has_rec else None)
        for j in range(s_blk):
            lg, dcache = decode_fn(draft_params, tok, dcache, pos + j,
                                   draft_cfg, draft_ctx)
            tok = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)[:, None]
            toks.append(tok)
            if ckpts is not None:
                _record(ckpts, spec_state_fn(dcache, draft_cfg), j)
        return torch.cat(toks[:k], dim=1), dcache, ckpts

    def spec_loop(params, cache, tokens, pos, live, stop_pos, sample_params,
                  key, step0, eos_id, *aux):
        temperature = sample_params["temperature"]
        top_k = sample_params["top_k"]
        if model_draft:
            draft_params, carry = aux
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
                drafts, carry, dckpts = draft_with_model(draft_params, carry,
                                                         tokens, pos)
            elif callable(drafter):
                carry = carry.index_put((lane, pos.long()),
                                        tokens[:, 0].to(carry.dtype))
                drafts = drafter(carry, tokens, pos).to(torch.int32)
            else:
                drafts, carry = draft_ngram(carry, tokens, pos, k, ngram)
            # -- verify: one target call over the whole block ----------
            seq = torch.cat([tokens, drafts], dim=1)          # (B, k + 1)
            logits, cache, ckpts = verify(params, seq, cache, pos)
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
            # -- roll recurrent state back to the last committed position
            last = (n_fin - 1).long()
            if ckpts is not None:
                spec_restore_fn(cache, _pick(ckpts, last, lane), cfg)
            if model_draft and dckpts is not None:
                spec_restore_fn(carry, _pick(dckpts, last, lane), draft_cfg)
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
