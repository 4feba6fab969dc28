"""Family registry and serving-cache helpers (port of ``repro.models.api``;
the ``lm`` and ``encdec`` families)."""

from __future__ import annotations

from types import ModuleType

import torch

from ..core.device import resolve_device
from . import encdec, lm

__all__ = ["get_family", "FAMILIES", "prefill_fn", "decode_fn",
           "init_cache_fn", "init_paged_cache_fn", "set_block_table",
           "invalidate_fn", "spec_state_fn", "spec_restore_fn"]

FAMILIES = {"lm": lm, "encdec": encdec}


def get_family(cfg) -> ModuleType:
    try:
        return FAMILIES[cfg.family]
    except KeyError:
        raise KeyError(f"family {cfg.family!r} is not ported yet (have "
                       f"{sorted(FAMILIES)}; ROADMAP.md queue 1)") from None


def prefill_fn(params, batch, cache, cfg, ctx, *, pos=None,
               full_logits: bool = False):
    """Family-dispatched (chunked) prefill; ``batch`` = {"tokens": (B, S)},
    plus ``"enc_input"`` (B, S_enc, D) for ``encdec``, which takes the
    whole batch, as in the reference."""
    fam = get_family(cfg)
    if cfg.family == "encdec":
        return fam.prefill(params, batch, cache, cfg, ctx, pos=pos,
                           full_logits=full_logits)
    return fam.prefill(params, batch["tokens"], cache, cfg, ctx, pos=pos,
                       full_logits=full_logits)


def decode_fn(params, tokens, cache, pos, cfg, ctx):
    """Family-dispatched single decode step."""
    return get_family(cfg).decode_step(params, tokens, cache, pos, cfg, ctx)


def init_cache_fn(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                  device=None):
    """Family-dispatched dense serving cache, on ``device`` (None: the GPU,
    :func:`~repro_torch.core.device.resolve_device`)."""
    return get_family(cfg).init_cache(cfg, batch, max_len, dtype,
                                      resolve_device(device))


def init_paged_cache_fn(cfg, batch: int, num_pages: int, page_size: int,
                        table_width: int, dtype=torch.float32, device=None):
    fam = get_family(cfg)
    if not hasattr(fam, "init_paged_cache"):
        raise NotImplementedError(
            f"family {cfg.family!r} has no paged serving cache; serve it "
            f"with a dense cache (paged=False)")
    return fam.init_paged_cache(cfg, batch, num_pages, page_size,
                                table_width, dtype, resolve_device(device))


def set_block_table(cache, bt: torch.Tensor):
    """Write the engine's (B, NP) block table into every layer's table,
    in place (page *assignment* is a host decision; this is its one
    channel to the device)."""
    def walk(node):
        for key, val in node.items():
            if key == "block_table":
                val.copy_(bt.to(val.dtype).expand_as(val))
            elif isinstance(val, dict):
                walk(val)
    walk(cache)
    return cache


def _is_paged(cache) -> bool:
    """A serving cache is paged iff any subtree carries a block table."""
    return any(key == "block_table" or (isinstance(val, dict)
                                        and _is_paged(val))
               for key, val in cache.items())


def invalidate_fn(cache, slot: int, cfg):
    """Zero one slot's dense KV rows, in place, so a recycled slot can
    never observe its previous occupant.  Dense leaves are (L, B, ...),
    so the slot is batch axis 1: the lm rows, and encdec's self rows and
    cross K/V alike.  A paged cache is returned unchanged: its pages
    carry no batch axis, and a retired slot's pages are unreachable once
    the engine resets its block-table row.  ``cfg`` is the reference's
    argument (its families with other cache layouts bring their own
    hook); the ported families need none."""
    if _is_paged(cache):
        return cache

    def walk(node):
        for val in node.values():
            if isinstance(val, dict):
                walk(val)
            else:
                val[:, slot].zero_()
    walk(cache)
    return cache


def spec_state_fn(cache, cfg):
    """The recurrent part of a serving cache, batch axis leading: what
    speculative decoding checkpoints per block position, because recurrent
    state cannot un-consume a rejected token.  KV rows rewind by the
    ``pos`` edit alone (the next block overwrites rejected rows before any
    query attends them), so the ported families, KV-only, return None.
    The recurrent families bring their ``spec_state`` hook (ROADMAP.md
    queue 1, item 14)."""
    fam = get_family(cfg)
    if hasattr(fam, "spec_state"):
        return fam.spec_state(cache)
    return None


def spec_restore_fn(cache, state, cfg):
    """Write a checkpoint of :func:`spec_state_fn`'s layout back into
    ``cache``; families that checkpoint nothing return the cache."""
    fam = get_family(cfg)
    if hasattr(fam, "spec_restore"):
        return fam.spec_restore(cache, state)
    return cache
