"""Family registry and serving-cache helpers (port of ``repro.models.api``;
the ``lm`` and ``encdec`` families)."""

from __future__ import annotations

from types import ModuleType

import torch

from ..core.device import resolve_device
from . import encdec, lm

__all__ = ["get_family", "FAMILIES", "prefill_fn", "decode_fn",
           "init_cache_fn", "init_paged_cache_fn", "set_block_table",
           "invalidate_fn", "spec_state_fn", "spec_restore_fn",
           "copy_pages_fn", "cache_leaves", "page_leaves"]

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


def cache_leaves(cache, path: str = ""):
    """``(path, tensor)`` of every tensor of a serving cache, in a fixed
    order (paths like ``/dense/pages/k``)."""
    out = []
    for key in sorted(cache):
        val = cache[key]
        if isinstance(val, dict):
            out += cache_leaves(val, f"{path}/{key}")
        else:
            out.append((f"{path}/{key}", val))
    return out


def page_leaves(cache):
    """:func:`cache_leaves` under a ``"pages"`` key: the page-pool leaves,
    K/V and int8 scales alike, each with the page axis at position 1 --
    (L, P+1, ...)."""
    return [(p, t) for p, t in cache_leaves(cache) if "/pages/" in p]


def copy_pages_fn(cache, src, dst):
    """Copy physical pages ``src`` -> ``dst`` in every page-pool leaf, in
    place (``index_copy_``), so the tensors keep their addresses and the
    captured decode graphs stay valid.  The copy-on-write primitive of
    prefix caching; block tables are the caller's host-side edit.
    ``src``/``dst``: ints or equal-length id sequences."""
    for _, leaf in page_leaves(cache):
        s = torch.as_tensor(src, dtype=torch.int64,
                            device=leaf.device).reshape(-1)
        d = torch.as_tensor(dst, dtype=torch.int64,
                            device=leaf.device).reshape(-1)
        leaf.index_copy_(1, d, leaf.index_select(1, s))
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
