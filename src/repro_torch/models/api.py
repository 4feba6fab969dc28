"""Family registry and serving-cache helpers (port of ``repro.models.api``;
the ``lm``, ``encdec``, ``ssm``, ``hybrid`` and ``vlm`` families).

Every helper edits a cache in place: the tensors keep their addresses, so
captured decode graphs stay valid."""

from __future__ import annotations

from types import ModuleType

import torch

from ..core.device import resolve_device
from . import encdec, hybrid, lm, ssm_lm, vlm

__all__ = ["get_family", "FAMILIES", "loss_fn", "prefill_fn", "decode_fn",
           "supports_chunked_prefill", "init_cache_fn",
           "init_paged_cache_fn", "set_block_table", "lane_leaves_fn",
           "invalidate_fn", "merge_slot_fn", "spec_state_fn",
           "spec_restore_fn", "copy_pages_fn", "cache_leaves",
           "page_leaves"]

FAMILIES = {"lm": lm, "encdec": encdec, "ssm": ssm_lm, "hybrid": hybrid,
            "vlm": vlm}


def get_family(cfg) -> ModuleType:
    try:
        return FAMILIES[cfg.family]
    except KeyError:
        raise KeyError(f"family {cfg.family!r} is not ported yet (have "
                       f"{sorted(FAMILIES)}; ROADMAP.md queue 1)") from None


def loss_fn(params, batch, cfg, ctx):
    """Family-dispatched training loss: ``(scalar, metrics)``."""
    return get_family(cfg).loss(params, batch, cfg, ctx)


def prefill_fn(params, batch, cache, cfg, ctx, *, pos=None,
               full_logits: bool = False):
    """Family-dispatched (chunked) prefill; ``batch`` = {"tokens": (B, S)},
    plus ``"enc_input"`` (B, S_enc, D) for ``encdec`` and ``"img_embed"``
    (B, n_img_tokens, D) for ``vlm``, which take the whole batch, as in
    the reference."""
    fam = get_family(cfg)
    if cfg.family in ("encdec", "vlm"):
        return fam.prefill(params, batch, cache, cfg, ctx, pos=pos,
                           full_logits=full_logits)
    return fam.prefill(params, batch["tokens"], cache, cfg, ctx, pos=pos,
                       full_logits=full_logits)


def decode_fn(params, tokens, cache, pos, cfg, ctx):
    """Family-dispatched single decode step."""
    return get_family(cfg).decode_step(params, tokens, cache, pos, cfg, ctx)


def supports_chunked_prefill(cfg) -> bool:
    """Families whose cache continues across prefill calls (attention KV);
    the recurrent families rebuild their state from one call's tokens."""
    return cfg.family == "lm"


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


def lane_leaves_fn(cache, cfg):
    """``(tensor, batch axis)`` of every per-lane leaf of a serving cache:
    what :func:`invalidate_fn` zeroes and :func:`merge_slot_fn` restores.
    A family whose cache mixes batch axes brings its ``lane_leaves`` hook
    (the hybrid: grouped SSM states at axis 2, dense lanes beside paged
    attention pages; the VLM: grouped self rows at axis 2, cross K/V at
    axis 1), consulted first.  Otherwise dense leaves are (L, B,
    ...), batch axis 1 (the lm rows, encdec's self rows and cross K/V,
    the ssm states), and a paged lm cache has none: its pages carry no
    batch axis, and a retired slot's pages are unreachable once the
    engine resets its block-table row."""
    fam = get_family(cfg)
    if hasattr(fam, "lane_leaves"):
        return fam.lane_leaves(cache)
    if _is_paged(cache):
        return []
    return [(t, 1) for _, t in cache_leaves(cache)]


def invalidate_fn(cache, slot: int, cfg):
    """Zero one slot's lanes (KV rows, recurrent state), in place, so a
    recycled slot can never observe its previous occupant."""
    for t, ax in lane_leaves_fn(cache, cfg):
        t.select(ax, slot).zero_()
    return cache


def merge_slot_fn(cache, before, slot: int, cfg):
    """Every lane but ``slot``'s back to ``before`` (clones of the same
    cache's :func:`lane_leaves_fn` tensors), in place: the per-slot isolation of a looped
    prefill, whose full-batch decode calls advance every lane's state
    (pad tokens included).  Restoring the others makes the slot's prefill
    a solo prefill and leaves generating neighbours as they were; paged
    attention pages keep the new payload (the reference's
    ``merge_slot``)."""
    for (t, ax), old in zip(lane_leaves_fn(cache, cfg), before):
        keep = t.select(ax, slot).clone()
        t.copy_(old)
        t.select(ax, slot).copy_(keep)
    return cache


def spec_state_fn(cache, cfg):
    """The recurrent part of a serving cache, batch axis leading: what
    speculative decoding checkpoints per block position, because recurrent
    state cannot un-consume a rejected token.  KV rows rewind by the
    ``pos`` edit alone (the next block overwrites rejected rows before any
    query attends them), so the KV-only families return None; the
    recurrent families (``ssm``, the hybrid's mamba lanes) bring their
    ``spec_state`` hook, views of the cache (a checkpoint must clone
    them)."""
    fam = get_family(cfg)
    if hasattr(fam, "spec_state"):
        return fam.spec_state(cache)
    return None


def spec_restore_fn(cache, state, cfg):
    """Write a checkpoint of :func:`spec_state_fn`'s layout back into
    ``cache``, in place; families that checkpoint nothing return the
    cache."""
    fam = get_family(cfg)
    if hasattr(fam, "spec_restore"):
        return fam.spec_restore(cache, state)
    return cache
