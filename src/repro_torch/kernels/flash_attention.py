"""Flash attention: the cache-free kernel and paged attention.

Port of ``repro.kernels.flash_attention``:

* the cache-free blocked online-softmax kernel (TPU
  ``flash_attention_pallas``), :func:`flash_attention`, which serves the
  cache-free forward (the whisper encoder, ``lm.forward`` without a
  cache); Hopper kernel ``csrc/flash_attention.cu``, plain version
  :func:`repro_torch.kernels.ref.flash_attention_plain`;
* paged attention over a block-table-indexed KV page pool: the unsplit
  route (TPU ``_paged_attention_unsplit``) and the split-KV
  flash-decoding route with its log-sum-exp combine (TPU
  ``paged_attention_pallas`` + ``combine_splits``), with the pure-Python
  knob resolvers, which must pick exactly the reference's
  ``(pages_per_step, kv_split)``.  One Hopper kernel serves both routes
  (``csrc/paged_attention.cu``, one launch each); plain versions
  :func:`repro_torch.kernels.ref.paged_attention_ref` (unsplit) and
  :func:`~repro_torch.kernels.ref.paged_attention_split_ref` (split).

Each wrapper runs its plain version for CPU tensors and launches its
kernel (or raises) for CUDA tensors.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from . import _cuda
from .ref import (combine_splits, flash_attention_plain, paged_attention_ref,
                  paged_attention_split_ref)

__all__ = ["flash_attention", "flash_attention_plain", "MAX_HEAD_DIM",
           "paged_attention", "paged_attention_unsplit",
           "paged_attention_split", "combine_splits", "choose_kv_split",
           "auto_pages_per_step", "get_cost_constants", "set_cost_constants",
           "_resolve_knobs"]


# -- knob resolution (pure Python, identical to the reference) -------------
#: relative latency units of the split cost model (analytic defaults)
_ANALYTIC_COST_CONSTANTS = {
    "tile_cost": 4.0,        # one multi-page tile
    "combine_cost": 1.0,     # one partition's extra combine traffic
    "target_lanes": 512.0,   # parallel lanes that saturate the device
}
_TILE_COST = _ANALYTIC_COST_CONSTANTS["tile_cost"]
_COMBINE_COST = _ANALYTIC_COST_CONSTANTS["combine_cost"]
_TARGET_LANES = _ANALYTIC_COST_CONSTANTS["target_lanes"]


def get_cost_constants() -> dict:
    """Current split cost-model constants (a copy)."""
    return {"tile_cost": _TILE_COST, "combine_cost": _COMBINE_COST,
            "target_lanes": _TARGET_LANES}


def set_cost_constants(tile_cost: float | None = None,
                       combine_cost: float | None = None,
                       target_lanes: float | None = None) -> dict:
    """Install cost-model constants (``None`` = the analytic default) and
    invalidate every cached ``choose_kv_split`` decision."""
    global _TILE_COST, _COMBINE_COST, _TARGET_LANES
    _TILE_COST = float(tile_cost) if tile_cost is not None \
        else _ANALYTIC_COST_CONSTANTS["tile_cost"]
    _COMBINE_COST = float(combine_cost) if combine_cost is not None \
        else _ANALYTIC_COST_CONSTANTS["combine_cost"]
    _TARGET_LANES = float(target_lanes) if target_lanes is not None \
        else _ANALYTIC_COST_CONSTANTS["target_lanes"]
    choose_kv_split.cache_clear()
    return get_cost_constants()


@functools.lru_cache(maxsize=None)
def choose_kv_split(seq_len: int, pages: int, hkv: int, *, batch: int = 1,
                    pages_per_step: int = 1) -> int:
    """``kv_split`` minimising ``ceil(tiles/split)*TILE + split*COMBINE``
    over power-of-two splits, with the reference's occupancy guard
    (the boundary candidate is costed before the guard fires) and ties
    toward the smaller split.  ``seq_len`` is part of the key only."""
    pages = max(1, int(pages))
    t = max(1, int(pages_per_step))
    tiles = -(-pages // t)
    lanes = max(1, int(batch) * max(1, int(hkv)))
    best, best_cost = 1, None
    split = 1
    while split <= tiles:
        cost = (-(-tiles // split)) * _TILE_COST + split * _COMBINE_COST
        if best_cost is None or cost < best_cost:
            best, best_cost = split, cost
        if split > 1 and lanes * (split // 2) >= _TARGET_LANES:
            break
        split *= 2
    return best


def auto_pages_per_step(page_size: int, pages: int) -> int:
    """Default multi-page tile: ~128 K/V rows, capped by the table."""
    return max(1, min(128 // max(1, int(page_size)), max(1, int(pages))))


def _resolve_knobs(np_: int, ps: int, hkv: int, batch: int, kv_split,
                   pages_per_step):
    """The reference's ``_resolve_knobs``: ``(pages_per_step, kv_split)``.

    Explicit values clamp to the table; an auto tile shrinks to honour an
    explicit split; an explicit ``kv_split=1`` alone pins the tile to 1
    (the unsplit kernel); an auto split comes from the cost model.
    """
    if pages_per_step is None:
        if kv_split is not None and int(kv_split) == 1:
            t = 1
        else:
            t = auto_pages_per_step(ps, np_)
            if kv_split is not None and int(kv_split) > 1:
                t = min(t, max(1, -(-np_ // int(kv_split))))
    else:
        t = max(1, min(int(pages_per_step), np_))
    tiles = -(-np_ // t)
    if kv_split is None:
        split = choose_kv_split(np_ * ps, np_, hkv, batch=batch,
                                pages_per_step=t)
    else:
        split = max(1, int(kv_split))
    return t, min(split, tiles)


# -- wrappers ----------------------------------------------------------------
#: widest head the flash kernel takes (gemma-2b's 256)
MAX_HEAD_DIM = 256


def flash_attention(q, k, v, *, causal: bool = True,
                    softmax_scale: Optional[float] = None):
    """Cache-free attention: q (B, Hq, Sq, D) against k, v (B, Hkv, Skv, D),
    ``Hq % Hkv == 0``, the queries the last Sq positions of the context;
    f32 or bf16 (all three alike), f32 softmax and accumulation, output
    in q's dtype.  ``softmax_scale`` None is ``D ** -0.5``.  bf16 runs the
    tensor-core kernel, f32 the CUDA-core kernel (no TF32); both have
    :func:`flash_attention_plain` as their plain version."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     softmax_scale=softmax_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes f32 or bf16 q, k, v of one "
                        f"dtype, not {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         f"(B, H, S, D) with v like k")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or hq % hkv \
            or skv == 0:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit "
                         f"k/v {tuple(k.shape)} (batch, head dim, Hq % Hkv, "
                         f"Skv >= 1)")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} outside the "
                         f"kernel's 1..{MAX_HEAD_DIM}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: operands on different devices")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return out
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    lib = _cuda.library("flash_attention")
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv,
        sq, skv, d, _scale(softmax_scale, d), int(bool(causal)),
        int(q.dtype == torch.bfloat16), _cuda.stream_of(q))
    _cuda.check(lib, err, "flash_attention")
    _cuda.LAUNCHES["flash_attention"] += 1
    return out


def _check(q, k_pages, v_pages, block_tables, qpos):
    """Validate what the CUDA kernels take; returns the geometry."""
    if q.device.type != "cuda":
        raise ValueError(f"paged attention: unsupported device {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"paged attention: q must be f32 or bf16, not {q.dtype}")
    if k_pages.dtype != torch.float32 or v_pages.dtype != torch.float32:
        raise TypeError("paged attention: the kernels take f32 KV pages "
                        "(int8 pages are not ported yet, ROADMAP.md)")
    if block_tables.dtype != torch.int32 or qpos.dtype != torch.int32:
        raise TypeError("paged attention: block tables and qpos must be int32")
    b, hq, s, d = q.shape
    p_, hkv, ps, d2 = k_pages.shape
    if v_pages.shape != k_pages.shape or d2 != d or hq % hkv:
        raise ValueError(f"paged attention: q {tuple(q.shape)} does not fit "
                         f"pages {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)}")
    if block_tables.ndim != 2 or block_tables.shape[0] != b \
            or tuple(qpos.shape) != (b,):
        raise ValueError(f"paged attention: block tables "
                         f"{tuple(block_tables.shape)} / qpos "
                         f"{tuple(qpos.shape)} do not fit batch {b}")
    for t in (q, k_pages, v_pages, block_tables, qpos):
        if t.device != q.device:
            raise ValueError("paged attention: operands on different devices")
        if not t.is_contiguous():
            raise ValueError("paged attention: operands must be contiguous")
    return b, hq, s, d, p_, hkv, ps, block_tables.shape[1]


def _scale(softmax_scale, d) -> float:
    return (softmax_scale if softmax_scale is not None
            else float(1.0 / np.sqrt(d)))


#: query rows a block of the paged kernel takes (one ticket per tile)
_ROW_TILE = 8


def _launch_paged(q, k_pages, v_pages, block_tables, qpos, softmax_scale,
                  what: str, kv_split: int, pages_per_step: int):
    """One launch of the paged kernel over the reference's partitions:
    ``kv_split`` of ``nt`` tiles of ``pages_per_step`` entries, clamped
    to the table (one partition: normalised in place, no scratch)."""
    q = q.contiguous()
    b, hq, s, d, p_, hkv, ps, np_ = _check(q, k_pages, v_pages,
                                           block_tables, qpos)
    if d % 4 or d > MAX_HEAD_DIM:
        raise ValueError(f"{what}: head dim {d} is not a multiple of 4 up "
                         f"to {MAX_HEAD_DIM}")
    t = max(1, min(int(pages_per_step), np_))
    tiles = -(-np_ // t)
    split = max(1, min(int(kv_split), tiles))
    span = max(1, -(-tiles // split) * t)       # table entries a partition
    rows = hq // hkv * s
    out = torch.empty_like(q)
    scratch = [None] * 4
    if split > 1:
        f32 = dict(dtype=torch.float32, device=q.device)
        acc = torch.empty((split, b, hkv, rows, d), **f32)
        m = torch.empty((split, b, hkv, rows), **f32)
        l = torch.empty((split, b, hkv, rows), **f32)
        # one per (batch, KV head, row tile), left zeroed by the kernel
        tickets = _cuda.zeroed_scratch("paged_attention_tickets", q.device,
                                       b * hkv * -(-rows // _ROW_TILE))
        scratch = [x.data_ptr() for x in (acc, m, l, tickets)]
    lib = _cuda.library("paged_attention")
    err = lib.paged_attention_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), qpos.data_ptr(), out.data_ptr(), *scratch,
        b, hkv, rows, d, s, ps, p_, np_, span, split,
        _scale(softmax_scale, d), int(q.dtype == torch.bfloat16),
        _cuda.stream_of(q))
    _cuda.check(lib, err, what)
    _cuda.LAUNCHES[what] += 1
    return out


def paged_attention_unsplit(q, k_pages, v_pages, block_tables, qpos, *,
                            softmax_scale: Optional[float] = None):
    """The whole table in one partition (knobs ``(1, 1)``): each block's
    warps take its pages in turn, merge and normalise.  The kernel takes
    head dims that are multiples of 4 up to 256."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_tables, qpos,
                                   softmax_scale=softmax_scale)
    return _launch_paged(q, k_pages, v_pages, block_tables, qpos,
                         softmax_scale, "paged_attention_unsplit", 1, 1)


def paged_attention_split(q, k_pages, v_pages, block_tables, qpos, *,
                          softmax_scale: Optional[float] = None,
                          kv_split: int = 1, pages_per_step: int = 1):
    """Split-KV flash decoding in one launch: the reference's ``kv_split``
    partitions of ``nt`` tiles of ``pages_per_step`` entries, each walked
    by its own block; the last block of each row tile combines them.

    ``kv_split``/``pages_per_step`` are used as given (clamped to the
    table); :func:`paged_attention` resolves auto values first.  Head
    dims as :func:`paged_attention_unsplit`.
    """
    if q.device.type == "cpu":
        return paged_attention_split_ref(
            q, k_pages, v_pages, block_tables, qpos,
            softmax_scale=softmax_scale, kv_split=kv_split,
            pages_per_step=pages_per_step)
    return _launch_paged(q, k_pages, v_pages, block_tables, qpos,
                         softmax_scale, "paged_attention_split", kv_split,
                         pages_per_step)


def paged_attention(q, k_pages, v_pages, block_tables, qpos, *,
                    softmax_scale: Optional[float] = None,
                    kv_split: Optional[int] = None,
                    pages_per_step: Optional[int] = None):
    """Resolve the knobs as the reference does; ``(1, 1)`` routes to the
    unsplit kernel, every other point to the split kernel."""
    np_ = block_tables.shape[1]
    t, split = _resolve_knobs(np_, k_pages.shape[2], k_pages.shape[1],
                             q.shape[0], kv_split, pages_per_step)
    if split == 1 and t == 1:
        return paged_attention_unsplit(q, k_pages, v_pages, block_tables,
                                       qpos, softmax_scale=softmax_scale)
    return paged_attention_split(q, k_pages, v_pages, block_tables, qpos,
                                 softmax_scale=softmax_scale, kv_split=split,
                                 pages_per_step=t)
