"""Flash attention: the cache-free kernel and paged attention.

Port of ``repro.kernels.flash_attention``:

* the cache-free blocked online-softmax kernel (TPU
  ``flash_attention_pallas``), :func:`flash_attention`, which serves the
  cache-free forward (the whisper encoder, ``lm.forward`` without a
  cache); Hopper kernel ``csrc/flash_attention.cu``, plain version
  :func:`repro_torch.kernels.ref.flash_attention_plain`.  When autograd
  records (training), a CUDA call runs as an autograd function: the
  forward kernel also writes the rows' log-sum-exp, and the gradient is
  the hand-written backward, :func:`flash_attention_bwd`
  (``csrc/flash_attention_bwd.cu``; the reference leaves it to XLA's
  autodiff), plain version
  :func:`repro_torch.kernels.ref.flash_attention_bwd_plain`.  On CPU
  tensors autograd runs through the plain forward;
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
kernel (or raises) for CUDA tensors.  Under a ``DeviceMesh``
:func:`flash_attention` takes DTensors: it runs the same local call on
each rank's shard (:func:`_flash_attention_sharded`; batch on the data
axes, whole GQA groups of heads on ``model`` where the head counts allow,
K/V replicated over ``model`` otherwise).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..dist.constrain import placements_of
from ..dist.sharding import is_dtensor
from . import _cuda
from .ref import (combine_splits, flash_attention_bwd_plain,
                  flash_attention_plain, paged_attention_ref,
                  paged_attention_split_ref)

__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_fwd",
           "flash_attention_bwd", "flash_attention_bwd_plain", "MAX_HEAD_DIM",
           "FlashFwdPlan", "flash_fwd_plan", "flash_fwd_route",
           "FLASH_FWD_ROUTES", "FlashBwdPlan", "flash_bwd_plan",
           "paged_attention", "paged_attention_unsplit",
           "paged_attention_split", "PagedPlan", "paged_plan",
           "paged_stages", "paged_call_plan",
           "combine_splits", "choose_kv_split",
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


def _check_flash(q, k, v):
    """Validate what the flash kernels take; returns the geometry."""
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
    return b, hq, hkv, sq, skv, d


#: query rows of one consumer warpgroup's item in the TMA forward kernel,
#: and the keys of one K/V tile
FLASH_FWD_ROWS = 64


@dataclasses.dataclass(frozen=True)
class FlashFwdPlan:
    """How the TMA forward kernel's grid cuts one shape
    (``csrc/flash_attention.cu``, ``fa3::flash_fwd_wgmma_kernel``).  A
    block owns one KV head and ``wgs`` items, each 64 query rows of one
    query head, one per consumer warpgroup: with ``pack_heads`` two query
    heads of a GQA group at the same rows, else consecutive 64-row steps
    of one head (``rows`` a block).  Blocks are numbered row tile first,
    causal row tiles longest first (:meth:`items` is the kernel's
    decode); a block loads the K/V tiles its longest item sees
    (:meth:`block_tiles`)."""
    b: int
    hq: int
    hkv: int
    sq: int
    skv: int
    d: int
    causal: bool
    wgs: int
    pack_heads: bool

    @property
    def rows(self) -> int:
        """Query rows of a block's row tile."""
        return FLASH_FWD_ROWS * (1 if self.pack_heads else self.wgs)

    @property
    def row_tiles(self) -> int:
        return -(-self.sq // self.rows)

    @property
    def units(self) -> int:
        """Blocks of one row tile: (batch, KV head, pair of its query
        heads), or (batch, query head)."""
        if self.pack_heads:
            return self.b * self.hkv * (self.hq // self.hkv // 2)
        return self.b * self.hq

    @property
    def blocks(self) -> int:
        return self.row_tiles * self.units

    def items(self, block: int) -> List[Tuple[int, int, int]]:
        """Block ``block``'s (batch, query head, first row) per consumer."""
        rt, u = divmod(block, self.units)
        r = self.row_tiles - 1 - rt if self.causal else rt
        group = self.hq // self.hkv
        if self.pack_heads:
            pairs = group // 2
            bb, rem = divmod(u, self.hkv * pairs)
            hk, pair = divmod(rem, pairs)
            return [(bb, hk * group + 2 * pair + c, r * FLASH_FWD_ROWS)
                    for c in range(2)]
        bb, h = divmod(u, self.hq)
        return [(bb, h, r * self.rows + FLASH_FWD_ROWS * c)
                for c in range(self.wgs)]

    def item_tiles(self, row0: int) -> int:
        """K/V tiles that 64 query rows from ``row0`` see (0 past Sq)."""
        if row0 >= self.sq:
            return 0
        kv_end = (min(self.skv, self.skv - self.sq
                      + min(row0 + FLASH_FWD_ROWS, self.sq))
                  if self.causal else self.skv)
        return max(0, -(-kv_end // FLASH_FWD_ROWS))

    def block_tiles(self, block: int) -> int:
        return max(self.item_tiles(r0) for _, _, r0 in self.items(block))


@functools.lru_cache(maxsize=256)
def flash_fwd_plan(b: int, hq: int, hkv: int, sq: int, skv: int, d: int, *,
                   causal: bool, sms: int) -> FlashFwdPlan:
    """The TMA forward kernel's grid for a shape, from the shape and the
    card's SM count alone (chip_smoke phase 3 times every grid; PERF.md
    section 6 has the times):

    * D > 128: two consumers a block, two heads of a GQA group at the
      same rows (even groups) or 128 rows of one head: a block has the
      SM's shared memory to itself, and its consumers share each K/V tile
      and take turns at the tensor cores.  One consumer (64-row blocks)
      where the two-consumer grid would leave more than half the SMs
      idle;
    * D <= 64, not causal: three consumers on 192 rows of one head, where
      that grid has a block for every SM: every consumer sees every tile,
      and three share each K/V load;
    * otherwise (D <= 128): one consumer a block, two blocks an SM, so
      that an item's walk is exactly its own tiles (two-consumer blocks
      measured slower at every such path shape)."""
    group = hq // hkv
    plan = functools.partial(FlashFwdPlan, b, hq, hkv, sq, skv, d,
                             bool(causal))
    one = plan(1, False)
    if d > 128:
        two = plan(2, group % 2 == 0)
        return two if 2 * two.blocks >= sms else one
    three = plan(3, False)
    if d <= 64 and not causal and three.blocks >= sms:
        return three
    return one


#: bf16 and f32 forward launches by kernel since the last reset: "wgmma"
#: (the TMA kernel), "mma" (the mma.sync kernel, for what TMA cannot
#: address), "f32" (CUDA cores); all count under ``LAUNCHES
#: ["flash_attention"]``
FLASH_FWD_ROUTES: Dict[str, int] = {"wgmma": 0, "mma": 0, "f32": 0}


def flash_fwd_route(q, k, v) -> str:
    """The forward kernel that contiguous ``q, k, v`` run: bf16 with a
    head dim that is a multiple of 8 and 16-byte aligned operands (what
    TMA addresses) take "wgmma", other bf16 calls "mma", f32 "f32"."""
    if q.dtype != torch.bfloat16:
        return "f32"
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    return "wgmma" if q.shape[-1] % 8 == 0 and aligned else "mma"


def _flash_fwd_launch(q, k, v, causal, softmax_scale, with_lse, plan):
    """One launch on contiguous CUDA operands: the TMA kernel on
    ``plan`` (a :class:`FlashFwdPlan`), or with ``plan`` None the
    mma.sync kernel (bf16) or the CUDA-core kernel (f32)."""
    b, hq, hkv, sq, skv, d = _check_flash(q, k, v)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return out, lse
    lib = _cuda.library("flash_attention")
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, hq, hkv, sq, skv, d,
        _scale(softmax_scale, d), int(bool(causal)),
        int(q.dtype == torch.bfloat16), 0 if plan is None else plan.wgs,
        int(plan is not None and plan.pack_heads), _cuda.stream_of(q))
    _cuda.check(lib, err, "flash_attention")
    _cuda.LAUNCHES["flash_attention"] += 1
    FLASH_FWD_ROUTES["wgmma" if plan is not None else
                     "mma" if q.dtype == torch.bfloat16 else "f32"] += 1
    return out, lse


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        softmax_scale: Optional[float] = None,
                        with_lse: bool = False):
    """One launch of the forward kernel on CUDA tensors: the output, and
    with ``with_lse`` also the rows' natural log-sum-exp (B, Hq, Sq) f32
    (-inf for a row that sees no key): ``(out, lse or None)``.  The
    kernel is :func:`flash_fwd_route`'s, on :func:`flash_fwd_plan`'s grid
    for the TMA kernel."""
    b, hq, hkv, sq, skv, d = _check_flash(q, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    plan = None
    if flash_fwd_route(q, k, v) == "wgmma":
        plan = flash_fwd_plan(b, hq, hkv, sq, skv, d, causal=bool(causal),
                              sms=_cuda.sm_count(q.device))
    return _flash_fwd_launch(q, k, v, causal, softmax_scale, with_lse, plan)


#: the backward's Q rows per step of a dk/dv block's walk
FLASH_BWD_Q_ROWS = 32


@dataclasses.dataclass(frozen=True)
class FlashBwdPlan:
    """How the backward's dk/dv grid cuts the work of one shape
    (``csrc/flash_attention_bwd.cu``, its ``Walk``).  A block owns
    ``kv_rows`` rows of one KV head (a KV tile) and one of ``chunks``
    column chunks of dk and dv.  The tile's items are (query head of its
    group, 32-row Q step that can see the tile), head-major; a block runs
    ``per`` consecutive items (:meth:`split_items`), so a tile with more
    items takes more blocks (:meth:`splits`).  When a tile takes more
    than one, every block writes f32 partial sums into a workspace of
    ``workspace_bytes``, summed in split order by a second pass."""
    b: int
    hq: int
    hkv: int
    sq: int
    skv: int
    d: int
    causal: bool
    kv_rows: int
    chunks: int
    per: int

    @property
    def kv_tiles(self) -> int:
        return -(-self.skv // self.kv_rows)

    def _steps(self, kv_tile: int) -> range:
        """The Q steps that can see the KV tile: causal, from the one
        holding the first row that sees its first key (``q_off = Skv -
        Sq``)."""
        k0 = kv_tile * self.kv_rows
        first = (max(0, k0 - (self.skv - self.sq)) if self.causal
                 else 0) // FLASH_BWD_Q_ROWS
        return range(first, -(-self.sq // FLASH_BWD_Q_ROWS))

    def tile_items(self, kv_tile: int) -> List[Tuple[int, int]]:
        """The KV tile's (query head of the group, Q step) items in
        order."""
        steps = self._steps(kv_tile)
        return [(hh, st) for hh in range(self.hq // self.hkv) for st in steps]

    def splits(self, kv_tile: int) -> int:
        """Blocks of the KV tile: ``ceil(items / per)``, at least one."""
        items = (self.hq // self.hkv) * len(self._steps(kv_tile))
        return max(1, -(-items // self.per))

    def split_items(self, kv_tile: int,
                    split: int) -> List[Tuple[int, int]]:
        """Block ``split`` of the tile: items ``[split * per, (split + 1)
        * per)``."""
        return self.tile_items(kv_tile)[split * self.per:
                                        (split + 1) * self.per]

    @property
    def nsplit(self) -> int:
        """The most blocks of a tile: the workspace's partials."""
        return max(self.splits(t) for t in range(self.kv_tiles))

    @property
    def blocks(self) -> int:
        """dk/dv blocks: each tile's splits x chunks x KV heads x batch."""
        return (sum(self.splits(t) for t in range(self.kv_tiles))
                * self.chunks * self.hkv * self.b)

    @property
    def workspace_bytes(self) -> int:
        """f32 partials of dk and dv, ``nsplit`` of each (none without a
        split)."""
        if self.nsplit == 1:
            return 0
        return 2 * self.nsplit * self.b * self.hkv * self.skv * self.d * 4


@functools.lru_cache(maxsize=256)
def flash_bwd_plan(b: int, hq: int, hkv: int, sq: int, skv: int, d: int, *,
                   causal: bool, bf16: bool, sms: int) -> FlashBwdPlan:
    """The backward's split for a shape, from the shape and the card's SM
    count alone.  bf16 (tensor cores) takes 64-row KV tiles and, at D >
    64, two column chunks, and ``per`` is the most items a block that
    still gives the SMs 1.2 dk/dv blocks each: a causal shape's first
    tiles, which have the most items, take the most blocks, and no more
    partial sums are written than that needs (the dq blocks, in the same
    grid, fill the rest; chip_bwd_variants.py times other ``per``).  f32
    (CUDA cores) takes 32-row tiles, one chunk, and the fewest items a
    block that keeps its own grid within two blocks an SM.  Without enough
    work to split, ``per`` is every item of a tile or 1."""
    kv_rows = 64 if bf16 else 32
    chunks = 2 if bf16 and d > 64 else 1
    plan = functools.partial(FlashBwdPlan, b, hq, hkv, sq, skv, d,
                             bool(causal), kv_rows, chunks)
    most = max(1, (hq // hkv) * -(-sq // FLASH_BWD_Q_ROWS))
    lo, hi = 1, most                    # blocks fall as per grows
    while lo < hi:
        if bf16:                        # the largest with >= 1.2 sms blocks
            mid = (lo + hi + 1) // 2
            lo, hi = ((mid, hi) if plan(mid).blocks >= -(-6 * sms // 5)
                      else (lo, mid - 1))
        else:                           # the smallest with <= 2 sms blocks
            mid = (lo + hi) // 2
            lo, hi = (lo, mid) if plan(mid).blocks <= 2 * sms else (mid + 1,
                                                                    hi)
    return plan(lo)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        softmax_scale: Optional[float] = None):
    """``(dq, dk, dv)`` of the cache-free attention from the forward's
    output ``o`` and log-sum-exp ``lse`` and the output gradient ``do``,
    in the operands' dtype (f32 sums): one launch of the backward (the
    ``delta``, dk/dv and dq kernels, and the reduction of dk/dv's split
    partials, :func:`flash_bwd_plan`) on CUDA tensors, deterministic.  Like
    :func:`flash_attention_fwd` it raises on the CPU, where autograd
    differentiates the plain forward (:func:`flash_attention`)."""
    b, hq, hkv, sq, skv, d = _check_flash(q, k, v)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} "
                         f"{o.dtype} and do {tuple(do.shape)} {do.dtype} "
                         f"must be like q {tuple(q.shape)} {q.dtype}")
    if lse.shape != (b, hq, sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} "
                         f"{lse.dtype} is not ({b}, {hq}, {sq}) f32")
    for t in (o, lse, do):
        if t.device != q.device:
            raise ValueError("flash_attention_bwd: operands on different "
                             "devices")
    q, k, v, o, lse, do = (t.contiguous() for t in (q, k, v, o, lse, do))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    bf16 = q.dtype == torch.bfloat16
    plan = flash_bwd_plan(b, hq, hkv, sq, skv, d, causal=causal, bf16=bf16,
                          sms=_cuda.sm_count(q.device))
    ws = (torch.empty(plan.workspace_bytes // 4, dtype=torch.float32,
                      device=q.device) if plan.nsplit > 1 else None)
    lib = _cuda.library("flash_attention_bwd")
    err = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), delta.data_ptr(), None if ws is None else ws.data_ptr(),
        b, hq, hkv, sq, skv, d, _scale(softmax_scale, d), int(bool(causal)),
        int(bf16), plan.per, _cuda.stream_of(q))
    _cuda.check(lib, err, "flash_attention_bwd")
    _cuda.LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The forward kernel with its log-sum-exp, the backward kernel as
    the gradient (CUDA tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, softmax_scale):
        out, lse = flash_attention_fwd(q, k, v, causal=causal,
                                       softmax_scale=softmax_scale,
                                       with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.softmax_scale = causal, softmax_scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do,
                                         causal=ctx.causal,
                                         softmax_scale=ctx.softmax_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    softmax_scale: Optional[float] = None):
    """Cache-free attention: q (B, Hq, Sq, D) against k, v (B, Hkv, Skv, D),
    ``Hq % Hkv == 0``, the queries the last Sq positions of the context;
    f32 or bf16 (all three alike), f32 softmax and accumulation, output
    in q's dtype.  ``softmax_scale`` None is ``D ** -0.5``.  bf16 runs the
    tensor-core kernel, f32 the CUDA-core kernel (no TF32); both have
    :func:`flash_attention_plain` as their plain version.  Under autograd
    (an operand that requires grad) a CUDA call is differentiable through
    :func:`flash_attention_bwd`; serving writes no log-sum-exp."""
    if is_dtensor(q):
        return _flash_attention_sharded(q, k, v, causal, softmax_scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     softmax_scale=softmax_scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, bool(causal), softmax_scale)
    return flash_attention_fwd(q, k, v, causal=causal,
                               softmax_scale=softmax_scale)[0]


def _sharded_placements(mesh, b: int, hq: int, hkv: int):
    """The kernels' placements of q (and o, lse, do) and of k, v on
    ``mesh``, and the placements of k's and v's gradients: the batch on
    the data axes where it divides them; the heads on ``model`` where
    their count divides it (K/V heads dividing it means each rank holds
    whole GQA groups); queries cut on ``model`` with K/V replicated
    there make each rank differentiate only its heads' K/V, whose
    gradients are then partial sums over ``model``."""
    from torch.distributed.tensor import Partial, Shard
    pq = placements_of((b, hq), mesh, "dp", "tp")
    pkv = placements_of((b, hkv), mesh, "dp", "tp")
    gkv = [Partial() if isinstance(a, Shard) and not isinstance(c, Shard)
           else c for a, c in zip(pq, pkv)]
    return pq, pkv, gkv


def _local_kv_heads(k, v, hq: int, hq_local: int, rank: int):
    """K/V replicated over ``model`` (B, Hkv, S, D) -> the heads that
    queries ``[rank * hq_local, (rank + 1) * hq_local)`` attend: whole
    groups, one group's head, or (a group split across ranks unevenly)
    one K/V head per query head."""
    hkv = k.shape[1]
    g = hq // hkv
    if hq_local % g == 0:
        lo, n = rank * hq_local // g, hq_local // g
        return k[:, lo:lo + n], v[:, lo:lo + n]
    if g % hq_local == 0:
        j = rank * hq_local // g
        return k[:, j:j + 1], v[:, j:j + 1]
    idx = (torch.arange(hq_local, device=k.device) + rank * hq_local) // g
    return k.index_select(1, idx), v.index_select(1, idx)


def _flash_attention_sharded(q, k, v, causal, softmax_scale):
    """:func:`flash_attention` on DTensors: the operands redistributed to
    :func:`_sharded_placements`, the kernel (the plain version on the
    CPU) run on each rank's local tensors, the output a DTensor of q's
    placements.  Autograd runs through the same local call, so the
    backward kernel takes ``do`` in the forward's placements."""
    from torch.distributed.tensor import DTensor
    mesh = q.device_mesh
    b, hq = q.shape[:2]
    hkv = k.shape[1]
    pq, pkv, gkv = _sharded_placements(mesh, b, hq, hkv)
    ql = q.redistribute(mesh, pq).to_local()
    kl = k.redistribute(mesh, pkv).to_local(grad_placements=gkv)
    vl = v.redistribute(mesh, pkv).to_local(grad_placements=gkv)
    if ql.shape[1] != hq and kl.shape[1] == hkv:      # q heads cut, K/V not
        rank = mesh.get_local_rank("model")
        kl, vl = _local_kv_heads(kl, vl, hq, ql.shape[1], rank)
    out = flash_attention(ql, kl, vl, causal=causal,
                          softmax_scale=softmax_scale)
    return DTensor.from_local(out, mesh, pq, run_check=False)


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


#: query rows a block of the control paged kernel takes (one ticket per
#: tile)
_ROW_TILE = 8
#: the Hopper paged kernel's limits: page rows (one key a lane of a half
#: warp), warps a group (two rows a warp), warps a block (the producer and
#: the groups), ring stages, dynamic shared memory a block (the H100's 227
#: KB) and the bytes before q's (barriers, slot ids, a flag)
PAGED_KEYS = 16
PAGED_ROW_WARPS = 8
PAGED_MAX_WARPS = 17
PAGED_MAX_STAGES = 8
PAGED_SMEM = 232448
PAGED_HEADER = 256


@dataclasses.dataclass(frozen=True)
class PagedPlan:
    """How one paged-attention launch cuts its work
    (``csrc/paged_attention.cu``).  Both instances walk the reference's
    ``split`` partitions of ``span`` table entries (``_resolve_knobs``'
    ``kv_split`` and ``nt * pages_per_step``).

    * ``"hopper"``: a block owns ``rows_per_block = 2 * rw`` query rows of
      one (batch, KV head) (``row_tiles`` of them cover the group's rows)
      and ``per`` consecutive entries of one partition (``cpp`` blocks a
      partition, ``chunks`` in all), which ``groups`` groups of ``rw``
      warps walk round-robin from a ring of ``stages`` pages that a
      producer warp fills; with more than one chunk the blocks' partials
      merge in chunk order (:meth:`entries` gives a chunk's entries);
    * ``"control"``: the first port's kernel: 8 rows a block, one block a
      partition, 8 warps taking its pages in turn."""
    instance: str
    b: int
    hkv: int
    rows: int
    d: int
    ps: int
    np_: int
    span: int
    split: int
    groups: int = 1
    rw: int = PAGED_ROW_WARPS
    per: int = 1
    stages: int = 1

    @property
    def rows_per_block(self) -> int:
        if self.instance == "control":
            return _ROW_TILE
        return 2 * self.rw

    @property
    def warps(self) -> int:
        """Warps a block: the producer and the groups'."""
        return 8 if self.instance == "control" else 1 + self.groups * self.rw

    @property
    def row_tiles(self) -> int:
        return -(-self.rows // self.rows_per_block)

    @property
    def cpp(self) -> int:
        """Blocks of pages a partition."""
        return 1 if self.instance == "control" else -(-self.span // self.per)

    @property
    def chunks(self) -> int:
        """Blocks of pages a (batch, KV head, row tile): partials merged."""
        return self.split * self.cpp

    @property
    def blocks(self) -> int:
        return self.chunks * self.row_tiles * self.b * self.hkv

    @property
    def smem_bytes(self) -> int:
        """The Hopper kernel's dynamic shared memory: header, q, ring."""
        return (PAGED_HEADER + self.rows_per_block * self.d * 4
                + self.stages * 2 * self.ps * self.d * 4)

    @property
    def ring(self) -> int:
        """The most stages (up to ``PAGED_MAX_STAGES``) that fit a block's
        shared memory beside its q."""
        page = 2 * self.ps * self.d * 4
        return max(1, min(PAGED_MAX_STAGES, (PAGED_SMEM - PAGED_HEADER
                                             - self.rows_per_block * self.d
                                             * 4) // page))

    def fits(self) -> bool:
        """What the kernel's launcher checks: shared memory, stages a
        multiple of the groups (a slot read by one group only), the
        groups' states in the ring, the merge's weights behind the
        header."""
        rtb = self.rows_per_block
        return (self.smem_bytes <= PAGED_SMEM
                and self.stages % self.groups == 0
                and (self.groups - 1) * rtb * (self.d + 2)
                <= self.stages * 2 * self.ps * self.d
                and (self.chunks == 1 or (self.chunks + 1) * rtb * 4
                     <= self.smem_bytes - PAGED_HEADER))

    def entries(self, chunk: int) -> range:
        """Table entries of block ``chunk`` of a row tile (before the
        kernel clamps them to the last visible position)."""
        if self.instance == "control":
            lo, hi = chunk * self.span, (chunk + 1) * self.span
        else:
            sp, sub = divmod(chunk, self.cpp)
            lo = sp * self.span + sub * self.per
            hi = min(lo + self.per, (sp + 1) * self.span)
        return range(min(lo, self.np_), min(hi, self.np_))


def _hopper_fits(ps: int, d: int) -> bool:
    """What the Hopper kernel takes: pages of at most 16 rows, head dims
    that are multiples of 4 up to 256."""
    return 1 <= ps <= PAGED_KEYS and d % 4 == 0 and 4 <= d <= MAX_HEAD_DIM


#: query positions a lane up to which a call cuts its pages as a decode
#: step does (verify passes: spec_k + 1), the groups such a block runs,
#: and the fewest table entries it walks (a block of one entry pays its
#: q load, partial and merge share for one page: PERF.md section 6)
PAGED_DECODE_S = 8
PAGED_DECODE_GROUPS = 4
PAGED_DECODE_MIN_PER = 2


@functools.lru_cache(maxsize=1024)
def paged_plan(b: int, hkv: int, rows: int, d: int, ps: int, np_: int,
               span: int, split: int, *, sms: int, s: int = 1,
               instance: Optional[str] = None) -> PagedPlan:
    """The launch for one call on a card of ``sms`` SMs: plain Python of
    the shape (``s`` query positions a lane, ``rows`` = group x ``s``),
    the reference's partitions (``split`` of ``span`` table entries) and
    the SM count, as the CPU tests hold it.  ``instance`` forces one (the
    card's checks time the control beside the plan).

    * ``"control"``, the first port's kernel: for pages of more than 16
      rows, which the Hopper kernel does not take (the wrapper also routes
      there pages that are not 16-byte aligned, which the bulk copies
      cannot address); and for a chunked prefill (``s`` > 8) whose grid of
      8-row tiles, one block a partition, is at most one wave: there its
      8 warps a block walk the pages side by side with no merge across
      blocks, faster than the Hopper kernel (gemma-2b's unsplit prefill,
      PERF.md section 6);
    * ``"hopper"`` otherwise.  Rows: blocks of up to 16 (a warp two rows).
      Pages: each partition cut into the most blocks (``cpp``) that keep
      one wave of blocks, one an SM, no block walking fewer than one
      entry, while the merge's weights stay within a block's shared
      memory; groups of warps walk a block's entries round-robin, so that
      several pages are in the products at once.  A call of up to 8
      positions (decode, a verify pass) cuts its pages and picks its
      groups (up to 4) from the batch, the KV heads and the table alone,
      no block walking fewer than ``PAGED_DECODE_MIN_PER`` entries,
      and fits its rows to them: a verify row then takes the same pages,
      groups and merges as the decode row at its position, bit for bit.
      A prefill chunk counts its row tiles in the cut and runs as many
      groups as 16 consumer warps allow.  Ring (:func:`paged_stages`):
      two pages a group where shared memory holds them and the block
      walks them, else one."""
    if instance is None:
        control = (b * hkv * -(-rows // _ROW_TILE) * split <= sms
                   and s > PAGED_DECODE_S)
        instance = ("hopper" if _hopper_fits(ps, d) and not control
                    else "control")
    if instance == "control":
        return PagedPlan("control", b, hkv, rows, d, ps, np_, span, split)
    if instance != "hopper":
        raise ValueError(f"paged_plan: no instance {instance!r}")
    if not _hopper_fits(ps, d):
        raise ValueError(f"paged_plan: the Hopper kernel takes pages of at "
                         f"most {PAGED_KEYS} rows and head dims that are "
                         f"multiples of 4 up to {MAX_HEAD_DIM}, not ps {ps} "
                         f"D {d}")
    decode = s <= PAGED_DECODE_S
    rw = min(PAGED_ROW_WARPS, -(-rows // 2))
    # a decode-like call cuts its pages as if its rows were one full tile
    cut = PagedPlan("hopper", b, hkv, 2 * PAGED_ROW_WARPS if decode else rows,
                    d, ps, np_, span, split, 1, PAGED_ROW_WARPS if decode
                    else rw)
    base = b * hkv * cut.row_tiles * split
    cpp = max(1, min(span, sms // base))
    while cpp > 1 and not dataclasses.replace(
            cut, per=-(-span // cpp)).fits():
        cpp -= 1
    per = -(-span // cpp)
    if decode:
        per = max(per, min(span, PAGED_DECODE_MIN_PER))
    plan = PagedPlan("hopper", b, hkv, rows, d, ps, np_, span, split, 1, rw,
                     per)
    if decode:
        groups = min(per, PAGED_DECODE_GROUPS)
        while True:
            rw = min(rw, (PAGED_MAX_WARPS - 1) // groups)
            p = dataclasses.replace(plan, groups=groups, rw=rw)
            p = dataclasses.replace(p, stages=paged_stages(p.ring, per,
                                                           groups))
            if rw == 1 or p.fits():
                return p
            rw -= 1
    groups = max(1, min((PAGED_MAX_WARPS - 1) // rw, per, plan.ring))
    while True:
        p = dataclasses.replace(plan, groups=groups,
                                stages=paged_stages(plan.ring, per, groups))
        if groups == 1 or p.fits():
            return p
        groups -= 1


def paged_stages(ring: int, per: int, groups: int) -> int:
    """Two pages a group in flight where the ring holds them and the block
    walks them, else one: a multiple of the groups."""
    return groups * (2 if min(ring, per) >= 2 * groups else 1)


def paged_call_plan(q, k_pages, v_pages, block_tables, *, kv_split: int = 1,
                    pages_per_step: int = 1,
                    instance: Optional[str] = None) -> PagedPlan:
    """:func:`paged_plan` for one call of :func:`paged_attention_split`
    (:func:`paged_attention_unsplit`: knobs ``(1, 1)``) on CUDA tensors:
    the reference's partitions (``kv_split`` of ``nt`` tiles of
    ``pages_per_step`` entries, clamped to the table), and the control
    where the pages are not 16-byte aligned (what the bulk copies cannot
    address) unless ``instance`` forces one."""
    b, hq, s = q.shape[:3]
    _, hkv, ps, d = k_pages.shape
    np_ = block_tables.shape[1]
    t = max(1, min(int(pages_per_step), np_))
    tiles = -(-np_ // t)
    split = max(1, min(int(kv_split), tiles))
    span = max(1, -(-tiles // split) * t)       # table entries a partition
    if instance is None and (k_pages.data_ptr() % 16
                             or v_pages.data_ptr() % 16):
        instance = "control"
    return paged_plan(b, hkv, hq // hkv * s, d, ps, np_, span, split,
                      sms=_cuda.sm_count(q.device), s=s, instance=instance)


def _launch_paged(q, k_pages, v_pages, block_tables, qpos, softmax_scale,
                  what: str, kv_split: int, pages_per_step: int,
                  plan: Optional[PagedPlan] = None, lib=None):
    """One launch of a paged kernel on :func:`paged_call_plan`'s plan (or
    ``plan``), from ``lib`` (default: the ``paged_attention`` library; a
    copy built from the same source is timed by ``chip_paged_variants.py``).
    A launch of the Hopper kernel counts under ``what``, one of the control
    under ``"paged_attention_control"``."""
    q = q.contiguous()
    b, hq, s, d, p_, hkv, ps, np_ = _check(q, k_pages, v_pages,
                                           block_tables, qpos)
    if d % 4 or d > MAX_HEAD_DIM:
        raise ValueError(f"{what}: head dim {d} is not a multiple of 4 up "
                         f"to {MAX_HEAD_DIM}")
    mine = paged_call_plan(q, k_pages, v_pages, block_tables,
                           kv_split=kv_split, pages_per_step=pages_per_step,
                           instance=None if plan is None else plan.instance)
    if plan is None:
        plan = mine
    elif (plan.b, plan.hkv, plan.rows, plan.d, plan.ps, plan.np_, plan.span,
          plan.split) != (mine.b, mine.hkv, mine.rows, mine.d, mine.ps,
                          mine.np_, mine.span, mine.split):
        raise ValueError(f"{what}: the plan is for another call ({plan})")
    out = torch.empty_like(q)
    scratch = [None] * 4
    if plan.chunks > 1:
        f32 = dict(dtype=torch.float32, device=q.device)
        rows = plan.rows
        acc = torch.empty((plan.chunks, b, hkv, rows, d), **f32)
        m = torch.empty((plan.chunks, b, hkv, rows), **f32)
        l = torch.empty((plan.chunks, b, hkv, rows), **f32)
        # one per (batch, KV head, row tile), left zeroed by the kernel
        tickets = _cuda.zeroed_scratch("paged_attention_tickets", q.device,
                                       b * hkv * plan.row_tiles)
        scratch = [x.data_ptr() for x in (acc, m, l, tickets)]
    if lib is None:
        lib = _cuda.library("paged_attention")
    args = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), qpos.data_ptr(), out.data_ptr(),
            *scratch, b, hkv, plan.rows, d, s, ps, p_, np_, plan.span,
            plan.split)
    if plan.instance == "control":
        err = lib.paged_attention_launch(
            *args, _scale(softmax_scale, d), int(q.dtype == torch.bfloat16),
            _cuda.stream_of(q))
    else:
        err = lib.paged_attention_hopper_launch(
            *args, plan.per, plan.cpp, plan.groups, plan.rw, plan.stages,
            _scale(softmax_scale, d), int(q.dtype == torch.bfloat16),
            _cuda.stream_of(q))
    _cuda.check(lib, err, f"{what} ({plan.instance})")
    _cuda.LAUNCHES["paged_attention_control" if plan.instance == "control"
                   else what] += 1
    return out


def paged_attention_unsplit(q, k_pages, v_pages, block_tables, qpos, *,
                            softmax_scale: Optional[float] = None,
                            plan: Optional[PagedPlan] = None):
    """The whole table in one partition (knobs ``(1, 1)``), on
    :func:`paged_plan`'s kernel and grid (or ``plan``'s).  The kernels
    take head dims that are multiples of 4 up to 256."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_tables, qpos,
                                   softmax_scale=softmax_scale)
    return _launch_paged(q, k_pages, v_pages, block_tables, qpos,
                         softmax_scale, "paged_attention_unsplit", 1, 1,
                         plan)


def paged_attention_split(q, k_pages, v_pages, block_tables, qpos, *,
                          softmax_scale: Optional[float] = None,
                          kv_split: int = 1, pages_per_step: int = 1,
                          plan: Optional[PagedPlan] = None):
    """Split-KV flash decoding in one launch: the reference's ``kv_split``
    partitions of ``nt`` tiles of ``pages_per_step`` entries, each walked
    by :func:`paged_plan`'s blocks (or ``plan``'s); the last block of each
    row tile combines them.

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
                         pages_per_step, plan)


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
