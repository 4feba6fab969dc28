"""GQA / MQA attention: the cache-free forward, cross-attention and the
KV-cache regimes (port of the GQA part of ``repro.nn.attention``).

* **cache-free** (prefill without a cache, training, the whisper
  encoder; cross-attention with fresh K/V from ``kv_input``) -- always
  ``ops.attention``: the Hopper ``flash_attention`` kernel for CUDA
  tensors, its plain version for CPU tensors, as the reference's TPU
  path takes ``flash_attention_pallas``.  Like that kernel it keeps the
  exact softmax under ``ctx.use_lut``; the reference's CPU branch
  (``_einsum_attention``) would use the table softmax there.
* **cross over cached K/V** (``cached_kv``, the encoder projections made
  once at prefill by :func:`gqa_project_kv`) -- :func:`_einsum_attention`
  with no mask.
* **paged f32** -- each call scatters the new tokens' K/V into their
  pages through the block table (write-before-attend), then attends
  through the table with ``ops.paged_attention``: the Hopper kernel for
  CUDA tensors, its plain version for CPU tensors, always with the exact
  softmax.  Unlike the reference, which gathers pages and runs an einsum
  off-TPU, the port always goes through the paged op; the kernel's knob
  (``ctx.kv_split`` / ``ctx.pages_per_step``) rides along.
* **paged int8** -- int8 payload pages plus per-(token, head) bf16 scale
  pages; the pages are gathered, dequantized in ``compute_dtype`` and
  attended by :func:`_einsum_attention` (whose softmax is the LUT one
  under ``ctx.use_lut``), as the reference does on every backend.
* **dense** -- per-slot rows ``(B, Hkv, rows, Dh)`` in f32, or int8 with
  bf16 scales; the new rows are written at ``cache_pos`` and the whole
  row range is attended under a visibility mask by
  :func:`_einsum_attention`.

Caches are updated **in place** (the reference returns new arrays): a
decode step writes ``B`` rows, not a copy of every layer's cache.  RoPE
is skipped where ``use_rope`` is off (learned positions, whisper) and
for cross-attention.  MLA is not ported yet (ROADMAP.md); nor is the
reference's ``seq_kv`` mesh constraint on the dense cache (distribution,
ROADMAP.md queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .activations import softmax
from .context import DEFAULT_CTX, QuantContext
from .linear import linear, linear_init
from .rope import apply_rope

__all__ = ["AttnDims", "gqa_init", "gqa_apply", "gqa_cache_spec",
           "gqa_paged_cache_spec", "gqa_project_kv"]


@dataclasses.dataclass(frozen=True)
class AttnDims:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0
    use_rope: bool = True
    qkv_bias: bool = False
    causal: bool = True


def gqa_init(gen: torch.Generator, d: AttnDims, *, dtype=torch.float32,
             device="cpu"):
    kw = dict(dtype=dtype, device=device)
    return {
        "wq": linear_init(gen, d.d_model, d.n_heads * d.head_dim,
                          bias=d.qkv_bias, **kw),
        "wk": linear_init(gen, d.d_model, d.n_kv_heads * d.head_dim,
                          bias=d.qkv_bias, **kw),
        "wv": linear_init(gen, d.d_model, d.n_kv_heads * d.head_dim,
                          bias=d.qkv_bias, **kw),
        "wo": linear_init(gen, d.n_heads * d.head_dim, d.d_model, **kw),
    }


def gqa_project_kv(p, kv_src: torch.Tensor, d: AttnDims,
                   ctx: QuantContext = DEFAULT_CTX, *, path: str = "attn"):
    """Project cross-attention K/V once (prefill) -> (B, Hkv, Skv, Dh)."""
    b, skv, _ = kv_src.shape
    k = linear(p["wk"], kv_src, ctx, path=f"{path}/wk")
    v = linear(p["wv"], kv_src, ctx, path=f"{path}/wv")
    k = k.reshape(b, skv, d.n_kv_heads, d.head_dim).transpose(1, 2)
    v = v.reshape(b, skv, d.n_kv_heads, d.head_dim).transpose(1, 2)
    return k, v


def _kv_leaves(shape, dtype, device):
    """K and V buffers of ``shape``; ``torch.int8`` adds per-(token, head)
    bf16 scale buffers (the last axis cut to 1)."""
    kv = {"k": torch.zeros(shape, dtype=dtype, device=device),
          "v": torch.zeros(shape, dtype=dtype, device=device)}
    if dtype == torch.int8:
        sshape = (*shape[:-1], 1)
        kv["k_scale"] = torch.zeros(sshape, dtype=torch.bfloat16,
                                    device=device)
        kv["v_scale"] = torch.zeros(sshape, dtype=torch.bfloat16,
                                    device=device)
    return kv


def gqa_cache_spec(d: AttnDims, batch: int, max_len: int,
                   dtype=torch.bfloat16, device="cpu"):
    """Dense KV cache: K and V of shape (B, Hkv, max_len, Dh).

    ``dtype=torch.int8`` selects the quantized cache: int8 payload plus
    per-(token, head) bf16 scales."""
    return _kv_leaves((batch, d.n_kv_heads, max_len, d.head_dim), dtype,
                      device)


def gqa_paged_cache_spec(d: AttnDims, batch: int, num_pages: int,
                         page_size: int, table_width: int,
                         dtype=torch.float32, device="cpu"):
    """Shared pool of ``num_pages`` pages plus one trash page (index
    ``num_pages``) that absorbs writes from lanes with no allocation;
    every table entry starts pointing at it.  ``dtype=torch.int8`` pages
    the quantized cache: int8 payload pages plus bf16 scale pages, the
    dense int8 layout, so paged and dense serving quantize identically."""
    return {"pages": _kv_leaves((num_pages + 1, d.n_kv_heads, page_size,
                                 d.head_dim), dtype, device),
            "block_table": torch.full((batch, table_width), num_pages,
                                      dtype=torch.int32, device=device)}


def _page_coords(bt: torch.Tensor, pos: torch.Tensor, s: int, page_size: int):
    """(physical page, in-page row) for tokens written at pos..pos+s-1;
    positions past the table clamp to its last entry."""
    tpos = pos.to(torch.int64)[:, None] + torch.arange(s, device=bt.device)[None, :]
    idx = torch.clamp(tpos // page_size, 0, bt.shape[1] - 1)
    return torch.gather(bt.to(torch.int64), 1, idx), tpos % page_size


def _paged_write(pages: torch.Tensor, page: torch.Tensor, row: torch.Tensor,
                 u: torch.Tensor) -> None:
    """Scatter (B, Hkv, s, X) new K/V rows into ``pages`` in place.  Lanes
    never share a (page, row) except on the trash page, whose contents
    are never observed."""
    pages[page, :, row] = u.transpose(1, 2).to(pages.dtype)


def _paged_gather(pages: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """A slot-contiguous copy (B, Hkv, NP*ps, X) of the table's pages."""
    g = pages[bt.to(torch.int64)]                  # (B, NP, Hkv, ps, X)
    b, np_, h, ps, x = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(b, h, np_ * ps, x)


def _dense_write(rows: torch.Tensor, u: torch.Tensor,
                 pos: torch.Tensor) -> None:
    """Write (B, Hkv, s, X) new rows into ``rows`` (B, Hkv, R, X) in place
    at each lane's ``pos``, clamped to ``R - s`` as the reference's
    ``dynamic_update_slice`` clamps its start."""
    b, s = u.shape[0], u.shape[2]
    start = torch.clamp(pos.to(torch.int64), 0, rows.shape[2] - s)
    idx = start[:, None] + torch.arange(s, device=rows.device)[None, :]
    lanes = torch.arange(b, device=rows.device)[:, None]
    rows[lanes, :, idx] = u.transpose(1, 2).to(rows.dtype)


def _quantize_kv(u: torch.Tensor):
    """(B, H, s, Dh) -> int8 payload + per-(token, head) bf16 scale."""
    uf = u.to(torch.float32)
    amax = torch.amax(torch.abs(uf), dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-6) / 127.0
    q = torch.clamp(torch.round(uf / scale), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def _dequantize(data: torch.Tensor, scale: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    return data.to(dtype) * scale.to(dtype)


def _einsum_attention(q, k, v, *, ctx: QuantContext,
                      mask: Optional[torch.Tensor] = None):
    """(B,Hq,Sq,D) x (B,Hkv,Skv,D) attention with GQA folding under the
    (B, Sq, Skv) visibility ``mask``; without one (cross-attention over
    cached K/V), unmasked.

    Operands are rounded to ``compute_dtype`` and multiplied in f32 (the
    reference's bf16 operands with ``preferred_element_type=f32``); the
    softmax is :func:`repro_torch.nn.activations.softmax` on f32 logits.
    """
    b, hq, sq, dh = q.shape
    hkv = k.shape[1]
    dv = v.shape[-1]
    cd = ctx.compute_dtype

    def operand(t):
        return t.to(cd).to(torch.float32)

    qg = q.reshape(b, hkv, hq // hkv, sq, dh)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", operand(qg),
                          operand(k)) * (dh ** -0.5)
    if mask is not None:
        logits = torch.where(mask[:, None, None], logits, -1e30)
    w = softmax(logits, ctx, axis=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", operand(w), operand(v))
    return out.reshape(b, hq, sq, dv).to(q.dtype)


def _cache_mask(pos: torch.Tensor, s: int, max_len: int,
                causal: bool) -> torch.Tensor:
    """(B, s, max_len) visibility for queries written at pos..pos+s-1."""
    dev = pos.device
    qpos = pos.to(torch.int64)[:, None] + torch.arange(s, device=dev)[None, :]
    kvpos = torch.arange(max_len, device=dev)[None, None, :]
    if causal:
        return kvpos <= qpos[:, :, None]
    return kvpos < (pos.to(torch.int64)[:, None, None] + s)


def gqa_apply(p, x: torch.Tensor, d: AttnDims, ctx: QuantContext = DEFAULT_CTX,
              *, kv_input: Optional[torch.Tensor] = None,
              cached_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              cache=None, cache_pos: Optional[torch.Tensor] = None,
              path: str = "attn") -> Tuple[torch.Tensor, Optional[dict]]:
    """Self- or cross-attention over ``x`` (B, S, D_model).

    ``kv_input``: the encoder stream for cross-attention (source of K/V,
    non-causal, no RoPE).  ``cached_kv``: cross K/V (B, Hkv, Skv, Dh)
    projected once at prefill.  ``cache``: one layer's paged cache
    ({"pages": {"k", "v"[, "k_scale", "v_scale"]}, "block_table"}) or
    dense cache ({"k", "v"[, "k_scale", "v_scale"]}), updated in place;
    ``cache_pos`` (B,) is each lane's position before this call.  With
    neither, the cache-free forward.  Returns ``(y, cache)``.
    """
    b, s, _ = x.shape
    q = linear(p["wq"], x, ctx, path=f"{path}/wq")
    q = q.reshape(b, s, d.n_heads, d.head_dim).transpose(1, 2)
    if cached_kv is not None:
        y = _einsum_attention(q, *cached_kv, ctx=ctx)
    else:
        y = _fresh_kv_attention(p, q, x, d, ctx, kv_input=kv_input,
                                cache=cache, cache_pos=cache_pos, path=path)
    y = y.transpose(1, 2).reshape(b, s, d.n_heads * d.head_dim)
    return linear(p["wo"], y, ctx, path=f"{path}/wo"), cache


def _fresh_kv_attention(p, q, x, d: AttnDims, ctx: QuantContext, *,
                        kv_input, cache, cache_pos, path: str):
    """Project K/V from ``kv_input`` (cross) or ``x`` (self), rotate q and
    k (self-attention with RoPE), then attend: cache-free through
    ``ops.attention``, else through the cache (written in place)."""
    b, s = x.shape[:2]
    kv_src = x if kv_input is None else kv_input
    skv = kv_src.shape[1]
    k = linear(p["wk"], kv_src, ctx, path=f"{path}/wk")
    k = k.reshape(b, skv, d.n_kv_heads, d.head_dim).transpose(1, 2)
    v = linear(p["wv"], kv_src, ctx, path=f"{path}/wv")
    v = v.reshape(b, skv, d.n_kv_heads, d.head_dim).transpose(1, 2)

    pos = (torch.zeros((b,), dtype=torch.int32, device=x.device)
           if cache_pos is None else cache_pos)
    if d.use_rope and kv_input is None:
        positions = (torch.arange(s, device=x.device)[None, :]
                     + pos.to(torch.int64)[:, None])
        q = apply_rope(q, positions[:, None], theta=d.rope_theta,
                       fraction=d.rope_fraction)
        k = apply_rope(k, positions[:, None], theta=d.rope_theta,
                       fraction=d.rope_fraction)

    if cache is None:                      # the flash kernel's path
        from ..kernels.ops import attention
        return attention(q, k, v, causal=d.causal and kv_input is None,
                         backend=ctx.backend)
    return _cache_attention(q, k, v, d, ctx, cache, pos)


def _cache_attention(q, k, v, d: AttnDims, ctx: QuantContext, cache,
                     pos: torch.Tensor) -> torch.Tensor:
    """Write the new K/V into ``cache`` at ``pos`` (in place), then attend
    over the cached rows: (B, Hq, s, Dh)."""
    s = q.shape[2]
    cd = ctx.compute_dtype
    paged = "pages" in cache
    store = cache["pages"] if paged else cache
    quantized = "k_scale" in store          # int8 K/V + bf16 scales
    new = {"k": k, "v": v}
    if quantized:
        (kq, ks), (vq, vs) = _quantize_kv(k), _quantize_kv(v)
        new = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    if paged:
        bt = cache["block_table"]
        page, row = _page_coords(bt, pos, s, store["k"].shape[2])
        for name, u in new.items():
            _paged_write(store[name], page, row, u)

        def rows(name):
            return _paged_gather(store[name], bt)
    else:
        for name, u in new.items():
            _dense_write(store[name], u, pos)

        def rows(name):
            return store[name]
    if paged and not quantized:            # the kernel walks the table
        from ..kernels.ops import paged_attention
        return paged_attention(q.contiguous(), store["k"], store["v"], bt,
                               pos.to(torch.int32), kv_split=ctx.kv_split,
                               pages_per_step=ctx.pages_per_step,
                               backend=ctx.backend)
    ck, cv = ((_dequantize(rows(n), rows(f"{n}_scale"), cd)
               if quantized else rows(n)) for n in ("k", "v"))
    return _einsum_attention(q, ck, cv, ctx=ctx,
                             mask=_cache_mask(pos, s, ck.shape[2], d.causal))
