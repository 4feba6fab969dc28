"""GQA / MQA attention: the cache-free forward, cross-attention and the
KV-cache regimes, and MLA (port of ``repro.nn.attention``).

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
  :func:`_einsum_attention` (a speculative verify pass one query
  position at a time, so its rows are plain decode's, bit for bit).

Caches are updated **in place** (the reference returns new arrays): a
decode step writes ``B`` rows, not a copy of every layer's cache.  RoPE
is skipped where ``use_rope`` is off (learned positions, whisper) and
for cross-attention.  Under a mesh q, k and v are pinned by
:func:`_constrain_heads` after RoPE, as in the reference: heads on
``tp`` where they divide it, else (``sp_attn``) queries on the sequence
with K/V replicated, else the head dim on ``tp``.  The reference's
``seq_kv`` constraint of the dense cache is serving under a mesh
(ROADMAP.md item 18b): the flag is read there and raises under a mesh.

MLA (deepseek-v2) keeps the reference's two forms.  Without a cache,
the *naive* form materializes per-head K/V from the latent and attends
through ``ops.attention`` with V zero-padded to the q/k width (the
reference's TPU branch; the ``flash_attention`` kernel on the card, its
plain version on the CPU).  With a cache, the *absorbed* form writes the
new latent rows (dense ``(B, rows, lora)`` or paged ``(P+1, ps, lora)``,
no head axis) first, then scores against the whole latent with einsums
and :func:`~repro_torch.nn.activations.softmax` (the table softmax under
``ctx.use_lut``); no kernel runs there, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..core.qtypes import QTensor
from ..dist.constrain import constrain, current_mesh
from ..dist.options import flags
from ..dist.sharding import mesh_shape
from .activations import softmax
from .context import DEFAULT_CTX, QuantContext
from .linear import linear, linear_init
from .norms import rmsnorm, rmsnorm_init
from .rope import apply_rope

__all__ = ["AttnDims", "gqa_init", "gqa_apply", "gqa_cache_spec",
           "gqa_paged_cache_spec", "gqa_project_kv", "MLADims", "mla_init",
           "mla_apply", "mla_cache_spec", "mla_paged_cache_spec"]


def _constrain_heads(t: torch.Tensor, role: str = "q") -> torch.Tensor:
    """Pin (B, H, S, D) under a mesh: TP on heads when they divide the
    model axis; else, under the ``sp_attn`` flag, queries on their
    sequence axis and K/V replicated; else the head dim on ``tp``.
    Identity without a mesh."""
    mesh = current_mesh()
    if mesh is None or "model" not in mesh_shape(mesh):
        return t
    tp = mesh_shape(mesh)["model"]
    if t.shape[1] % tp == 0:
        return constrain(t, "dp", "tp", None, None)
    if flags().sp_attn and t.shape[2] > 1:
        if role == "q":
            return constrain(t, "dp", None, "tp", None)
        return constrain(t, "dp", None, None, None)   # replicate K/V
    return constrain(t, "dp", None, None, "tp")


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

    Under ``ctx.per_position_attention`` (the verify pass) a masked call
    of several query positions attends one position at a time
    (:func:`_attention_by_row`): GQA folds the positions into the
    products' M, and cuBLAS picks another algorithm at M = 5 x group than
    at a decode step's M = group, whose per-row sums round otherwise, so
    the verify pass would part from plain decode.  Every other call (a
    prefill chunk, whisper's decoder prompt) keeps the two fused
    products; at the CPU tests' shapes both forms are bitwise the JAX
    reference's.
    """
    if mask is not None and q.shape[2] > 1 and ctx.per_position_attention:
        return _attention_by_row(q, k, v, ctx=ctx, mask=mask)
    return _einsum_attention_fused(q, k, v, ctx=ctx, mask=mask)


def _attention_by_row(q, k, v, *, ctx: QuantContext, mask: torch.Tensor):
    """:func:`_einsum_attention_fused` per query position: every call has
    a decode step's shapes, so the rows do not depend on how many
    positions a call carries."""
    return torch.cat([
        _einsum_attention_fused(q[:, :, i:i + 1], k, v, ctx=ctx,
                                mask=mask[:, i:i + 1])
        for i in range(q.shape[2])], dim=2)


def _einsum_attention_fused(q, k, v, *, ctx: QuantContext,
                            mask: Optional[torch.Tensor] = None):
    """:func:`_einsum_attention` as two batched products over every query
    position at once."""
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
        y = _einsum_attention(_constrain_heads(q, "q"), *cached_kv, ctx=ctx)
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
    q = _constrain_heads(q, "q")
    k = _constrain_heads(k, "kv")
    v = _constrain_heads(v, "kv")

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
    if flags().seq_kv and current_mesh() is not None and not paged:
        # the reference's sequence-sharded dense cache (small Hkv on the
        # model axis) is serving under a mesh: ROADMAP.md item 18b
        raise NotImplementedError("seq_kv: the dense cache under a mesh is "
                                  "ROADMAP.md item 18b")
    return _einsum_attention(q, ck, cv, ctx=ctx,
                             mask=_cache_mask(pos, s, ck.shape[2], d.causal))


# ===========================================================================
# MLA (deepseek-v2 multi-head latent attention)
# ===========================================================================
@dataclasses.dataclass(frozen=True)
class MLADims:
    d_model: int
    n_heads: int
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0

    @property
    def qk_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim


def mla_init(gen: torch.Generator, d: MLADims, *, dtype=torch.float32,
             device="cpu"):
    kw = dict(dtype=dtype, device=device)
    h = d.n_heads
    return {
        "wq_a": linear_init(gen, d.d_model, d.q_lora_rank, **kw),
        "q_norm": rmsnorm_init(d.q_lora_rank, **kw),
        "wq_b": linear_init(gen, d.q_lora_rank, h * d.qk_dim, **kw),
        "wkv_a": linear_init(gen, d.d_model, d.kv_lora_rank + d.qk_rope_dim,
                             **kw),
        "kv_norm": rmsnorm_init(d.kv_lora_rank, **kw),
        "wkv_b": linear_init(gen, d.kv_lora_rank,
                             h * (d.qk_nope_dim + d.v_head_dim), **kw),
        "wo": linear_init(gen, h * d.v_head_dim, d.d_model, **kw),
    }


def _latent_dtype(dtype):
    """The latent is the cache's compression (576 values a token at full
    width) and precision-sensitive: an int8 request is served in bf16,
    as the reference does."""
    return torch.bfloat16 if dtype == torch.int8 else dtype


def mla_cache_spec(d: MLADims, batch: int, max_len: int,
                   dtype=torch.bfloat16, device="cpu"):
    """Dense latent cache: compressed KV (B, max_len, kv_lora) and the
    shared RoPE key (B, max_len, rope_dim); int8 becomes bf16."""
    dtype = _latent_dtype(dtype)
    return {"ckv": torch.zeros((batch, max_len, d.kv_lora_rank), dtype=dtype,
                               device=device),
            "krope": torch.zeros((batch, max_len, d.qk_rope_dim),
                                 dtype=dtype, device=device)}


def mla_paged_cache_spec(d: MLADims, batch: int, num_pages: int,
                         page_size: int, table_width: int,
                         dtype=torch.bfloat16, device="cpu"):
    """Paged latent: (P+1, page_size, kv_lora / rope_dim) pages, the
    trash page last, and the block table (the GQA scheme without a head
    axis); int8 becomes bf16 as in the dense spec."""
    dtype = _latent_dtype(dtype)
    return {"pages": {
                "ckv": torch.zeros((num_pages + 1, page_size,
                                    d.kv_lora_rank), dtype=dtype,
                                   device=device),
                "krope": torch.zeros((num_pages + 1, page_size,
                                      d.qk_rope_dim), dtype=dtype,
                                     device=device)},
            "block_table": torch.full((batch, table_width), num_pages,
                                      dtype=torch.int32, device=device)}


def _mla_qkv(p, x, d: MLADims, ctx: QuantContext, positions, path: str):
    """Queries (nope and rotated rope parts, (B, S, H, .)), the normed
    latent (B, S, lora) and the rotated shared key (B, S, rope_dim)."""
    b, s, _ = x.shape
    h = d.n_heads
    q = linear(p["wq_b"], rmsnorm(p["q_norm"], linear(
        p["wq_a"], x, ctx, path=f"{path}/wq_a")), ctx,
        path=f"{path}/wq_b").reshape(b, s, h, d.qk_dim)
    q_nope, q_rope = q[..., :d.qk_nope_dim], q[..., d.qk_nope_dim:]
    q_rope = apply_rope(q_rope.transpose(1, 2), positions[:, None],
                        theta=d.rope_theta).transpose(1, 2)
    kv_a = linear(p["wkv_a"], x, ctx, path=f"{path}/wkv_a")
    ckv = rmsnorm(p["kv_norm"], kv_a[..., :d.kv_lora_rank])
    krope = apply_rope(kv_a[..., None, d.kv_lora_rank:].transpose(1, 2),
                       positions[:, None], theta=d.rope_theta)[:, 0]
    return q_nope, q_rope, ckv, krope


def _mla_naive(q_nope, q_rope, ckv, krope, w_uk, w_uv, d: MLADims,
               ctx: QuantContext, dtype) -> torch.Tensor:
    """The cache-free form: per-head K/V from the latent, causal
    attention through ``ops.attention`` with V zero-padded to the q/k
    width (the flash kernel takes one head width) and sliced after.
    Returns (B, H, S, v_dim)."""
    from ..kernels.ops import attention
    b, s, h = q_nope.shape[:3]
    f32 = torch.float32
    k_nope = torch.einsum("bsl,lhd->bshd", ckv.to(f32),
                          w_uk.to(f32)).to(dtype)
    v = torch.einsum("bsl,lhd->bshd", ckv.to(f32), w_uv.to(f32)).to(dtype)
    k = torch.cat([k_nope, krope[:, :, None].to(dtype).expand(
        b, s, h, d.qk_rope_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    q, k, v = (_constrain_heads(t.transpose(1, 2), role)
               for t, role in ((q, "q"), (k, "kv"), (v, "kv")))
    vp = torch.nn.functional.pad(v, (0, d.qk_dim - d.v_head_dim))
    y = attention(q, k, vp, causal=True, softmax_scale=d.qk_dim ** -0.5,
                  backend=ctx.backend)
    return y[..., :d.v_head_dim]


def _latent_write(rows: torch.Tensor, u: torch.Tensor,
                  pos: torch.Tensor) -> None:
    """Write (B, s, X) latent rows into ``rows`` (B, R, X) in place at
    each lane's ``pos``, clamped to ``R - s`` (``dynamic_update_slice``)."""
    b, s = u.shape[:2]
    start = torch.clamp(pos.to(torch.int64), 0, rows.shape[1] - s)
    idx = start[:, None] + torch.arange(s, device=rows.device)[None, :]
    lanes = torch.arange(b, device=rows.device)[:, None]
    rows[lanes, idx] = u.to(rows.dtype)


def _mla_absorbed(q_nope, q_rope, cckv, ckrope, w_uk, w_uv, d: MLADims,
                  ctx: QuantContext, pos: torch.Tensor) -> torch.Tensor:
    """Attention of (B, s, H, .) queries against the whole latent (B, T,
    lora) and shared key (B, T, rope) with W_uk absorbed into the query
    and W_uv applied to the attended latent; operands rounded to
    ``compute_dtype``, products in f32.  Returns (B, s, H, v_dim) f32."""
    cd = ctx.compute_dtype

    def operand(t):
        return t.to(cd).to(torch.float32)

    s, t = q_nope.shape[1], cckv.shape[1]
    q_abs = torch.einsum("bshd,lhd->bshl", operand(q_nope), operand(w_uk))
    logits = (torch.einsum("bshl,btl->bhst", operand(q_abs), operand(cckv))
              + torch.einsum("bshr,btr->bhst", operand(q_rope),
                             operand(ckrope))) * (d.qk_dim ** -0.5)
    mask = _cache_mask(pos, s, t, True)                      # (B, s, T)
    logits = torch.where(mask[:, None], logits, -1e30)      # (B, H, s, T)
    w = softmax(logits, ctx, axis=-1)
    lat = torch.einsum("bhst,btl->bshl", operand(w), operand(cckv))
    return torch.einsum("bshl,lhd->bshd", operand(lat), operand(w_uv))


def mla_apply(p, x: torch.Tensor, d: MLADims, ctx: QuantContext = DEFAULT_CTX,
              *, cache=None, cache_pos: Optional[torch.Tensor] = None,
              path: str = "attn") -> Tuple[torch.Tensor, Optional[dict]]:
    """MLA over ``x`` (B, S, D_model).  ``cache``: one layer's dense
    latent ({"ckv", "krope"}) or paged latent ({"pages": {"ckv",
    "krope"}, "block_table"}), written in place; ``cache_pos`` (B,) each
    lane's position before this call.  Without a cache, the naive
    cache-free causal form.  Returns ``(y, cache)``."""
    b, s, _ = x.shape
    h = d.n_heads
    pos = (torch.zeros((b,), dtype=torch.int32, device=x.device)
           if cache_pos is None else cache_pos)
    positions = (torch.arange(s, device=x.device)[None, :]
                 + pos.to(torch.int64)[:, None])
    q_nope, q_rope, ckv, krope = _mla_qkv(p, x, d, ctx, positions, path)
    # wkv_b is consumed raw (reshaped into the absorbed form), not through
    # linear(): a PTQ'd payload is dequantized here
    w_b = p["wkv_b"]["w"]
    if isinstance(w_b, QTensor):
        w_b = w_b.dequantize(ctx.compute_dtype)
    wkv_b = w_b.reshape(d.kv_lora_rank, h, d.qk_nope_dim + d.v_head_dim)
    w_uk, w_uv = wkv_b[..., :d.qk_nope_dim], wkv_b[..., d.qk_nope_dim:]

    if cache is None:
        y = _mla_naive(q_nope, q_rope, ckv, krope, w_uk, w_uv, d, ctx,
                       x.dtype).transpose(1, 2)
    else:
        if "pages" in cache:
            # paged latent: write this call's rows into the lane's pages,
            # then score against the gathered logical view
            pages, bt = cache["pages"], cache["block_table"]
            page, row = _page_coords(bt, pos, s, pages["ckv"].shape[1])
            pages["ckv"][page, row] = ckv.to(pages["ckv"].dtype)
            pages["krope"][page, row] = krope.to(pages["krope"].dtype)
            idx = bt.to(torch.int64)
            cckv = pages["ckv"][idx].reshape(b, -1, d.kv_lora_rank)
            ckrope = pages["krope"][idx].reshape(b, -1, d.qk_rope_dim)
        else:
            _latent_write(cache["ckv"], ckv, pos)
            _latent_write(cache["krope"], krope, pos)
            cckv, ckrope = cache["ckv"], cache["krope"]
        if s > 1 and ctx.per_position_attention:
            # a verify pass: each position at a decode step's shapes
            y = torch.cat([
                _mla_absorbed(q_nope[:, i:i + 1], q_rope[:, i:i + 1], cckv,
                              ckrope, w_uk, w_uv, d, ctx, pos + i)
                for i in range(s)], dim=1)
        else:
            y = _mla_absorbed(q_nope, q_rope, cckv, ckrope, w_uk, w_uv, d,
                              ctx, pos)
    y = y.reshape(b, s, h * d.v_head_dim).to(x.dtype)
    return linear(p["wo"], y, ctx, path=f"{path}/wo"), cache
