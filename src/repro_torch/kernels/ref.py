"""Plain PyTorch versions of the kernels (port of ``repro.kernels.ref``).

Each function mirrors its ``repro.kernels.ref`` counterpart op for op and
runs on any device.  They are the ``ref`` backend of the registry, what
a kernel wrapper runs when it is handed CPU tensors, and what
``chip_smoke.py`` holds every CUDA kernel against on the card.

Table lookups come in two forms.  :func:`lut_activation_ref` is the
reference's ``lut_activation_ref``, bit for bit: positions ``(x - lo) /
step``.  :func:`apply_table` is the in-kernel form that the TPU kernels
(``repro.kernels.lut_activation.apply_table``) and the CUDA kernels
compute, ``(x - lo) * step_inv`` with ``step_inv = 1 / step`` rounded to
f32 once; the two agree whenever the step is a power of two and may pick
a neighbouring entry otherwise.  :func:`lut_activation_plain` and the
epilogue of :func:`qmatmul_ref` use the kernel form, so that each is
bitwise the plain version of its kernel.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.qtypes import FixedPointType
from ..core.quantize import calibrate_scale
from ..core.tables import TableSpec, get_table, table_lookup

__all__ = ["lut_activation_ref", "apply_table", "lut_activation_plain",
           "lut_gated_mul_ref", "lut_gated_mul_plain", "quantize_rows_ref",
           "qmatmul_ref", "flash_attention_ref", "flash_attention_plain",
           "paged_attention_ref",
           "paged_attention_split_ref", "combine_splits",
           "sample_tokens_ref", "verify_tokens_ref"]

_NEG = -1e30


def lut_activation_ref(x: torch.Tensor, spec: TableSpec) -> torch.Tensor:
    """Table-lookup activation: gather from a build-time constant table."""
    return table_lookup(x, get_table(spec).values(x.device), spec.lo,
                        spec.hi, spec.indexing)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` on f32 tensors with one rounding, as a fused
    multiply-add computes it.

    The product of two f32 values is exact in f64.  The f64 sum is made
    round-to-odd (TwoSum gives its exact error; an inexact sum with an
    even last bit steps one ulp towards the exact value), and rounding a
    round-to-odd f64 to f32 is the correctly rounded result, because f64
    carries more than 24 + 1 bits.
    """
    p = a.to(torch.float64) * b.to(torch.float64)
    c64 = c.to(torch.float64)
    s = p + c64
    t = s - p
    err = (p - (s - t)) + (c64 - t)
    even = (s.view(torch.int64) & 1) == 0
    step = torch.nextafter(s, torch.where(err > 0, torch.inf, -torch.inf))
    return torch.where((err != 0) & even, step, s).to(torch.float32)


def apply_table(y: torch.Tensor, values: torch.Tensor, *, lo: float,
                step_inv: float, indexing: str,
                gated: bool = False) -> torch.Tensor:
    """The kernels' table gather on an f32 tensor ``y`` (the plain twin of
    ``csrc/apply_table.cuh``): ``pos = (y - lo) * step_inv``, clip,
    ``floor``/round-half-even, one or two gathers, all in f32.  ``interp``
    returns ``y0 * (1 - frac) + y1 * frac`` with the first product fused
    into the add, ``fma(y0, 1 - frac, y1 * frac)``: that is how XLA
    compiles the reference kernel's expression (its interpret mode on the
    CPU), and the port keeps it, so that the plain version, the CUDA
    kernels and ``lut_activation_pallas`` agree bit for bit.
    ``gated=True`` returns ``y * table(y)``."""
    n = values.shape[0]
    pos = (y - lo) * step_inv
    if indexing == "interp":
        pos = torch.clamp(pos, 0.0, n - 1.0)
        i0f = torch.floor(pos)
        frac = pos - i0f
        i0 = i0f.to(torch.int64)
        i1 = torch.clamp_max(i0 + 1, n - 1)
        z = fma_f32(values[i0], 1.0 - frac, values[i1] * frac)
    else:
        r = torch.round(pos) if indexing == "nearest" else torch.floor(pos)
        z = values[torch.clamp(r, 0, n - 1).to(torch.int64)]
    return y * z if gated else z


def lut_activation_plain(x: torch.Tensor, spec: TableSpec) -> torch.Tensor:
    """The plain version of the ``lut_activation`` kernel (TPU
    ``lut_activation_pallas``): :func:`apply_table` in f32, the result
    cast to ``x``'s dtype."""
    z = apply_table(x.to(torch.float32), get_table(spec).values(x.device),
                    lo=spec.lo, step_inv=1.0 / spec.step,
                    indexing=spec.indexing)
    return z.to(x.dtype)


def lut_gated_mul_ref(g: torch.Tensor, up: torch.Tensor,
                      spec: TableSpec) -> torch.Tensor:
    """The gated MLP's table pass as the reference computes it: its
    ``act_fn`` (``x * lut_activation_ref(x)`` cast to ``x``'s dtype), then
    the product with ``up`` (``repro.nn.blocks.mlp_apply``)."""
    return (g * lut_activation_ref(g, spec)).to(g.dtype) * up


def lut_gated_mul_plain(g: torch.Tensor, up: torch.Tensor,
                        spec: TableSpec) -> torch.Tensor:
    """The plain version of the ``lut_gated_mul`` kernel: the chain the
    card ran before the kernel existed, :func:`lut_activation_plain` (the
    table in ``g``'s dtype), ``g * T(g)`` cast to ``g``'s dtype, ``* up``;
    each product one rounding in that dtype."""
    return (g * lut_activation_plain(g, spec)).to(g.dtype) * up


def quantize_rows_ref(x: torch.Tensor, qtype: FixedPointType):
    """Per-row dynamic quantization of ``x`` (T, K), as the reference's
    ``_int8_matmul`` does it: in f32, ``calibrate_scale`` over each row,
    then ``clamp(round(x / s))`` cast to the storage type.  Returns
    ``(q, s)`` with ``s`` of shape (T, 1).  Also the plain version of the
    ``quantize_rows`` kernel."""
    x2 = x.to(torch.float32)
    s = calibrate_scale(x2, qtype, channel_axes=(0,))
    q = torch.clamp(torch.round(x2 / s), qtype.int_min, qtype.int_max)
    return q.to(qtype.dtype), s


def int8_matmul_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32, exactly.

    Neither CPU nor CUDA PyTorch offers a general int32 matmul, so the
    product runs in float64: every partial sum is an integer below
    2**53 (|a*b| <= 2**14, K << 2**39), hence exact, and the cast back
    recovers the int32 accumulator bit for bit.
    """
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.int32)


def qmatmul_ref(a_data: torch.Tensor, b_data: torch.Tensor,
                a_scale, b_scale, bias: Optional[torch.Tensor] = None,
                out_dtype=torch.float32, *,
                act_spec: Optional[TableSpec] = None,
                act_gated: bool = False) -> torch.Tensor:
    """int8 x int8 -> int32 -> ``acc.f32 * sa * sb`` (+ bias) (-> LUT).

    With a bias the last product and the sum round once,
    ``fma(acc * sa, sb, bias)``, as XLA compiles ``qmatmul_pallas``'s
    epilogue (bitwise its interpret mode); the reference's
    ``qmatmul_ref`` rounds twice, an ulp away at most.

    ``a_scale`` broadcasts as (M, 1) or scalar, ``b_scale`` as (1, N) or
    scalar; ``act_gated`` gives ``y * table(y)``.  The table epilogue
    indexes as the kernels do (:func:`apply_table`, as
    ``repro.kernels.qmatmul.qmatmul_pallas``), not as the reference's
    ``qmatmul_ref`` (``/ step``): the two differ only at a step that is
    not a power of two.
    """
    dev = a_data.device
    acc = int8_matmul_exact(a_data, b_data)
    sa = torch.as_tensor(a_scale, dtype=torch.float32, device=dev)
    sb = torch.as_tensor(b_scale, dtype=torch.float32, device=dev)
    y = acc.to(torch.float32) * sa
    if bias is None:
        y = y * sb
    else:
        # XLA compiles the reference kernel's ``acc * sa * sb + bias`` as
        # ``fma(acc * sa, sb, bias)``; the CUDA kernel's __fmaf_rn too
        y = fma_f32(y, sb, torch.as_tensor(bias, dtype=torch.float32,
                                           device=dev).reshape(1, -1))
    if act_spec is not None:
        y = apply_table(y, get_table(act_spec).values(dev), lo=act_spec.lo,
                        step_inv=1.0 / act_spec.step,
                        indexing=act_spec.indexing, gated=act_gated)
    return y.to(out_dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Plain attention oracle with f32 softmax (the reference's
    ``flash_attention_ref``): q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D) with
    Hq % Hkv == 0; the queries are the last Sq positions of the context,
    masked with ``-inf`` (a row that sees no key comes out NaN)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    scale = (softmax_scale if softmax_scale is not None
             else float(1.0 / np.sqrt(d)))
    qg = q.reshape(b, hkv, hq // hkv, sq, d)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        mask = qpos >= torch.arange(skv, device=q.device)[None, :]
        logits = torch.where(mask, logits, -torch.inf)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(torch.float32))
    return out.reshape(b, hq, sq, v.shape[-1]).to(q.dtype)


#: the flash kernel's K/V tile (rows per online-softmax update)
FLASH_BK = 64


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          softmax_scale: Optional[float] = None
                          ) -> torch.Tensor:
    """The plain version of the ``flash_attention`` kernel (TPU
    ``flash_attention_pallas``): the online softmax over K/V tiles of
    :data:`FLASH_BK` rows, vectorised over batch, heads and every query
    row.  ``q.f32 * scale`` before the product; a position is visible
    when ``kpos < Skv`` and, causal, ``q_off + i >= kpos`` with ``q_off =
    Skv - Sq``; masked logits are ``-1e30`` and their ``p`` 0; ``l`` is
    floored at ``1e-30``, so a row that sees no key gives 0, not NaN.
    The kernel skips whole tiles that no query of its tile sees; for
    those rows such a tile is an exact no-op of the update here.  The
    output is in q's dtype.  It is the plain version of both kernels: the
    f32 CUDA-core kernel, and the bf16 tensor-core kernel, which feeds p
    to ``p.v`` as three bf16 terms that sum to the f32 p."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    scale = (softmax_scale if softmax_scale is not None
             else float(1.0 / np.sqrt(d)))
    dev = q.device
    qf = q.reshape(b, hkv, hq // hkv, sq, d).to(torch.float32) * scale
    qpos = (skv - sq) + torch.arange(sq, device=dev)[:, None]      # (Sq, 1)
    m = torch.full((b, hkv, hq // hkv, sq, 1), _NEG, dtype=torch.float32,
                   device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, hq // hkv, sq, v.shape[-1]),
                      dtype=torch.float32, device=dev)
    for k0 in range(0, skv, FLASH_BK):
        kt = k[:, :, k0:k0 + FLASH_BK].to(torch.float32)
        vt = v[:, :, k0:k0 + FLASH_BK].to(torch.float32)
        logits = torch.einsum("bhgqd,bhkd->bhgqk", qf, kt)
        if causal:
            mask = qpos >= k0 + torch.arange(kt.shape[2], device=dev)
            logits = torch.where(mask, logits, _NEG)
        m_new = torch.maximum(m, torch.amax(logits, dim=-1, keepdim=True))
        p = torch.exp(logits - m_new)
        if causal:
            p = torch.where(mask, p, 0.0)
        alpha = torch.exp(m - m_new)
        l = alpha * l + torch.sum(p, dim=-1, keepdim=True)
        acc = alpha * acc + torch.einsum("bhgqk,bhkd->bhgqd", p, vt)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)
    return out.reshape(b, hq, sq, v.shape[-1]).to(q.dtype)


def combine_splits(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor):
    """Log-sum-exp merge of per-partition online-softmax partials.

    ``acc`` (split, ..., rows, d), ``m``/``l`` (split, ..., rows, 1).
    Dead partitions (``m = -1e30, l = 0``) weigh exactly 0.  The same
    formula as ``repro.kernels.flash_attention.combine_splits``.
    """
    m_star = torch.amax(m, dim=0)
    alpha = torch.exp(m - m_star[None])
    l_star = torch.sum(alpha * l, dim=0)
    acc_star = torch.sum(alpha * acc, dim=0)
    return acc_star, m_star, l_star


def _fold(q: torch.Tensor, hkv: int) -> torch.Tensor:
    """(B, Hq, S, D) -> (B, Hkv, group*S, D), query heads group-major."""
    b, hq, s, d = q.shape
    return q.reshape(b, hkv, hq // hkv, s, d).reshape(b, hkv, hq // hkv * s, d)


def paged_attention_split_ref(q, k_pages, v_pages, block_tables, qpos, *,
                              softmax_scale: Optional[float] = None,
                              kv_split: int = 1,
                              pages_per_step: int = 1) -> torch.Tensor:
    """Split-KV flash decoding, op for op (the split kernel's oracle).

    The table is padded to ``split * nt * t`` entries pointing at page 0
    (always masked), cut into ``split`` partitions of ``nt`` tiles of
    ``t`` pages; each partition runs the online ``(m, l, acc)`` update
    per tile under the ``-1e30`` mask, and :func:`combine_splits` merges
    them.  Vectorised over batch, KV heads and partitions (the reference
    loops over them in Python); the per-element arithmetic is the same.
    """
    b, hq, s, d = q.shape
    _, hkv, ps, _ = k_pages.shape
    np_ = block_tables.shape[1]
    assert hq % hkv == 0
    rows = hq // hkv * s
    scale = (softmax_scale if softmax_scale is not None
             else float(1.0 / np.sqrt(d)))
    dev = q.device

    t = max(1, min(int(pages_per_step), np_))
    tiles = -(-np_ // t)
    split = max(1, min(int(kv_split), tiles))
    nt = -(-tiles // split)
    np_pad = split * nt * t
    bt = block_tables.to(torch.int64)
    if np_pad > np_:
        bt = torch.nn.functional.pad(bt, (0, np_pad - np_))
    bt = bt.reshape(b, split, nt, t)
    qf = _fold(q, hkv).to(torch.float32) * scale            # (B, H, R, D)
    qp = (qpos.to(torch.int64)[:, None]
          + torch.arange(rows, device=dev) % s)             # (B, R)
    heads = torch.arange(hkv, device=dev)

    m = torch.full((b, split, hkv, rows, 1), _NEG, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, split, hkv, rows, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, split, hkv, rows, d), dtype=torch.float32,
                      device=dev)
    for it in range(nt):
        idx = bt[:, :, it]                                   # (B, S, t)
        # (B, S, t, H, ps, D) -> (B, S, H, t*ps, D)
        k = k_pages[idx[..., None], heads].permute(0, 1, 3, 2, 4, 5) \
            .reshape(b, split, hkv, t * ps, d).to(torch.float32)
        v = v_pages[idx[..., None], heads].permute(0, 1, 3, 2, 4, 5) \
            .reshape(b, split, hkv, t * ps, d).to(torch.float32)
        logits = torch.einsum("bhrd,bshkd->bshrk", qf, k)
        base = (torch.arange(split, device=dev) * nt + it) * t * ps
        kvpos = base[:, None] + torch.arange(t * ps, device=dev)[None, :]
        mask = kvpos[None, :, None, None, :] <= qp[:, None, None, :, None]
        logits = torch.where(mask, logits, _NEG)
        m_new = torch.maximum(m, torch.amax(logits, dim=-1, keepdim=True))
        p = torch.exp(logits - m_new)
        p = torch.where(mask, p, 0.0)
        alpha = torch.exp(m - m_new)
        l = alpha * l + torch.sum(p, dim=-1, keepdim=True)
        acc = alpha * acc + torch.einsum("bshrk,bshkd->bshrd", p, v)
        m = m_new
    acc_star, _, l_star = combine_splits(acc.transpose(0, 1),
                                         m.transpose(0, 1),
                                         l.transpose(0, 1))
    out = acc_star / torch.clamp_min(l_star, 1e-30)
    return out.to(q.dtype).reshape(b, hkv, hq // hkv, s, d).reshape(b, hq, s, d)


def paged_attention_ref(q, k_pages, v_pages, block_tables, qpos, *,
                        softmax_scale: Optional[float] = None,
                        kv_split: Optional[int] = None,
                        pages_per_step: Optional[int] = None) -> torch.Tensor:
    """Block-table-indexed attention (decode S == 1, chunked prefill S > 1).

    q (B, Hq, S, D); pages (P, Hkv, page_size, D); block_tables (B, NP);
    qpos (B,) -- query row ``i`` of batch ``b`` sits at ``qpos[b] + i``
    and sees kv positions ``<= qpos[b] + i`` (write-before-attend).
    Masked positions use a finite ``-1e30``.  Knobs > 1 route through
    :func:`paged_attention_split_ref`, as in the reference.
    """
    if (kv_split or 1) > 1 or (pages_per_step or 1) > 1:
        return paged_attention_split_ref(
            q, k_pages, v_pages, block_tables, qpos,
            softmax_scale=softmax_scale, kv_split=kv_split or 1,
            pages_per_step=pages_per_step or 1)
    b, hq, s, d = q.shape
    _, hkv, ps, _ = k_pages.shape
    np_ = block_tables.shape[1]
    group = hq // hkv
    assert hq % hkv == 0
    scale = (softmax_scale if softmax_scale is not None
             else 1.0 / np.sqrt(d))
    dev = q.device
    bt = block_tables.to(torch.int64)

    def gather(pages):                       # (P, Hkv, ps, D) -> contiguous
        g = pages[bt]                        # (B, NP, Hkv, ps, D)
        return g.permute(0, 2, 1, 3, 4).reshape(b, hkv, np_ * ps,
                                                pages.shape[-1])

    k = gather(k_pages).to(torch.float32)
    v = gather(v_pages).to(torch.float32)
    qg = q.reshape(b, hkv, group, s, d).to(torch.float32)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k) * scale
    kvpos = torch.arange(np_ * ps, device=dev)[None, None, :]
    visible = kvpos <= (qpos.to(torch.int64)[:, None]
                        + torch.arange(s, device=dev)[None, :])[:, :, None]
    logits = torch.where(visible[:, None, None], logits, _NEG)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", w, v)
    return out.reshape(b, hq, s, v.shape[-1]).to(q.dtype)


def sample_tokens_ref(logits: torch.Tensor, temperature=None, top_k=None,
                      key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-sampling oracle: (B, V) logits -> (B,) int32 ids.

    The reference's ``sample_tokens_ref`` op for op (its ``k_eff`` form):
    greedy first-argmax when ``key`` is None; else the rank of each logit
    by two stable argsorts, candidates ``rank < k_eff`` (``k_eff`` the
    clipped ``top_k``, or V when ``top_k <= 0``), logits over
    ``max(temperature, 1e-6)`` plus the shared threefry Gumbel noise,
    and the perturbed argmax where ``temperature > 0``.  It matches
    :func:`repro_torch.kernels.sampling.sample_tokens_fused` exactly,
    ties included (both draw the same noise and rank the same way).
    """
    from .sampling import gumbel_noise, slot_params
    logits = logits.to(torch.float32)
    b, v = logits.shape
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if key is None:
        return greedy
    temperature, top_k = slot_params(temperature, top_k, b, logits.device)
    # rank 0 = the largest logit in its row; candidate iff rank < k
    order = torch.argsort(-logits, dim=-1, stable=True)             # (B, V)
    ranks = torch.argsort(order, dim=-1, stable=True)               # (B, V)
    k_eff = torch.where(top_k > 0, torch.clamp(top_k, 1, v), v)
    candidate = ranks < k_eff[:, None]
    temp = torch.clamp_min(temperature, 1e-6)[:, None]
    perturbed = torch.where(candidate, logits / temp, -torch.inf) \
        + gumbel_noise(key, (b, v))
    sampled = torch.argmax(perturbed, dim=-1).to(torch.int32)
    return torch.where(temperature > 0, sampled, greedy)


def verify_tokens_ref(logits: torch.Tensor, draft: torch.Tensor,
                      temperature=None, top_k=None,
                      key: Optional[torch.Tensor] = None):
    """Draft-verification oracle: (B, S, V) x (B, S - 1) -> (next_token,
    n_advance), int32; the reference's ``verify_tokens_ref`` op for op.

    Like :func:`sample_tokens_ref` it shares the stochastic pieces with
    the fused lowering (the noise of
    :func:`~repro_torch.kernels.speculative.verify_noise`, ranks by two
    stable argsorts, the temperature floor, the softmax), so the two agree
    bit for bit; what it derives on its own is the composition: an
    explicit loop over positions carrying the "chain still alive" flag
    (the fused one takes a cumulative product), per-position residual
    masking and the commit selection.
    """
    from .sampling import slot_params
    from .speculative import verify_noise
    logits = logits.to(torch.float32)
    b, s, v = logits.shape
    k = s - 1
    draft = draft.to(torch.int64)
    lane = torch.arange(b, device=logits.device)
    greedy_t = torch.argmax(logits, dim=-1).to(torch.int32)
    if key is None:
        accept = draft == greedy_t[:, :k]
        t_full = greedy_t
    else:
        temperature, top_k = slot_params(temperature, top_k, b,
                                         logits.device)
        order = torch.argsort(-logits, dim=-1, stable=True)
        ranks = torch.argsort(order, dim=-1, stable=True)
        k_eff = torch.where(top_k > 0, torch.clamp(top_k, 1, v), v)
        candidate = ranks < k_eff[:, None, None]
        temp = torch.clamp_min(temperature, 1e-6)[:, None, None]
        scaled = torch.where(candidate, logits / temp, -torch.inf)
        probs = torch.softmax(scaled, dim=-1)
        u, g_resample, g_bonus = verify_noise(key, b, k, v)
        vocab = torch.arange(v, device=logits.device)[None, :]
        cols, accepts = [], []
        for j in range(k):
            accepts.append(u[:, j] < probs[lane, j, draft[:, j]])
            res = torch.where(vocab == draft[:, j, None], -torch.inf,
                              scaled[:, j])
            cols.append(torch.argmax(res + g_resample[:, j], dim=-1))
        bonus = torch.argmax(scaled[:, k] + g_bonus, dim=-1)
        t_sampled = torch.stack(cols + [bonus], dim=1).to(torch.int32)
        is_greedy = (temperature <= 0)[:, None]
        accept = torch.where(is_greedy, draft == greedy_t[:, :k],
                             torch.stack(accepts, dim=1))
        t_full = torch.where(is_greedy, greedy_t, t_sampled)
    alive = torch.ones((b,), dtype=torch.bool, device=logits.device)
    n_accept = torch.zeros((b,), dtype=torch.int64, device=logits.device)
    for j in range(k):
        alive = alive & accept[:, j]
        n_accept = n_accept + alive.to(torch.int64)
    next_token = torch.gather(t_full, 1, n_accept[:, None])[:, 0]
    return next_token, (n_accept + 1).to(torch.int32)
