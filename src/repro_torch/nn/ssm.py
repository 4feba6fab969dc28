"""Mamba-2 (SSD, state-space duality) blocks: the chunked whole-sequence
path and the O(1)-state decode step (port of ``repro.nn.ssm``).

The chunked SSD algorithm (Dao & Gu, arXiv:2405.21060) splits the
sequence into chunks of ``Q`` tokens: inside a chunk the recurrence is an
attention-like quadratic form, and across chunks a state of (P heads, N
state, hd head-dim) is carried.  The reference leaves every product here
to XLA (``jnp.einsum`` and an ``associative_scan``; no Pallas kernel), so
the port runs them as PyTorch ops:

* every three-operand ``einsum`` of the reference is written as a
  pairwise product in a fixed order (``torch.einsum`` contracts from the
  left without ``opt_einsum``), and the order never builds a
  ``(B, c, i, j, p, h)`` intermediate;
* the cross-chunk ``associative_scan`` is a loop over chunks,
  ``h_c = g_c * h_{c-1} + s_c``.

:func:`ssd_scan` and :func:`decode_state_step` are those parts, between
the two projections, so that they can be timed apart.

The state recurrence runs in float32 under every quantization mode; the
in/out projections are ordinary quantizable linears (``qmatmul`` under
int8) and ``dt``, the conv output and the gate go through the LUT
softplus / silu under ``ctx.use_lut``.

The decode state is written **in place** (``copy_``), as every serving
cache of the port is: a captured decode graph reads the tensors it was
captured with.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..dist.constrain import constrain
from .activations import act_fn
from .context import DEFAULT_CTX, QuantContext
from .linear import linear, linear_init
from .norms import rmsnorm

__all__ = ["SSMDims", "mamba2_init", "mamba2_apply", "mamba2_decode_step",
           "mamba2_state_spec", "ssd_scan", "decode_state_step"]


@dataclasses.dataclass(frozen=True)
class SSMDims:
    d_model: int
    d_state: int = 128          # N
    head_dim: int = 64          # hd
    expand: int = 2
    n_groups: int = 1           # G (B/C parameter groups)
    d_conv: int = 4
    chunk: int = 256            # Q, the SSD chunk length

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


def mamba2_init(gen: torch.Generator, d: SSMDims, *, dtype=torch.float32,
                device="cpu"):
    """Random parameters from ``gen`` with the reference's distributions
    (``A_log``, ``D`` and ``dt_bias`` f32 whatever ``dtype``)."""
    di, ph = d.d_inner, d.n_heads
    in_dim = 2 * di + 2 * d.n_groups * d.d_state + ph
    f32 = dict(dtype=torch.float32, device=device)
    conv_w = torch.randn((d.d_conv, d.conv_dim), generator=gen, **f32) * 0.1
    return {
        "in_proj": linear_init(gen, d.d_model, in_dim, dtype=dtype,
                               device=device),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((d.conv_dim,), dtype=dtype, device=device),
        "A_log": torch.zeros((ph,), **f32),             # A = -exp(A_log)
        "D": torch.ones((ph,), **f32),
        "dt_bias": torch.zeros((ph,), **f32),
        "norm": {"scale": torch.ones((di,), dtype=dtype, device=device)},
        "out_proj": linear_init(gen, di, d.d_model, dtype=dtype,
                                device=device),
    }


def mamba2_state_spec(d: SSMDims, batch: int, device="cpu"):
    """Decode state: the depthwise conv's window and the SSM state, f32."""
    f32 = dict(dtype=torch.float32, device=device)
    return {"conv": torch.zeros((batch, d.d_conv - 1, d.conv_dim), **f32),
            "ssm": torch.zeros((batch, d.n_heads, d.d_state, d.head_dim),
                               **f32)}


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor) -> torch.Tensor:
    """x (B, S, C), w (K, C): depthwise causal conv along S, tap by tap."""
    k, s = w.shape[0], x.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i:i + s] * w[i]
    return out + b


def _split_zxbcdt(zxbcdt: torch.Tensor, d: SSMDims):
    di, gn = d.d_inner, d.n_groups * d.d_state
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * gn],
            zxbcdt[..., 2 * di + 2 * gn:])


def _heads(xbc: torch.Tensor, d: SSMDims):
    """(..., conv_dim) -> x (..., P, hd), B and C (..., P, N), f32; the B/C
    groups repeated over their heads."""
    ph, hd, n, g = d.n_heads, d.head_dim, d.d_state, d.n_groups
    lead = xbc.shape[:-1]
    xh = xbc[..., :d.d_inner].reshape(*lead, ph, hd).to(torch.float32)

    def per_head(t):                    # (..., G * N) -> (..., P, N)
        t = t.reshape(*lead, g, 1, n).expand(*lead, g, ph // g, n)
        return t.reshape(*lead, ph, n).to(torch.float32)
    return (xh, per_head(xbc[..., d.d_inner:d.d_inner + g * n]),
            per_head(xbc[..., d.d_inner + g * n:]))


def _gate_out(p, y: torch.Tensor, z: torch.Tensor, x_dtype, ctx, path):
    """Gated RMSNorm, then the output projection."""
    y = rmsnorm(p["norm"], y * act_fn("silu", z.to(torch.float32), ctx,
                                      path=f"{path}/gate"))
    return linear(p["out_proj"], y.to(x_dtype), ctx, path=f"{path}/out_proj")


def ssd_scan(p, xbc_raw: torch.Tensor, dt_raw: torch.Tensor, d: SSMDims,
             ctx: QuantContext = DEFAULT_CTX, *, path: str = "ssm",
             initial_state: Optional[torch.Tensor] = None):
    """The chunked SSD of one layer, what the reference leaves to XLA
    between the two projections: the causal conv, the intra-chunk
    quadratic form, the chunk states and the cross-chunk recurrence.
    xbc_raw (B, S, conv_dim), dt_raw (B, S, P) -> (y (B, S, d_inner) before
    the gate, the final SSM state (B, P, N, hd))."""
    bsz, s, _ = xbc_raw.shape
    q = min(d.chunk, s)
    assert s % q == 0, (s, q)
    nc = s // q
    ph, hd = d.n_heads, d.head_dim
    f32 = torch.float32
    xbc = act_fn("silu", _causal_depthwise_conv(
        xbc_raw.to(f32), p["conv_w"].to(f32), p["conv_b"].to(f32)), ctx,
        path=f"{path}/conv_act")
    xh, b_, c_ = _heads(xbc, d)                    # (B,S,P,hd), (B,S,P,N)
    # TP over SSD heads under a mesh: every einsum below is elementwise in P
    xh, b_, c_ = (constrain(t, "dp", None, "tp", None) for t in (xh, b_, c_))
    dt = act_fn("softplus", dt_raw.to(f32) + p["dt_bias"], ctx,
                path=f"{path}/dt")                  # (B,S,P)
    da = dt * -torch.exp(p["A_log"])

    def ch(t):                                      # (B, S, ...) -> chunks
        return t.reshape(bsz, nc, q, *t.shape[2:])
    xh_c, b_c, c_c, dt_c, da_c = map(ch, (xh, b_, c_, dt, da))
    ca = torch.cumsum(da_c, dim=2)                  # (B,nc,Q,P)

    # intra-chunk: att[i, j] = (C_i . B_j) exp(ca_i - ca_j) dt_j, i >= j.
    # The exponent is masked before the exp, not after: for i < j it is
    # a sum of up to Q positive dt |A| terms, past f32's exp range in a
    # long chunk (mamba2's dt ~0.69 at Q 256 sums to ~177), and
    # where(mask, scores * inf, 0) is 0 forward but 0 * inf = NaN in
    # its backward.  The reference exps first (src/repro/nn/ssm.py:154)
    # and its gradients are NaN there; the values here are the same.
    scores = torch.einsum("bcipn,bcjpn->bcijp", c_c, b_c)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                 device=xbc.device))[None, None, :, :, None]
    decay = torch.exp(torch.where(
        mask, ca[:, :, :, None, :] - ca[:, :, None, :, :], -math.inf))
    att = torch.where(mask, scores * decay, 0.0)
    y_intra = torch.einsum("bcijp,bcjph->bciph", att * dt_c[:, :, None],
                           xh_c)

    # chunk states
    decay_out = torch.exp(ca[:, :, -1:, :] - ca)    # (B,nc,Q,P)
    s_c = torch.einsum("bcjpn,bcjph->bcpnh",
                       b_c * (dt_c * decay_out)[..., None], xh_c)

    # cross-chunk recurrence h_c = g_c h_{c-1} + s_c, from the seed
    g_c = torch.exp(ca[:, :, -1, :])[..., None, None]   # (B,nc,P,1,1)
    h = (torch.zeros_like(s_c[:, 0]) if initial_state is None
         else initial_state.to(f32))
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = g_c[:, c] * h + s_c[:, c]
    h_prev = torch.stack(h_prev, dim=1)             # (B,nc,P,N,hd)

    y_inter = torch.einsum("bcipn,bcpnh->bciph",
                           c_c * torch.exp(ca)[..., None], h_prev)
    y = (y_intra + y_inter).reshape(bsz, s, ph, hd)
    y = y + p["D"][None, None, :, None] * xh
    return y.reshape(bsz, s, d.d_inner), h


def mamba2_apply(p, x: torch.Tensor, d: SSMDims,
                 ctx: QuantContext = DEFAULT_CTX, *, path: str = "ssm",
                 initial_state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, dict]:
    """Whole-sequence SSD.  x (B, S, Dm) with S % chunk == 0 (or S <
    chunk).  Returns (y, final state {"conv", "ssm"}), the state that
    seeds decode."""
    zxbcdt = linear(p["in_proj"], x, ctx, path=f"{path}/in_proj")
    z, xbc_raw, dt = _split_zxbcdt(zxbcdt, d)
    conv_tail = xbc_raw[:, -(d.d_conv - 1):]       # the decode window seed
    if conv_tail.shape[1] < d.d_conv - 1:          # a prompt shorter than it
        conv_tail = torch.nn.functional.pad(
            conv_tail, (0, 0, d.d_conv - 1 - conv_tail.shape[1], 0))
    y, h = ssd_scan(p, xbc_raw, dt, d, ctx, path=path,
                    initial_state=initial_state)
    out = _gate_out(p, y, z, x.dtype, ctx, path)
    return out, {"conv": conv_tail.to(torch.float32), "ssm": h}


def decode_state_step(p, xbc: torch.Tensor, dt_raw: torch.Tensor, state,
                      d: SSMDims, ctx: QuantContext = DEFAULT_CTX, *,
                      path: str = "ssm") -> torch.Tensor:
    """One token's recurrence, what the reference leaves to XLA between
    the two projections: the conv window shift and tap sum, then the SSM
    state update ``h = exp(dt A) h + dt B x`` and ``y = C h + D x``.
    xbc (B, conv_dim), dt_raw (B, P); ``state`` advanced **in place**.
    Returns y (B, d_inner) before the gate."""
    f32 = torch.float32
    # the new window reads the old one: built apart, then copied in
    window = torch.cat([state["conv"], xbc[:, None].to(state["conv"].dtype)],
                       dim=1)                       # (B, K, C)
    w = p["conv_w"].to(f32)
    conv_out = window[:, 0].to(f32) * w[0]
    for i in range(1, w.shape[0]):
        conv_out = conv_out + window[:, i].to(f32) * w[i]
    conv_out = conv_out + p["conv_b"].to(f32)
    xbc_t = act_fn("silu", conv_out, ctx, path=f"{path}/conv_act")
    xh, b_, c_ = _heads(xbc_t, d)                   # (B,P,hd), (B,P,N)

    dt = act_fn("softplus", dt_raw.to(f32) + p["dt_bias"], ctx,
                path=f"{path}/dt")                  # (B,P)
    ga = torch.exp(dt * -torch.exp(p["A_log"]))[..., None, None]
    upd = (dt[..., None] * b_)[..., None] * xh[:, :, None, :]   # (B,P,N,hd)
    h = ga * state["ssm"].to(f32) + upd
    y = torch.einsum("bpn,bpnh->bph", c_, h)
    y = y + p["D"][None, :, None] * xh
    state["conv"].copy_(window[:, 1:])
    state["ssm"].copy_(h)
    return y.reshape(xbc.shape[0], d.d_inner)


def mamba2_decode_step(p, x: torch.Tensor, state, d: SSMDims,
                       ctx: QuantContext = DEFAULT_CTX, *,
                       path: str = "ssm") -> torch.Tensor:
    """One token.  x (B, 1, Dm); ``state`` from :func:`mamba2_state_spec`
    (or a layer's view of a stacked one), advanced **in place**.  Returns
    y (B, 1, Dm)."""
    zxbcdt = linear(p["in_proj"], x, ctx, path=f"{path}/in_proj")
    z, xbc, dt = _split_zxbcdt(zxbcdt[:, 0], d)     # (B, ...)
    y = decode_state_step(p, xbc, dt, state, d, ctx, path=path)
    return _gate_out(p, y[:, None], z[:, None], x.dtype, ctx, path)
