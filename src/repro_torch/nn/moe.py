"""Mixture-of-Experts FFN: top-k token-choice routing with capacity
dispatch (port of ``repro.nn.moe``, its default scatter dispatch).

* The router runs in f32 whatever the context: softmax, top-k (ties to
  the lower expert index, as ``lax.top_k``), the optional renormalization
  and ``routed_scale``, and the Switch-style load-balancing aux loss.
* Position in expert comes from a cumsum over the flattened (token,
  choice) slots of each batch row; a slot past the expert's capacity is
  *dropped* to a dummy trailing slot of the (E * C + 1, D) buffer, whose
  output is never read back.  Capacity is the capacity factor's when
  training and ``min(S, max(k, ceil(4 S k / E)))`` when serving
  (``dropless``).
* Expert FFNs are the reference's einsums over the banks in
  ``compute_dtype`` (a PTQ'd bank is dequantized per call, as the
  reference does; no kernel of the port runs there), the activation
  through :func:`~repro_torch.nn.activations.act_fn` (the
  ``lut_activation`` kernel under ``ctx.use_lut`` on the card).

The reference's mesh options (``flags().moe_einsum``, ``moe_local``)
come with distribution (ROADMAP.md queue 1, item 18).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..core.qtypes import QTensor
from .activations import act_fn
from .context import DEFAULT_CTX, QuantContext

__all__ = ["MoEDims", "moe_init", "moe_apply", "route"]


@dataclasses.dataclass(frozen=True)
class MoEDims:
    d_model: int
    d_ff: int               # per-expert hidden dim
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    renormalize: bool = True    # deepseek renormalizes top-k gate weights
    act: str = "silu"
    routed_scale: float = 1.0   # deepseek-v2 routed_scaling_factor

    def capacity(self, tokens_per_group: int) -> int:
        c = int(tokens_per_group * self.top_k * self.capacity_factor
                / self.n_experts)
        return max(c, self.top_k)


def moe_init(gen: torch.Generator, d: MoEDims, *, dtype=torch.float32,
             device="cpu"):
    """The router (always f32) and the (E, D, F) / (E, F, D) banks, with
    the reference's scales."""
    e, dm, f = d.n_experts, d.d_model, d.d_ff

    def normal(shape, std):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=device) * std

    return {"router": normal((dm, e), dm ** -0.5),
            "w_gate": normal((e, dm, f), dm ** -0.5).to(dtype),
            "w_up": normal((e, dm, f), dm ** -0.5).to(dtype),
            "w_down": normal((e, f, dm), f ** -0.5).to(dtype)}


def route(x: torch.Tensor, router: torch.Tensor, d: MoEDims):
    """f32 routing of x (B, S, D): (gates (B, S, k), expert ids (B, S, k)
    int64, aux loss ()).  Ties in the top-k go to the lower expert index
    (a stable descending sort), as ``lax.top_k`` breaks them."""
    e, k = d.n_experts, d.top_k
    logits = torch.einsum("bsd,de->bse", x.to(torch.float32), router)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[..., :k], idx[..., :k]
    if d.renormalize:
        gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    gates = gates * d.routed_scale
    me = probs.mean(dim=(0, 1))                                     # (E,)
    ce = torch.nn.functional.one_hot(idx, e).to(torch.float32).sum(2) \
        .mean(dim=(0, 1))
    return gates, idx, e * torch.sum(me * ce)


def moe_apply(p, x: torch.Tensor, d: MoEDims,
              ctx: QuantContext = DEFAULT_CTX, *, path: str = "moe",
              dropless: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y, aux_loss).  The dispatch group is a batch row,
    so capacity is per sequence.  ``dropless`` (serving) raises capacity
    to ``min(S, max(k, ceil(4 S k / E)))``: exact whenever E <= 4 k, 4x
    balance headroom beyond, and at E 160, k 6 a 16-token prefill chunk
    still drops past 6 slots an expert, as the reference does."""
    b, s, dm = x.shape
    e, k = d.n_experts, d.top_k
    cap = min(s, max(k, -(-4 * s * k // e))) if dropless else d.capacity(s)
    gates, idx, aux = route(x, p["router"], d)

    # position in expert: a cumsum over the flattened (s, k) slots
    idx_f = idx.reshape(b, s * k)                                  # (B, T)
    onehot = torch.nn.functional.one_hot(idx_f, e)                 # (B,T,E)
    pos = torch.cumsum(onehot, dim=1) - 1
    pos_in_e = torch.gather(pos, 2, idx_f[..., None])[..., 0]
    keep = pos_in_e < cap
    slot = torch.where(keep, idx_f * cap + pos_in_e,
                       torch.full_like(idx_f, e * cap))             # (B, T)

    # dispatch: slot rows into the (E * C + 1, D) buffer; every slot but
    # the dummy one receives at most one row, so the reference's scatter-
    # add into zeros is that row (the dummy slot's content is never read)
    tok = torch.arange(s, device=x.device).repeat_interleave(k)     # (T,)
    x_slot = x[:, tok]                                              # (B,T,D)
    buf = torch.zeros((b, e * cap + 1, dm), dtype=x.dtype, device=x.device)
    lanes = torch.arange(b, device=x.device)[:, None].expand_as(slot)
    buf[lanes, slot] = x_slot
    xe = buf[:, :-1].reshape(b, e, cap, dm)

    # expert FFN (gated), banks in compute_dtype
    cd = ctx.compute_dtype
    w_gate, w_up, w_down = (
        w.dequantize(cd) if isinstance(w, QTensor) else w.to(cd)
        for w in (p["w_gate"], p["w_up"], p["w_down"]))
    h_g = torch.einsum("becd,edf->becf", xe.to(cd), w_gate)
    h_u = torch.einsum("becd,edf->becf", xe.to(cd), w_up)
    h = act_fn(d.act, h_g, ctx, path=f"{path}/act") * h_u
    ye = torch.einsum("becf,efd->becd", h.to(cd), w_down)

    # combine: slots back to tokens, weighted by the gate (dropped: 0)
    yb = torch.cat([ye.reshape(b, e * cap, dm),
                    torch.zeros((b, 1, dm), dtype=ye.dtype,
                                device=ye.device)], dim=1)
    y_slot = torch.gather(yb, 1, slot[..., None].expand(b, s * k, dm))
    y_slot = y_slot * (gates.reshape(b, s * k, 1).to(y_slot.dtype)
                       * keep[..., None].to(y_slot.dtype))
    y = y_slot.reshape(b, s, k, dm).sum(dim=2)
    return y.to(x.dtype), aux
