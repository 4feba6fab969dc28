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

``flags().moe_einsum`` replaces the scatter and the gather by the
reference's one-hot einsums (operands in ``compute_dtype``, f32 sums),
with or without a mesh.  Under a mesh (x a DTensor) the routing, the
slot positions and the scatter run on each rank's batch rows (a batch
row is its own dispatch group, so they are local), the aux loss sums the
ranks' means, the expert FFN runs on DTensors pinned as the reference
pins them (experts on ``model``; ``flags().moe_local`` keeps the
capacity buffer batch-local and sliced per expert shard), and the expert
outputs are gathered over ``model`` once for the combine.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..core.qtypes import QTensor
from ..dist.constrain import constrain, placements_of
from ..dist.options import flags
from ..dist.sharding import is_dtensor
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


def _route_parts(x: torch.Tensor, router: torch.Tensor, d: MoEDims):
    """f32 routing of x (B, S, D): gates (B, S, k), expert ids (B, S, k)
    int64, and the aux loss's two (E,) means over (B, S): the router's
    probabilities and the choices' one-hot counts."""
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
    return gates, idx, me, ce


def route(x: torch.Tensor, router: torch.Tensor, d: MoEDims):
    """f32 routing of x (B, S, D): (gates (B, S, k), expert ids (B, S, k)
    int64, aux loss ()).  Ties in the top-k go to the lower expert index
    (a stable descending sort), as ``lax.top_k`` breaks them."""
    gates, idx, me, ce = _route_parts(x, router, d)
    return gates, idx, d.n_experts * torch.sum(me * ce)


def _plan(x: torch.Tensor, router: torch.Tensor, d: MoEDims, cap: int):
    """Routing and each (token, choice) slot's place, a batch row one
    dispatch group: (gates (B, T), slot (B, T), keep (B, T), x_slot
    (B, T, D), me, ce); T = S * k."""
    b, s, _ = x.shape
    e, k = d.n_experts, d.top_k
    gates, idx, me, ce = _route_parts(x, router, d)

    # position in expert: a cumsum over the flattened (s, k) slots
    idx_f = idx.reshape(b, s * k)                                  # (B, T)
    onehot = torch.nn.functional.one_hot(idx_f, e)                 # (B,T,E)
    pos = torch.cumsum(onehot, dim=1) - 1
    pos_in_e = torch.gather(pos, 2, idx_f[..., None])[..., 0]
    keep = pos_in_e < cap
    slot = torch.where(keep, idx_f * cap + pos_in_e,
                       torch.full_like(idx_f, e * cap))             # (B, T)
    tok = torch.arange(s, device=x.device).repeat_interleave(k)     # (T,)
    return gates.reshape(b, s * k), slot, keep, x[:, tok], me, ce


def _scatter(x_slot: torch.Tensor, slot: torch.Tensor,
             n_slots: int) -> torch.Tensor:
    """Slot rows into the (B, E * C + 1, D) buffer; every slot but the
    dummy one receives at most one row, so the reference's scatter-add
    into zeros is that row (the dummy slot's content is never read)."""
    b, _, dm = x_slot.shape
    buf = torch.zeros((b, n_slots, dm), dtype=x_slot.dtype,
                      device=x_slot.device)
    lanes = torch.arange(b, device=x_slot.device)[:, None].expand_as(slot)
    buf[lanes, slot] = x_slot
    return buf


def _onehot(slot: torch.Tensor, n_slots: int, cd) -> torch.Tensor:
    return torch.nn.functional.one_hot(slot, n_slots).to(cd)


def _f32_einsum(eq: str, a: torch.Tensor, b: torch.Tensor, cd):
    """``einsum`` of operands rounded to ``cd``, summed in f32 (the
    reference's ``preferred_element_type=f32``)."""
    return torch.einsum(eq, a.to(cd).to(torch.float32),
                        b.to(cd).to(torch.float32))


def _experts(p, xe: torch.Tensor, d: MoEDims, ctx: QuantContext,
             path: str) -> torch.Tensor:
    """The gated expert FFN over (B, E, C, D), banks in compute_dtype."""
    cd = ctx.compute_dtype
    w_gate, w_up, w_down = (
        w.dequantize(cd) if isinstance(w, QTensor) else w.to(cd)
        for w in (p["w_gate"], p["w_up"], p["w_down"]))
    h_g = torch.einsum("becd,edf->becf", xe.to(cd), w_gate)
    h_u = torch.einsum("becd,edf->becf", xe.to(cd), w_up)
    h = act_fn(d.act, h_g, ctx, path=f"{path}/act") * h_u
    return torch.einsum("becf,efd->becd", h.to(cd), w_down)


def _combine(yb: torch.Tensor, slot, gates, keep, onehot, cd,
             s: int, k: int) -> torch.Tensor:
    """Slots back to tokens, weighted by the gate (dropped: 0): yb
    (B, E * C, D) -> y (B, S, D)."""
    b, _, dm = yb.shape
    yb = torch.cat([yb, torch.zeros((b, 1, dm), dtype=yb.dtype,
                                    device=yb.device)], dim=1)
    if onehot is not None:
        y_slot = _f32_einsum("bts,bsd->btd", onehot, yb, cd)
    else:
        y_slot = torch.gather(yb, 1, slot[..., None].expand(b, s * k, dm))
    y_slot = y_slot * (gates[..., None].to(y_slot.dtype)
                       * keep[..., None].to(y_slot.dtype))
    return y_slot.reshape(b, s, k, dm).sum(dim=2)


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
    if is_dtensor(x):
        return _moe_sharded(p, x, d, ctx, path, cap)
    n_slots = e * cap + 1                      # trailing slot = dropped
    cd = ctx.compute_dtype
    gates, slot, keep, x_slot, me, ce = _plan(x, p["router"], d, cap)
    aux = e * torch.sum(me * ce)
    onehot = None
    if flags().moe_einsum:
        onehot = _onehot(slot, n_slots, cd)
        buf = _f32_einsum("bts,btd->bsd", onehot, x_slot, cd).to(x.dtype)
    else:
        buf = _scatter(x_slot, slot, n_slots)
    xe = buf[:, :-1].reshape(b, e, cap, dm)
    ye = _experts(p, xe, d, ctx, path)
    y = _combine(ye.reshape(b, e * cap, dm), slot, gates, keep, onehot, cd,
                 s, k)
    return y.to(x.dtype), aux


def _moe_sharded(p, x, d: MoEDims, ctx: QuantContext, path: str, cap: int):
    """:func:`moe_apply` on DTensors: routing, slots and the scatter on
    each rank's batch rows, the expert FFN on DTensors (experts on
    ``model``), the combine on the rows again after one all-gather of the
    expert outputs over ``model``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = x.device_mesh
    b, s, dm = x.shape
    e, k = d.n_experts, d.top_k
    n_slots = e * cap + 1
    cd = ctx.compute_dtype
    rows = placements_of(x.shape, mesh, "dp")          # batch on dp
    cut = [isinstance(pl, Shard) for pl in rows]
    xl = x.redistribute(mesh, rows).to_local()
    # each rank's rows add their share to the router's gradient
    rl = p["router"].redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=[Partial() if c else Replicate() for c in cut])
    gates, slot, keep, x_slot, me, ce = _plan(xl, rl, d, cap)
    nb = 1
    for m, c in enumerate(cut):
        nb *= mesh.size(m) if c else 1
    part = [Partial() if c else Replicate() for c in cut]
    me, ce = (DTensor.from_local(t / nb, mesh, part, run_check=False)
              for t in (me, ce))
    aux = e * torch.sum(me * ce)

    def sharded(t):
        return DTensor.from_local(t, mesh, rows, run_check=False)

    onehot = None
    if flags().moe_einsum:
        onehot = _onehot(slot, n_slots, cd)
        oh = constrain(sharded(onehot), "dp", None, "tp")
        buf = _f32_einsum("bts,btd->bsd", oh, sharded(x_slot),
                          cd).to(x.dtype)
    else:
        buf = sharded(_scatter(x_slot, slot, n_slots))
        if flags().moe_local:
            buf = constrain(buf, "dp", None, None)
    xe = buf[:, :-1].reshape(b, e, cap, dm)
    if flags().moe_local:
        xe = constrain(xe, "dp", None, None, None)   # sliced per EP shard
    else:
        xe = constrain(xe, "dp", "tp", None, None)   # EP: experts on model
    ye = constrain(_experts(p, xe, d, ctx, path), "dp", "tp", None, None)
    yb = ye.reshape(b, e * cap, dm)
    if flags().moe_local:
        yb = constrain(yb, "dp", None, None)   # one all-gather over model
    ybl = yb.redistribute(mesh, rows).to_local()
    y = _combine(ybl, slot, gates, keep, onehot, cd, s, k)
    return sharded(y.to(x.dtype)), aux

