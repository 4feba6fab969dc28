"""Draft verification and prompt-lookup drafting for speculative decoding
(port of ``repro.kernels.speculative``).

``verify_tokens_fused`` is the acceptance rule: from the target model's
logits over a drafted block ``[cur, d_1, .., d_k]`` (B, k + 1, V), one
model call, and the k drafts, it decides on the device how many drafts
survive and what the next input token is.  Row ``j`` predicts the token
after ``d_j``, so it judges ``d_{j+1}``.

* ``temperature <= 0``, greedy: ``d_{j+1}`` is accepted iff it is the
  argmax of row ``j``, so the committed stream is the target's argmax
  chain whatever the drafter proposed.
* ``temperature > 0``: rejection sampling against a point-mass proposal
  (every drafter here proposes greedily): accept ``d`` with probability
  ``p(d)`` under the temperature / top-k distribution; on rejection
  draw from ``p`` with the draft's mass removed (Gumbel-max).

The last row never judges a draft: with every draft accepted it supplies
the bonus token, so a round commits between 1 and k + 1 tokens.  The
noise is the reference's, bit for bit ``jax.random``'s bits
(:func:`verify_noise`), and top-k is by rank with the ties of
:mod:`repro_torch.kernels.sampling` (a stable argsort and its inverse
permutation by a scatter).

The reference leaves all of this to XLA (no Pallas kernel), and so does
the port: PyTorch ops on the device that read nothing on the host, so a
block of draft -> verify rounds can be captured in one CUDA graph.
``verify_tokens_fused`` is the ``cuda`` lowering of
``ops.verify_tokens``; :func:`repro_torch.kernels.ref.verify_tokens_ref`
is the ``ref`` one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import prng
from .sampling import gumbel_noise, slot_params

__all__ = ["verify_tokens_fused", "verify_noise", "draft_ngram"]


def verify_noise(key: torch.Tensor, batch: int, k: int, vocab: int):
    """The shared noise of the three stochastic legs: acceptance uniforms
    (B, k), residual-resample Gumbel (B, k, V) and bonus Gumbel (B, V),
    from ``split(key, 3)``, as the reference draws them."""
    ku, kr, kb = prng.split(key, 3)
    u = prng.uniform(ku, (batch, k))
    return u, gumbel_noise(kr, (batch, k, vocab)), gumbel_noise(kb,
                                                                (batch, vocab))


def _topk_restricted(logits: torch.Tensor, top_k: torch.Tensor):
    """(B, S, V) -> bool candidacy: ``rank < clip(top_k, 1, V)`` by a stable
    descending argsort (all of the row when ``top_k <= 0``)."""
    v = logits.shape[-1]
    order = torch.argsort(-logits, dim=-1, stable=True)
    k_eff = torch.clamp(top_k, 1, v).to(torch.int64)
    in_top = (torch.arange(v, device=logits.device)[None, None, :]
              < k_eff[:, None, None]).expand_as(order)
    candidate = torch.zeros_like(in_top).scatter_(-1, order, in_top)
    return candidate | (top_k <= 0)[:, None, None]


def verify_tokens_fused(logits: torch.Tensor, draft: torch.Tensor,
                        temperature=None, top_k=None,
                        key: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, V) logits x (B, S - 1) drafts -> (next_token (B,), n_advance
    (B,) in [1, S]), int32.  ``temperature`` (B,) f32 and ``top_k`` (B,)
    int32 per slot; ``key`` may be None only when every slot is greedy."""
    logits = logits.to(torch.float32)
    b, s, v = logits.shape
    k = s - 1
    draft = draft.to(torch.int64)
    greedy_t = torch.argmax(logits, dim=-1).to(torch.int32)          # (B, S)
    if key is None:
        accept = draft == greedy_t[:, :k]
        t_full = greedy_t
    else:
        temperature, top_k = slot_params(temperature, top_k, b,
                                         logits.device)
        restricted = _topk_restricted(logits, top_k)
        temp = torch.clamp_min(temperature, 1e-6)[:, None, None]
        scaled = torch.where(restricted, logits / temp, -torch.inf)
        probs = torch.softmax(scaled, dim=-1)
        u, g_resample, g_bonus = verify_noise(key, b, k, v)
        p_draft = torch.gather(probs[:, :k], -1, draft[..., None])[..., 0]
        accept_s = u < p_draft
        # the residual max(0, p - q) with a point-mass q: p without the
        # draft token, drawn by Gumbel-max over the restricted logits
        res_logits = scaled[:, :k].scatter(-1, draft[..., None], -torch.inf)
        resample = torch.argmax(res_logits + g_resample, dim=-1)
        bonus = torch.argmax(scaled[:, k] + g_bonus, dim=-1)
        t_sampled = torch.cat([resample, bonus[:, None]], dim=1) \
            .to(torch.int32)
        is_greedy = (temperature <= 0)[:, None]
        accept = torch.where(is_greedy, draft == greedy_t[:, :k], accept_s)
        t_full = torch.where(is_greedy, greedy_t, t_sampled)
    # committed drafts: the leading run of accepts
    n_accept = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1)
    next_token = torch.gather(t_full, 1, n_accept[:, None])[:, 0]
    return next_token, (n_accept + 1).to(torch.int32)


def draft_ngram(hist: torch.Tensor, tok: torch.Tensor, pos: torch.Tensor,
                k: int, ngram: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draft ``k`` tokens per slot by prompt lookup over ``hist``.

    ``hist`` (B, H) int32 holds each slot's committed tokens at their
    absolute positions; ``tok`` (B, 1) is the current token at ``pos``
    (B,).  The current token is written into (a copy of) ``hist``, then
    the most recent earlier window equal to the trailing ``ngram`` tokens
    is found and its k-token continuation proposed; a slot with no match
    (or too short a history) repeats the current token.  Returns
    ``(drafts (B, k) int32, hist)``.
    """
    b, h = hist.shape
    lane = torch.arange(b, device=hist.device)
    pos = pos.to(torch.int64)
    hist = hist.index_put((lane, pos), tok[:, 0].to(hist.dtype))
    # the window ending at t matches the one ending at pos iff
    # hist[t - i] == hist[pos - i] for all i < ngram
    match = torch.ones((b, h), dtype=torch.bool, device=hist.device)
    for i in range(ngram):
        ref = hist[lane, torch.clamp_min(pos - i, 0)]
        shifted = F.pad(hist, (i, 0))[:, :h]                     # hist[t - i]
        match = match & (shifted == ref[:, None])
    t_arr = torch.arange(h, device=hist.device)[None, :]
    valid = ((t_arr >= ngram - 1) & (t_arr + k <= pos[:, None])
             & (pos[:, None] >= ngram))
    best = torch.amax(torch.where(match & valid, t_arr, -1), dim=1)
    found = best >= 0
    idx = torch.clamp(torch.where(found, best, 0)[:, None] + 1
                      + torch.arange(k, device=hist.device)[None, :], 0, h - 1)
    cont = torch.gather(hist, 1, idx)
    drafts = torch.where(found[:, None], cont, tok.expand(b, k))
    return drafts.to(torch.int32), hist
