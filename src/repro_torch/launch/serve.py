"""Serving engine: batched chunked prefill, the fused decode block (greedy
or sampled) and continuous batching over a dense or paged KV cache (port
of the core of ``repro.launch.serve``).

* **Weights are quantized once** (``--quant int8``): :func:`quantize_for_serving`
  runs ``ptq_params`` before serving; every projection then runs the
  ``qmatmul`` kernel on int8 payloads.
* **The paper's tables** (``--lut``): activations go through the
  ``lut_activation`` kernel (or, on int8 projections, the ``qmatmul``
  kernel's fused bias + table epilogue) and the attention softmax of the
  dense and int8 caches through the exp/invert tables.
* **Batched chunked prefill**: admitted prompts advance together, one
  full-batch model call per ``prefill_chunk`` tokens.  Lanes that are
  still generating keep their position; their chunk writes land at or
  past it (never attended before decode overwrites them) or on the trash
  page.  The recurrent families (``ssm``, ``hybrid``) rebuild their state
  from one call's tokens, so they take the **looped prefill** instead, as
  the reference: one full-batch decode step per prompt token, slot by
  slot, every other lane's state put back afterwards
  (``models.api.merge_slot_fn``).
* **Device-resident decode**: ``step_many(n)`` runs ``n`` steps whose
  tokens, positions, live mask, fault lane and draws stay on the card,
  with one host sync per block.  On the card each block is one CUDA
  graph replay (one graph per block length and greedy/sampled, captured
  after one eager block; ``graphs=False`` runs it eagerly), the
  counterpart of the reference's single jitted ``lax.scan``.
* **Sampled streams**: per-slot ``temperature`` (<= 0 greedy) and
  ``top_k`` (<= 0 unrestricted), as the reference: step ``i`` of the
  engine's life draws threefry Gumbel noise from ``fold_in(PRNGKey(seed),
  i)``, bit for bit ``jax.random``'s, so a block split never changes a
  stream.  An all-greedy batch skips the sorts and the noise.
* **Speculative decoding** (``spec=True``): each block runs ``n``
  draft -> verify rounds (``train.step.build_spec_decode_loop``): ``spec_k``
  drafts a round from prompt lookup over the committed history
  (``spec_ngram``), from a draft model (``spec_draft=(cfg, params,
  ctx)``, any served family, its own dense cache, prefilled with the
  target), or from a caller's ``drafter_fn``; the target verifies them
  in one call over ``spec_k + 1`` positions (a recurrent target in
  ``spec_k + 1`` decode steps with per-position state checkpoints).  Greedy streams are the plain
  engine's; sampled ones keep its distribution.  On the card a block is
  one CUDA graph replay too.
* **Continuous batching**: ``submit`` queues requests; each block
  boundary retires finished lanes and admits the queue head as soon as a
  lane (and, paged, enough free pages) exists: the most important
  priority class first (REALTIME > STANDARD > BATCH), FIFO within a
  class, a page-blocked head blocking every class below it.
* **KV cache**: dense by default, as in the reference -- per-slot rows
  ``max_len`` plus a margin long (``prefill_chunk``, or ``spec_k + 2``
  when larger), a retired slot's rows zeroed -- or
  paged (``paged=True``), with the split-KV knob resolved once per
  geometry, exactly as the reference resolves it.  ``kv_bits=8`` stores
  either as int8 rows or pages with bf16 scales.  ``stats()`` reports
  the cache, the knob and the kernel launch counts.
* **Prefix caching** (``prefix_cache=True``, paged): committed,
  page-aligned prompt pages are published to a hash index and mapped
  read-only into later requests that open with the same tokens; a hit
  allocates and prefills only its suffix, and a full-prompt hit
  duplicates its boundary page (copy-on-write) before writing it.
* **The request lifecycle**: ``status``/``cancel`` by request id,
  deadlines (TTLs checked at block boundaries), preempt-and-spill under
  page pressure (``preempt=True``: a victim's pages, and a recurrent
  family's state lane, go to host memory and come back into fresh pages,
  a restore, never a recompute), pressure and
  SLO shedding, and restore-and-replay of a faulted block from a pre-block
  snapshot (``fault_injector`` / ``recover``).  Every cache edit of the
  lifecycle (copy-on-write, resume, restore, the chaos hook's poison) is
  made in place, so the captured decode graphs stay valid.
* **Class quotas** (``class_quotas``, paged): per-class floors reserve
  pool pages for a class and caps bound a class's pages, at admission
  and in prefix eviction, so a BATCH flood cannot take REALTIME's pages.
* **Crash-safe warm restart** (``durable_dir``): every externally driven
  transition (submit, add, admit, block, cancel, finish, retire) goes to
  an fsync'd journal (a block's record ahead of its device work) and a
  full snapshot with the journal cursor lands every ``snapshot_every``
  blocks; :meth:`Engine.recover` on a fresh Engine restores the newest
  snapshot and replays the journal's tail, so every stream resumes as if
  never interrupted.  ``launch.fleet.Fleet`` builds replicas and a
  journal-tailing hot standby on top of it.
* **The autotuner** (``autotune="analytic"`` or ``"fitted"``): the knob
  vector (``kv_split``, ``pages_per_step``, ``decode_block``) resolved at
  construction by ``launch.autotune``, and ``spec_k`` adapted online
  from the measured acceptance (on the card, one graph per k).

The Engine serves the ``lm``, ``ssm`` and ``hybrid`` families; the
``encdec`` and ``vlm`` families serve through the step builders of
``repro_torch.train.step``, as the reference Engine never passes their
encoder frames or image (:func:`_cross_input_refusal`).  ``--quant
fake`` serves the float weights fake-quantized to ``FixedPointType(qbits,
max(qbits // 2, 2))`` at every call (the reference's QAT numerics, each
product ``torch.matmul``); ``--reuse-factor`` rides in the QuantContext
as in the reference, where it is a compile knob (``scan_unroll``) with no
numeric effect.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
        --quant int8 --paged --batch 8 --prompt-len 128 --gen-len 32 \\
        --requests 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
        --quant int8 --lut --kv-bits 8 --batch 8 --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
        --quant int8 --paged --temperature 0.8 --top-k 40 --seed 1 \\
        [--no-graphs]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
        --quant int8 --paged --spec --spec-k 4 [--spec-draft gemma-2b]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
        --quant int8 --paged --prefix-cache --preempt --num-pages 56 \\
        [--deadline-s 30 --priority-class realtime --slo-ttft-s 1]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
        --quant int8 --paged --durable-dir /tmp/d --snapshot-every 2 \\
        [--replicas 2 --standby-dir /tmp/s] \\
        [--class-quota realtime:floor=0.25] [--autotune fitted]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
        --quant int8 --paged --preempt [--spec --spec-k 4]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs import get_config
from ..core.device import resolve_device
from ..core.precision import PrecisionPolicy
from ..core.qtypes import FixedPointType
from ..core.quantize import ptq_params
from ..data.pipeline import SyntheticLM
from ..kernels import launch_counts
from ..kernels.flash_attention import _resolve_knobs
from ..kernels.prng import PRNGKey
from ..checkpoint.store import BlobLog, latest_step, load_blob, save_blob
from ..ft.straggler import StragglerMonitor
from ..models.api import (cache_leaves, copy_pages_fn, get_family,
                          init_cache_fn, init_paged_cache_fn, invalidate_fn,
                          lane_leaves_fn, merge_slot_fn, page_leaves,
                          set_block_table, spec_state_fn,
                          supports_chunked_prefill)
from ..nn.context import QuantContext
from ..train.graphs import DecodeBlocks
from ..train.step import build_prefill_step, build_serve_step
from .autotune import SpecKAdapter, WorkloadShape, load_estimator, resolve
from .lifecycle import (PriorityClass, RequestStatus, coerce_priority,
                        normalize_class_quotas, normalize_slo_targets,
                        request_row, validate_request)
from .lifecycle import now as _now
from .paging import PageAllocator
from .prefix import PREFIX_OWNER, ROOT, PrefixIndex

__all__ = ["Engine", "DeviceFault", "resolve_device",
           "quantize_for_serving", "prepare_params", "build_ctx", "main"]


#: the families whose cross layers need an input besides tokens: (the
#: batch key, what it carries, the ROADMAP.md queue 1 item that ported
#: the family)
_CROSS_INPUT = {"encdec": ("enc_input", "the encoder's frames", 7),
                "vlm": ("img_embed", "the image", 17)}


def _cross_input_refusal(cfg) -> Optional[str]:
    """Why the Engine refuses ``cfg``'s family, or None.  The Engine
    serves models that need nothing but tokens: the reference Engine
    prefills every family but ``lm`` through its looped prefill (decode
    steps), which attends to the zero cross K/V of ``init_cache`` and
    never passes ``enc_input`` or ``img_embed`` -- whisper is never
    encoded, the VLM never sees its image."""
    if cfg.family not in _CROSS_INPUT:
        return None
    key, what, item = _CROSS_INPUT[cfg.family]
    return (f"{cfg.name}: the Engine does not serve the {cfg.family} family "
            f"(the reference Engine never passes {key}: its looped prefill "
            f"decodes against the zero cross K/V of init_cache, so "
            f"{what} never reaches the model); serve it through "
            f"train.step.build_prefill_step with {key} and "
            f"build_decode_loop (ROADMAP.md queue 1, item {item})")


def _refuse_cross_input(cfg) -> None:
    msg = _cross_input_refusal(cfg)
    if msg is not None:
        raise NotImplementedError(msg)


def _to(tree, device):
    from ..core.qtypes import QTensor
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return QTensor(tree.data.to(device), tree.scale.to(device), tree.qtype)
    return tree.to(device)


def prepare_params(params, ctx: QuantContext, device):
    """Params on ``device``, with the (tied) embedding table cast once to
    the compute dtype.  Both ``embed`` and ``unembed`` cast the table
    elementwise before use, so casting it ahead changes no value -- it
    only stops every step from converting 256000 x 2048 floats."""
    params = _to(params, device)
    emb = dict(params["embed"])
    emb["table"] = emb["table"].to(ctx.compute_dtype)
    return dict(params, embed=emb)


def quantize_for_serving(params, ctx: QuantContext):
    """PTQ the parameter tree once, before serving."""
    return ptq_params(params, ctx.policy)


class DeviceFault(RuntimeError):
    """The block's fault lane flagged slots (non-finite logits on the
    device: a poisoned cache, a kernel NaN).  Raised inside ``step_many``
    so that recovery can restore and replay; without recovery the flagged
    slots finish FAILED with their valid prefix."""

    def __init__(self, slots):
        slots = tuple(int(s) for s in slots)
        super().__init__(f"device fault lane flagged slots {list(slots)}")
        self.slots = slots


def _copy_record(r: dict) -> dict:
    """A queue record for a snapshot: the mutable ``outputs`` list is
    copied; spilled payloads never change after the spill and are shared."""
    r2 = dict(r)
    if r2.get("outputs"):
        r2["outputs"] = list(r2["outputs"])
    return r2


def _host_copy(tree) -> Dict[str, torch.Tensor]:
    """Host copies of every tensor of a cache tree, keyed by path."""
    return {p: t.detach().to("cpu", copy=True) for p, t in cache_leaves(tree)}


def _write_back(tree, host: Dict[str, torch.Tensor]) -> None:
    """Copy :func:`_host_copy`'s tensors into ``tree``'s, in place: the
    tensors keep their addresses, so captured decode graphs stay valid."""
    for p, t in cache_leaves(tree):
        t.copy_(host[p])


class Engine:
    """Slot-based continuous batching over chunked prefill and fused decode
    blocks (greedy or sampled per slot), on a dense (default) or paged KV
    cache, with the reference's request lifecycle.

    ``kv_bits``: None (f32 cache) or 8 (int8 rows / pages with bf16
    scales).  ``kv_split`` / ``pages_per_step`` (paged only): ``"auto"``
    (the cost model, as the reference), or explicit integers;
    ``kv_split=1, pages_per_step=1`` is the unsplit kernel.  ``device``:
    None means ``cuda`` (raises without a GPU); pass ``"cpu"`` to run the
    plain versions on the CPU.  ``seed`` keys the sampling noise.
    ``graphs``: each decode block as a CUDA graph replay; None means on
    for a CUDA device and off (eager) on the CPU, where asking for graphs
    raises.

    Speculative decoding, as the reference: ``spec`` on, ``spec_k`` drafts
    a round, prompt lookup over ``spec_ngram`` tokens by default;
    ``spec_draft=(cfg, params, ctx or None)`` drafts with a second model
    (any served family, the target's vocab); ``drafter_fn(hist, tok, pos) ->
    (B, k)`` drafts for tests.  ``step_many(n)`` then runs ``n`` rounds.

    The lifecycle: ``prefix_cache`` (paged) maps committed prompt pages
    into later requests that share them; ``preempt`` (paged) spills a
    running victim's pages to host memory under page pressure, after its
    queue head was blocked ``preempt_after`` sweeps; ``shed_threshold``
    (pool occupancy) or ``slo_targets`` (per class ``ttft_s`` /
    ``tok_per_s``) shed speculation and halve blocks under pressure;
    ``fault_injector`` (:class:`~repro_torch.ft.ServingFaultInjector`)
    and ``recover`` (default on with an injector) restore a pre-block
    snapshot and replay a faulted block, at most ``max_replays`` times;
    ``straggler`` (a :class:`~repro_torch.ft.StragglerMonitor`, one by
    default) flags slow blocks; ``clock`` replaces the engine's wall
    clock (deadlines and telemetry).  ``class_quotas`` (paged;
    ``{class: {"floor": f, "cap": f}}``, see
    :func:`~repro_torch.launch.lifecycle.normalize_class_quotas`)
    partition the page pool by priority class.

    ``durable_dir`` journals every transition there and snapshots every
    ``snapshot_every`` blocks (0: journal only); building an Engine with
    it starts a new run (the journal is truncated): a killed run is
    rebuilt by :meth:`recover` on an Engine built with the same
    arguments and without ``durable_dir``.  ``autotune``: ``"off"`` (the
    knobs as given or from the cost model), ``"analytic"`` or
    ``"fitted"`` (the knob vector from ``launch.autotune``, explicit
    knobs winning, ``decode_block`` resolved, ``spec_k`` adapted online
    within ``[1, spec_k]``).
    """

    def __init__(self, cfg, ctx: QuantContext, params, *, batch: int,
                 max_len: int, kv_bits=None, prefill_chunk: int = 16,
                 eos_id: int = -1, seed: int = 0, paged: bool = False,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 kv_split="auto", pages_per_step="auto",
                 prefix_cache: bool = False, autotune: str = "off",
                 spec: bool = False, spec_k: int = 4, spec_draft=None,
                 spec_ngram: int = 2, drafter_fn=None, preempt: bool = False,
                 preempt_after: int = 2, shed_threshold=None,
                 slo_targets=None, class_quotas=None, fault_injector=None,
                 recover=None, max_replays: int = 8, straggler=None,
                 clock=None, durable_dir=None, snapshot_every: int = 8,
                 device=None, graphs=None):
        if kv_bits not in (None, 8):
            raise ValueError(f"kv_bits must be None or 8, not {kv_bits!r}")
        self.autotune = str(autotune)
        if self.autotune not in ("off", "analytic", "fitted"):
            raise ValueError(
                f"autotune={autotune!r}: expected 'off' (the knobs as "
                f"given), 'analytic' (the resolver on hand-set constants) "
                f"or 'fitted' (the resolver on the card's measured fit)")
        if int(snapshot_every) < 0:
            raise ValueError(
                f"snapshot_every must be >= 0 (got {snapshot_every}); "
                f"0 disables periodic snapshots, a negative period has "
                f"no meaning")
        if class_quotas and not paged:
            raise ValueError(
                "class_quotas need the paged cache: quotas partition the "
                "page pool, and dense slots have no pool to partition")
        if not spec and (spec_draft is not None or drafter_fn is not None):
            raise ValueError(
                "spec_draft/drafter_fn were given but spec=False -- a "
                "drafter without speculation would silently never run; "
                "pass spec=True")
        _refuse_cross_input(cfg)
        get_family(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.batch, self.max_len = batch, max_len
        self.prefill_chunk = max(1, prefill_chunk)
        # chunked prefill continues a cache across calls: the attention
        # families only (a recurrent state is rebuilt from one call)
        self.chunked = supports_chunked_prefill(cfg)
        self.seed = seed
        self.params = prepare_params(params, ctx, self.device)
        self.kv_bits = kv_bits
        cache_dtype = torch.int8 if kv_bits == 8 else torch.float32
        # chunked prefill writes a full chunk at every lane's position,
        # also at a generating lane's (ignored) one, and a verify pass
        # k + 1 rows from a (possibly held) position: the margin keeps
        # those writes past max_len (dense rows, or table entries)
        margin = self.prefill_chunk if self.chunked else 0
        self.spec, self.spec_k = bool(spec), max(1, int(spec_k))
        self.spec_ngram = max(1, int(spec_ngram))
        self.drafter_fn = drafter_fn
        # the autotuner: "off" keeps the knobs as given (explicit kwarg >
        # ctx > the cost model) and resolves no block length; the other
        # modes resolve the whole knob vector and adapt spec_k within
        # [1, spec_k] (the margin and history are sized for the cap)
        self._autotune_est = None
        self._spec_adapter = None
        self._spec_k_init = self.spec_k
        self._last_spec_obs = (0, 0)
        self.decode_block: Optional[int] = None
        if self.autotune != "off":
            self._autotune_est = load_estimator(self.autotune)
            if self.spec:
                self._spec_adapter = SpecKAdapter(k_init=self.spec_k,
                                                  k_max=self.spec_k)
        if self.spec:
            margin = max(margin, self.spec_k + 2)
        #: committed tokens per slot at their absolute positions (prompt
        #: and accepted generations): the prompt-lookup drafter's corpus
        #: and the prefix index's publication source
        self.hist = np.zeros((batch, max_len + self.spec_k + 2), np.int32)
        self.draft = None
        if self.spec and spec_draft is not None:
            d_cfg, d_params, d_ctx = spec_draft
            if d_cfg.vocab != cfg.vocab:
                raise ValueError(
                    f"draft model vocab {d_cfg.vocab} != target vocab "
                    f"{cfg.vocab}; drafts would be meaningless")
            _refuse_cross_input(d_cfg)
            d_ctx = d_ctx or ctx
            self.draft = (d_cfg, prepare_params(d_params, d_ctx, self.device),
                          d_ctx)
            self.draft_chunked = supports_chunked_prefill(d_cfg)
            # the drafter's cache is dense: one model's rows, rolled back by
            # pos (or its recurrent checkpoints), never paged (paging meters
            # the target's admission)
            d_margin = max(self.prefill_chunk if self.draft_chunked else 0,
                           self.spec_k + 2)
            self.draft_cache = init_cache_fn(
                d_cfg, batch, max_len + d_margin, torch.float32, self.device)
            self._draft_prefill = build_prefill_step(d_cfg, d_ctx)
            self._draft_decode = build_serve_step(d_cfg, d_ctx)
        self.paged = bool(paged)
        self._bt_dirty = False
        self.kv_split = self.pages_per_step = None
        if self.paged:
            ps = max(1, int(page_size))
            if num_pages is None:
                num_pages = -(-(batch * max_len) // ps)
            self.allocator = PageAllocator(num_pages, ps,
                                           class_quotas=class_quotas)
            self._trash = num_pages          # reserved garbage page id
            # the table covers every reachable write position: decode
            # holds a dead lane at pos <= max_len; prefill margin writes
            # reach max_len + margin - 1
            width = -(-(max_len + max(margin, 1)) // ps)
            self.block_tables = np.full((batch, width), self._trash,
                                        np.int32)
            self._slot_pages: Dict[int, List[int]] = {}
            self.cache = init_paged_cache_fn(cfg, batch, num_pages, ps,
                                             width, cache_dtype, self.device)
            # split-KV knob: explicit engine kwarg > ctx > cost model
            req_t = (int(pages_per_step)
                     if pages_per_step not in (None, "auto")
                     else ctx.pages_per_step)
            req_s = (int(kv_split) if kv_split not in (None, "auto")
                     else ctx.kv_split)
            hkv = cfg.n_kv_heads or cfg.n_heads or 1
            if self.autotune != "off":
                # the resolver fills what the caller left on auto
                kv = resolve(WorkloadShape(
                    pages=width, page_size=ps, hkv=max(1, hkv), batch=batch,
                    gen_len=max_len, spec=self.spec), self._autotune_est)
                req_t = kv.pages_per_step if req_t is None else req_t
                req_s = kv.kv_split if req_s is None else req_s
                self.decode_block = kv.decode_block
            self.pages_per_step, self.kv_split = _resolve_knobs(
                width, ps, max(1, hkv), batch, req_s, req_t)
            ctx = dataclasses.replace(ctx, kv_split=self.kv_split,
                                      pages_per_step=self.pages_per_step)
        else:
            self.cache = init_cache_fn(cfg, batch, max_len + margin,
                                       cache_dtype, self.device)
            if self.autotune != "off":
                # dense: no kv knobs, the block length only
                self.decode_block = resolve(
                    WorkloadShape(pages=0, page_size=1, hkv=1, batch=batch,
                                  gen_len=max_len, spec=self.spec),
                    self._autotune_est).decode_block
        # -- prefix caching: committed, page-aligned prompt pages are
        # published to a hash index and mapped read-only into later
        # requests that share the prefix (admission of a hit allocates and
        # prefills only the suffix); page sharing needs the page pool.  A
        # recurrent family cannot skip a prefix (its state is sequential):
        # the flag is accepted there and inert, as in the reference
        self.prefix_cache = False
        if prefix_cache:
            if not self.paged:
                raise ValueError(
                    "prefix_cache=True needs the paged cache: prefix "
                    "reuse IS page sharing (dense lanes have no pages "
                    "to share)")
            self.prefix_cache = self.chunked
        if self.prefix_cache:
            self.prefix_index = PrefixIndex(self.allocator.page_size)
            #: slot -> index pages mapped read-only into its table (one
            #: reference held on each; the table holds them first)
            self._slot_shared: Dict[int, List[int]] = {}
            #: slot -> (chunks published or matched, chain key of the last)
            self._pub: Dict[int, tuple] = {}
        self.ctx = ctx
        self.prefill = build_prefill_step(cfg, self.ctx)
        self.decode = build_serve_step(cfg, self.ctx)
        if graphs is None:
            graphs = self.device.type == "cuda"
        spec_kw = None
        if self.spec:
            spec_kw = dict(k=self.spec_k, ngram=self.spec_ngram,
                           hist_len=self.hist.shape[1], drafter="ngram")
            if drafter_fn is not None:
                spec_kw["drafter"] = drafter_fn
            elif self.draft is not None:
                spec_kw.update(drafter="model", draft_cfg=self.draft[0],
                               draft_ctx=self.draft[2])
        self.blocks = DecodeBlocks(cfg, self.ctx, batch, self.device,
                                   graphs=graphs, spec=spec_kw)
        #: plain decode blocks of a speculative engine (shed blocks)
        self._plain_blocks = None
        self.pos = np.zeros((batch,), np.int32)
        self.live = np.zeros((batch,), bool)
        self.tokens = np.zeros((batch, 1), np.int32)
        #: lanes known zeroed since a block last touched them: a block
        #: advances dead lanes too (a recurrent state decays under the held
        #: pad token), so admission zeroes a dirty lane
        self._clean = np.ones((batch,), bool)
        self.stop_pos = np.full((batch,), max_len, np.int32)
        self.eos_id = int(eos_id)
        #: per-slot sampling params; temperature <= 0 = greedy, top_k <= 0
        #: = unrestricted (see repro_torch.kernels.sampling)
        self.temperature = np.zeros((batch,), np.float32)
        self.top_k = np.zeros((batch,), np.int32)
        self._key = PRNGKey(seed, self.device)
        self._gen_step = 0          # global decode-step counter (PRNG)
        self.outputs: List[Optional[list]] = [None] * batch
        self.done: List[list] = []
        self.waiting: deque = deque()
        self.counters = {"peak_live": 0, "admitted": 0, "gen_tokens": 0,
                         "decode_s": 0.0, "decode_steps": 0,
                         "prefill_chunks": 0, "prefill_tokens": 0,
                         "verify_steps": 0, "draft_accepted": 0,
                         "preemptions": 0, "cancellations": 0,
                         "timeouts": 0, "failures": 0, "replays": 0,
                         "spilled_pages": 0, "shed_spec_rounds": 0,
                         "straggler_blocks": 0, "prefix_hits": 0,
                         "prefix_hit_pages": 0, "prefix_tokens_saved": 0,
                         "cow_copies": 0, "spec_k_rejits": 0,
                         "recoveries": 0}
        self.request_log: List[dict] = []
        self._req_meta: Dict[int, dict] = {}    # slot -> live request row
        # -- the request lifecycle -------------------------------------------
        self.preempt = bool(preempt)
        if self.preempt and not self.paged:
            raise ValueError(
                "preempt=True needs the paged cache: preempt-and-spill "
                "is a page-pool mechanism (dense slots have nothing to "
                "spill -- every lane already owns its max_len rows)")
        if self.preempt and self.draft is not None:
            raise ValueError(
                "preempt=True with a model drafter is unsupported: the "
                "draft cache is a dense lane that cannot be spilled "
                "through the page pool (use ngram self-speculation)")
        self.preempt_after = max(1, int(preempt_after))
        self.shed_threshold = (None if shed_threshold is None
                               else float(shed_threshold))
        self.slo_targets = normalize_slo_targets(slo_targets)
        #: per-class lifecycle counters (``counters`` keeps the totals)
        self.class_counters = {c: self._fresh_class_row()
                               for c in PriorityClass}
        self.fault_injector = fault_injector
        self._recover = (bool(recover) if recover is not None
                         else fault_injector is not None)
        self.max_replays = int(max_replays)
        self.straggler = (StragglerMonitor() if straggler is None
                          else straggler)
        self.clock = _now if clock is None else clock
        self._t_start = self.clock()
        #: journal records a fleet's hot standby has not applied yet
        #: (None: no fleet feeds it)
        self.journal_lag_records = None
        self.results: Dict[int, dict] = {}
        self._next_id = 0
        self._round = 0             # decode-block counter (chaos schedule)
        self._injected_slow = False
        self._slow_penalty = 1.0    # synthetic straggler seconds
        #: per class, (request id, blocked admission sweeps) of its head
        self._head_blocked: Dict[PriorityClass, tuple] = {}
        # -- the durable journal ----------------------------------------------
        self._journal = None
        self._jmute = 0             # > 0: nested or replayed calls log nothing
        self._durable_dir = None
        self.snapshot_every = int(snapshot_every)
        self._durable_step = 0
        self._blocks_since_snap = 0
        if durable_dir is not None:
            os.makedirs(durable_dir, exist_ok=True)
            self._durable_dir = str(durable_dir)
            self._journal = BlobLog(os.path.join(durable_dir, "journal.log"),
                                    fresh=True)

    @staticmethod
    def _fresh_class_row() -> dict:
        return {"admitted": 0, "completed": 0, "preemptions": 0,
                "cancellations": 0, "timeouts": 0, "failures": 0,
                "shed_rounds": 0, "straggler_blocks": 0}

    def _class_count(self, cls, key: str, n: int = 1) -> None:
        self.class_counters[coerce_priority(cls)][key] += n

    @contextlib.contextmanager
    def _journal_scope(self, *record, ahead: bool = False):
        """Journal one externally driven transition, at the outermost call
        only: what a journaled call does inside (a block's admission
        sweep, retire's finishes, a replayed record) follows from the
        record on replay.  ``ahead`` (blocks) appends before the call, so
        that a crash inside the block finds it durable and re-runs it;
        otherwise the record is appended when the call returns (a call
        that raised at validation never happened)."""
        log = self._journal is not None and self._jmute == 0
        if log and ahead:
            self._journal.append(record)
        self._jmute += 1
        try:
            yield
        except BaseException:
            log = False
            raise
        finally:
            self._jmute -= 1
            if log and not ahead:
                self._journal.append(record)

    # -- admission ------------------------------------------------------------
    def add_requests(self, requests: Dict[int, np.ndarray], *,
                     gen_len=None, temperature=None, top_k=None,
                     deadline_s=None, priority=None, _t_submit=None,
                     _ids=None, _deadlines=None, _prefix=None):
        """Prefill several fresh slots together (batched chunked prefill).

        ``gen_len`` (scalar or ``{slot: v}``) bounds generation
        (``stop_pos = min(prompt_len + gen_len, max_len)``);
        ``temperature``/``top_k`` (scalar or ``{slot: v}``, default 0)
        set the slots' sampling; ``deadline_s`` a TTL from now (the
        request times out at the first block boundary past it);
        ``priority`` the SLO class (default STANDARD).  Paged: the whole
        token budget's pages are allocated here, less a prefix hit's
        shared pages (MemoryError when the pool is short, after evicting
        cold prefixes and, with ``preempt``, spilling victims, or when a
        class quota refuses it; queue through :meth:`submit` to wait
        instead).  An empty prompt is a single pad token (id 0).
        """
        with self._journal_scope(
                "add", {"requests": {int(s): np.asarray(p)
                                     for s, p in requests.items()},
                        "gen_len": gen_len, "temperature": temperature,
                        "top_k": top_k, "deadline_s": deadline_s,
                        "priority": priority}):
            return self._add_requests(
                requests, gen_len=gen_len, temperature=temperature,
                top_k=top_k, deadline_s=deadline_s, priority=priority,
                _t_submit=_t_submit, _ids=_ids, _deadlines=_deadlines,
                _prefix=_prefix)

    def _add_requests(self, requests, *, gen_len=None, temperature=None,
                      top_k=None, deadline_s=None, priority=None,
                      _t_submit=None, _ids=None, _deadlines=None,
                      _prefix=None):
        t_call = self.clock()
        reqs = {int(s): validate_request(p, vocab=self.cfg.vocab,
                                         temperature=temperature,
                                         top_k=top_k, priority=priority)
                for s, p in requests.items()}
        if deadline_s is not None:
            validate_request([], vocab=self.cfg.vocab, deadline_s=deadline_s)
        for s, p in reqs.items():
            if p.shape[0] > self.max_len:
                raise ValueError(
                    f"prompt of {p.shape[0]} tokens does not fit the cache "
                    f"(max_len={self.max_len}); refusing to clamp-write "
                    f"the tail")
            if p.size == 0:
                reqs[s] = np.zeros((1,), np.int32)
        if not reqs:
            return

        def per_slot(v, s, default):
            if v is None:
                return default
            return v.get(s, default) if isinstance(v, dict) else v

        def stop_of(s, plen):
            return self._token_budget(plen, per_slot(gen_len, s, None))

        prefix_of: Dict[int, dict] = {}
        if self.paged:
            self._alloc_pages(reqs, stop_of,
                              {s: coerce_priority(per_slot(priority, s, None))
                               for s in reqs}, prefix_of, _prefix)
        for s in reqs:
            if not self._clean[s]:
                # a dirty lane: blocks advanced it since finish()
                self.cache = invalidate_fn(self.cache, s, self.cfg)
                if self.draft is not None:
                    self.draft_cache = invalidate_fn(self.draft_cache, s,
                                                     self.draft[0])
        starts = {s: info["start"] for s, info in prefix_of.items()
                  if info["start"]}
        first = (self._prefill_chunked(reqs, starts) if self.chunked
                 else self._prefill_looped(reqs))
        if self.draft is not None:
            self._prefill_draft(reqs)
        t_first = self.clock()
        for s, p in reqs.items():
            self.pos[s] = p.shape[0]
            self.live[s] = True
            self.outputs[s] = []
            self.tokens[s, 0] = first[s]
            self._clean[s] = False
            self.temperature[s] = per_slot(temperature, s, 0.0)
            self.top_k[s] = per_slot(top_k, s, 0)
            self.stop_pos[s] = stop_of(s, p.shape[0])
            self.hist[s, :] = 0
            self.hist[s, :p.shape[0]] = p
            t_sub = (_t_submit or {}).get(s, t_call)
            rid = (_ids or {}).get(s)
            if rid is None:
                rid = self._mint_id()
            if _deadlines is not None and s in _deadlines:
                dl = _deadlines[s]
            else:
                d = per_slot(deadline_s, s, None)
                dl = None if d is None else t_call + float(d)
            cls = coerce_priority(per_slot(priority, s, None))
            self._req_meta[s] = {"id": rid, "ttft_s": t_first - t_sub,
                                 "t_admit": t_first, "deadline": dl,
                                 "priority": cls}
            self._class_count(cls, "admitted")
        self.counters["admitted"] += len(reqs)
        self.counters["peak_live"] = max(self.counters["peak_live"],
                                         int(self.live.sum()))
        if self.prefix_cache:
            # publish the fresh prompts' full pages now, so that requests
            # admitted in the very next sweep already hit
            for s in reqs:
                self._publish_committed(s)

    def _alloc_pages(self, reqs, stop_of, cls_of, prefix_of,
                     _prefix) -> None:
        """Pages for each slot's whole token budget, all or nothing: a
        prefix hit maps its shared pages and allocates the rest; a short
        pool evicts cold prefixes, then (``preempt``) spills victims at or
        below the most important class admitted, then raises MemoryError
        with the engine as it was.  The block table is flushed."""
        held: Dict[int, List[int]] = {}
        if self.prefix_cache:
            # hold the hit pages at once (refcount >= 2), before eviction
            # or preemption below can run; try_admit matched and shared
            # them at pop time and hands its holds over through _prefix
            for s, p in reqs.items():
                info = (_prefix or {}).get(s)
                if info is None:
                    info = self._match_prefix(p)
                    h = self._hit_pages(info)
                    if h:
                        self.allocator.share(h)
                prefix_of[s] = info
                held[s] = self._hit_pages(info)
        floor = min(cls_of.values())
        needs = {s: self.allocator.pages_for(stop_of(s, p.shape[0]))
                 - len(prefix_of[s]["shared"] if s in prefix_of else ())
                 for s, p in reqs.items()}
        recyclable = sum(len(self._slot_pages.get(s, ())) for s in reqs)

        def short():
            return sum(needs.values()) - self.allocator.free_pages \
                - recyclable

        if short() > 0 and self.prefix_cache:
            # cold index entries yield before any running request does
            # (with quotas, only entries at or below the admitted classes)
            self.prefix_index.evict(
                self.allocator, short(),
                floor=floor if self.allocator.class_quotas else None)
        if short() > 0 and self.preempt:
            self._preempt_until(sum(needs.values()) - recyclable,
                                exclude=set(reqs), floor=floor)
        if short() > 0:
            for h in held.values():
                if h:
                    self.allocator.free(h)      # release the match
            raise MemoryError(
                f"page pool exhausted: admission needs "
                f"{sum(needs.values())} pages, free "
                f"{self.allocator.free_pages} of {self.allocator.num_pages} "
                f"(queue through submit() to wait for pages)")
        if self.allocator.class_quotas:
            # the group's quota check before any state moves; the pages
            # the recycle loop below releases count as credit
            needs_cls: Dict[PriorityClass, int] = {}
            for s in reqs:
                needs_cls[cls_of[s]] = needs_cls.get(cls_of[s], 0) + needs[s]
            release = [p for s in reqs for p in
                       (self._slot_shared.get(s, [])
                        if self.prefix_cache else [])
                       + self._slot_pages.get(s, [])]
            freed, uncharge = self.allocator.release_credit(release)
            qmsg = self.allocator.quota_violation(needs_cls, freed=freed,
                                                  uncharge=uncharge)
            if qmsg is not None:
                for h in held.values():
                    if h:
                        self.allocator.free(h)
                raise MemoryError(f"class quota exceeded: {qmsg} (queue "
                                  f"through submit() to wait)")
        for s in reqs:
            # a slot admitted over one that still holds pages recycles them
            if self.prefix_cache:
                self.allocator.free(self._slot_shared.pop(s, []))
                self._pub.pop(s, None)
            if s in self._slot_pages:
                self.allocator.free(self._slot_pages.pop(s))
        for s in reqs:
            info = prefix_of.get(s)
            shared = info["shared"] if info else []
            pages = self.allocator.alloc(needs[s], owner=s, cls=cls_of[s])
            self._slot_pages[s] = pages
            self.block_tables[s, :] = self._trash
            self.block_tables[s, :len(shared)] = shared
            self.block_tables[s, len(shared):len(shared) + len(pages)] = pages
            if self.prefix_cache:
                self._slot_shared[s] = list(shared)
                self._pub[s] = ((info["depth"], info["key"])
                                if info else (0, ROOT))
            if info and info["cow"] is not None:
                # full-prompt hit: the boundary page still takes this
                # slot's writes (the last prompt row and decode), so it is
                # duplicated into the slot's first private page first
                copy_pages_fn(self.cache, info["cow"], pages[0])
                self.allocator.free([info["cow"]])
                self.counters["cow_copies"] += 1
            if info and (info["shared"] or info["cow"] is not None):
                self.counters["prefix_hits"] += 1
                self.counters["prefix_hit_pages"] += (
                    len(shared) + (1 if info["cow"] is not None else 0))
                self.counters["prefix_tokens_saved"] += info["start"]
        self._flush_block_tables()

    def _flush_block_tables(self):
        """Upload the host block table into every layer's table (one copy
        covering every edit since the last flush)."""
        set_block_table(self.cache, torch.from_numpy(
            self.block_tables.copy()).to(self.device))
        self._bt_dirty = False

    # -- prefix caching -------------------------------------------------------
    @staticmethod
    def _hit_pages(info: dict) -> List[int]:
        return info["shared"] + ([info["cow"]] if info["cow"] is not None
                                 else [])

    def _match_prefix(self, prompt: np.ndarray) -> dict:
        """Plan a prompt's admission against the prefix index: ``start``
        (first token to prefill), ``shared`` (index pages mapped read-only
        at table entries 0..), ``cow`` (an index page duplicated into the
        slot's first private page, or None), and ``depth``/``key`` (where
        the slot's own publication resumes).  Moves no refcount.

        A full-prompt hit still prefills the last prompt token (its logits
        are the first generated token); its row and every decode write
        land in the last matched page, which is therefore the copy."""
        ps = self.allocator.page_size
        plen = int(prompt.shape[0])
        m, pages, key = self.prefix_index.match(prompt)
        if m == 0:
            return {"start": 0, "shared": [], "cow": None,
                    "depth": 0, "key": ROOT}
        if m * ps == plen:
            return {"start": plen - 1, "shared": pages[:-1],
                    "cow": pages[-1], "depth": m, "key": key}
        return {"start": m * ps, "shared": pages, "cow": None,
                "depth": m, "key": key}

    def _publish_committed(self, slot: int) -> None:
        """Publish ``slot``'s pages whose rows are all below its committed
        position (``pos`` never decreases, so a published page stays
        committed).  A chunk whose chain key is indexed already is touched
        and its page stays private.  Publication shares the page, re-owns
        it to the index and moves it to the slot's shared list, so a later
        finish or preemption drops a reference instead of freeing it."""
        ps = self.allocator.page_size
        depth, parent = self._pub.get(slot, (0, ROOT))
        pos = int(self.pos[slot])
        while (depth + 1) * ps <= pos:
            chunk = self.hist[slot, depth * ps:(depth + 1) * ps]
            key = self.prefix_index.chain_key(parent, chunk)
            if key in self.prefix_index:
                self.prefix_index.touch(key)
            else:
                page = int(self.block_tables[slot, depth])
                assert page != self._trash \
                    and page in self._slot_pages.get(slot, ()), \
                    "publishable chunk not backed by a private page"
                self.allocator.share([page])
                self.allocator.transfer([page], PREFIX_OWNER)
                self._slot_pages[slot].remove(page)
                self._slot_shared[slot].append(page)
                meta = self._req_meta.get(slot)
                self.prefix_index.put(
                    key, parent, chunk, page, depth,
                    cls=meta["priority"] if meta else None)
            depth, parent = depth + 1, key
        self._pub[slot] = (depth, parent)

    def _cow_guard(self) -> None:
        """Copy-on-write sweep before a block: a table entry at or past a
        slot's ``pos`` that maps a page others reference is duplicated
        into a fresh private page (``cow_copies`` counts it).  By
        construction no block writes a shared page; the sweep guards the
        proof."""
        ps = self.allocator.page_size
        dirty = False
        for s in range(self.batch):
            if self.outputs[s] is None:
                continue                    # empty lane: all-trash table
            row = self.block_tables[s]
            for e in range(int(self.pos[s]) // ps, row.shape[0]):
                page = int(row[e])
                if (page == self._trash
                        or self.allocator.refcount(page) <= 1
                        or page in self._slot_pages.get(s, ())):
                    continue
                meta = self._req_meta.get(s)
                fresh = self.allocator.alloc(
                    1, owner=s, cls=meta["priority"] if meta else None)[0]
                copy_pages_fn(self.cache, page, fresh)
                self.block_tables[s, e] = fresh
                self._slot_pages[s].append(fresh)
                if page in self._slot_shared.get(s, ()):
                    self._slot_shared[s].remove(page)
                self.allocator.free([page])     # drop this slot's hold
                self.counters["cow_copies"] += 1
                dirty = True
        if dirty:
            self._flush_block_tables()

    # -- the admission queue --------------------------------------------------
    def _mint_id(self) -> int:
        rid = self._next_id
        self._next_id += 1
        return rid

    def submit(self, prompt: np.ndarray, *, gen_len: Optional[int] = None,
               temperature: float = 0.0, top_k: int = 0,
               deadline_s: Optional[float] = None, priority=None) -> int:
        """Queue a request; returns its id (the key of ``results``,
        :meth:`status` and :meth:`cancel`).  ``temperature > 0`` samples
        (``top_k > 0`` restricts the draw to the k best logits); 0 is
        greedy.  ``deadline_s``: a TTL from now, past which the request
        times out at the next block boundary, queued or running.
        ``priority``: the SLO class (REALTIME > STANDARD > BATCH, FIFO
        within a class); it changes when a request runs, never what it
        generates."""
        prompt = validate_request(prompt, vocab=self.cfg.vocab,
                                  temperature=temperature, top_k=top_k,
                                  deadline_s=deadline_s, priority=priority)
        if prompt.shape[0] > self.max_len:
            raise ValueError(
                f"prompt of {prompt.shape[0]} tokens does not fit the "
                f"cache (max_len={self.max_len})")
        t = self.clock()
        req = {"id": self._mint_id(), "prompt": prompt, "gen_len": gen_len,
               "temperature": temperature, "top_k": top_k,
               "t_submit": t, "priority": coerce_priority(priority),
               "deadline": None if deadline_s is None
               else t + float(deadline_s)}
        if self.paged:
            need = self.allocator.pages_for(self._budget(req))
            if need > self.allocator.num_pages:
                raise ValueError(
                    f"request needs {need} pages but the pool only has "
                    f"{self.allocator.num_pages}; raise num_pages or lower "
                    f"gen_len")
            cap = self.allocator.cap_pages(req["priority"])
            if cap is not None and need > cap:
                raise ValueError(
                    f"request needs {need} pages but class "
                    f"{req['priority'].name.lower()} is capped at {cap} "
                    f"of {self.allocator.num_pages}; raise the cap or "
                    f"lower gen_len")
        self.waiting.append(req)
        if self._journal is not None and self._jmute == 0:
            # with the minted id, which replay checks; the deadline rides
            # relative (a clock value does not survive a process), so a
            # recovered request's TTL restarts at recovery
            self._journal.append(("submit", {
                "id": req["id"], "prompt": prompt, "gen_len": gen_len,
                "temperature": temperature, "top_k": top_k,
                "deadline_s": deadline_s,
                "priority": req["priority"].name.lower()}))
        return req["id"]

    def status(self, req_id: int):
        """Lifecycle status of a request id (None = unknown id)."""
        if req_id in self.results:
            return self.results[req_id]["status"]
        for r in self.waiting:
            if r["id"] == req_id:
                return (RequestStatus.PREEMPTED if r.get("resume")
                        else RequestStatus.QUEUED)
        for m in self._req_meta.values():
            if m["id"] == req_id:
                return RequestStatus.RUNNING
        return None

    def cancel(self, req_id: int) -> bool:
        """Cancel a request wherever it is: queued (fresh or preempted),
        it leaves the queue CANCELLED with the tokens it had committed;
        running, its lane finishes now with its partial output.  Unknown
        or terminal ids return False."""
        with self._journal_scope("cancel", int(req_id)):
            for i, r in enumerate(self.waiting):
                if r["id"] == req_id:
                    del self.waiting[i]
                    self._finalize_queued(r, RequestStatus.CANCELLED)
                    return True
            for s, m in list(self._req_meta.items()):
                if m["id"] == req_id:
                    self.live[s] = False
                    self.finish(s, status=RequestStatus.CANCELLED)
                    return True
            return False

    def _finalize_queued(self, rec: dict, status: RequestStatus) -> None:
        """Terminal outcome of a request that holds no lane: a results
        entry only (``done`` keeps lane streams)."""
        self.results[rec["id"]] = {"status": status,
                                   "tokens": list(rec.get("outputs") or [])}
        if status is RequestStatus.TIMED_OUT:
            self.counters["timeouts"] += 1
            self._class_count(self._rec_priority(rec), "timeouts")
        elif status is RequestStatus.CANCELLED:
            self.counters["cancellations"] += 1
            self._class_count(self._rec_priority(rec), "cancellations")

    def _sweep_deadlines(self) -> None:
        """TTLs at the block boundary: expired queued requests finalize
        without a lane, expired live ones finish with their output."""
        t = self.clock()
        expired = [r for r in self.waiting
                   if r.get("deadline") is not None and t >= r["deadline"]]
        if expired:
            gone = {id(r) for r in expired}
            self.waiting = deque(r for r in self.waiting
                                 if id(r) not in gone)
            for r in expired:
                self._finalize_queued(r, RequestStatus.TIMED_OUT)
        for s in range(self.batch):
            m = self._req_meta.get(s)
            if (m is not None and m.get("deadline") is not None
                    and self.live[s] and t >= m["deadline"]):
                self.live[s] = False
                self.finish(s, status=RequestStatus.TIMED_OUT)

    def _token_budget(self, plen: int, gen_len: Optional[int]) -> int:
        """A request's cache-row budget, i.e. its final ``stop_pos``."""
        plen = max(1, int(plen))
        return min(plen + gen_len, self.max_len) if gen_len is not None \
            else self.max_len

    def _budget(self, req) -> int:
        return self._token_budget(len(req["prompt"]), req["gen_len"])

    def retire_finished(self) -> int:
        """finish() every lane whose generation ended."""
        with self._journal_scope("retire"):
            n = 0
            for s in range(self.batch):
                if self.outputs[s] is not None and not self.live[s]:
                    self.finish(s)
                    n += 1
            return n

    def _rec_priority(self, rec: dict) -> PriorityClass:
        """SLO class of a queue record (fresh or a preempted resume)."""
        if rec.get("resume"):
            return coerce_priority(rec["meta"].get("priority"))
        return coerce_priority(rec.get("priority"))

    def _queue_head(self) -> int:
        """Index of the next admission candidate: the front of the most
        important non-empty class (FIFO within a class; a page-blocked
        head blocks every lower class)."""
        best, best_i = None, 0
        for i, r in enumerate(self.waiting):
            p = self._rec_priority(r)
            if best is None or p < best:
                best, best_i = p, i
                if p == PriorityClass.REALTIME:
                    break
        return best_i

    def try_admit(self) -> int:
        """Admit queued requests into free lanes while pages last: by
        class, FIFO within a class, no head-of-line skipping; fresh
        admissions share one batched prefill, preempted records resume
        (payload and lane restored, no prefill).  A page-blocked head
        first evicts cold prefixes; with ``preempt``, after
        ``preempt_after`` blocked sweeps of the same head (at once when
        its class is past its TTFT target), victims at or below its class
        spill until it fits.  With class quotas a head whose class is over
        its cap, or that would take another class's reserved pages,
        waits as a pool-short head does."""
        with self._journal_scope("admit"):
            return self._try_admit()

    def _try_admit(self) -> int:
        free = [s for s in range(self.batch)
                if self.outputs[s] is None and not self.live[s]]
        admit: Dict[int, np.ndarray] = {}
        kw = {"gen_len": {}, "temperature": {}, "top_k": {}, "priority": {},
              "_t_submit": {}, "_ids": {}, "_deadlines": {}, "_prefix": {}}
        planned = 0
        planned_cls: Dict[PriorityClass, int] = {}
        resumed = 0
        placed: set = set()
        while self.waiting and free:
            i = self._queue_head()
            req = self.waiting[i]
            cls = self._rec_priority(req)
            pre = None
            if self.paged:
                if req.get("resume"):
                    need = req["n_pages"]
                else:
                    need = self.allocator.pages_for(self._budget(req))
                    if self.prefix_cache:
                        # a hit's shared pages are mapped, not allocated
                        pre = self._match_prefix(req["prompt"])
                        need -= len(pre["shared"])
                # the pool first, then the quotas with the head's own class
                # (the reference asks can_alloc without a class here, which
                # under quotas checks the head as STANDARD: a REALTIME head
                # then waits on its own floor; ROADMAP, reference hazards)
                fits = planned + need <= self.allocator.free_pages
                if fits and self.allocator.class_quotas:
                    want = dict(planned_cls)
                    want[cls] = want.get(cls, 0) + need
                    fits = self.allocator.quota_violation(want) is None
                if not fits:
                    if self.prefix_cache:
                        # pages promised this sweep are held (refcount >=
                        # 2); the current head's match is protected here.
                        # The sweep covers the pool's shortfall or, quota-
                        # blocked, the class's own published pages; it
                        # evicts entries at or below the head's class only
                        mine = set(self._hit_pages(pre)) if pre else set()
                        want = max(
                            planned + need - self.allocator.free_pages,
                            self.allocator.quota_evict_want(
                                cls, need, planned=planned_cls))
                        if self.prefix_index.evict(
                                self.allocator, want, protect=mine,
                                floor=(cls if self.allocator.class_quotas
                                       else None)):
                            continue    # freed pages; recheck the head
                    if self._maybe_preempt(req, cls, planned + need, free,
                                           exclude=placed):
                        continue        # victims spilled; recheck head
                    break
            del self.waiting[i]
            hb = self._head_blocked.get(cls)
            if hb is not None and hb[0] == req["id"]:
                # only the tracked head's own admission resets its count
                del self._head_blocked[cls]
            s = free.pop(0)
            placed.add(s)
            if req.get("resume"):
                self._resume(s, req)
                resumed += 1
                continue
            if self.paged:
                planned += need
                planned_cls[cls] = planned_cls.get(cls, 0) + need
            if pre is not None:
                # hold the matched pages now: a later head's eviction must
                # not free them while this admission is pending
                h = self._hit_pages(pre)
                if h:
                    self.allocator.share(h)
                kw["_prefix"][s] = pre
            admit[s] = req["prompt"]
            kw["gen_len"][s] = req["gen_len"]
            kw["temperature"][s] = req["temperature"]
            kw["top_k"][s] = req["top_k"]
            kw["priority"][s] = cls
            kw["_t_submit"][s] = req["t_submit"]
            kw["_ids"][s] = req["id"]
            kw["_deadlines"][s] = req["deadline"]
        if admit:
            self.add_requests(admit, **kw)
        return len(admit) + resumed

    # -- preempt and spill ------------------------------------------------------
    def _victim_order(self, exclude=(), floor=None) -> List[int]:
        """Spill order: BATCH before STANDARD before REALTIME; within a
        class requests without a deadline first, then the most slack;
        ties latest-admitted first.  ``floor`` (the preempting head's
        class) spares every more important victim."""
        cands = [s for s in range(self.batch)
                 if self.live[s] and s in self._req_meta
                 and s not in exclude]
        if floor is not None:
            cands = [s for s in cands
                     if coerce_priority(self._req_meta[s].get("priority"))
                     >= floor]

        def rank(s):
            m = self._req_meta[s]
            dl = m.get("deadline")
            return (-int(coerce_priority(m.get("priority"))),
                    dl is not None, -(dl or 0.0), -m["t_admit"], -s)

        return sorted(cands, key=rank)

    def _preempt_until(self, target_free: int, exclude=(),
                       floor=None) -> None:
        """Spill victims until ``free_pages`` covers ``target_free`` (or
        none is left: the caller checks again)."""
        for v in self._victim_order(exclude, floor=floor):
            if self.allocator.free_pages >= target_free:
                break
            self._preempt(v)

    def _maybe_preempt(self, req, cls: PriorityClass, need: int,
                       free: List[int], exclude=()) -> bool:
        """Escalation inside try_admit: once the same head was blocked
        ``preempt_after`` sweeps of its class (or is past its class's TTFT
        target), spill victims at or below its class until it fits."""
        if not self.preempt:
            return False
        hb = self._head_blocked.get(cls)
        rounds = hb[1] + 1 if hb is not None and hb[0] == req["id"] else 1
        self._head_blocked[cls] = (req["id"], rounds)
        if rounds < self.preempt_after and not self._past_ttft_slo(req, cls):
            return False
        progressed = False
        for v in self._victim_order(exclude, floor=cls):
            if self.allocator.can_alloc(need, cls=cls):
                break
            self._preempt(v)
            free.append(v)          # the victim's lane is admittable now
            progressed = True
        return progressed and self.allocator.can_alloc(need, cls=cls)

    def _past_ttft_slo(self, req: dict, cls: PriorityClass) -> bool:
        """Is this fresh queued record past its class's TTFT target?"""
        tgt = self.slo_targets.get(cls, {}).get("ttft_s")
        if tgt is None or req.get("resume"):
            return False
        return self.clock() - req["t_submit"] >= tgt

    def _page_payload(self, pages: List[int]) -> Dict[str, torch.Tensor]:
        """Host copy of the pool pages' payload, keyed by cache path: one
        gather over the page axis of every page leaf (K/V and int8 scales
        alike)."""
        out = {}
        for path, leaf in page_leaves(self.cache):
            ids = torch.as_tensor(pages, dtype=torch.int64,
                                  device=leaf.device)
            out[path] = leaf.index_select(1, ids).to("cpu")
        return out

    def _write_pages(self, payload: Dict[str, torch.Tensor],
                     pages: List[int]) -> None:
        """Scatter a spilled payload into (new) physical pages, in place."""
        for path, leaf in page_leaves(self.cache):
            data = payload.get(path)
            if data is None:
                continue
            ids = torch.as_tensor(pages, dtype=torch.int64,
                                  device=leaf.device)
            leaf.index_copy_(1, ids, data.to(leaf.device))

    def _lane_state(self, slot: int):
        """Host copy of ``slot``'s recurrent lane (None for a KV-only
        family), through the batch-leading views speculative rollback
        uses."""
        rec = spec_state_fn(self.cache, self.cfg)
        if rec is None:
            return None
        return {p: t[slot].to("cpu", copy=True) for p, t in cache_leaves(rec)}

    def _write_lane(self, slot: int, lane) -> None:
        """Copy a :meth:`_lane_state` back into ``slot``'s lane, in place."""
        if lane is None:
            return
        for p, t in cache_leaves(spec_state_fn(self.cache, self.cfg)):
            t[slot].copy_(lane[p])

    def _preempt(self, slot: int) -> None:
        """Spill ``slot``'s request to host memory and queue it again, at
        the back.  Every page its table maps (shared prefix pages first,
        then its own) is copied to the host and every reference it holds
        dropped; the resumed request gets private pages.  A recurrent
        family's state lane is copied out too, and the lane zeroed."""
        meta = self._req_meta.pop(slot)
        row = self.block_tables[slot]
        mapped = [int(p) for p in row[row != self._trash]]
        payload = self._page_payload(mapped) if mapped else {}
        lane = self._lane_state(slot)
        shared = (self._slot_shared.pop(slot, [])
                  if self.prefix_cache else [])
        if shared:
            self.allocator.free(shared)         # drop this slot's holds
        private = self._slot_pages.pop(slot, [])
        spilled = self.allocator.spill(slot)
        assert sorted(spilled) == sorted(private) \
            and set(mapped) == set(shared) | set(private), \
            "allocator/engine page maps diverged"
        self.block_tables[slot, :] = self._trash
        self._bt_dirty = True
        rec = {"resume": True, "id": meta["id"], "meta": meta,
               "deadline": meta.get("deadline"),
               "n_pages": len(mapped), "payload": payload, "lane": lane,
               "pub": (self._pub.pop(slot, (0, ROOT))
                       if self.prefix_cache else None),
               "outputs": self.outputs[slot],
               "pos": int(self.pos[slot]),
               "token": int(self.tokens[slot, 0]),
               "hist": self.hist[slot].copy(),
               "temperature": float(self.temperature[slot]),
               "top_k": int(self.top_k[slot]),
               "stop_pos": int(self.stop_pos[slot])}
        self.outputs[slot] = None
        self.live[slot] = False
        self.pos[slot] = 0
        self.tokens[slot, 0] = 0
        self.temperature[slot] = 0.0
        self.top_k[slot] = 0
        self.stop_pos[slot] = self.max_len
        self.cache = invalidate_fn(self.cache, slot, self.cfg)
        self._clean[slot] = True
        self.waiting.append(rec)
        self.counters["preemptions"] += 1
        self._class_count(meta.get("priority"), "preemptions")
        self.counters["spilled_pages"] += len(mapped)

    def _resume(self, slot: int, rec: dict) -> None:
        """Re-admit a preempted request: fresh pages take the spilled
        payload and the recurrent lane its state (in place), and the table
        re-targets them; ``pos``, the held token, outputs, drafting history
        and sampling params are exactly as spilled, so the stream goes on
        as if never spilled."""
        pages = self.allocator.alloc(rec["n_pages"], owner=slot,
                                     cls=self._rec_priority(rec))
        self._slot_pages[slot] = pages
        if self.prefix_cache:
            # all its pages are private now; publication resumes at the
            # kept chain position (indexed chunks are recognized, skipped)
            self._slot_shared[slot] = []
            self._pub[slot] = rec.get("pub") or (0, ROOT)
        self.block_tables[slot, :] = self._trash
        self.block_tables[slot, :len(pages)] = pages
        self._flush_block_tables()
        if not self._clean[slot]:
            # blocks advanced the idle lane since its last occupant left
            self.cache = invalidate_fn(self.cache, slot, self.cfg)
        if rec["payload"]:
            self._write_pages(rec["payload"], pages)
        self._write_lane(slot, rec.get("lane"))
        self.pos[slot] = rec["pos"]
        self.tokens[slot, 0] = rec["token"]
        self.live[slot] = True
        self.outputs[slot] = rec["outputs"]
        self.hist[slot] = rec["hist"]
        self.temperature[slot] = rec["temperature"]
        self.top_k[slot] = rec["top_k"]
        self.stop_pos[slot] = rec["stop_pos"]
        self._clean[slot] = False
        self._req_meta[slot] = rec["meta"]
        self.counters["peak_live"] = max(self.counters["peak_live"],
                                         int(self.live.sum()))

    # -- prefill ----------------------------------------------------------------
    def _prefill_chunked(self, reqs, starts=None) -> Dict[int, int]:
        """Batched chunked prefill; returns each slot's first token.
        ``starts`` (slot -> first token to ingest) makes it suffix-only
        for prefix hits: the chunk grid runs at ``start + c0`` per slot
        and attends the shared pages through the flushed block table.

        Everything a chunk needs is uploaded once and the per-chunk
        argmaxes stay on the device, so the whole prefill costs one host
        sync (the reference reads every chunk's logits back).
        """
        chunk = self.prefill_chunk
        starts = starts or {}
        offs = {s: int(starts.get(s, 0)) for s in reqs}
        sufs = {s: p[offs[s]:] for s, p in reqs.items()}
        plen = max(t.shape[0] for t in sufs.values())
        padded = -(-plen // chunk) * chunk
        toks = np.zeros((self.batch, padded), np.int32)
        for s, t in sufs.items():
            toks[s, :t.shape[0]] = t
        # lanes whose (shorter) suffix is exhausted park at the last full
        # chunk inside the table: their writes land at positions >=
        # max_len, in the margin, never below a committed watermark
        park = (self.block_tables.shape[1] * self.allocator.page_size
                - chunk) if (self.paged and offs and max(offs.values())) \
            else None
        n_chunks = -(-plen // chunk)
        cur = np.repeat(self.pos[None, :], n_chunks, axis=0)
        for c in range(n_chunks):
            for s in reqs:
                cur[c, s] = (c * chunk if park is None
                             else min(offs[s] + c * chunk, park))
        toks_d = torch.from_numpy(toks).to(self.device)
        cur_d = torch.from_numpy(cur).to(self.device)
        picks = []
        for c in range(n_chunks):
            piece = {"tokens": toks_d[:, c * chunk:(c + 1) * chunk]}
            logits, self.cache = self.prefill(self.params, piece, self.cache,
                                              cur_d[c])
            self.counters["prefill_chunks"] += 1
            picks.append(torch.argmax(logits.to(torch.float32), dim=-1))
        self.counters["prefill_tokens"] += sum(t.shape[0]
                                               for t in sufs.values())
        ids = torch.cat(picks, dim=1).cpu().numpy()
        return {s: int(ids[s, t.shape[0] - 1]) for s, t in sufs.items()}

    def _prefill_looped(self, reqs) -> Dict[int, int]:
        """Per-token prefill of the families without chunked prefill;
        returns each slot's first token.  Slot by slot (:meth:`_loop_slot`),
        as the reference; the slot's position then stays at its prompt
        length, so later slots' loops never write over its rows."""
        first: Dict[int, int] = {}
        for s, p in reqs.items():
            self.cache, last = self._loop_slot(
                self.decode, self.params, self.cache, self.cfg, s, p,
                int(self.pos[s]))
            self.pos[s] += p.shape[0]
            first[s] = int(torch.argmax(last.to(torch.float32)))
            self.counters["prefill_tokens"] += p.shape[0]
        return first

    def _loop_slot(self, step, params, cache, cfg, slot: int, prompt,
                   start: int):
        """Ingest ``prompt`` into ``slot``'s lane from position ``start``:
        one full-batch decode step (``step``) per token, the slot's token
        at its position and a pad token at every other lane's.  The steps
        advance every lane's state, so every other lane is put back as it
        was before the loop (:func:`~repro_torch.models.api.merge_slot_fn`,
        in place): the slot's prefill is a solo prefill, and neighbours
        are untouched.  Returns (cache, the slot's last logits)."""
        before = [t.clone() for t, _ in lane_leaves_fn(cache, cfg)]
        n = prompt.shape[0]
        toks = np.zeros((n, self.batch, 1), np.int32)
        toks[:, slot, 0] = prompt
        pos = np.repeat(self.pos[None, :], n, axis=0)
        pos[:, slot] = start + np.arange(n, dtype=np.int32)
        toks_d = torch.from_numpy(toks).to(self.device)
        pos_d = torch.from_numpy(pos).to(self.device)
        for t in range(n):
            logits, cache = step(params, cache, toks_d[t], pos_d[t])
        return merge_slot_fn(cache, before, slot, cfg), logits[slot, -1]

    def _prefill_draft(self, reqs) -> None:
        """Ingest the admitted prompts, whole, into the draft model's
        cache: it then sits one token behind the held first token, which
        the first draft step consumes.  Chunked for an attention drafter;
        looped with the lane isolation for a recurrent one, as the
        target."""
        if not self.draft_chunked:
            d_cfg, d_params, _ = self.draft
            for s, p in reqs.items():
                self.draft_cache, _ = self._loop_slot(
                    self._draft_decode, d_params, self.draft_cache, d_cfg, s,
                    p, 0)
            return
        chunk = self.prefill_chunk
        plen = max(p.shape[0] for p in reqs.values())
        n_chunks = -(-plen // chunk)
        toks = np.zeros((self.batch, n_chunks * chunk), np.int32)
        cur = np.repeat(self.pos[None, :], n_chunks, axis=0)
        for s, p in reqs.items():
            toks[s, :p.shape[0]] = p
            cur[:, s] = np.arange(n_chunks) * chunk
        toks_d = torch.from_numpy(toks).to(self.device)
        cur_d = torch.from_numpy(cur).to(self.device)
        for c in range(n_chunks):
            _, self.draft_cache = self._draft_prefill(
                self.draft[1], {"tokens": toks_d[:, c * chunk:(c + 1) * chunk]},
                self.draft_cache, cur_d[c])

    # -- decode / retire --------------------------------------------------------
    def step_many(self, n: int):
        """Run ``n`` fused decode steps, sync once.

        Returns ``(block, block_live)``, (n, B) emitted tokens and their
        validity.  Under ``spec`` ``n`` counts draft -> verify rounds and
        the block is (n * (spec_k + 1), B), each live slot committing 1 to
        spec_k + 1 tokens a round.

        Every block boundary sweeps deadlines and applies the shedding
        policy (a shed block is a plain block, half as long when
        REALTIME is at risk); with recovery on, the engine snapshots
        first, and a faulted block (an injected exception, the device
        fault lane, a corruption report) is restored and replayed -- an
        injected fault fires once, so the replay runs clean and commits
        the fault-free tokens.  Without recovery, lanes of the fault lane
        finish FAILED with their valid prefix, and host faults propagate.
        With requests waiting, finished lanes are retired and the queue
        admitted at the end.

        Durable (``durable_dir``): the block's journal record is fsync'd
        before any device work, so a crash inside the block (a graph
        replay included) re-runs the whole block on recovery; every
        ``snapshot_every`` blocks a durable snapshot bounds the replay.
        """
        if self._journal is not None and self._jmute == 0:
            self._blocks_since_snap += 1
            if (self.snapshot_every
                    and self._blocks_since_snap > self.snapshot_every):
                # before this block's record: the cursor must not cover a
                # block the snapshot has not run
                self._save_durable()
                self._blocks_since_snap = 1
        with self._journal_scope("block", int(n), ahead=True):
            return self._step_many(n)

    def _step_many(self, n: int):
        self._round += 1
        self._sweep_deadlines()
        n_eff, spec_now = self._shed_policy(n)
        if self.prefix_cache:
            self._cow_guard()
        if self.paged and self._bt_dirty:
            self._flush_block_tables()
        snap = self.snapshot() if self._recover else None
        pos_before = self.pos.copy()
        injector = self.fault_injector
        attempt = 0
        fault_slots: tuple = ()
        while True:
            try:
                self._injected_slow = False
                if injector is not None:
                    injector.before_block(self._round, self)
                t0 = self.clock()
                if spec_now:
                    block, block_live, fault = self._block_spec(n_eff)
                else:
                    block, block_live, fault = self._block_decode(n_eff)
                if injector is not None:
                    injector.after_block(self._round, self)
                t1 = self.clock()
                if fault.any():
                    raise DeviceFault(np.where(fault)[0])
                break
            except (RuntimeError, FloatingPointError) as e:
                if snap is not None and attempt < self.max_replays:
                    attempt += 1
                    self.restore(snap)
                    self.counters["replays"] += 1
                    continue
                if isinstance(e, DeviceFault):
                    # no recovery: keep the block's committed prefix and
                    # fail the flagged slots below
                    fault_slots = e.slots
                    break
                raise
        self._gen_step += n_eff
        self._clean[:] = False              # a block advances every lane
        self.counters["decode_s"] += t1 - t0
        self.counters["decode_steps"] += n_eff
        self.counters["gen_tokens"] += int(block_live.sum())
        if spec_now and self._spec_adapter is not None:
            # adaptive spec_k: this block's acceptance (observed once, after
            # the fault check) re-ranks k for the next block; committed
            # tokens do not depend on k, only the cost of a round does
            rounds, acc = self._last_spec_obs
            self._spec_adapter.observe(rounds, acc)
            k_new = self._spec_adapter.propose()
            if k_new != self.spec_k:
                self.spec_k = int(k_new)
                self.counters["spec_k_rejits"] += 1
        # straggler telemetry: wall time per step, plus the injector's
        # synthetic penalty for a deterministic slow block
        dur = (t1 - t0) / max(1, n_eff)
        if self._injected_slow:
            dur += self._slow_penalty
            self._injected_slow = False
        if (self.straggler is not None
                and self.straggler.record(self._round, dur)):
            self.counters["straggler_blocks"] += 1
            # charged to every class that had a request in the block
            for cls in {coerce_priority(m.get("priority"))
                        for m in self._req_meta.values()}:
                self._class_count(cls, "straggler_blocks")
        for s in range(self.batch):
            if not self.live[s] and s in self._req_meta:
                self._req_meta[s].setdefault("t_done", t1)
        for s in range(self.batch):
            if self.outputs[s] is not None:
                self.outputs[s].extend(
                    int(t) for t in block[block_live[:, s], s])
        if (self.spec or self.prefix_cache) and not spec_now:
            # a plain block feeds hist on the host -- the drafting corpus
            # under speculation, the publication source under prefix
            # caching -- as the spec block does on the device
            for s in range(self.batch):
                col = block[:, s][block_live[:, s]]
                if col.size:
                    p0 = int(pos_before[s])
                    end = min(p0 + col.size, self.hist.shape[1])
                    self.hist[s, p0:end] = col[:end - p0]
        if self.prefix_cache:
            assert (self.pos >= pos_before).all(), \
                "pos went backwards across a block"
            for s in range(self.batch):
                # live slots and slots that finished inside the block (their
                # pages stay mapped until retirement), never a fault-flagged
                # one: its pages may hold what the fault lane caught
                if self.outputs[s] is not None and s not in fault_slots:
                    self._publish_committed(s)
        for s in fault_slots:
            if self.outputs[s] is not None:
                self.live[s] = False
                self.finish(s, status=RequestStatus.FAILED)
        if self.waiting:
            self.retire_finished()
            self.try_admit()
        return block, block_live

    def _shed_policy(self, n: int):
        """Pressure shedding: (block steps, speculative?).  With
        ``slo_targets``, pressure is a class behind its target (its oldest
        fresh queued request past the TTFT target, or its recent
        completions below the tok/s target): speculation is shed, and the
        block halved only when REALTIME is at risk.  Else, past
        ``shed_threshold`` pool occupancy, the block is halved and
        speculation shed.  Shapes change, greedy streams do not."""
        if self.slo_targets:
            cls = self._slo_pressure()
            if cls is None:
                return n, self.spec
            if self.spec:
                self.counters["shed_spec_rounds"] += 1
            self._class_count(cls, "shed_rounds")
            if cls == PriorityClass.REALTIME:
                return max(1, n // 2), False
            return n, False
        if (self.shed_threshold is None or not self.paged
                or self.allocator.num_pages == 0):
            return n, self.spec
        occ = self.allocator.used_pages / self.allocator.num_pages
        if occ < self.shed_threshold:
            return n, self.spec
        if self.spec:
            self.counters["shed_spec_rounds"] += 1
        return max(1, n // 2), False

    def _slo_pressure(self) -> Optional[PriorityClass]:
        """The most important class behind its SLO target, or None."""
        t = self.clock()
        worst = None
        for cls, tgt in self.slo_targets.items():
            at_risk = False
            ttft = tgt.get("ttft_s")
            if ttft is not None:
                at_risk = any(
                    not r.get("resume") and t - r["t_submit"] >= ttft
                    for r in self.waiting
                    if self._rec_priority(r) == cls)
            rate = tgt.get("tok_per_s")
            if rate is not None and not at_risk:
                recent = [r["tok_per_s"] for r in self.request_log[-8:]
                          if r.get("priority") == cls.name.lower()
                          and r["tok_per_s"] is not None]
                at_risk = bool(recent) and float(np.mean(recent)) < rate
            if at_risk and (worst is None or cls < worst):
                worst = cls
        return worst

    def _block_decode(self, n: int):
        """One fused decode block: one upload, ``n`` steps (one graph
        replay on the card), one download.  The cache is written in
        place.  A speculative engine's shed blocks run here too."""
        blocks = self.blocks
        if self.spec:
            if self._plain_blocks is None:
                self._plain_blocks = DecodeBlocks(
                    self.cfg, self.ctx, self.batch, self.device,
                    graphs=self.blocks.graphs)
            blocks = self._plain_blocks
        state = blocks.pack(self.tokens, self.pos, self.live,
                            self.stop_pos, self.temperature, self.top_k,
                            self._gen_step, self.eos_id)
        # all-greedy batches skip the top-k sorts and the noise (greedy
        # consumes no PRNG state, so the stream is unaffected)
        key = self._key if (self.temperature > 0).any() else None
        out = blocks(self.params, self.cache, state, key, n)
        block, block_live, self.tokens, self.pos, self.live, fault = \
            blocks.unpack(out, n)
        return block, block_live, fault

    def _block_spec(self, n: int):
        """One speculative block of ``n`` rounds: one upload (with the
        drafting history), one graph replay on the card, one download
        (with the accepted counts and the new history)."""
        self.blocks.set_spec_k(self.spec_k)
        state = self.blocks.pack(self.tokens, self.pos, self.live,
                                 self.stop_pos, self.temperature, self.top_k,
                                 self._gen_step, self.eos_id, hist=self.hist)
        key = self._key if (self.temperature > 0).any() else None
        model_draft = self.draft is not None and self.drafter_fn is None
        draft = (self.draft[1], self.draft_cache) if model_draft else None
        out = self.blocks(self.params, self.cache, state, key, n, draft=draft)
        (block, block_live, self.tokens, self.pos, self.live, fault,
         accepted, hist) = self.blocks.unpack(out, n)
        if hist is not None:
            self.hist = hist
        # rounds in which a slot was live, and the drafts each committed
        step_live = block_live.reshape(n, self.spec_k + 1, self.batch)[:, 0]
        rounds = int(step_live.sum())
        acc = int(accepted[step_live].sum())
        self.counters["verify_steps"] += rounds
        self.counters["draft_accepted"] += acc
        # for the spec_k adapter, read by step_many once the block has
        # passed the fault check (a replayed block is observed once)
        self._last_spec_obs = (rounds, acc)
        return block, block_live, fault

    def step(self):
        """Per-token decode: the n=1 block."""
        return self.step_many(1)

    def finish(self, slot: int,
               status: RequestStatus = RequestStatus.COMPLETED):
        """Retire ``slot`` with a terminal ``status``: its tokens land in
        ``results[req_id]`` (partial for CANCELLED, TIMED_OUT and FAILED).
        Dense: its KV rows are zeroed, so a recycled slot never observes
        its previous occupant.  Paged: its own pages return to the free
        list, its shared prefix pages lose its reference only, and its
        table row points at the trash page (the device table is rewritten
        lazily, once per sweep)."""
        with self._journal_scope("finish", int(slot), status.value):
            self._finish(slot, status)

    def _finish(self, slot: int, status: RequestStatus) -> None:
        meta = self._req_meta.pop(slot, None)
        if meta is not None:
            cls = coerce_priority(meta.get("priority"))
            done = meta.get("t_done", self.clock())
            self.request_log.append(request_row(
                ttft_s=meta["ttft_s"],
                gen_tokens=len(self.outputs[slot] or []),
                decode_s=done - meta["t_admit"], status=status,
                priority=cls))
            self.results[meta["id"]] = {
                "status": status, "tokens": list(self.outputs[slot] or [])}
            key = {RequestStatus.CANCELLED: "cancellations",
                   RequestStatus.TIMED_OUT: "timeouts",
                   RequestStatus.FAILED: "failures"}.get(status)
            if key is not None:
                self.counters[key] += 1
                self._class_count(cls, key)
            elif status is RequestStatus.COMPLETED:
                self._class_count(cls, "completed")
        self.done.append(self.outputs[slot])
        self.outputs[slot] = None
        self.live[slot] = False
        self.pos[slot] = 0
        self.temperature[slot] = 0.0
        self.top_k[slot] = 0
        self.stop_pos[slot] = self.max_len
        self.cache = invalidate_fn(self.cache, slot, self.cfg)
        if self.draft is not None:
            # the draft rounds advance dead lanes too: a recycled slot's
            # drafter must not see its previous occupant either
            self.draft_cache = invalidate_fn(self.draft_cache, slot,
                                             self.draft[0])
        if self.paged:
            if self.prefix_cache:
                self.allocator.free(self._slot_shared.pop(slot, []))
                self._pub.pop(slot, None)
            self.allocator.free(self._slot_pages.pop(slot, []))
            self.block_tables[slot, :] = self._trash
            self._bt_dirty = True
        self._clean[slot] = True

    # -- snapshot / restore -----------------------------------------------------
    def snapshot(self) -> dict:
        """Everything a block can change, copied to host memory: the cache
        (and a draft model's), the slot arrays, the allocator with its
        free-list order, block tables, queue, outputs, results, counters,
        the prefix index and the PRNG step, so that :meth:`restore`
        rewinds the engine to this block boundary exactly."""
        snap = {
            "cache": _host_copy(self.cache),
            "pos": self.pos.copy(), "tokens": self.tokens.copy(),
            "live": self.live.copy(), "clean": self._clean.copy(),
            "temperature": self.temperature.copy(),
            "top_k": self.top_k.copy(),
            "stop_pos": self.stop_pos.copy(), "hist": self.hist.copy(),
            "gen_step": self._gen_step, "round": self._round,
            "next_id": self._next_id,
            "head_blocked": dict(self._head_blocked),
            "class_counters": {c: dict(row) for c, row
                               in self.class_counters.items()},
            "outputs": [None if o is None else list(o)
                        for o in self.outputs],
            "done": list(self.done),
            "waiting": [_copy_record(r) for r in self.waiting],
            "req_meta": {s: dict(m) for s, m in self._req_meta.items()},
            "results": {k: {"status": v["status"],
                            "tokens": list(v["tokens"])}
                        for k, v in self.results.items()},
            "counters": dict(self.counters),
            "request_log": [dict(r) for r in self.request_log],
        }
        if self.paged:
            snap["allocator"] = self.allocator.state()
            snap["block_tables"] = self.block_tables.copy()
            snap["bt_dirty"] = self._bt_dirty
            snap["slot_pages"] = {s: list(p)
                                  for s, p in self._slot_pages.items()}
        if self.prefix_cache:
            snap["prefix_index"] = self.prefix_index.state()
            snap["slot_shared"] = {s: list(p)
                                   for s, p in self._slot_shared.items()}
            snap["pub"] = dict(self._pub)
        if self.draft is not None:
            snap["draft_cache"] = _host_copy(self.draft_cache)
        return snap

    def restore(self, snap: dict) -> None:
        """Rewind the engine to a :meth:`snapshot`, which stays pristine
        (one snapshot survives any number of replays).  The caches are
        written back into their tensors in place: their addresses, and
        with them the captured decode graphs, survive."""
        _write_back(self.cache, snap["cache"])
        self.pos = snap["pos"].copy()
        self.tokens = snap["tokens"].copy()
        self.live = snap["live"].copy()
        self._clean = snap["clean"].copy()
        self.temperature = snap["temperature"].copy()
        self.top_k = snap["top_k"].copy()
        self.stop_pos = snap["stop_pos"].copy()
        self.hist = snap["hist"].copy()
        self._gen_step = snap["gen_step"]
        self._round = snap["round"]
        self._next_id = snap["next_id"]
        self._head_blocked = dict(snap["head_blocked"])
        self.class_counters = {c: dict(row) for c, row
                               in snap["class_counters"].items()}
        self.outputs = [None if o is None else list(o)
                        for o in snap["outputs"]]
        self.done = list(snap["done"])
        self.waiting = deque(_copy_record(r) for r in snap["waiting"])
        self._req_meta = {s: dict(m) for s, m in snap["req_meta"].items()}
        self.results = {k: {"status": v["status"],
                            "tokens": list(v["tokens"])}
                        for k, v in snap["results"].items()}
        self.counters = dict(self.counters, **snap["counters"])
        self.request_log = [dict(r) for r in snap["request_log"]]
        if self.paged:
            self.allocator.load_state(snap["allocator"])
            self.block_tables = snap["block_tables"].copy()
            self._bt_dirty = snap["bt_dirty"]
            self._slot_pages = {s: list(p)
                                for s, p in snap["slot_pages"].items()}
        if self.prefix_cache:
            self.prefix_index.load_state(snap["prefix_index"])
            self._slot_shared = {s: list(p)
                                 for s, p in snap["slot_shared"].items()}
            self._pub = dict(snap["pub"])
        if self.draft is not None:
            _write_back(self.draft_cache, snap["draft_cache"])

    def save_snapshot(self, directory: str, step: int = 0) -> str:
        """Write :meth:`snapshot` to disk atomically (``save_blob``)."""
        return save_blob(self.snapshot(), directory, step)

    def load_snapshot(self, directory: str,
                      step: Optional[int] = None) -> None:
        """Restore the newest (or the given) on-disk snapshot."""
        if step is None:
            step = latest_step(directory)
            if step is None:
                raise FileNotFoundError(f"no engine snapshot under "
                                        f"{directory}")
        self.restore(load_blob(directory, step))

    # -- crash-safe warm restart ------------------------------------------------
    def _save_durable(self) -> str:
        """One durable snapshot: :meth:`snapshot` plus the journal cursor
        (the records it already reflects), through ``save_blob``'s tmp +
        rename, so a crash mid-save leaves the previous one in force."""
        snap = self.snapshot()
        snap["journal_cursor"] = self._journal.count
        path = save_blob(snap, self._durable_dir, self._durable_step)
        self._durable_step += 1
        return path

    def recover(self, directory: str) -> dict:
        """Rebuild this freshly built Engine from a killed run's durable
        directory and journal on into it.

        Build the Engine with the dead one's arguments but without
        ``durable_dir`` (that would truncate the journal), then call
        ``recover``: the newest durable snapshot is restored (in place:
        the cache keeps its tensors), the journal's records past its
        cursor run again (muted, not journaled twice) and the journal
        reopens for append, a torn tail truncated.  Greedy and sampled
        streams resume exactly (``gen_step`` rides the snapshot).  The
        dead Engine gave up its device state where it died
        (:meth:`release`, called by the fault injector).

        Returns ``{"snapshot_step", "replayed"}``.
        """
        if self._journal is not None:
            raise RuntimeError(
                "recover() on an engine constructed with durable_dir: "
                "construction already truncated the journal -- build "
                "the engine without durable_dir and recover into it")
        directory = str(directory)
        log = BlobLog(os.path.join(directory, "journal.log"))
        step = latest_step(directory)
        cursor = 0
        if step is not None:
            snap = load_blob(directory, step)
            cursor = int(snap.get("journal_cursor", 0))
            self.restore(snap)
            self._durable_step = step + 1
        records = log.read(cursor)
        self._jmute += 1
        try:
            for rec in records:
                self._replay_event(rec)
        finally:
            self._jmute -= 1
        self._adopt_journal(log, directory)
        self.counters["recoveries"] += 1
        return {"snapshot_step": step, "replayed": len(records)}

    def _adopt_journal(self, log: BlobLog, directory: str) -> None:
        """Journal on into ``log`` under ``directory`` (recovery and a
        fleet's promotion)."""
        self._journal = log
        self._durable_dir = str(directory)
        self._blocks_since_snap = 0

    def _replay_event(self, rec: tuple) -> None:
        """Run one journaled transition again (muted by the caller)."""
        kind = rec[0]
        if kind == "submit":
            p = rec[1]
            rid = self.submit(p["prompt"], gen_len=p["gen_len"],
                              temperature=p["temperature"],
                              top_k=p["top_k"], deadline_s=p["deadline_s"],
                              priority=p["priority"])
            if rid != p["id"]:
                raise RuntimeError(
                    f"journal replay diverged: submit re-minted id {rid}, "
                    f"the journal says {p['id']} (snapshot and journal "
                    f"from different runs?)")
        elif kind == "add":
            p = rec[1]
            self.add_requests(p["requests"], gen_len=p["gen_len"],
                              temperature=p["temperature"], top_k=p["top_k"],
                              deadline_s=p["deadline_s"],
                              priority=p["priority"])
        elif kind == "admit":
            self.try_admit()
        elif kind == "block":
            self.step_many(rec[1])
        elif kind == "retire":
            self.retire_finished()
        elif kind == "cancel":
            self.cancel(rec[1])
        elif kind == "finish":
            self.finish(rec[1], status=RequestStatus(rec[2]))
        else:
            raise RuntimeError(f"unknown journal record kind {kind!r}")

    def release(self) -> None:
        """Give up the device state of an Engine that died in this process
        (a crash, a fleet replica's death): its decode graphs (and the
        scratch they captured), caches and params references, and its
        journal handle.  The Engine serves nothing afterwards."""
        if self._journal is not None:
            self._journal.close()
        for blocks in (self.blocks, self._plain_blocks):
            if blocks is not None:
                blocks.release()
        self.cache = self.draft_cache = self.params = None
        self.draft = None

    def _poison_cache(self, value: float) -> None:
        """Chaos hook: fill every float leaf of the serving cache with
        ``value``, in place (block tables and int8 payloads stay)."""
        for _, leaf in cache_leaves(self.cache):
            if leaf.is_floating_point():
                leaf.fill_(float(value))

    # -- telemetry ----------------------------------------------------------------
    def stats(self) -> dict:
        """Serving telemetry: TTFT (submit -> first token), decode tokens
        per second of block wall time (syncs included), the model calls
        made (decode steps, prefill chunks and the prompt tokens they
        computed), the cache, the resolved split-KV knob (None when
        dense), whether blocks run as CUDA graphs, how many were captured
        and the seconds that took (inside ``decode_s``), and the kernel
        launch counts since the last reset (a graph replay counts every
        launch it runs).  Under ``spec``: the live verify rounds, the
        mean drafts accepted per round and ``spec_k`` (now, at
        construction, and the switches the adapter made).  The autotuner's
        mode, its estimator's source and the resolved ``decode_block``.
        The lifecycle: prefix-cache hits, pages and tokens saved and
        copy-on-write copies; preemptions, cancellations, timeouts,
        failures, replays, spilled pages, shed spec rounds and straggler
        blocks; recoveries from a journal and the standby's journal lag;
        per-class rows (``classes``) for every class with any activity."""
        c = self.counters
        captures = self.blocks.captures + (self._plain_blocks.captures
                                           if self._plain_blocks else 0)
        capture_s = self.blocks.capture_s + (self._plain_blocks.capture_s
                                             if self._plain_blocks else 0.0)
        out = {"requests": len(self.done), "admitted": c["admitted"],
               "peak_live": c["peak_live"], "gen_tokens": c["gen_tokens"],
               "decode_s": c["decode_s"],
               "decode_tok_per_s": (c["gen_tokens"] / c["decode_s"]
                                    if c["decode_s"] > 0 else None),
               "decode_steps": c["decode_steps"],
               "prefill_chunks": c["prefill_chunks"],
               "prefill_tokens": c["prefill_tokens"],
               "paged": self.paged, "kv_bits": self.kv_bits,
               "kv_split": self.kv_split,
               "pages_per_step": self.pages_per_step,
               "queued": len(self.waiting),
               "device": str(self.device), "graphs": self.blocks.graphs,
               "graph_captures": captures, "graph_capture_s": capture_s,
               "kernel_launches": launch_counts()}
        if self.spec:
            out["verify_steps"] = c["verify_steps"]
            out["accepted_per_step"] = (c["draft_accepted"]
                                        / max(c["verify_steps"], 1))
            out["spec_k"] = self.spec_k
            out["spec_k_init"] = self._spec_k_init
            out["spec_k_rejits"] = c["spec_k_rejits"]
        out["autotune"] = self.autotune
        if self._autotune_est is not None:
            out["autotune_source"] = self._autotune_est.source
        if self.decode_block is not None:
            out["decode_block"] = self.decode_block
        if self.request_log:
            out["ttft_mean_s"] = float(np.mean(
                [r["ttft_s"] for r in self.request_log]))
            rates = [r["tok_per_s"] for r in self.request_log
                     if r["tok_per_s"] is not None]
            out["req_tok_per_s_mean"] = (float(np.mean(rates))
                                         if rates else None)
        if self.prefix_cache:
            for k in ("prefix_hits", "prefix_hit_pages",
                      "prefix_tokens_saved", "cow_copies"):
                out[k] = c[k]
            out["shared_pages"] = self.allocator.shared_pages()
            out["prefix_index_pages"] = len(self.prefix_index)
        for k in ("preemptions", "cancellations", "timeouts", "failures",
                  "replays", "spilled_pages", "shed_spec_rounds",
                  "straggler_blocks"):
            out[k] = c[k]
        out["straggler_events"] = (len(self.straggler.events)
                                   if self.straggler is not None else 0)
        out["uptime_s"] = float(self.clock() - self._t_start)
        out["recoveries"] = c["recoveries"]
        out["journal_lag_records"] = self.journal_lag_records
        classes = {}
        for cls in PriorityClass:
            row = dict(self.class_counters[cls])
            rows = [r for r in self.request_log
                    if r.get("priority", "standard") == cls.name.lower()]
            row["requests"] = len(rows)
            row["queued"] = sum(1 for r in self.waiting
                                if self._rec_priority(r) == cls)
            if rows:
                tt = [r["ttft_s"] for r in rows]
                row["ttft_p50_s"] = float(np.percentile(tt, 50))
                row["ttft_p99_s"] = float(np.percentile(tt, 99))
                rates = [r["tok_per_s"] for r in rows
                         if r["tok_per_s"] is not None]
                row["tok_per_s_mean"] = (float(np.mean(rates))
                                         if rates else None)
            if (row["requests"] or row["queued"]
                    or any(row[k] for k in self._fresh_class_row())):
                classes[cls.name.lower()] = row
        if classes:
            out["classes"] = classes
        if self.slo_targets:
            out["slo_targets"] = {c.name.lower(): dict(t)
                                  for c, t in self.slo_targets.items()}
        return out


def build_ctx(args) -> QuantContext:
    """QuantContext from CLI flags (the reference's ``launch.train.build_ctx``)."""
    policy = PrecisionPolicy()
    if args.quant != "none":
        qt = FixedPointType(args.qbits, max(args.qbits // 2, 2))
        policy = PrecisionPolicy.uniform(qt)
    return QuantContext(mode=args.quant, policy=policy, use_lut=args.lut,
                        compute_dtype=(torch.float32 if args.f32
                                       else torch.bfloat16),
                        reuse_factor=args.reuse_factor)


def _parse_class_quotas(specs) -> Optional[dict]:
    """``--class-quota CLASS:KIND=FRACTION`` strings -> the quotas
    :func:`normalize_class_quotas` validates (None without the flag)."""
    if not specs:
        return None
    quotas: Dict[str, Dict[str, float]] = {}
    for spec in specs:
        head, sep, val = spec.partition("=")
        cls, csep, kind = head.partition(":")
        if not sep or not csep or not cls or not kind:
            raise SystemExit(
                f"--class-quota {spec!r}: expected CLASS:KIND=FRACTION "
                f"(e.g. realtime:floor=0.25)")
        try:
            frac = float(val)
        except ValueError:
            raise SystemExit(
                f"--class-quota {spec!r}: fraction {val!r} is not a number")
        quotas.setdefault(cls, {})[kind] = frac
    return normalize_class_quotas(quotas)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Serve a model with the PyTorch/CUDA port.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--quant", default="none",
                    choices=["none", "fake", "int8"])
    ap.add_argument("--qbits", type=int, default=8)
    ap.add_argument("--reuse-factor", type=int, default=1,
                    help="the reference's compile knob (scan_unroll); no "
                         "numeric effect")
    ap.add_argument("--lut", action="store_true",
                    help="the paper's constant-table activations and softmax")
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--kv-bits", type=int, default=None, choices=[8],
                    help="int8 KV cache (per-token scales)")
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--decode-block", type=int, default=None,
                    help="decode steps per block (default: the autotuner's "
                         "resolved block; 8 with --autotune off)")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache: shared page pool + block tables "
                         "(default: the dense cache)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=None)
    ap.add_argument("--kv-split", default="auto")
    ap.add_argument("--pages-per-step", default="auto")
    ap.add_argument("--autotune", default="analytic",
                    choices=("off", "analytic", "fitted"),
                    help="knob resolution: 'off' = the knobs as given and "
                         "the cost model; 'analytic' = the resolver on the "
                         "hand-set constants (same knobs); 'fitted' = the "
                         "resolver on the card's measured fit "
                         "(AUTOTUNE_H100.json; analytic without it).  Other "
                         "split knobs sum attention in another order: with "
                         "int8 weights greedy streams can change")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="restrict sampling to the k best logits (0 = off)")
    ap.add_argument("--seed", type=int, default=0,
                    help="weights, prompts and the sampling key")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain versions)")
    ap.add_argument("--spec", action="store_true",
                    help="speculative decoding: draft k tokens a round and "
                         "verify them with one target call (greedy streams "
                         "stay the plain engine's)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="drafted tokens per verify round")
    ap.add_argument("--spec-draft", default=None,
                    help="arch of a draft model sharing the target's "
                         "vocab (implies --spec); default: prompt lookup")
    ap.add_argument("--spec-ngram", type=int, default=2,
                    help="context length of the prompt-lookup match")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="prefix caching over the page pool (needs "
                         "--paged): committed prompt pages are shared "
                         "copy-on-write with later requests that open with "
                         "the same tokens, which prefill only their suffix")
    ap.add_argument("--preempt", action="store_true",
                    help="preempt-and-spill (needs --paged): under page "
                         "pressure spill a running victim's pages to host "
                         "memory and resume it later")
    ap.add_argument("--shed-threshold", type=float, default=None,
                    help="page-pool occupancy (0..1) past which a block is "
                         "halved and speculation skipped")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request TTL from submission; past it the "
                         "request times out at the next block boundary "
                         "with its partial output")
    ap.add_argument("--priority-class", default="standard",
                    choices=[c.name.lower() for c in PriorityClass],
                    help="SLO class of the submitted requests (realtime > "
                         "standard > batch, FIFO within a class)")
    ap.add_argument("--slo-ttft-s", type=float, default=None,
                    help="TTFT target (s) of the realtime class: a realtime "
                         "request queued past it preempts at once and "
                         "sheds speculation until it is served")
    ap.add_argument("--slo-tok-per-s", type=float, default=None,
                    help="decode-rate target (tok/s) of the realtime class, "
                         "driving the same shedding")
    ap.add_argument("--graphs", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="decode blocks as CUDA graph replays (default: on "
                         "for cuda; --no-graphs runs them eagerly)")
    ap.add_argument("--durable-dir", default=None,
                    help="crash-safe warm restart: journal every request "
                         "and block (fsync'd, write-ahead) and snapshot "
                         "the engine every --snapshot-every blocks under "
                         "this directory; Engine.recover(dir) rebuilds a "
                         "killed engine")
    ap.add_argument("--snapshot-every", type=int, default=8,
                    help="blocks between durable snapshots (0: journal "
                         "only)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve through a Fleet of N engine replicas "
                         "(least-pressure routing, heartbeat failure "
                         "detection)")
    ap.add_argument("--standby-dir", default=None,
                    help="a journal-shipped hot standby (implies a fleet): "
                         "the primary journals here, the standby tails it "
                         "and is promoted when the primary dies")
    ap.add_argument("--class-quota", action="append", default=None,
                    metavar="CLASS:KIND=FRACTION",
                    help="partition the page pool per class (repeatable; "
                         "needs --paged): 'realtime:floor=0.25' reserves a "
                         "quarter of the pages for realtime, "
                         "'batch:cap=0.5' caps batch at half")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if _cross_input_refusal(cfg) is not None:
        ap.error(f"--arch {args.arch}: {_cross_input_refusal(cfg)}")
    device = resolve_device(args.device)
    if args.smoke:
        cfg = cfg.smoke()
    ctx = build_ctx(args)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if args.quant == "int8":
        params = quantize_for_serving(
            get_family(cfg).init(gen, cfg, device=device), ctx)
    else:
        # float projections cast their weights to the compute dtype before
        # every product; drawing them in it changes no value
        params = get_family(cfg).init(gen, cfg, dtype=ctx.compute_dtype,
                                      device=device)

    if args.spec_draft:
        args.spec = True                    # a drafter implies --spec
    spec_draft = None
    if args.spec_draft:
        d_cfg = get_config(args.spec_draft)
        if _cross_input_refusal(d_cfg) is not None:
            ap.error(f"--spec-draft {args.spec_draft}: cannot draft: "
                     f"{_cross_input_refusal(d_cfg)}")
        if args.smoke:
            d_cfg = d_cfg.smoke()
        d_gen = torch.Generator(device=device).manual_seed(args.seed + 1)
        spec_draft = (d_cfg, get_family(d_cfg).init(d_gen, d_cfg,
                                                    device=device), ctx)

    def knob(v):
        return "auto" if v == "auto" else int(v)

    fleet_mode = args.replicas > 1 or args.standby_dir is not None
    eng_kw = dict(
        batch=args.batch, max_len=args.prompt_len + args.gen_len + 1,
        kv_bits=args.kv_bits, prefill_chunk=args.prefill_chunk,
        seed=args.seed, paged=args.paged, page_size=args.page_size,
        num_pages=args.num_pages, kv_split=knob(args.kv_split),
        pages_per_step=knob(args.pages_per_step),
        autotune=args.autotune, spec=args.spec,
        spec_k=args.spec_k, spec_draft=spec_draft,
        spec_ngram=args.spec_ngram, prefix_cache=args.prefix_cache,
        preempt=args.preempt, shed_threshold=args.shed_threshold,
        class_quotas=_parse_class_quotas(args.class_quota),
        slo_targets=({"realtime": {"ttft_s": args.slo_ttft_s,
                                   "tok_per_s": args.slo_tok_per_s}}
                     if (args.slo_ttft_s is not None
                         or args.slo_tok_per_s is not None) else None),
        # a fleet owns durability (the primary journals under
        # --standby-dir): replicas sharing one --durable-dir would
        # clobber each other's journal
        durable_dir=None if fleet_mode else args.durable_dir,
        snapshot_every=args.snapshot_every, device=device,
        graphs=args.graphs)

    def make_engine(**over):
        return Engine(cfg, ctx, params, **dict(eng_kw, **over))

    fleet = None
    if fleet_mode:
        from .fleet import Fleet
        fleet = Fleet(make_engine, args.replicas,
                      standby_dir=args.standby_dir)
        eng = fleet.replicas[0]
    else:
        eng = make_engine()
    src = SyntheticLM(cfg.vocab, seed=args.seed)
    prompts = [src.tokens(i, 1, args.prompt_len)[0, :-1]
               for i in range(args.requests)]
    # explicit flag > the autotuner's resolved block > 8
    block = max(1, args.decode_block if args.decode_block is not None
                else (eng.decode_block or 8))
    t0 = time.perf_counter()
    sub = dict(gen_len=args.gen_len, temperature=args.temperature,
               top_k=args.top_k, deadline_s=args.deadline_s,
               priority=args.priority_class)
    if fleet is not None:
        for p in prompts:
            fleet.submit(p, **sub)
        fleet.try_admit()
        fleet.drain(block=block)
        eng = fleet.replicas[0]     # a promotion may have replaced it
        gen_tokens = sum(st["gen_tokens"]
                         for st in fleet.stats()["per_replica"]
                         if st is not None)
    else:
        for p in prompts:
            eng.submit(p, **sub)
        eng.try_admit()
        gen_tokens = 0
        while eng.live.any() or eng.waiting:
            _, block_live = eng.step_many(block)
            gen_tokens += int(block_live.sum())
        eng.retire_finished()
    dt = time.perf_counter() - t0
    cache = (f"paged(ps={eng.allocator.page_size},"
             f"pages={eng.allocator.num_pages},kv_split={eng.kv_split},"
             f"pages_per_step={eng.pages_per_step})" if eng.paged
             else "dense")
    if args.spec:
        cache += (f" spec(k={eng.spec_k},"
                  f"draft={args.spec_draft or 'ngram'})")
    if args.prefix_cache:
        cache += " prefix-cache"
    if args.preempt:
        cache += " preempt"
    served = len(fleet.results) if fleet is not None else len(eng.results)
    print(f"served {served} requests, {gen_tokens} tokens in "
          f"{dt:.2f}s ({gen_tokens / dt:.1f} tok/s), quant={args.quant} "
          f"lut={args.lut} kv_bits={args.kv_bits} device={device} {cache} "
          f"decode_block={block} autotune={args.autotune} "
          f"temperature={args.temperature} top_k={args.top_k} "
          f"graphs={eng.blocks.graphs}")
    if fleet is not None:
        fs = fleet.stats()
        print(f"fleet: {args.replicas} replicas (states "
              f"{','.join(fs['states'])}), standby="
              f"{'on' if fs['standby'] else 'off'}, deaths={fs['deaths']} "
              f"promotions={fs['promotions']} "
              f"redispatched={fs['redispatched']}")
    print(json.dumps(eng.stats(), default=str))
    return fleet.results if fleet is not None else eng.done


if __name__ == "__main__":
    main()
