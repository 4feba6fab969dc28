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
  page.
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
  (``spec_ngram``), from a draft model of the ``lm`` family
  (``spec_draft=(cfg, params, ctx)``, its own dense cache, prefilled with
  the target), or from a caller's ``drafter_fn``; the target verifies them
  in one call over ``spec_k + 1`` positions.  Greedy streams are the plain
  engine's; sampled ones keep its distribution.  On the card a block is
  one CUDA graph replay too.
* **Continuous batching**: ``submit`` queues requests; each block
  boundary retires finished lanes and admits the queue head (FIFO) as
  soon as a lane (and, paged, enough free pages) exists.
* **KV cache**: dense by default, as in the reference -- per-slot rows
  ``max_len`` plus a margin long (``prefill_chunk``, or ``spec_k + 2``
  when larger), a retired slot's rows zeroed -- or
  paged (``paged=True``), with the split-KV knob resolved once per
  geometry, exactly as the reference resolves it.  ``kv_bits=8`` stores
  either as int8 rows or pages with bf16 scales.  ``stats()`` reports
  the cache, the knob and the kernel launch counts.

Out of this slice (ROADMAP.md):
prefix caching, preemption, priorities, the durable journal, the fleet,
the autotuner (and with it the adaptive ``spec_k``) and non-``lm``
families (the ``encdec`` family serves through the step builders of
``repro_torch.train.step``, as the reference Engine never runs an
encoder).  The Engine and the CLI refuse them by name.

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
"""

from __future__ import annotations

import argparse
import dataclasses
import json
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
from ..models.api import (get_family, init_cache_fn, init_paged_cache_fn,
                          invalidate_fn, set_block_table)
from ..nn.context import QuantContext
from ..train.graphs import DecodeBlocks
from ..train.step import build_prefill_step
from .lifecycle import RequestStatus, request_row, validate_request
from .lifecycle import now as _now
from .paging import PageAllocator

__all__ = ["Engine", "resolve_device", "quantize_for_serving",
           "prepare_params", "build_ctx", "main"]


def _refuse_encdec(cfg) -> None:
    """The Engine serves decoder-only models: the reference Engine never
    runs an encoder (its looped prefill decodes against the zero cross
    K/V of ``init_cache`` and never passes ``enc_input``)."""
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: the Engine does not serve the encdec family (the "
            f"reference Engine never runs the encoder); serve it through "
            f"train.step.build_prefill_step with enc_input and "
            f"build_decode_loop (ROADMAP.md queue 1, item 7)")


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


class Engine:
    """Slot-based continuous batching over chunked prefill and fused decode
    blocks (greedy or sampled per slot), on a dense (default) or paged KV
    cache.

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
    (``lm`` family, the target's vocab); ``drafter_fn(hist, tok, pos) ->
    (B, k)`` drafts for tests.  ``step_many(n)`` then runs ``n`` rounds.
    """

    def __init__(self, cfg, ctx: QuantContext, params, *, batch: int,
                 max_len: int, kv_bits=None, prefill_chunk: int = 16,
                 eos_id: int = -1, seed: int = 0, paged: bool = False,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 kv_split="auto", pages_per_step="auto",
                 autotune: str = "off", spec: bool = False, spec_k: int = 4,
                 spec_draft=None, spec_ngram: int = 2, drafter_fn=None,
                 device=None, graphs=None):
        if kv_bits not in (None, 8):
            raise ValueError(f"kv_bits must be None or 8, not {kv_bits!r}")
        if autotune != "off":
            raise NotImplementedError(
                f"autotune={autotune!r}: the autotuner is not ported yet "
                f"(ROADMAP.md queue 1, item 9); use 'off'")
        if not spec and (spec_draft is not None or drafter_fn is not None):
            raise ValueError(
                "spec_draft/drafter_fn were given but spec=False -- a "
                "drafter without speculation would silently never run; "
                "pass spec=True")
        _refuse_encdec(cfg)
        get_family(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.batch, self.max_len = batch, max_len
        self.prefill_chunk = max(1, prefill_chunk)
        self.seed = seed
        self.params = prepare_params(params, ctx, self.device)
        self.kv_bits = kv_bits
        cache_dtype = torch.int8 if kv_bits == 8 else torch.float32
        # chunked prefill writes a full chunk at every lane's position,
        # also at a generating lane's (ignored) one, and a verify pass
        # k + 1 rows from a (possibly held) position: the margin keeps
        # those writes past max_len (dense rows, or table entries)
        margin = self.prefill_chunk
        self.spec, self.spec_k = bool(spec), max(1, int(spec_k))
        self.spec_ngram = max(1, int(spec_ngram))
        self.drafter_fn = drafter_fn
        if self.spec:
            margin = max(margin, self.spec_k + 2)
        #: committed tokens per slot at their absolute positions (prompt
        #: and accepted generations): the prompt-lookup drafter's corpus
        self.hist = np.zeros((batch, max_len + self.spec_k + 2), np.int32)
        self.draft = None
        if self.spec and spec_draft is not None:
            d_cfg, d_params, d_ctx = spec_draft
            if d_cfg.vocab != cfg.vocab:
                raise ValueError(
                    f"draft model vocab {d_cfg.vocab} != target vocab "
                    f"{cfg.vocab}; drafts would be meaningless")
            if d_cfg.family != "lm":
                raise NotImplementedError(
                    f"draft model {d_cfg.name} ({d_cfg.family}): only lm "
                    f"drafters are ported (ROADMAP.md queue 1, item 14)")
            d_ctx = d_ctx or ctx
            self.draft = (d_cfg, prepare_params(d_params, d_ctx, self.device),
                          d_ctx)
            # the drafter's cache is dense: one model's rows, rolled back by
            # pos, never paged (paging meters the target's admission)
            self.draft_cache = init_cache_fn(
                d_cfg, batch, max_len + max(self.prefill_chunk,
                                            self.spec_k + 2),
                torch.float32, self.device)
            self._draft_prefill = build_prefill_step(d_cfg, d_ctx)
        self.paged = bool(paged)
        self._bt_dirty = False
        self.kv_split = self.pages_per_step = None
        if self.paged:
            ps = max(1, int(page_size))
            if num_pages is None:
                num_pages = -(-(batch * max_len) // ps)
            self.allocator = PageAllocator(num_pages, ps)
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
            self.pages_per_step, self.kv_split = _resolve_knobs(
                width, ps, max(1, hkv), batch, req_s, req_t)
            ctx = dataclasses.replace(ctx, kv_split=self.kv_split,
                                      pages_per_step=self.pages_per_step)
        else:
            self.cache = init_cache_fn(cfg, batch, max_len + margin,
                                       cache_dtype, self.device)
        self.ctx = ctx
        self.prefill = build_prefill_step(cfg, self.ctx)
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
        self.pos = np.zeros((batch,), np.int32)
        self.live = np.zeros((batch,), bool)
        self.tokens = np.zeros((batch, 1), np.int32)
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
                         "decode_s": 0.0, "failures": 0, "decode_steps": 0,
                         "prefill_chunks": 0, "verify_steps": 0,
                         "draft_accepted": 0}
        self.request_log: List[dict] = []
        self._req_meta: Dict[int, dict] = {}
        self.results: Dict[int, dict] = {}
        self._next_id = 0
        self.clock = _now

    # -- admission ------------------------------------------------------------
    def add_requests(self, requests: Dict[int, np.ndarray], *,
                     gen_len=None, temperature=None, top_k=None,
                     _t_submit=None, _ids=None):
        """Prefill several fresh slots together (batched chunked prefill).

        ``gen_len`` (scalar or ``{slot: v}``) bounds generation
        (``stop_pos = min(prompt_len + gen_len, max_len)``);
        ``temperature``/``top_k`` (scalar or ``{slot: v}``, default 0)
        set the slots' sampling (negative values are refused).  Paged: the
        whole token budget's pages are allocated here (MemoryError when
        the pool is short; queue through :meth:`submit` to wait instead).
        An empty prompt is a single pad token (id 0).
        """
        t_call = self.clock()
        reqs = {int(s): validate_request(p, vocab=self.cfg.vocab,
                                         temperature=temperature,
                                         top_k=top_k)
                for s, p in requests.items()}
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

        if self.paged:
            self._alloc_pages({s: stop_of(s, p.shape[0])
                               for s, p in reqs.items()})

        first = self._prefill_chunked(reqs)
        t_first = self.clock()
        for s, p in reqs.items():
            self.pos[s] = p.shape[0]
            self.live[s] = True
            self.outputs[s] = []
            self.tokens[s, 0] = first[s]
            self.temperature[s] = per_slot(temperature, s, 0.0)
            self.top_k[s] = per_slot(top_k, s, 0)
            self.stop_pos[s] = stop_of(s, p.shape[0])
            self.hist[s, :] = 0
            self.hist[s, :p.shape[0]] = p
            t_sub = (_t_submit or {}).get(s, t_call)
            rid = (_ids or {}).get(s)
            if rid is None:
                rid = self._mint_id()
            self._req_meta[s] = {"id": rid, "ttft_s": t_first - t_sub,
                                 "t_admit": t_first}
        self.counters["admitted"] += len(reqs)
        self.counters["peak_live"] = max(self.counters["peak_live"],
                                         int(self.live.sum()))

    def _alloc_pages(self, budgets: Dict[int, int]) -> None:
        """Pages for each slot's whole token budget, all or nothing, and
        the block table flushed to the device."""
        needs = {s: self.allocator.pages_for(n) for s, n in budgets.items()}
        recyclable = sum(len(self._slot_pages.get(s, ())) for s in needs)
        if sum(needs.values()) - self.allocator.free_pages - recyclable > 0:
            raise MemoryError(
                f"page pool exhausted: admission needs "
                f"{sum(needs.values())} pages, free "
                f"{self.allocator.free_pages} of {self.allocator.num_pages} "
                f"(queue through submit() to wait for pages)")
        for s in needs:
            if s in self._slot_pages:
                self.allocator.free(self._slot_pages.pop(s))
        for s, need in needs.items():
            pages = self.allocator.alloc(need, owner=s)
            self._slot_pages[s] = pages
            self.block_tables[s, :] = self._trash
            self.block_tables[s, :len(pages)] = pages
        self._flush_block_tables()

    def _flush_block_tables(self):
        """Upload the host block table into every layer's table (one copy
        covering every edit since the last flush)."""
        set_block_table(self.cache, torch.from_numpy(
            self.block_tables.copy()).to(self.device))
        self._bt_dirty = False

    def _mint_id(self) -> int:
        rid = self._next_id
        self._next_id += 1
        return rid

    def submit(self, prompt: np.ndarray, *, gen_len: Optional[int] = None,
               temperature: float = 0.0, top_k: int = 0) -> int:
        """Queue a request; returns its id (the key of ``results``).
        ``temperature > 0`` samples (``top_k > 0`` restricts the draw to
        the k best logits); 0 is greedy."""
        prompt = validate_request(prompt, vocab=self.cfg.vocab,
                                  temperature=temperature, top_k=top_k)
        if prompt.shape[0] > self.max_len:
            raise ValueError(
                f"prompt of {prompt.shape[0]} tokens does not fit the "
                f"cache (max_len={self.max_len})")
        req = {"id": self._mint_id(), "prompt": prompt, "gen_len": gen_len,
               "temperature": temperature, "top_k": top_k,
               "t_submit": self.clock()}
        if self.paged:
            need = self.allocator.pages_for(self._budget(req))
            if need > self.allocator.num_pages:
                raise ValueError(
                    f"request needs {need} pages but the pool only has "
                    f"{self.allocator.num_pages}; raise num_pages or lower "
                    f"gen_len")
        self.waiting.append(req)
        return req["id"]

    def _token_budget(self, plen: int, gen_len: Optional[int]) -> int:
        """A request's cache-row budget, i.e. its final ``stop_pos``."""
        plen = max(1, int(plen))
        return min(plen + gen_len, self.max_len) if gen_len is not None \
            else self.max_len

    def _budget(self, req) -> int:
        return self._token_budget(len(req["prompt"]), req["gen_len"])

    def retire_finished(self) -> int:
        """finish() every lane whose generation ended."""
        n = 0
        for s in range(self.batch):
            if self.outputs[s] is not None and not self.live[s]:
                self.finish(s)
                n += 1
        return n

    def try_admit(self) -> int:
        """Admit queued requests into free lanes (paged: while pages last):
        FIFO, no head-of-line skipping; one batched prefill for all."""
        free = [s for s in range(self.batch)
                if self.outputs[s] is None and not self.live[s]]
        admit: Dict[int, np.ndarray] = {}
        kw = {"gen_len": {}, "temperature": {}, "top_k": {}, "_t_submit": {},
              "_ids": {}}
        planned = 0
        while self.waiting and free:
            req = self.waiting[0]
            if self.paged:
                need = self.allocator.pages_for(self._budget(req))
                if not self.allocator.can_alloc(planned + need):
                    break
                planned += need
            self.waiting.popleft()
            s = free.pop(0)
            admit[s] = req["prompt"]
            kw["gen_len"][s] = req["gen_len"]
            kw["temperature"][s] = req["temperature"]
            kw["top_k"][s] = req["top_k"]
            kw["_t_submit"][s] = req["t_submit"]
            kw["_ids"][s] = req["id"]
        if admit:
            self.add_requests(admit, **kw)
        return len(admit)

    def _prefill_chunked(self, reqs) -> Dict[int, int]:
        """Batched chunked prefill; returns each slot's first token.

        Everything a chunk needs is uploaded once and the per-chunk
        argmaxes stay on the device, so the whole prefill costs one host
        sync (the reference reads every chunk's logits back).  A draft
        model takes each chunk too (the reference's ``_prefill_draft``):
        it has then consumed the prompt, one token behind the held first
        token, which the first draft step consumes.
        """
        chunk = self.prefill_chunk
        plen = max(p.shape[0] for p in reqs.values())
        padded = -(-plen // chunk) * chunk
        toks = np.zeros((self.batch, padded), np.int32)
        fresh = np.zeros((self.batch,), bool)
        for s, p in reqs.items():
            toks[s, :p.shape[0]] = p
            fresh[s] = True
        toks_d = torch.from_numpy(toks).to(self.device)
        fresh_d = torch.from_numpy(fresh).to(self.device)
        # lanes mid-generation keep their own position
        pos_d = torch.from_numpy(self.pos.copy()).to(self.device)
        picks = []
        for c0 in range(0, padded, chunk):
            if c0 >= plen:
                break
            cur = torch.where(fresh_d, c0, pos_d).to(torch.int32)
            piece = {"tokens": toks_d[:, c0:c0 + chunk]}
            logits, self.cache = self.prefill(self.params, piece, self.cache,
                                              cur)
            if self.draft is not None:
                _, self.draft_cache = self._draft_prefill(
                    self.draft[1], piece, self.draft_cache, cur)
            self.counters["prefill_chunks"] += 1
            picks.append(torch.argmax(logits.to(torch.float32), dim=-1))
        ids = torch.cat(picks, dim=1).cpu().numpy()
        return {s: int(ids[s, p.shape[0] - 1]) for s, p in reqs.items()}

    # -- decode / retire --------------------------------------------------------
    def step_many(self, n: int):
        """Run ``n`` fused decode steps, sync once.

        Returns ``(block, block_live)``, (n, B) emitted tokens and their
        validity.  Under ``spec`` ``n`` counts draft -> verify rounds and
        the block is (n * (spec_k + 1), B), each live slot committing 1 to
        spec_k + 1 tokens a round.  Lanes whose logits went non-finite are
        finished with status FAILED and their valid prefix.  With requests
        waiting, finished lanes are retired and the queue admitted at the
        end.
        """
        if self._bt_dirty:
            self._flush_block_tables()
        t0 = self.clock()
        block, block_live, fault = (self._block_spec(n) if self.spec
                                    else self._block_decode(n))
        t1 = self.clock()
        self._gen_step += n
        self.counters["decode_s"] += t1 - t0
        self.counters["decode_steps"] += n
        self.counters["gen_tokens"] += int(block_live.sum())
        for s in range(self.batch):
            if not self.live[s] and s in self._req_meta:
                self._req_meta[s].setdefault("t_done", t1)
        for s in range(self.batch):
            if self.outputs[s] is not None:
                self.outputs[s].extend(
                    int(t) for t in block[block_live[:, s], s])
        for s in np.where(fault)[0]:
            if self.outputs[s] is not None:
                self.live[s] = False
                self.finish(int(s), status=RequestStatus.FAILED)
        if self.waiting:
            self.retire_finished()
            self.try_admit()
        return block, block_live

    def _block_decode(self, n: int):
        """One fused decode block: one upload, ``n`` steps (one graph
        replay on the card), one download.  The cache is written in
        place."""
        state = self.blocks.pack(self.tokens, self.pos, self.live,
                                 self.stop_pos, self.temperature, self.top_k,
                                 self._gen_step, self.eos_id)
        # all-greedy batches skip the top-k sorts and the noise (greedy
        # consumes no PRNG state, so the stream is unaffected)
        key = self._key if (self.temperature > 0).any() else None
        out = self.blocks(self.params, self.cache, state, key, n)
        block, block_live, self.tokens, self.pos, self.live, fault = \
            self.blocks.unpack(out, n)
        return block, block_live, fault

    def _block_spec(self, n: int):
        """One speculative block of ``n`` rounds: one upload (with the
        drafting history), one graph replay on the card, one download
        (with the accepted counts and the new history)."""
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
        self.counters["verify_steps"] += int(step_live.sum())
        self.counters["draft_accepted"] += int(accepted[step_live].sum())
        return block, block_live, fault

    def step(self):
        """Per-token decode: the n=1 block."""
        return self.step_many(1)

    def finish(self, slot: int,
               status: RequestStatus = RequestStatus.COMPLETED):
        """Retire ``slot``: its tokens land in ``results[req_id]``.  Dense:
        its KV rows are zeroed, so a recycled slot never observes its
        previous occupant.  Paged: its pages return to the free list and
        its table row points at the trash page (the device table is
        rewritten lazily, once per sweep)."""
        meta = self._req_meta.pop(slot, None)
        if meta is not None:
            done = meta.get("t_done", self.clock())
            self.request_log.append(request_row(
                ttft_s=meta["ttft_s"],
                gen_tokens=len(self.outputs[slot] or []),
                decode_s=done - meta["t_admit"], status=status))
            self.results[meta["id"]] = {
                "status": status, "tokens": list(self.outputs[slot] or [])}
            if status is RequestStatus.FAILED:
                self.counters["failures"] += 1
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
            self.allocator.free(self._slot_pages.pop(slot, []))
            self.block_tables[slot, :] = self._trash
            self._bt_dirty = True

    # -- telemetry ----------------------------------------------------------------
    def stats(self) -> dict:
        """Serving telemetry: TTFT (submit -> first token), decode tokens
        per second of block wall time (syncs included), the model calls
        made (decode steps, prefill chunks), the cache, the resolved
        split-KV knob (None when dense), whether blocks run as CUDA graphs,
        how many were captured and the seconds that took (inside
        ``decode_s``), and the kernel launch counts --
        ``lut_activation`` among them -- since the last reset (a graph
        replay counts every launch it runs).  Under ``spec``: the live
        verify rounds and the mean drafts accepted per round
        (``accepted_per_step``; committed tokens per round = that + 1)."""
        c = self.counters
        out = {"requests": len(self.done), "admitted": c["admitted"],
               "peak_live": c["peak_live"], "gen_tokens": c["gen_tokens"],
               "decode_s": c["decode_s"],
               "decode_tok_per_s": (c["gen_tokens"] / c["decode_s"]
                                    if c["decode_s"] > 0 else None),
               "decode_steps": c["decode_steps"],
               "prefill_chunks": c["prefill_chunks"],
               "paged": self.paged, "kv_bits": self.kv_bits,
               "kv_split": self.kv_split,
               "pages_per_step": self.pages_per_step,
               "queued": len(self.waiting), "failures": c["failures"],
               "device": str(self.device), "graphs": self.blocks.graphs,
               "graph_captures": self.blocks.captures,
               "graph_capture_s": self.blocks.capture_s,
               "kernel_launches": launch_counts()}
        if self.spec:
            out["verify_steps"] = c["verify_steps"]
            out["accepted_per_step"] = (c["draft_accepted"]
                                        / max(c["verify_steps"], 1))
            out["spec_k"] = self.spec_k
        if self.request_log:
            out["ttft_mean_s"] = float(np.mean(
                [r["ttft_s"] for r in self.request_log]))
            rates = [r["tok_per_s"] for r in self.request_log
                     if r["tok_per_s"] is not None]
            out["req_tok_per_s_mean"] = (float(np.mean(rates))
                                         if rates else None)
        return out


def build_ctx(args) -> QuantContext:
    """QuantContext from CLI flags (the reference's ``launch.train.build_ctx``)."""
    policy = PrecisionPolicy()
    if args.quant != "none":
        qt = FixedPointType(args.qbits, max(args.qbits // 2, 2))
        policy = PrecisionPolicy.uniform(qt)
    return QuantContext(mode=args.quant, policy=policy, use_lut=args.lut,
                        compute_dtype=(torch.float32 if args.f32
                                       else torch.bfloat16))


#: reference CLI flags outside this slice -> the ROADMAP.md item porting them
_REFUSED = {"--prefix-cache": "queue 1, item 11",
            "--preempt": "queue 1, item 10",
            "--durable-dir": "queue 1, item 12",
            "--replicas": "queue 1, item 13"}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Serve a model with the PyTorch/CUDA port.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--quant", default="none", choices=["none", "int8"])
    ap.add_argument("--qbits", type=int, default=8)
    ap.add_argument("--lut", action="store_true",
                    help="the paper's constant-table activations and softmax")
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--kv-bits", type=int, default=None, choices=[8],
                    help="int8 KV cache (per-token scales)")
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--decode-block", type=int, default=8)
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache: shared page pool + block tables "
                         "(default: the dense cache)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=None)
    ap.add_argument("--kv-split", default="auto")
    ap.add_argument("--pages-per-step", default="auto")
    ap.add_argument("--autotune", default="off")
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
                    help="arch of an lm draft model sharing the target's "
                         "vocab (implies --spec); default: prompt lookup")
    ap.add_argument("--spec-ngram", type=int, default=2,
                    help="context length of the prompt-lookup match")
    ap.add_argument("--graphs", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="decode blocks as CUDA graph replays (default: on "
                         "for cuda; --no-graphs runs them eagerly)")
    for flag in _REFUSED:
        ap.add_argument(flag, nargs="?", const=True, default=None,
                        help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    for flag, item in _REFUSED.items():
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            ap.error(f"{flag} is not ported yet (ROADMAP.md {item})")
    if args.autotune != "off":
        ap.error("--autotune other than 'off' is not ported yet "
                 "(ROADMAP.md queue 1, item 9)")

    cfg = get_config(args.arch)
    if cfg.family == "encdec":
        ap.error(f"--arch {args.arch}: the Engine does not serve the encdec "
                 f"family (the reference Engine never runs the encoder); "
                 f"see ROADMAP.md queue 1, item 7")
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
        if d_cfg.family != "lm":
            ap.error(f"--spec-draft {args.spec_draft}: only lm drafters are "
                     f"ported (ROADMAP.md queue 1, item 14)")
        if args.smoke:
            d_cfg = d_cfg.smoke()
        d_gen = torch.Generator(device=device).manual_seed(args.seed + 1)
        spec_draft = (d_cfg, get_family(d_cfg).init(d_gen, d_cfg,
                                                    device=device), ctx)

    def knob(v):
        return "auto" if v == "auto" else int(v)

    eng = Engine(cfg, ctx, params, batch=args.batch,
                 max_len=args.prompt_len + args.gen_len + 1,
                 kv_bits=args.kv_bits, prefill_chunk=args.prefill_chunk,
                 seed=args.seed, paged=args.paged, page_size=args.page_size,
                 num_pages=args.num_pages, kv_split=knob(args.kv_split),
                 pages_per_step=knob(args.pages_per_step), spec=args.spec,
                 spec_k=args.spec_k, spec_draft=spec_draft,
                 spec_ngram=args.spec_ngram, device=device,
                 graphs=args.graphs)
    src = SyntheticLM(cfg.vocab, seed=args.seed)
    prompts = [src.tokens(i, 1, args.prompt_len)[0, :-1]
               for i in range(args.requests)]
    t0 = time.perf_counter()
    for p in prompts:
        eng.submit(p, gen_len=args.gen_len, temperature=args.temperature,
                   top_k=args.top_k)
    eng.try_admit()
    gen_tokens = 0
    while eng.live.any() or eng.waiting:
        _, block_live = eng.step_many(max(1, args.decode_block))
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
    print(f"served {len(eng.done)} requests, {gen_tokens} tokens in "
          f"{dt:.2f}s ({gen_tokens / dt:.1f} tok/s), quant={args.quant} "
          f"lut={args.lut} kv_bits={args.kv_bits} device={device} {cache} "
          f"temperature={args.temperature} top_k={args.top_k} "
          f"graphs={eng.blocks.graphs}")
    print(json.dumps(eng.stats(), default=str))
    return eng.done


if __name__ == "__main__":
    main()
