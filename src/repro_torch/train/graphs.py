"""The decode block behind static inputs: eager, or one CUDA graph per
(block length, sampled) -- the port's counterpart of the reference's one
jitted ``lax.scan`` per block length (``repro.launch.serve.Engine.
_block_decode``), and likewise for speculative blocks (``_block_spec``:
one graph per (rounds, k, sampled, drafter)).

:class:`DecodeBlocks` owns one int32 device buffer that holds every
input of a block (tokens, positions, live mask, stop positions,
temperatures as float32 bits, top-k, a speculative block's drafting
history, the step offset, the EOS id and the PRNG key).  A block fills
it with one host-to-device copy (and the key with one device copy), runs
``build_decode_loop``'s (or ``build_spec_decode_loop``'s) loop on views
of it, and packs every output (with a speculative block's accepted
counts and history) into one int32 tensor that the caller reads with one
device-to-host copy: the block's one host sync.

With ``graphs=True`` (CUDA only) the first block of each ``(steps,
sampled)`` runs eagerly -- a real block, which also builds the kernels,
configures the CUDA libraries and copies the lazily cached constants to
the card (RoPE frequencies, tables, split scratch): a first
host-to-device copy inside a capture is an error -- and is then
captured; later blocks refill the buffer and replay.  The KV cache and
the block tables are written in place, so a replay serves whatever the
caller admitted or retired since the capture.  The graphs hold the
addresses of the params' and the cache's tensors (and of a draft
model's params and dense cache): when any is replaced, the graphs are
dropped and captured again.  The graphs of one :class:`DecodeBlocks`
share one memory pool: a block's temporaries (deepseek's dequantized
expert banks, 7.5 GB at full width) are held once, not once per block
length; the blocks replay one at a time on one stream, and each graph
keeps its own output and scratch alive.  A capture runs with Python's cyclic
garbage collector off (after one collection): a graph that the collector
destroyed mid-capture would invalidate it.  A capture that fails raises;
nothing falls back to eager.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..core.qtypes import QTensor
from ..kernels import _cuda
from .step import build_decode_loop, build_spec_decode_loop

__all__ = ["BlockGraph", "DecodeBlocks"]


class BlockGraph:
    """``fn`` captured once in a CUDA graph; :meth:`replay` runs it again
    and returns the tensor it returned at capture (overwritten in place),
    and adds the kernel launches it recorded to the launch counts."""

    def __init__(self, fn: Callable[[], torch.Tensor], pool=None):
        self.graph = torch.cuda.CUDAGraph()
        # a graph destroyed while another is being captured (a dead
        # Engine's, freed by the cyclic collector at any allocation)
        # invalidates the capture: collect first, and keep the collector
        # off until the capture ends
        gc.collect()
        enabled = gc.isenabled()
        gc.disable()
        try:
            with _cuda.captured_scratch() as self.scratch:
                with _cuda.recorded_launches() as self.launches:
                    with torch.cuda.graph(self.graph, pool=pool):
                        self.out = fn()
        finally:
            if enabled:
                gc.enable()

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        _cuda.add_launches(self.launches)
        return self.out


def _addresses(tree) -> Tuple:
    """(address, shape) of every tensor of a params or cache tree."""
    if isinstance(tree, dict):
        return tuple(a for k in sorted(tree) for a in _addresses(tree[k]))
    if isinstance(tree, (tuple, list)):
        return tuple(a for t in tree for a in _addresses(t))
    if isinstance(tree, QTensor):
        return _addresses({"data": tree.data, "scale": tree.scale})
    if isinstance(tree, torch.Tensor):
        return ((tree.data_ptr(), tuple(tree.shape)),)
    return ()


class DecodeBlocks:
    """Decode blocks of ``build_decode_loop(cfg, ctx, steps)`` for a batch
    of ``batch`` slots on ``device``, eager or through CUDA graphs; with
    ``spec``, speculative blocks of ``build_spec_decode_loop`` instead.

    ``spec``: None, or ``build_spec_decode_loop``'s keywords (``k``,
    ``drafter``, ``ngram``, ``draft_cfg``, ``draft_ctx``) with
    ``hist_len``, the width of the drafting history (the model drafter
    keeps none here: its state is the draft cache).  :meth:`set_spec_k`
    changes ``k`` between blocks (an adaptive ``spec_k``): each k gets
    its own loop and graph.

    Call with the params, the cache, the host state packed by
    :meth:`pack`, the device key (None: every slot greedy), the block
    length (rounds, under ``spec``) and, for the model drafter, ``draft =
    (draft_params, draft_cache)``; returns the block's outputs as one int32
    numpy array (see :meth:`unpack`)."""

    def __init__(self, cfg, ctx, batch: int, device, *, graphs: bool,
                 spec=None):
        device = torch.device(device)
        if graphs and device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not {device}; "
                             f"the block runs eager on the CPU")
        self.cfg, self.ctx, self.batch = cfg, ctx, batch
        self.device, self.graphs = device, bool(graphs)
        self.spec = None if spec is None else dict(spec)
        self.hist_len = 0
        if self.spec is not None:
            hist_len = int(self.spec.pop("hist_len", 0))
            if self.spec.get("drafter") != "model":
                self.hist_len = hist_len
        b, h = batch, self.hist_len
        self.static = torch.zeros(6 * b + b * h + 4, dtype=torch.int32,
                                  device=device)
        s = self.static
        self.tokens, self.pos, self.live, self.stop_pos = (
            s[i * b:(i + 1) * b] for i in range(4))
        self.temperature = s[4 * b:5 * b].view(torch.float32)
        self.top_k = s[5 * b:6 * b]
        self.hist = s[6 * b:6 * b + b * h].view(b, h)
        end = 6 * b + b * h
        self.step0, self.eos_id = s[end], s[end + 1]
        self.key = s[end + 2:]
        self._loops: Dict[Tuple, Callable] = {}
        self._graphs: Dict[Tuple, BlockGraph] = {}
        self._pool = None            # the graphs' shared memory pool
        self._owner = None
        self.captures = 0
        self.capture_s = 0.0         # host seconds spent capturing

    def set_spec_k(self, k: int) -> None:
        """Drafts per round of the next speculative blocks."""
        self.spec["k"] = int(k)

    def release(self) -> None:
        """Drop every captured graph (and the scratch it holds) and every
        loop: an Engine that died gives its device memory back."""
        self._graphs.clear()
        self._loops.clear()
        self._pool = self._owner = None

    def pack(self, tokens, pos, live, stop_pos, temperature, top_k,
             step0: int, eos_id: int, hist=None) -> np.ndarray:
        """The host state as the int32 image of the buffer (key excluded);
        ``hist`` (B, hist_len) for a speculative block that keeps one."""
        parts = [np.asarray(tokens, np.int32).reshape(-1),
                 np.asarray(pos, np.int32), np.asarray(live, np.int32),
                 np.asarray(stop_pos, np.int32),
                 np.asarray(temperature, np.float32).view(np.int32),
                 np.asarray(top_k, np.int32)]
        if self.hist_len:
            parts.append(np.asarray(hist, np.int32).reshape(-1))
        parts.append(np.asarray([step0, eos_id], np.int32))
        return np.concatenate(parts)

    def unpack(self, out: np.ndarray, steps: int):
        """-> (block (rows, B), block_live (rows, B), tokens (B, 1), pos,
        live, fault), rows = ``steps``; under ``spec`` rows = ``steps * (k +
        1)``, followed by accepted (steps, B) and the history (B,
        hist_len), or None for the model drafter."""
        b, n = self.batch, steps
        rows = n * (self.spec["k"] + 1) if self.spec is not None else n
        block = out[:rows * b].reshape(rows, b)
        block_live = out[rows * b:2 * rows * b].reshape(rows, b).astype(bool)
        off = 2 * rows * b
        if self.spec is not None:
            accepted = out[off:off + n * b].reshape(n, b)
            off += n * b
        rest = out[off:off + 4 * b].reshape(4, b)
        head = (block, block_live, rest[0][:, None].copy(), rest[1].copy(),
                rest[2].astype(bool), rest[3].astype(bool))
        if self.spec is None:
            return head
        hist = (out[off + 4 * b:].reshape(b, self.hist_len).copy()
                if self.hist_len else None)
        return head + (accepted, hist)

    def __call__(self, params, cache, state: np.ndarray, key, steps: int,
                 draft=None):
        sampled = key is not None
        self.static[:state.shape[0]].copy_(torch.from_numpy(state))
        if sampled:
            self.key.copy_(key)
        if not self.graphs:
            return self._block(params, cache, steps, sampled,
                               draft).cpu().numpy()
        owner = (_addresses(params), _addresses(cache), _addresses(draft))
        if owner != self._owner:
            self._graphs.clear()
            self._owner = owner
        gkey = (steps, sampled) if self.spec is None else (
            steps, self.spec["k"], sampled, self.spec.get("drafter", "ngram"))
        graph = self._graphs.get(gkey)
        if graph is not None:
            return graph.replay().cpu().numpy()
        out = self._block(params, cache, steps, sampled, draft).cpu().numpy()
        t0 = time.perf_counter()
        if not self._graphs:
            self._pool = torch.cuda.graph_pool_handle()
        self._graphs[gkey] = BlockGraph(
            lambda: self._block(params, cache, steps, sampled, draft),
            pool=self._pool)
        self.capture_s += time.perf_counter() - t0
        self.captures += 1
        return out

    def _block(self, params, cache, steps: int, sampled: bool, draft=None):
        """One block on the buffer's views; its outputs packed in one int32
        tensor."""
        lkey = (steps, None if self.spec is None else self.spec["k"])
        loop = self._loops.get(lkey)
        if loop is None:
            loop = self._loops[lkey] = (
                build_decode_loop(self.cfg, self.ctx, steps)
                if self.spec is None else
                build_spec_decode_loop(self.cfg, self.ctx, steps,
                                       **self.spec))
        args = (params, cache, self.tokens[:, None], self.pos,
                self.live != 0, self.stop_pos,
                {"temperature": self.temperature, "top_k": self.top_k},
                self.key if sampled else None, self.step0, self.eos_id)
        mid, tail = [], []
        if self.spec is None:
            _, tokens, pos, live, block, block_live, fault = loop(*args)
        else:
            aux = draft if self.hist_len == 0 else (self.hist,)
            (_, tokens, pos, live, carry, block, block_live, accepted,
             fault) = loop(*args, *aux)
            mid = [accepted.reshape(-1)]
            if self.hist_len:
                tail = [carry.reshape(-1)]
        return torch.cat([block.reshape(-1), block_live.reshape(-1).int(),
                          *mid, tokens.reshape(-1), pos, live.int(),
                          fault.int(), *tail])
