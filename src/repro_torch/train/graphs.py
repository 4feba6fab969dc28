"""The decode block behind static inputs: eager, or one CUDA graph per
(block length, sampled) -- the port's counterpart of the reference's one
jitted ``lax.scan`` per block length (``repro.launch.serve.Engine.
_block_decode``).

:class:`DecodeBlocks` owns one int32 device buffer that holds every
input of a block (tokens, positions, live mask, stop positions,
temperatures as float32 bits, top-k, the step offset, the EOS id and the
PRNG key).  A block fills it with one host-to-device copy (and the key
with one device copy), runs ``build_decode_loop``'s loop on views of it,
and packs every output into one int32 tensor that the caller reads with
one device-to-host copy: the block's one host sync.

With ``graphs=True`` (CUDA only) the first block of each ``(steps,
sampled)`` runs eagerly -- a real block, which also builds the kernels,
configures the CUDA libraries and copies the lazily cached constants to
the card (RoPE frequencies, tables, split scratch): a first
host-to-device copy inside a capture is an error -- and is then
captured; later blocks refill the buffer and replay.  The KV cache and
the block tables are written in place, so a replay serves whatever the
caller admitted or retired since the capture.  The graphs hold the
addresses of the params' and the cache's tensors: when either is
replaced, the graphs are dropped and captured again.  A capture that
fails raises; nothing falls back to eager.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..core.qtypes import QTensor
from ..kernels import _cuda
from .step import build_decode_loop

__all__ = ["BlockGraph", "DecodeBlocks"]


class BlockGraph:
    """``fn`` captured once in a CUDA graph; :meth:`replay` runs it again
    and returns the tensor it returned at capture (overwritten in place),
    and adds the kernel launches it recorded to the launch counts."""

    def __init__(self, fn: Callable[[], torch.Tensor]):
        self.graph = torch.cuda.CUDAGraph()
        with _cuda.recorded_launches() as self.launches:
            with torch.cuda.graph(self.graph):
                self.out = fn()

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        _cuda.add_launches(self.launches)
        return self.out


def _addresses(tree) -> Tuple:
    """(address, shape) of every tensor of a params or cache tree."""
    if isinstance(tree, dict):
        return tuple(a for k in sorted(tree) for a in _addresses(tree[k]))
    if isinstance(tree, QTensor):
        return _addresses({"data": tree.data, "scale": tree.scale})
    if isinstance(tree, torch.Tensor):
        return ((tree.data_ptr(), tuple(tree.shape)),)
    return ()


class DecodeBlocks:
    """Decode blocks of ``build_decode_loop(cfg, ctx, steps)`` for a batch
    of ``batch`` slots on ``device``, eager or through CUDA graphs.

    Call with the params, the cache, the host state packed by
    :meth:`pack`, the device key (None: every slot greedy) and the block
    length; returns the block's outputs as one int32 numpy array (see
    :meth:`unpack`)."""

    def __init__(self, cfg, ctx, batch: int, device, *, graphs: bool):
        device = torch.device(device)
        if graphs and device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not {device}; "
                             f"the block runs eager on the CPU")
        self.cfg, self.ctx, self.batch = cfg, ctx, batch
        self.device, self.graphs = device, bool(graphs)
        b = batch
        self.static = torch.zeros(6 * b + 4, dtype=torch.int32, device=device)
        s = self.static
        self.tokens, self.pos, self.live, self.stop_pos = (
            s[i * b:(i + 1) * b] for i in range(4))
        self.temperature = s[4 * b:5 * b].view(torch.float32)
        self.top_k = s[5 * b:6 * b]
        self.step0, self.eos_id = s[6 * b], s[6 * b + 1]
        self.key = s[6 * b + 2:]
        self._loops: Dict[int, Callable] = {}
        self._graphs: Dict[Tuple[int, bool], BlockGraph] = {}
        self._owner = None
        self.captures = 0
        self.capture_s = 0.0         # host seconds spent capturing

    def pack(self, tokens, pos, live, stop_pos, temperature, top_k,
             step0: int, eos_id: int) -> np.ndarray:
        """The host state as the int32 image of the buffer (key excluded)."""
        return np.concatenate([
            np.asarray(tokens, np.int32).reshape(-1),
            np.asarray(pos, np.int32), np.asarray(live, np.int32),
            np.asarray(stop_pos, np.int32),
            np.asarray(temperature, np.float32).view(np.int32),
            np.asarray(top_k, np.int32),
            np.asarray([step0, eos_id], np.int32)])

    def unpack(self, out: np.ndarray, steps: int):
        """-> (block (steps, B), block_live (steps, B), tokens (B, 1), pos,
        live, fault)."""
        b, n = self.batch, steps
        block = out[:n * b].reshape(n, b)
        block_live = out[n * b:2 * n * b].reshape(n, b).astype(bool)
        rest = out[2 * n * b:].reshape(4, b)
        return (block, block_live, rest[0][:, None].copy(), rest[1].copy(),
                rest[2].astype(bool), rest[3].astype(bool))

    def __call__(self, params, cache, state: np.ndarray, key, steps: int):
        sampled = key is not None
        self.static[:state.shape[0]].copy_(torch.from_numpy(state))
        if sampled:
            self.key.copy_(key)
        if not self.graphs:
            return self._block(params, cache, steps, sampled).cpu().numpy()
        owner = (_addresses(params), _addresses(cache))
        if owner != self._owner:
            self._graphs.clear()
            self._owner = owner
        graph = self._graphs.get((steps, sampled))
        if graph is not None:
            return graph.replay().cpu().numpy()
        out = self._block(params, cache, steps, sampled).cpu().numpy()
        t0 = time.perf_counter()
        self._graphs[(steps, sampled)] = BlockGraph(
            lambda: self._block(params, cache, steps, sampled))
        self.capture_s += time.perf_counter() - t0
        self.captures += 1
        return out

    def _block(self, params, cache, steps: int, sampled: bool):
        """One block on the buffer's views; its outputs packed in one int32
        tensor."""
        loop = self._loops.get(steps)
        if loop is None:
            loop = self._loops[steps] = build_decode_loop(self.cfg, self.ctx,
                                                          steps)
        _, tokens, pos, live, block, block_live, fault = loop(
            params, cache, self.tokens[:, None], self.pos, self.live != 0,
            self.stop_pos, {"temperature": self.temperature,
                            "top_k": self.top_k},
            self.key if sampled else None, self.step0, self.eos_id)
        return torch.cat([block.reshape(-1), block_live.reshape(-1).int(),
                          tokens.reshape(-1), pos, live.int(), fault.int()])
