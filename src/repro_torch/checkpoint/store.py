"""Checkpoints of tensor trees, atomic snapshots of host objects and the
append-only journal (port of ``repro.checkpoint.store``).

One directory per step, ``<dir>/step_%08d/``, and a ``manifest.json``.
:func:`save_state` writes one ``.npy`` per leaf of a tensor tree, named
by its '.'-joined path (the reference's layout; a bf16 leaf is stored as
its uint16 bits, the manifest keeping ``bfloat16``), and
:func:`restore_state` loads them into the structure of a template;
:class:`CheckpointManager` saves on a thread (the host copy is made on
the caller's thread), keeps the newest ``keep`` and restores the
latest.  :func:`save_blob` holds a host object as one pickled ``.npy``.
Every save writes ``<step>.tmp`` and renames it, so a crash mid-save
never corrupts the newest complete checkpoint.  Under a mesh the layout
is the same: a save gathers each DTensor leaf on the calling thread (the
same leaves in the same order on every rank, one leaf whole at a time),
the mesh's first rank alone copies it to the host and writes, the
others drop it and wait at a barrier before its next save or restore;
a restore places each leaf with the given shardings (or the template
leaf's placements), so a checkpoint saved on one mesh restores onto
another, or onto one process.  ``BlobLog`` is the serving engine's
write-ahead journal (``<u32 length><u32 crc32>`` + pickle, fsync'd per
append); a
``BlobLogFollower`` tails it for a hot standby.  Pickle: only for
trusted, self-written state.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import struct
import threading
import zlib
from typing import Optional

import numpy as np
import torch

from ..core.tree import tree_leaves, tree_paths
from ..dist.sharding import is_dtensor, shard_tensor

__all__ = ["save_state", "restore_state", "save_blob", "load_blob",
           "latest_step", "BlobLog", "BlobLogFollower", "CheckpointManager"]

_SEP = "."


def _mesh_of(tree):
    """The DeviceMesh of a tree's DTensor leaves, or None."""
    for leaf in tree_leaves(tree):
        if is_dtensor(leaf):
            return leaf.device_mesh
    return None


def _mesh_barrier(mesh) -> None:
    """Every rank of ``mesh`` has arrived (a barrier per mesh axis)."""
    import torch.distributed as dist
    for m in range(mesh.ndim):
        dist.barrier(group=mesh.get_group(m))


def _to_numpy(leaf) -> np.ndarray:
    """A host numpy copy of a leaf; bf16 as its uint16 bits.  Always a
    copy: ``.cpu()`` of a CPU tensor is the tensor itself, which the
    train step goes on to update in place while a save is on its
    thread."""
    if is_dtensor(leaf):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _host_tree(tree):
    """The tree with every leaf copied to host numpy (bf16 kept as bits)
    and its dtype name: ``{path: (array, dtype name)}``."""
    return {path: (_to_numpy(leaf),
                   str(leaf.dtype).replace("torch.", "")
                   if isinstance(leaf, torch.Tensor)
                   else str(np.asarray(leaf).dtype))
            for path, leaf in tree_paths(tree, _SEP).items()}


def _write_state(host, directory: str, step: int) -> str:
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {}
    for path, (arr, dtype) in host.items():
        fn = path.replace("/", "_") + ".npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest[path] = {"shape": list(arr.shape), "dtype": dtype,
                          "file": fn}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "leaves": manifest}, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def save_state(state, directory: str, step: int) -> str:
    """Blocking save of a tensor tree.  Returns the checkpoint path."""
    return _write_state(_host_tree(state), directory, step)


def restore_state(template, directory: str, step: int, *, device=None,
                  shardings=None):
    """Load checkpoint ``step`` into the structure of ``template`` (a tree
    of tensors, meta tensors and DTensors included): new tensors of each
    template leaf's dtype, on ``device`` (None: each template leaf's
    device; a meta leaf loads to the CPU).  ``shardings``, a tree of
    :class:`~repro_torch.dist.NamedSharding` like ``template``, places
    each leaf on its mesh (every rank reads the files; nothing is
    communicated); without it a DTensor template leaf's placements are
    used.  A shape that differs raises."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)["leaves"]
    flat_sh = ({} if shardings is None else tree_paths(shardings, _SEP))

    def load(key, leaf):
        t = _load_leaf(key, leaf)
        sh = flat_sh.get(key)
        if sh is not None:
            return shard_tensor(t, sh.mesh, sh.placements)
        if is_dtensor(leaf):
            return shard_tensor(t, leaf.device_mesh, leaf.placements)
        return t

    def _load_leaf(key, leaf):
        arr = np.load(os.path.join(path, key.replace("/", "_") + ".npy"))
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"ckpt leaf {key}: shape {arr.shape} != "
                             f"{tuple(leaf.shape)}")
        if manifest.get(key, {}).get("dtype") == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        dev = device if device is not None else (
            "cpu" if leaf.device.type == "meta" else
            leaf.to_local().device if is_dtensor(leaf) else leaf.device)
        return t.to(device=dev, dtype=leaf.dtype)

    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}{_SEP}{k}" if prefix else str(k))
                    for k, v in node.items()}
        return load(prefix, node)

    return walk(template, "")


def save_blob(obj, directory: str, step: int, *, name: str = "blob") -> str:
    """Atomically persist ``obj``; returns the step directory."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    arr = np.empty((), dtype=object)
    arr[()] = obj
    np.save(os.path.join(tmp, name + ".npy"), arr, allow_pickle=True)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "blob": name + ".npy"}, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def load_blob(directory: str, step: int, *, name: str = "blob"):
    """Load a :func:`save_blob` snapshot."""
    path = os.path.join(directory, f"step_{step:08d}", name + ".npy")
    return np.load(path, allow_pickle=True)[()]


class BlobLog:
    """Append-only write-ahead log of pickled records (the journal
    primitive under the serving engine's crash-safe warm restart).

    Framing: each record is ``<u32 length><u32 crc32>`` followed by the
    pickled payload.  :meth:`append` flushes AND ``os.fsync``\\ s before
    returning, so an append that returned is durable — kill -9 the
    process the next instruction and the record replays.

    Torn-tail tolerance: a crash *mid-append* leaves a short or
    CRC-mismatched frame at the end of the file.  Opening for append
    scans the existing frames, keeps every complete one, and truncates
    the torn tail (an os.replace-style atomicity guarantee built from
    sequential appends: the prefix of durable records is always
    intact).  Corruption anywhere *before* the tail cannot be repaired
    and raises — silently resuming past a hole would replay a wrong
    history.

    Only for trusted self-written state (pickle), like every
    checkpoint in this module.
    """

    _HEADER = struct.Struct("<II")

    def __init__(self, path: str, *, fresh: bool = False):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if fresh or not os.path.exists(path):
            self._f = open(path, "wb")
            self.count = 0
        else:
            self.count, good = self._scan()
            with open(path, "r+b") as f:
                f.truncate(good)        # drop a torn tail, keep the rest
            self._f = open(path, "ab")

    def _scan(self):
        """(record count, byte offset after the last complete record).

        Stops at the first short/CRC-broken frame ONLY if it is the
        file's tail (an interrupted append); a broken frame with valid
        data after it is real corruption and raises.
        """
        count, good = 0, 0
        with open(self.path, "rb") as f:
            data = f.read()
        off, end = 0, len(data)
        while off + self._HEADER.size <= end:
            length, crc = self._HEADER.unpack_from(data, off)
            body = data[off + self._HEADER.size:
                        off + self._HEADER.size + length]
            if len(body) < length or zlib.crc32(body) != crc:
                break
            count += 1
            off += self._HEADER.size + length
        good = off
        # anything after the torn frame means mid-file damage, not an
        # interrupted append — refuse to silently drop committed history
        tail = data[good:]
        max_torn = self._HEADER.size + (self._HEADER.unpack_from(
            data, good)[0] if good + self._HEADER.size <= end else len(tail))
        if len(tail) > max_torn:
            raise IOError(
                f"journal {self.path} corrupt at byte {good}: broken "
                f"frame followed by {len(tail) - max_torn} more bytes "
                f"(not a torn tail)")
        # second net, for damage the length bound can't see: a bit flip
        # that ENLARGES a mid-file length field makes every committed
        # record after it look like one huge torn frame.  A torn tail is
        # a partial write of ONE record, so a complete CRC-valid frame
        # anywhere inside it proves the break happened before committed
        # history — refuse rather than drop it.  (Non-empty frames only:
        # crc32(b"") == 0, so eight zero bytes inside a genuinely torn
        # pickle body would otherwise masquerade as a valid empty frame.)
        for probe in range(good + 1, end - self._HEADER.size + 1):
            length, crc = self._HEADER.unpack_from(data, probe)
            if length == 0:
                continue
            body = data[probe + self._HEADER.size:
                        probe + self._HEADER.size + length]
            if len(body) == length and zlib.crc32(body) == crc:
                raise IOError(
                    f"journal {self.path} corrupt at byte {good}: broken "
                    f"frame with a complete valid frame at byte {probe} "
                    f"after it (mid-file damage, not a torn tail)")
        return count, good

    def follow(self) -> "BlobLogFollower":
        """A cursor over this journal for another engine to tail."""
        return BlobLogFollower(self.path)

    def append(self, obj) -> int:
        """Durably append one record; returns its index."""
        body = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        self._f.write(self._HEADER.pack(len(body), zlib.crc32(body)))
        self._f.write(body)
        self._f.flush()
        os.fsync(self._f.fileno())
        idx = self.count
        self.count += 1
        return idx

    def read(self, start: int = 0) -> list:
        """Records ``start..`` re-read from disk (tail-tolerant)."""
        out = []
        with open(self.path, "rb") as f:
            data = f.read()
        off, end, i = 0, len(data), 0
        while off + self._HEADER.size <= end:
            length, crc = self._HEADER.unpack_from(data, off)
            body = data[off + self._HEADER.size:
                        off + self._HEADER.size + length]
            if len(body) < length or zlib.crc32(body) != crc:
                break
            if i >= start:
                out.append(pickle.loads(body))
            i += 1
            off += self._HEADER.size + length
        return out

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


class BlobLogFollower:
    """Incremental cursor over a :class:`BlobLog` another engine appends
    to — the journal-shipping primitive under the fleet's hot standby.

    :meth:`poll` returns every record that became durable since the
    last call, advancing a (byte offset, record index) cursor.  The
    writer only ever appends, so the follower distinguishes two tail
    states it can observe:

    * a **short frame** (header or body not fully on disk yet) is an
      append in flight — stop, keep the cursor, pick it up next poll;
    * a **complete frame with a CRC mismatch** can never be an append
      in flight (bytes land in order, so a frame whose full claimed
      length is on disk was fully written) — that is corruption, and
      silently skipping it would ship the standby a wrong history, so
      it raises.
    """

    def __init__(self, path: str):
        self.path = path
        self.offset = 0         # byte offset of the next unread frame
        self.count = 0          # records consumed so far

    def poll(self, max_records: Optional[int] = None) -> list:
        """New durable records since the last poll (possibly none)."""
        out: list = []
        if not os.path.exists(self.path):
            return out
        with open(self.path, "rb") as f:
            f.seek(self.offset)
            data = f.read()
        hdr = BlobLog._HEADER
        off, end = 0, len(data)
        while off + hdr.size <= end:
            if max_records is not None and len(out) >= max_records:
                break
            length, crc = hdr.unpack_from(data, off)
            body = data[off + hdr.size: off + hdr.size + length]
            if len(body) < length:
                break               # append in flight: wait for the rest
            if zlib.crc32(body) != crc:
                raise IOError(
                    f"journal {self.path} corrupt at byte "
                    f"{self.offset + off}: CRC mismatch on a complete "
                    f"frame while following")
            out.append(pickle.loads(body))
            off += hdr.size + length
            self.count += 1
        self.offset += off
        return out


def latest_step(directory: str) -> Optional[int]:
    """The newest complete step under ``directory`` (None: none)."""
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(directory, d, "manifest.json"))]
    return max(steps) if steps else None


class CheckpointManager:
    """Async save + retention + restore-latest of tensor trees."""

    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._mesh = None
        os.makedirs(directory, exist_ok=True)

    def save(self, state, step: int, *, blocking: bool = False):
        """The host copy now (on the caller's thread: DTensor leaves are
        gathered there, collectives in order on every rank), the files on
        a worker thread unless ``blocking``.  Under a mesh only its first
        rank writes; every rank of it calls ``save``."""
        self.wait()
        self._mesh = _mesh_of(state)
        if self._mesh is not None and any(self._mesh.get_coordinate()):
            # another rank writes: take part in each leaf's gather, in
            # the writer's order, and keep nothing
            for leaf in tree_paths(state, _SEP).values():
                if is_dtensor(leaf):
                    leaf.full_tensor()
            host = None
        else:
            host = _host_tree(state)

        def work():
            _write_state(host, self.directory, step)
            self._gc()

        if host is not None and blocking:
            work()
        elif host is not None:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        if blocking:
            self.wait()

    def wait(self):
        """The last save is on disk (under a mesh: on every rank)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._mesh is not None:
            _mesh_barrier(self._mesh)
            self._mesh = None

    def restore_latest(self, template, *, device=None, shardings=None):
        """``(state, step)`` of the newest complete checkpoint, or
        ``(None, None)``; ``shardings`` as :func:`restore_state`."""
        self.wait()
        step = latest_step(self.directory)
        if step is None:
            return None, None
        return restore_state(template, self.directory, step, device=device,
                             shardings=shardings), step

    def _gc(self):
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.directory)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
