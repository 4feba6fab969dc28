"""Prefix index: committed KV pages keyed by page-aligned token chunks
(port of ``repro.launch.prefix``).

For a prompt cut into ``page_size``-token chunks ``t_0, t_1, ...``, chunk
``g`` is keyed by the hash chain

    key_g = sha256(key_{g-1} || t_g.tobytes()),   key_{-1} = ROOT

so a key commits to the whole token history up to its chunk.  Entries
also keep their chunk's tokens, and :meth:`PrefixIndex.match` re-checks
them on the walk down: a hash collision is a miss, never wrong KV.

The index holds host metadata only (keys and page ids); each page it
names lives in the engine's pool with one reference held for the index
(owner :data:`PREFIX_OWNER`).  Eviction is LRU over entries whose page
nobody else references, least important class first, deepest chunk
first within a tie, so a chain comes apart leaf to root.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from .lifecycle import PriorityClass, coerce_priority

__all__ = ["PrefixIndex", "PREFIX_OWNER", "ROOT"]

#: allocator owner tag of the pages the index holds
PREFIX_OWNER = "__prefix__"

#: chain key of the empty prefix
ROOT = b""


class _Entry:
    __slots__ = ("key", "parent", "tokens", "page", "depth", "used", "cls")

    def __init__(self, key: bytes, parent: bytes, tokens: np.ndarray,
                 page: int, depth: int, used: int,
                 cls: PriorityClass = PriorityClass.STANDARD):
        self.key = key
        self.parent = parent            # chain key of the previous chunk
        self.tokens = tokens            # this chunk's tokens (int32, page_size)
        self.page = page                # physical page holding the KV rows
        self.depth = depth              # chunk index (0 = first page)
        self.used = used                # LRU tick of the last match/publish
        self.cls = cls                  # class of the publishing request


class PrefixIndex:
    """Host-side map ``chain key -> committed KV page`` (int32 tokens;
    ``page_size`` is the engine's page size)."""

    def __init__(self, page_size: int):
        if page_size <= 0:
            raise ValueError("page_size must be positive")
        self.page_size = int(page_size)
        self._by_key: Dict[bytes, _Entry] = {}
        self._tick = 0                  # monotonic LRU clock (not wall time)

    # -- keys ---------------------------------------------------------------
    @staticmethod
    def chain_key(parent: bytes, tokens: np.ndarray) -> bytes:
        """``sha256(parent || tokens)`` over the chunk's int32 bytes."""
        return hashlib.sha256(
            parent + np.ascontiguousarray(tokens, np.int32).tobytes()
        ).digest()

    def keys_for(self, tokens: np.ndarray) -> List[bytes]:
        """Chain keys of every full chunk of ``tokens``."""
        toks = np.asarray(tokens, np.int32)
        keys, parent = [], ROOT
        for g in range(len(toks) // self.page_size):
            parent = self.chain_key(
                parent, toks[g * self.page_size:(g + 1) * self.page_size])
            keys.append(parent)
        return keys

    # -- queries ------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._by_key)

    def __contains__(self, key: bytes) -> bool:
        return key in self._by_key

    def page_of(self, key: bytes) -> int:
        return self._by_key[key].page

    def pages(self) -> List[int]:
        """Every page the index holds a reference on."""
        return [e.page for e in self._by_key.values()]

    def match(self, tokens: np.ndarray) -> Tuple[int, List[int], bytes]:
        """Longest indexed prefix of ``tokens``: ``(chunks matched, their
        pages in order, chain key of the last one or ROOT)``.  Stored
        tokens are re-checked; matched entries' LRU ticks are refreshed."""
        toks = np.asarray(tokens, np.int32)
        pages: List[int] = []
        parent = ROOT
        hits: List[_Entry] = []
        for g in range(len(toks) // self.page_size):
            chunk = toks[g * self.page_size:(g + 1) * self.page_size]
            key = self.chain_key(parent, chunk)
            e = self._by_key.get(key)
            if e is None or not np.array_equal(e.tokens, chunk):
                break
            pages.append(e.page)
            hits.append(e)
            parent = key
        self._tick += 1
        for e in hits:
            e.used = self._tick
        return len(pages), pages, parent

    # -- mutation -----------------------------------------------------------
    def put(self, key: bytes, parent: bytes, tokens: np.ndarray,
            page: int, depth: int, cls=None) -> None:
        """Register ``page`` as the committed KV of chunk ``key`` (the
        caller already holds the index's reference on it).  Indexing a
        key twice raises."""
        if key in self._by_key:
            raise ValueError("chain key already indexed")
        self._tick += 1
        # a private copy: callers pass views of the engine's hist rows
        self._by_key[key] = _Entry(
            key, parent, np.array(tokens, np.int32, copy=True),
            int(page), int(depth), self._tick, coerce_priority(cls))

    def touch(self, key: bytes) -> bool:
        """Refresh ``key``'s LRU tick; False if not indexed."""
        e = self._by_key.get(key)
        if e is None:
            return False
        self._tick += 1
        e.used = self._tick
        return True

    def evict(self, allocator, want: int,
              protect: Optional[set] = None, floor=None) -> int:
        """Free up to ``want`` pages by dropping entries whose page only
        the index references and that ``protect`` does not name; least
        important class first, then oldest, then deepest.  ``floor`` (a
        class) spares entries more important than it.  Returns the pages
        freed."""
        if want <= 0:
            return 0
        protect = protect or set()
        floor_v = None if floor is None else int(coerce_priority(floor))
        victims = sorted(
            (e for e in self._by_key.values()
             if allocator.refcount(e.page) == 1 and e.page not in protect
             and (floor_v is None or int(e.cls) >= floor_v)),
            key=lambda e: (-int(e.cls), e.used, -e.depth))
        freed = 0
        for e in victims:
            if freed >= want:
                break
            del self._by_key[e.key]
            allocator.free([e.page])
            freed += 1
        return freed

    def drop(self, key: bytes, allocator) -> None:
        """Remove one entry and release its reference."""
        e = self._by_key.pop(key)
        allocator.free([e.page])

    # -- snapshot / restore -------------------------------------------------
    def state(self) -> dict:
        return {
            "page_size": self.page_size,
            "tick": self._tick,
            "entries": [
                {"key": e.key, "parent": e.parent,
                 "tokens": e.tokens.copy(), "page": e.page,
                 "depth": e.depth, "used": e.used, "cls": e.cls.name}
                for e in self._by_key.values()],
        }

    def load_state(self, state: dict) -> None:
        if int(state["page_size"]) != self.page_size:
            raise ValueError("prefix index page_size mismatch")
        self._tick = int(state["tick"])
        self._by_key = {}
        for d in state["entries"]:
            self._by_key[d["key"]] = _Entry(
                d["key"], d["parent"],
                np.ascontiguousarray(d["tokens"], np.int32),
                int(d["page"]), int(d["depth"]), int(d["used"]),
                PriorityClass[d.get("cls", "STANDARD")])
