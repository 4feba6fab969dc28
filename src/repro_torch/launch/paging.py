"""Reference-counted free-list page allocator for the paged KV cache
(host side; port of ``repro.launch.paging.PageAllocator``).

A LIFO free list over page ids ``0 .. num_pages-1``.  Pages are
reference counted: ``alloc``/``adopt`` create a page with one reference,
:meth:`share` adds one (prefix caching maps one stored page into every
request that shares it), and :meth:`free`/:meth:`spill` drop one; a page
returns to the free list only when its last reference drops.  Every page
has one owner tag (a slot index, or the prefix index's sentinel), moved
by :meth:`transfer`.  :meth:`state`/:meth:`load_state` round-trip the
free-list order, so allocation after a restore is deterministic.

The allocator never touches device memory: block tables carry its
decisions to the cache.  Class quotas (``class_quotas=``) come with the
fleet (ROADMAP.md queue 1, item 13); ``cls=`` is accepted and charges
nothing on an unpartitioned pool, as in the reference.
"""

from __future__ import annotations

from typing import Dict, List

__all__ = ["PageAllocator"]


class PageAllocator:
    """Refcounting LIFO free list: any ``n <= free_pages`` request is
    satisfiable, because the block table gives each request a contiguous
    *logical* view over arbitrary physical pages."""

    def __init__(self, num_pages: int, page_size: int, *,
                 class_quotas=None):
        if class_quotas:
            raise NotImplementedError(
                "class_quotas: per-class partitions of the page pool are "
                "not ported yet (ROADMAP.md queue 1, item 13)")
        if num_pages <= 0 or page_size <= 0:
            raise ValueError("num_pages and page_size must be positive")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        #: page id -> owner tag (engine: slot index); the double-assign guard
        self._owner: Dict[int, object] = {}
        #: owner tag -> pages in allocation order (pages_of is O(own pages))
        self._pages: Dict[object, List[int]] = {}
        #: page id -> reference count (>= 1 while allocated)
        self._ref: Dict[int, int] = {}

    # -- queries ------------------------------------------------------------
    def pages_for(self, tokens: int) -> int:
        """Pages needed to hold ``tokens`` KV rows (ceil division)."""
        return -(-max(int(tokens), 0) // self.page_size)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.num_pages - len(self._free)

    def can_alloc(self, n: int, cls=None) -> bool:
        return n <= len(self._free)

    def pages_of(self, owner) -> List[int]:
        """The pages ``owner`` owns, in allocation order."""
        return list(self._pages.get(owner, ()))

    def refcount(self, page: int) -> int:
        """References held on ``page`` (0 = not allocated)."""
        return self._ref.get(int(page), 0)

    def shared_pages(self) -> int:
        """Allocated pages with more than one reference."""
        return sum(1 for r in self._ref.values() if r > 1)

    # -- alloc / free -------------------------------------------------------
    def alloc(self, n: int, owner=None, cls=None) -> List[int]:
        """Take ``n`` pages off the free list (MemoryError if short), each
        with one reference."""
        if n > len(self._free):
            raise MemoryError(
                f"page pool exhausted: need {n}, free {len(self._free)} "
                f"of {self.num_pages}")
        pages = [self._free.pop() for _ in range(n)]
        own = self._pages.setdefault(owner, [])
        for p in pages:
            assert p not in self._owner, f"page {p} double-assigned"
            self._owner[p] = owner
            self._ref[p] = 1
            own.append(p)
        return pages

    def share(self, pages: List[int]) -> None:
        """Add one reference to each page; atomic (every id is checked
        before any count moves)."""
        pages = [int(p) for p in pages]
        for p in pages:
            if p not in self._owner:
                raise ValueError(f"page {p} is not allocated; cannot share")
        for p in pages:
            self._ref[p] += 1

    def free(self, pages: List[int]) -> None:
        """Drop one reference per page; a page whose count reaches zero
        returns to the pool.  Atomic: a duplicate or unallocated id
        raises before any reference moves."""
        pages = [int(p) for p in pages]
        if len(set(pages)) != len(pages):
            raise ValueError(f"duplicate page ids in free(): {pages}")
        for p in pages:
            if p not in self._owner:
                raise ValueError(f"page {p} is not allocated")
        for p in pages:
            self._ref[p] -= 1
            if self._ref[p] > 0:
                continue                      # other holders remain
            del self._ref[p]
            owner = self._owner.pop(p)
            self._pages[owner].remove(p)
            self._free.append(p)

    def transfer(self, pages: List[int], owner) -> None:
        """Re-own allocated pages to ``owner`` (refcounts untouched): the
        publication primitive of prefix caching."""
        pages = [int(p) for p in pages]
        for p in pages:
            if p not in self._owner:
                raise ValueError(f"page {p} is not allocated; "
                                 f"cannot transfer")
        dst = self._pages.setdefault(owner, [])
        for p in pages:
            old = self._owner[p]
            if old == owner:
                continue
            self._pages[old].remove(p)
            self._owner[p] = owner
            dst.append(p)

    # -- preempt / restore --------------------------------------------------
    def spill(self, owner) -> List[int]:
        """Drop ``owner``'s reference on every page it owns (the caller has
        copied their payload first); returns them in allocation order."""
        pages = self.pages_of(owner)
        self.free(pages)
        return pages

    def adopt(self, pages: List[int], owner=None, cls=None) -> None:
        """Claim *specific* free page ids for ``owner`` (one reference
        each); atomic."""
        pages = [int(p) for p in pages]
        if len(set(pages)) != len(pages):
            raise ValueError(f"duplicate page ids in adopt(): {pages}")
        free_set = set(self._free)
        for p in pages:
            if p in self._owner:
                raise ValueError(f"page {p} is already assigned")
            if p not in free_set:
                raise ValueError(f"page {p} is not a valid free page")
        taken = set(pages)
        self._free = [p for p in self._free if p not in taken]
        own = self._pages.setdefault(owner, [])
        for p in pages:
            self._owner[p] = owner
            self._ref[p] = 1
            own.append(p)

    # -- snapshot / restore -------------------------------------------------
    def state(self) -> dict:
        """Host-copyable state: free-list order, owners, refcounts and the
        per-owner allocation order (``cls`` charges nothing here)."""
        return {"free": list(self._free), "owner": dict(self._owner),
                "ref": dict(self._ref),
                "pages": {o: list(ps) for o, ps in self._pages.items()
                          if ps},
                "cls": {p: None for p in self._owner}}

    def load_state(self, state: dict) -> None:
        """Restore :meth:`state`; checks that free and owned ids partition
        the pool and that every owned page holds a reference."""
        free, owner = list(state["free"]), dict(state["owner"])
        ids = free + list(owner)
        if sorted(ids) != list(range(self.num_pages)):
            raise ValueError("allocator state does not partition the pool")
        ref = dict(state.get("ref") or {p: 1 for p in owner})
        if sorted(ref) != sorted(owner) or any(r < 1 for r in ref.values()):
            raise ValueError("allocator refcounts do not cover the "
                             "allocated pages (every owned page needs "
                             ">= 1 reference)")
        pages = state.get("pages")
        if pages is None:
            # a state without per-owner lists: the owner map's order
            pages = {}
            for p, o in owner.items():
                pages.setdefault(o, []).append(p)
        else:
            pages = {o: list(ps) for o, ps in pages.items()}
            flat = sorted(p for ps in pages.values() for p in ps)
            if flat != sorted(owner):
                raise ValueError("allocator per-owner lists do not match "
                                 "the owner map")
        self._free, self._owner = free, owner
        self._ref, self._pages = ref, pages
