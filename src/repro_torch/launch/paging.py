"""Free-list page allocator for the paged KV cache (host side).

A copy of the subset of ``repro.launch.paging.PageAllocator`` the
engine's main path uses: LIFO free list over page ids ``0 ..
num_pages-1``, one owner per page, O(1) feasibility checks.  Sharing
(reference counts, prefix caching), spill and class quotas are not
ported yet (ROADMAP.md queue 1, items 10-12).
"""

from __future__ import annotations

from typing import Dict, List

__all__ = ["PageAllocator"]


class PageAllocator:
    """LIFO free list: any ``n <= free_pages`` request is satisfiable,
    because the block table gives each request a contiguous *logical*
    view over arbitrary physical pages."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages <= 0 or page_size <= 0:
            raise ValueError("num_pages and page_size must be positive")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        #: page id -> owner tag (engine: slot index); the double-assign guard
        self._owner: Dict[int, object] = {}

    def pages_for(self, tokens: int) -> int:
        """Pages needed to hold ``tokens`` KV rows (ceil division)."""
        return -(-max(int(tokens), 0) // self.page_size)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int, owner=None) -> List[int]:
        if n > len(self._free):
            raise MemoryError(f"page pool exhausted: need {n}, free "
                              f"{len(self._free)} of {self.num_pages}")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            assert p not in self._owner, f"page {p} double-assigned"
            self._owner[p] = owner
        return pages

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if p not in self._owner:
                raise ValueError(f"page {p} freed but not allocated")
            del self._owner[p]
            self._free.append(p)
