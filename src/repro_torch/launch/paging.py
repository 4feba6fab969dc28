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
decisions to the cache.  ``class_quotas`` (see
:func:`~repro_torch.launch.lifecycle.normalize_class_quotas`) partition
the pool: a page is charged to the class that allocated it for its whole
life in the pool (sharing and transfer keep the charge), a floor reserves
pages no other class may take and a cap bounds a class's charge.  On an
unpartitioned pool ``cls=`` charges nothing.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from .lifecycle import PriorityClass, coerce_priority, normalize_class_quotas

__all__ = ["PageAllocator"]


class PageAllocator:
    """Refcounting LIFO free-list allocator over page ids ``0 .. num_pages-1``.

    A free list cannot fragment: any ``n <= len(free)`` request is
    satisfiable because pages are position-independent (the block table
    gives each request its own contiguous *logical* view over arbitrary
    *physical* page ids).  That is the property the dense layout lacks —
    a dense slot needs ``max_len`` contiguous rows whether or not the
    request uses them.

    Each allocated page has exactly one *owner tag* (who to charge it
    to — the engine uses slot indices, and the prefix index a sentinel)
    plus a refcount counting every logical holder.  Sharing does not
    move ownership; :meth:`transfer` does (the engine re-owns a page to
    the prefix index when it is published).
    """

    def __init__(self, num_pages: int, page_size: int, *,
                 class_quotas=None):
        if num_pages <= 0 or page_size <= 0:
            raise ValueError("num_pages and page_size must be positive")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        #: page id -> owner tag (engine: slot index); the double-assign guard
        self._owner: Dict[int, object] = {}
        #: owner tag -> pages in allocation order.  Kept in lockstep with
        #: ``_owner`` so :meth:`pages_of` is O(own pages), not an
        #: O(num_pages) scan — ``spill`` calls it per victim, and a heavy
        #: preemption sweep must not go quadratic in pool size.
        self._pages: Dict[object, List[int]] = {}
        #: page id -> reference count (>= 1 while allocated)
        self._ref: Dict[int, int] = {}
        #: per-class partition of the pool (empty dict = unpartitioned,
        #: byte-identical legacy behaviour).  A page is *charged* to the
        #: class that allocated it for its whole pool lifetime — sharing
        #: and ownership transfer (prefix publication) keep the charge,
        #: so a REALTIME-published prefix page keeps counting toward the
        #: REALTIME floor, which is exactly the working set the floor
        #: exists to protect.
        self.class_quotas = normalize_class_quotas(class_quotas)
        self._cls: Dict[int, Optional[PriorityClass]] = {}
        self._cls_used: Dict[PriorityClass, int] = {
            c: 0 for c in PriorityClass}
        #: floors round UP (the reservation is "at least this fraction"),
        #: caps round down but never to zero (a cap the class can never
        #: use at all would be a ban spelled as a bound)
        self._floor_pages: Dict[PriorityClass, int] = {}
        self._cap_pages: Dict[PriorityClass, int] = {}
        for c, q in self.class_quotas.items():
            if "floor" in q:
                self._floor_pages[c] = min(
                    self.num_pages,
                    int(math.ceil(q["floor"] * self.num_pages - 1e-9)))
            if "cap" in q:
                self._cap_pages[c] = max(
                    1, int(q["cap"] * self.num_pages + 1e-9))

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
        if n > len(self._free):
            return False
        if not self.class_quotas:
            return True
        return self.quota_violation({self._coerce_cls(cls): int(n)}) is None

    # -- class quotas -------------------------------------------------------
    def _coerce_cls(self, cls) -> Optional[PriorityClass]:
        """Charge class for an allocation: explicit class, else STANDARD
        when the pool is partitioned (defaulted traffic is the middle
        class, same convention as ``coerce_priority``), else ``None``
        (unpartitioned pools track nothing)."""
        if not self.class_quotas:
            return None
        return (PriorityClass.STANDARD if cls is None
                else coerce_priority(cls))

    def class_used(self, cls) -> int:
        """Pages currently charged to ``cls``."""
        return self._cls_used.get(coerce_priority(cls), 0)

    def cap_pages(self, cls) -> Optional[int]:
        """``cls``'s page cap (None = uncapped)."""
        return self._cap_pages.get(coerce_priority(cls))

    def floor_pages(self, cls) -> int:
        """Pages reserved for ``cls`` (0 = no reservation)."""
        return self._floor_pages.get(coerce_priority(cls), 0)

    def quota_violation(self, needs: Dict, *, freed: int = 0,
                        uncharge: Optional[Dict] = None) -> Optional[str]:
        """``None`` if per-class allocations ``needs`` fit every quota,
        else a message naming the violated constraint.

        ``needs`` maps class -> fresh pages wanted.  ``freed`` pages are
        known to return to the free list first (a recycle/preempt plan),
        with ``uncharge`` as the matching per-class charge decrements
        (see :meth:`release_credit`).  Two constraints:

        * **cap**: a capped class may not exceed its page bound;
        * **floor**: after the allocation, the free list must still
          cover every *other* class's unfilled reservation — the free
          pages behind a floor belong to that class's future, not to
          whoever asks first.
        """
        if not self.class_quotas:
            return None
        used = dict(self._cls_used)
        for c, n in (uncharge or {}).items():
            used[c] = used.get(c, 0) - int(n)
        total = 0
        for key, n in needs.items():
            c = self._coerce_cls(key)
            used[c] = used.get(c, 0) + int(n)
            total += int(n)
        free_after = len(self._free) + int(freed) - total
        for c, cap in self._cap_pages.items():
            if used.get(c, 0) > cap:
                return (f"class {c.name.lower()} over its page cap: "
                        f"{used[c]} > {cap} of {self.num_pages}")
        shortfall = sum(max(0, fp - used.get(c, 0))
                        for c, fp in self._floor_pages.items())
        if free_after < shortfall:
            return (f"allocation would break reserved class floors: "
                    f"{free_after} pages would stay free but "
                    f"{shortfall} are reserved")
        return None

    def quota_evict_want(self, cls, n: int,
                         planned: Optional[Dict] = None) -> int:
        """Pages of ``cls`` (or less important) that would have to
        leave the pool — freed AND uncharged — before ``n`` fresh pages
        for ``cls`` clear both quota constraints (0 = quotas are not
        the blocker).  Sizes the prefix-eviction sweep a quota-blocked
        admission head runs: a pool with plenty of free pages can still
        refuse a capped class whose *published* prefix pages hold its
        whole budget."""
        if not self.class_quotas:
            return 0
        used = dict(self._cls_used)
        total = 0
        for key, m in (planned or {}).items():
            c = self._coerce_cls(key)
            used[c] = used.get(c, 0) + int(m)
            total += int(m)
        c = self._coerce_cls(cls)
        used[c] = used.get(c, 0) + int(n)
        total += int(n)
        want = 0
        cap = self._cap_pages.get(c)
        if cap is not None and used[c] > cap:
            want = used[c] - cap
        free_after = len(self._free) - total
        shortfall = sum(max(0, fp - used.get(k, 0))
                        for k, fp in self._floor_pages.items())
        if free_after < shortfall:
            want = max(want, shortfall - free_after)
        return want

    def release_credit(self, pages) -> Tuple[int, Dict]:
        """``(pages that would return to the pool, per-class uncharges)``
        if one reference were dropped on each of ``pages`` — the credit
        an admission plan may count before it actually frees anything."""
        freed, uncharge = 0, {}
        for p in pages:
            if self._ref.get(int(p), 0) == 1:
                freed += 1
                c = self._cls.get(int(p))
                if c is not None:
                    uncharge[c] = uncharge.get(c, 0) + 1
        return freed, uncharge

    def pages_of(self, owner) -> List[int]:
        """The pages currently owned by ``owner``, in allocation order
        (the same order the engine's block table holds them).  O(own
        pages) via the per-owner list — never a pool-wide scan."""
        return list(self._pages.get(owner, ()))

    def refcount(self, page: int) -> int:
        """References held on ``page`` (0 = not allocated)."""
        return self._ref.get(int(page), 0)

    def shared_pages(self) -> int:
        """Number of allocated pages with more than one reference."""
        return sum(1 for r in self._ref.values() if r > 1)

    # -- alloc / free -------------------------------------------------------
    def alloc(self, n: int, owner=None, cls=None) -> List[int]:
        """Take ``n`` pages off the free list (raises if short), each
        with refcount 1, charged to ``cls`` when the pool is
        class-partitioned.

        Without quotas ``free_pages >= n`` is the complete admission
        condition — there is no fragmentation failure mode to account
        for.  With quotas the class constraints of
        :meth:`quota_violation` apply on top.
        """
        if n > len(self._free):
            raise MemoryError(
                f"page pool exhausted: need {n}, free {len(self._free)} "
                f"of {self.num_pages}")
        cls = self._coerce_cls(cls)
        if self.class_quotas:
            msg = self.quota_violation({cls: int(n)})
            if msg is not None:
                raise MemoryError(
                    f"class quota exceeded: {msg} (need {n} for "
                    f"{cls.name.lower()})")
        pages = [self._free.pop() for _ in range(n)]
        own = self._pages.setdefault(owner, [])
        for p in pages:
            assert p not in self._owner, f"page {p} double-assigned"
            self._owner[p] = owner
            self._ref[p] = 1
            own.append(p)
            self._charge(p, cls)
        return pages

    def _charge(self, page: int, cls: Optional[PriorityClass]) -> None:
        self._cls[page] = cls
        if cls is not None:
            self._cls_used[cls] += 1

    def _uncharge(self, page: int) -> None:
        cls = self._cls.pop(page, None)
        if cls is not None:
            self._cls_used[cls] -= 1

    def share(self, pages: List[int]) -> None:
        """Add one reference to each page (all must be allocated).

        Atomic: every id is validated before any count moves, so a
        failed share changes nothing.  Sharing never touches ownership
        or the free list — it is the O(pages) half of a prefix-cache
        hit (the other half is a block-table edit on the engine side).
        """
        pages = [int(p) for p in pages]
        for p in pages:
            if p not in self._owner:
                raise ValueError(f"page {p} is not allocated; cannot share")
        for p in pages:
            self._ref[p] += 1

    def free(self, pages: List[int]) -> None:
        """Drop one reference per page; a page whose count reaches zero
        returns to the pool (immediately reusable, O(pages)).

        Atomic: the whole list is validated before any reference moves,
        so a double-free (or a duplicate within the call) raises without
        half-freeing — the guard that keeps a preempt/restore cycle from
        ever putting one page on the free list twice.  A page still
        referenced elsewhere (prefix-shared) survives the call with its
        owner unchanged: *no page is freed while references remain*.
        """
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
            self._uncharge(p)

    def transfer(self, pages: List[int], owner) -> None:
        """Re-own allocated pages to ``owner`` (refcounts untouched).

        The publication primitive: a page entering the prefix index is
        charged to the index rather than the slot that computed it, so
        ``pages_of(slot)``/``spill(slot)`` keep meaning "pages only this
        slot holds".  Atomic like every other mutator."""
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
        """Drop ``owner``'s reference on every page it owns; returns
        them in allocation order.  The preemption primitive: the engine
        copies the returned pages' payload to host memory *before*
        calling this, then exclusively-held ids rejoin the free list
        exactly as a normal ``free`` would — a later :meth:`alloc` for
        the resumed request hands out whatever physical ids are free
        *then* (restore re-targets the payload, it does not pin
        physical ids)."""
        pages = self.pages_of(owner)
        self.free(pages)
        return pages

    def adopt(self, pages: List[int], owner=None, cls=None) -> None:
        """Claim *specific* free page ids for ``owner`` (refcount 1),
        charged to ``cls`` when the pool is class-partitioned.

        The restore-side primitive: re-attaching allocator state from an
        engine snapshot (or migrating pages between pools) must mark the
        exact ids a request held, not whatever the LIFO head offers.
        Atomic: every id is validated free (and unique) before any is
        claimed."""
        pages = [int(p) for p in pages]
        if len(set(pages)) != len(pages):
            raise ValueError(f"duplicate page ids in adopt(): {pages}")
        free_set = set(self._free)
        for p in pages:
            if p in self._owner:
                raise ValueError(f"page {p} is already assigned")
            if p not in free_set:
                raise ValueError(f"page {p} is not a valid free page")
        cls = self._coerce_cls(cls)
        if self.class_quotas:
            msg = self.quota_violation({cls: len(pages)})
            if msg is not None:
                raise MemoryError(
                    f"class quota exceeded: {msg} (adopting "
                    f"{len(pages)} for {cls.name.lower()})")
        taken = set(pages)
        self._free = [p for p in self._free if p not in taken]
        own = self._pages.setdefault(owner, [])
        for p in pages:
            self._owner[p] = owner
            self._ref[p] = 1
            own.append(p)
            self._charge(p, cls)

    # -- snapshot / restore -------------------------------------------------
    def state(self) -> dict:
        """Host-copyable allocator state (free-list ORDER included —
        allocation determinism after a restore depends on it — plus
        per-page refcounts and the per-owner allocation order)."""
        return {"free": list(self._free), "owner": dict(self._owner),
                "ref": dict(self._ref),
                "pages": {o: list(ps) for o, ps in self._pages.items()
                          if ps},
                "cls": {p: (c.name if c is not None else None)
                        for p, c in self._cls.items()}}

    def load_state(self, state: dict) -> None:
        """Restore :meth:`state` output; validates the page-id partition
        (every id exactly once across free + owned) and that every
        allocated page carries at least one reference."""
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
            # legacy snapshots: reconstruct per-owner allocation order
            # from the owner dict's insertion order (how pages_of used
            # to derive it)
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
        # class charges: legacy snapshots (pre-quota) carry none — their
        # pages restore unclassified, which under-counts floors/caps
        # until those requests retire (documented, conservative for the
        # restored requests themselves, never for the floor holders)
        cls_map = state.get("cls") or {}
        self._cls = {}
        self._cls_used = {c: 0 for c in PriorityClass}
        for p in owner:
            name = cls_map.get(p)
            self._charge(p, PriorityClass[name] if name else None)
