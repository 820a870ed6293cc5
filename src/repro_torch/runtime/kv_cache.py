"""Paged KV-cache bookkeeping: fixed-size pages and per-request block tables.

Host-side only. A copy of the core of ``repro.runtime.kv_cache`` (the port
imports nothing of the JAX package): a free-list allocator over a flat pool
of pages, one block table per request, refcounted pages shared between
tables (prefix sharing, copy-on-write, speculative rollback) and pinned by
the prefix cache. The device pools live in
``repro_torch.models.api.paged_cache_init``. Page 0 is the scratch page:
dead slots and beyond-allocation writes are redirected there, and its
contents are always masked out on the read side. The sliding-window base
offsets and the host-tier classes of the JAX allocator are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

SCRATCH_PAGE = 0


class PageAllocator:
    """Free-list page allocator with per-request block tables and per-page
    refcounts. ``num_pages`` counts usable pages; the implicit scratch page
    makes the device pool ``num_pages + 1`` pages."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 1 or page_size < 1:
            raise ValueError(f"need num_pages >= 1 and page_size >= 1, got "
                             f"{num_pages}, {page_size}")
        self.num_pages = num_pages
        self.page_size = page_size
        # LIFO free list keeps the working set hot (ids 1..num_pages)
        self._free: List[int] = list(range(num_pages, 0, -1))
        self._tables: Dict[int, List[int]] = {}   # rid -> physical pages
        self._tokens: Dict[int, int] = {}         # rid -> live token count
        self._ref: Dict[int, int] = {}            # page -> refcount (> 0)
        self._pinned: Set[int] = set()            # prefix-cache pins (+1 ref)
        self.peak_pages = 0                        # high-water mark
        self.share_events = 0                      # table refs to shared pages

    # -- queries ----------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def allocated_pages(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def cached_idle_pages(self) -> int:
        """Pages held only by the prefix cache (evictable on pressure)."""
        return sum(1 for p in self._pinned if self._ref[p] == 1)

    @property
    def live_tokens(self) -> int:
        return sum(self._tokens.values())

    @property
    def live_requests(self) -> int:
        return len(self._tables)

    def ref(self, page: int) -> int:
        """Current refcount of ``page`` (0 = free)."""
        return self._ref.get(page, 0)

    def is_pinned(self, page: int) -> bool:
        return page in self._pinned

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` (>= 1 page once admitted)."""
        return max(1, -(-n_tokens // self.page_size))

    def block_table(self, rid: int) -> List[int]:
        return list(self._tables[rid])

    def tokens(self, rid: int) -> int:
        return self._tokens[rid]

    def utilization(self) -> float:
        """Live tokens over allocated page capacity (1.0 = no slack; above
        1.0 once sharing puts several requests' tokens on one page)."""
        cap = self.allocated_pages * self.page_size
        return self.live_tokens / cap if cap else 1.0

    # -- lifecycle --------------------------------------------------------
    def _pop_free(self) -> int:
        page = self._free.pop()
        self._ref[page] = 1
        return page

    def _decref(self, page: int) -> bool:
        """Drop one reference; True if the page became free."""
        n = self._ref[page] - 1
        if n:
            self._ref[page] = n
            return False
        del self._ref[page]
        self._free.append(page)
        return True

    def allocate(self, rid: int, n_tokens: int) -> Optional[List[int]]:
        """Admit ``rid`` with ``n_tokens`` live tokens. Returns its block
        table, or None (state unchanged) if the pool can't cover it."""
        return self.allocate_shared(rid, n_tokens, [])

    def allocate_shared(self, rid: int, n_tokens: int,
                        shared: List[int]) -> Optional[List[int]]:
        """Admit ``rid`` reusing ``shared`` (allocated prefix pages, in
        block order) and allocating fresh pages for the rest. Returns the
        table ``shared + fresh`` with each shared page's refcount raised,
        or None (state unchanged, no refs taken) if the free list can't
        cover the fresh part."""
        if rid in self._tables:
            raise ValueError(f"rid {rid} already admitted")
        need = self.pages_for(n_tokens)
        if len(shared) > need:
            raise ValueError("shared prefix longer than the request")
        fresh_n = need - len(shared)
        if fresh_n > len(self._free):
            return None
        for p in shared:
            if p not in self._ref:
                raise ValueError(f"shared page {p} is not allocated")
            self._ref[p] += 1
        self.share_events += len(shared)
        pages = list(shared) + [self._pop_free() for _ in range(fresh_n)]
        self._tables[rid] = pages
        self._tokens[rid] = n_tokens
        self.peak_pages = max(self.peak_pages, self.allocated_pages)
        return list(pages)

    def extend_to(self, rid: int, n_tokens: int) -> Optional[int]:
        """Grow ``rid`` to cover ``n_tokens`` tokens (allocate on demand, at
        most one page per call). Returns the new page id if a page boundary
        was crossed, 0 if the current pages already cover it, or None if
        the pool is exhausted (state unchanged: evict or preempt)."""
        need = self.pages_for(n_tokens)
        have = len(self._tables[rid])
        if need > have + 1:
            raise ValueError("extend_to grows by at most one page")
        if need <= have:
            self._tokens[rid] = max(self._tokens[rid], n_tokens)
            return 0
        if not self._free:
            return None
        page = self._pop_free()
        self._tables[rid].append(page)
        self._tokens[rid] = n_tokens
        self.peak_pages = max(self.peak_pages, self.allocated_pages)
        return page

    def truncate_to(self, rid: int, n_tokens: int) -> int:
        """Roll ``rid`` back to ``n_tokens`` live tokens (speculative
        rejection): drop this table's reference to every whole page past
        the ones ``n_tokens`` needs. A dropped page that is shared or
        pinned survives its other references. Rows of the kept tail page
        past the accept point stay as garbage, masked by the request's
        length and overwritten by the next write. Returns the number of
        table entries dropped."""
        if not 0 < n_tokens <= self._tokens[rid]:
            raise ValueError(f"truncate_to({n_tokens}) must shrink rid {rid} "
                             f"({self._tokens[rid]} tokens)")
        table = self._tables[rid]
        keep = self.pages_for(n_tokens)
        dropped = len(table) - keep
        for p in reversed(table[keep:]):   # LIFO: reuse hottest first
            self._decref(p)
        del table[keep:]
        self._tokens[rid] = n_tokens
        return dropped

    def replace_page(self, rid: int, block: int) -> Optional[Tuple[int, int]]:
        """Copy-on-write swap: give ``rid`` a fresh private page in table
        slot ``block`` and drop its reference to the page there. Returns
        (old_page, new_page), for the caller to copy the device contents
        and update the device table, or None if no page is free (state
        unchanged)."""
        table = self._tables[rid]
        if not 0 <= block < len(table):
            raise ValueError(f"block {block} outside rid {rid}'s table")
        if not self._free:
            return None
        old = table[block]
        new = self._pop_free()
        table[block] = new
        self._decref(old)
        self.peak_pages = max(self.peak_pages, self.allocated_pages)
        return old, new

    def free_request(self, rid: int) -> int:
        """Drop ``rid``'s reference to every page of its table. Returns the
        number of pages that became free (shared and pinned pages survive
        their other references)."""
        pages = self._tables.pop(rid)
        del self._tokens[rid]
        freed = 0
        for p in reversed(pages):       # LIFO: reuse hottest first
            freed += self._decref(p)
        return freed

    # -- prefix-cache pins -------------------------------------------------
    def alloc_pinned_page(self) -> Optional[int]:
        """Allocate one page whose only reference is a prefix-cache pin (no
        table holds it). None if the free list is dry."""
        if not self._free:
            return None
        page = self._pop_free()         # ref = 1 ...
        self._pinned.add(page)          # ... and that 1 is the pin
        self.peak_pages = max(self.peak_pages, self.allocated_pages)
        return page

    def cache_pin(self, page: int) -> None:
        """The prefix cache keeps ``page`` alive (+1 ref) while it sits in
        the radix tree, so it outlives its last owner."""
        if page not in self._ref:
            raise ValueError(f"cannot pin free page {page}")
        if page in self._pinned:
            raise ValueError(f"page {page} already pinned")
        self._ref[page] += 1
        self._pinned.add(page)

    def cache_unpin(self, page: int) -> bool:
        """Drop the prefix-cache pin (eviction). True if the page became
        free (no table still referenced it)."""
        self._pinned.discard(page)
        return self._decref(page)

    # -- invariants (cheap; used by tests) ---------------------------------
    def check(self) -> None:
        """Every allocated page's refcount equals its table occurrences plus
        its cache pin; no page is both free and referenced; scratch is
        never handed out; free plus allocated covers exactly the usable
        pages."""
        occurrences: Dict[int, int] = {}
        for rid, pages in self._tables.items():
            assert len(set(pages)) == len(pages), \
                f"rid {rid} table repeats a page"
            for p in pages:
                assert p != SCRATCH_PAGE, f"rid {rid} holds scratch page"
                occurrences[p] = occurrences.get(p, 0) + 1
        free = set(self._free)
        assert len(free) == len(self._free), "free list repeats a page"
        for p, n in self._ref.items():
            assert p not in free, f"page {p} both free and referenced"
            want = occurrences.get(p, 0) + (1 if p in self._pinned else 0)
            assert n == want, (
                f"page {p}: refcount {n} != {occurrences.get(p, 0)} table "
                f"refs + {int(p in self._pinned)} pin")
        for p in occurrences:
            assert p in self._ref, f"page {p} in a table but not allocated"
        for p in self._pinned:
            assert p in self._ref, f"pinned page {p} not allocated"
        assert len(free) + len(self._ref) == self.num_pages
        assert SCRATCH_PAGE not in free and SCRATCH_PAGE not in self._ref

    def check_no_aliasing(self) -> None:
        """``check()`` plus: no page is shared by two tables."""
        self.check()
        for p, n in self._ref.items():
            pin = 1 if p in self._pinned else 0
            assert n - pin <= 1, f"page {p} shared by {n - pin} tables"


@dataclasses.dataclass
class PoolStats:
    """Snapshot of pool utilization for telemetry output."""
    page_size: int
    num_pages: int
    allocated_pages: int
    peak_pages: int
    live_tokens: int
    utilization: float
    dense_equiv_tokens: int    # what a dense slots x max_len cache reserves
    cached_idle_pages: int = 0  # prefix-cache-only pages (evictable)
    shared_page_refs: int = 0   # table refs served by sharing, lifetime

    @staticmethod
    def of(alloc: PageAllocator, slots: int, max_len: int) -> "PoolStats":
        return PoolStats(
            page_size=alloc.page_size, num_pages=alloc.num_pages,
            allocated_pages=alloc.allocated_pages,
            peak_pages=alloc.peak_pages, live_tokens=alloc.live_tokens,
            utilization=alloc.utilization(),
            dense_equiv_tokens=slots * max_len,
            cached_idle_pages=alloc.cached_idle_pages,
            shared_page_refs=alloc.share_events)
