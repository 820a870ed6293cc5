"""Prefix-sharing KV cache: a radix tree over page-aligned token chunks.

A copy of ``repro.runtime.prefix_cache`` (the port imports nothing of the
JAX package). The host-tier half (``demote_node``/``promote_node``) is kept
for the copy's sake; the port's engine has no host tier yet.

The serving-level continuation of the paper's shared-memory argument
(PAPER.md, Sec. II-C): Voltra wins its temporal-utilization gain by letting
competing consumers dynamically (re)allocate ONE physical memory instead of
each holding a private copy. Here the competing consumers are *requests*:
production traffic ("millions of users") overlaps heavily — shared system
prompts, few-shot templates, multi-turn history — and without sharing,
every request recomputes and privately stores the KV of the same prefix.

Structure
---------
* **Key** = the request's token ids, chunked into page-size-aligned pieces.
  Each radix node holds exactly one full chunk (``page_size`` token ids)
  and the physical page storing that chunk's KV in every layer's pool.
  Page-aligned chunking means a radix hit IS a block-table entry: matched
  pages are written verbatim into the request's table, no copying.
* **Refcounts** live in ``kv_cache.PageAllocator``: the tree holds one pin
  (+1 ref) per cached page; each live table that reuses the page holds one
  more. Pages whose only reference is the tree's pin are *idle* —
  evictable but still instantly matchable (the hit path for a request
  arriving after its twin finished).
* **Copy-on-write**: a request that diverges *inside* a cached page (the
  shared tokens end mid-page) must not write its own suffix KV into the
  shared physical page. ``match()`` reports the partial hit; the engine
  copies the cached page into a fresh private one on device and prefills
  only the divergent tail (``serving.PagedServingEngine.submit``).
* **Eviction**: ``evict(n)`` releases idle pages in LRU order, leaves
  first (an inner node may not outlive its children, or a later match
  would walk across a freed page). The engine calls it when the free list
  runs dry, BEFORE falling back to preempting a live request — dropping
  an idle cached page costs one future re-prefill at most, preemption
  costs a guaranteed one.
* **Host tier**: with the two-tier hierarchy on (``runtime/host_tier.py``)
  idle pages *demote* instead of evicting: the node stays in the tree but
  ``page`` becomes None and ``host`` holds the host-store handle of the
  page's KV. A host node is still matchable — ``match()`` walks through
  it (page placeholder ``-1``) and reports the node path so the engine
  can promote (H2D) instead of re-prefilling. Demotion carries NO
  leaf-first constraint (the node keeps its place in the tree), so any
  idle device node may demote, in LRU order (``demotable``).

Host-side only: physical page ids in, physical page ids out.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.runtime.kv_cache import PageAllocator
from repro_torch.runtime.trace import NULL_TRACER, Tracer

Chunk = Tuple[int, ...]


class _Node:
    __slots__ = ("chunk", "page", "parent", "children", "last_used", "host")

    def __init__(self, chunk: Optional[Chunk], page: int,
                 parent: Optional["_Node"]):
        self.chunk = chunk              # None only for the root
        self.page = page                # physical page id; None = demoted
        self.parent = parent
        self.children: Dict[Chunk, _Node] = {}
        self.last_used = 0
        self.host = None                # host-store handle when demoted


@dataclasses.dataclass
class PrefixMatch:
    """Result of a longest-prefix lookup.

    ``pages`` are full-page hits in block order (reusable verbatim in the
    block table). ``partial_page``/``partial_tokens`` describe a hit that
    ends inside a cached page: the first ``partial_tokens`` rows of
    ``partial_page`` hold valid KV, the engine must copy-on-write before
    prefilling past them. ``tokens`` counts every matched token.

    With the host tier on, a matched node may be host-resident: its entry
    in ``pages`` is the ``-1`` placeholder and ``path`` (the full-page
    node chain, one node per ``pages`` entry) carries the node so the
    engine can promote it back to a device page before use."""
    pages: List[int]
    tokens: int = 0
    partial_page: Optional[int] = None
    partial_tokens: int = 0
    # deepest matched node, for commit()'s LRU touch (internal)
    node: Optional[_Node] = None
    # full-page node chain, parallel to ``pages`` (internal)
    path: List[_Node] = dataclasses.field(default_factory=list)


class PrefixCache:
    """Radix tree mapping page-aligned token-id chunks -> physical pages."""

    def __init__(self, alloc: PageAllocator, *,
                 tracer: Optional[Tracer] = None):
        self.alloc = alloc
        self.trace = tracer if tracer is not None else NULL_TRACER
        self.page_size = alloc.page_size
        self.root = _Node(None, -1, None)
        self._by_page: Dict[int, _Node] = {}
        self._clock = 0
        # telemetry (lifetime counters; engine exports them)
        self.lookups = 0
        self.lookup_tokens = 0
        self.hits = 0                   # lookups with >= 1 matched token
        self.hit_tokens = 0             # tokens served from cache
        self.full_page_hits = 0         # pages reused without any copy
        self.partial_hits = 0           # matches ending inside a page (CoW)
        self.inserted_pages = 0
        self.evicted_pages = 0
        self.host_nodes = 0             # demoted (host-resident) nodes

    # -- queries ----------------------------------------------------------
    @property
    def cached_pages(self) -> int:
        return len(self._by_page)

    def _chunks(self, tokens: Sequence[int]) -> Iterable[Chunk]:
        ps = self.page_size
        for i in range(0, len(tokens) - ps + 1, ps):
            yield tuple(tokens[i:i + ps])

    def _touch(self, node: _Node) -> None:
        self._clock += 1
        while node is not self.root:
            node.last_used = self._clock
            node = node.parent

    # -- match -------------------------------------------------------------
    def match(self, tokens: Sequence[int], *,
              max_tokens: Optional[int] = None) -> PrefixMatch:
        """Longest prefix of ``tokens`` present in the tree, in whole
        pages plus at most one partial page. ``max_tokens`` caps the match
        (the engine passes len-1 so at least one token is left to prefill
        — prefill must produce the next-token logits).

        Pure lookup: neither telemetry nor LRU state moves. The caller
        commits the match only once it is actually USED (commit()), so a
        rejected admission retried every scheduler tick doesn't inflate
        hit rates or keep a stalled request's prefix artificially hot."""
        with self.trace.span("match", tid="prefix"):
            return self._match(tokens, max_tokens=max_tokens)

    def _match(self, tokens: Sequence[int], *,
               max_tokens: Optional[int] = None) -> PrefixMatch:
        ps = self.page_size
        limit = len(tokens) if max_tokens is None else min(len(tokens),
                                                           max_tokens)
        node = self.root
        pages: List[int] = []
        path: List[_Node] = []
        i = 0
        while limit - i >= ps:
            child = node.children.get(tuple(tokens[i:i + ps]))
            if child is None:
                break
            # host-resident node: still a hit — placeholder page, the
            # engine promotes it (or truncates the match there).
            pages.append(child.page if child.page is not None else -1)
            path.append(child)
            node = child
            i += ps
        # divergence inside the next page: longest common prefix against
        # any child chunk (> 0 tokens) is still reusable KV, via CoW.
        # Device children only — a partial hit is consumed by an on-device
        # page copy, which a demoted page cannot serve.
        best_node: Optional[_Node] = None
        best_p = 0
        if limit > i:
            want = tuple(tokens[i:min(i + ps, limit)])
            for chunk, child in node.children.items():
                if child.page is None:
                    continue
                p = 0
                for a, b in zip(want, chunk):
                    if a != b:
                        break
                    p += 1
                if p > best_p:
                    best_p, best_node = p, child
        matched = i + best_p
        if best_node is not None:
            return PrefixMatch(pages, matched, best_node.page, best_p,
                               node=best_node, path=path)
        return PrefixMatch(pages, matched,
                           node=node if pages else None, path=path)

    def commit(self, m: PrefixMatch, total_tokens: int) -> None:
        """Record that a match() result was used to admit a request of
        ``total_tokens`` prompt tokens: bump the hit/lookup telemetry
        (misses count too — they are the hit-rate denominator) and touch
        the matched path's LRU clock, exactly once per admission."""
        self.lookups += 1
        self.lookup_tokens += total_tokens
        if m.tokens:
            self.hits += 1
            self.hit_tokens += m.tokens
            self.full_page_hits += len(m.pages)
            if m.partial_page is not None:
                self.partial_hits += 1
        if m.node is not None:
            self._touch(m.node)

    def reset_hit_counters(self) -> None:
        """Zero the per-lookup telemetry (benchmarks call this after a
        cache-warming phase so the timed replay reports its own rates);
        tree contents and the lifetime insert/evict counters survive."""
        self.lookups = self.lookup_tokens = 0
        self.hits = self.hit_tokens = 0
        self.full_page_hits = self.partial_hits = 0

    # -- insert ------------------------------------------------------------
    def insert(self, tokens: Sequence[int], table: Sequence[int]) -> int:
        """Publish ``tokens``'s full pages into the tree. ``table`` is the
        owner's block table; block ``j`` holds tokens ``[j*ps, (j+1)*ps)``.
        Pages already represented by an existing node are skipped (the
        owner keeps its private copy; future matches use the incumbent).
        Newly inserted pages are pinned in the allocator. Returns the
        number of pages inserted."""
        node = self.root
        added = 0
        for j, chunk in enumerate(self._chunks(tokens)):
            child = node.children.get(chunk)
            if child is None:
                page = table[j]
                if self.alloc.is_pinned(page):
                    # already in the tree under another path — a page can
                    # carry only one pin, and re-keying it would alias two
                    # token histories onto one physical page.
                    break
                child = _Node(chunk, page, node)
                node.children[chunk] = child
                self._by_page[page] = child
                self.alloc.cache_pin(page)
                added += 1
            node = child
        if added:
            self._touch(node)
            self.inserted_pages += added
            if self.trace:
                self.trace.instant("insert", tid="prefix",
                                   args={"pages": added})
        return added

    # -- host tier: demote / promote ---------------------------------------
    def demotable(self, protect: Optional[Set[int]] = None) -> List["_Node"]:
        """Idle device nodes (refcount == pin only), LRU first. Unlike
        eviction there is NO leaf-first constraint: a demoted node keeps
        its place in the tree (host nodes stay matchable), so an inner
        node may demote while its children stay on device."""
        protect = protect or set()
        out = [n for n in self._by_page.values()
               if n.page not in protect and self.alloc.ref(n.page) == 1]
        out.sort(key=lambda n: n.last_used)
        return out

    def demotable_count(self, protect: Optional[Set[int]] = None) -> int:
        return len(self.demotable(protect))

    def demote_node(self, node: _Node, handle) -> int:
        """Move ``node`` to the host tier: drop its pin (freeing the
        device page) and remember the host-store ``handle``. The caller
        must have dispatched the page-content gather BEFORE calling this
        (gather-then-free is safe under JAX dispatch ordering). Returns
        the freed page id."""
        page = node.page
        assert page is not None and node.host is None
        del self._by_page[page]
        node.page = None
        node.host = handle
        self.host_nodes += 1
        became_free = self.alloc.cache_unpin(page)
        assert became_free, "demoted an idle page that was still referenced"
        return page

    def promote_node(self, node: _Node, page: int) -> None:
        """Re-attach a host-resident node to device ``page`` (allocated
        pinned by the caller via ``PageAllocator.alloc_pinned_page``; the
        caller also scatters the page contents back)."""
        assert node.page is None and node.host is not None
        assert self.alloc.is_pinned(page)
        node.page = page
        node.host = None
        self._by_page[page] = node
        self.host_nodes -= 1

    # -- eviction ----------------------------------------------------------
    def _evictable(self, protect: Set[int]) -> List[_Node]:
        """Idle leaves (refcount == pin only, no children), LRU first."""
        out = [n for n in self._by_page.values()
               if not n.children and n.page not in protect
               and self.alloc.ref(n.page) == 1]
        out.sort(key=lambda n: n.last_used)
        return out

    def evictable_count(self, protect: Optional[Set[int]] = None) -> int:
        """How many pages evict() could free at most, honoring leaf-first
        order (an idle inner node whose subtree holds an in-use page can
        never be reached) — a dry run, nothing moves. Callers use it to
        skip an eviction that cannot cover their deficit anyway: flushing
        still-matchable prefixes for an admission that gets rejected
        regardless is pure loss."""
        protect = protect or set()
        removed: Set[int] = set()
        progress = True
        while progress:
            progress = False
            for node in self._by_page.values():
                if (node.page in removed or node.page in protect
                        or self.alloc.ref(node.page) != 1):
                    continue
                if any(c.page not in removed
                       for c in node.children.values()):
                    continue
                removed.add(node.page)
                progress = True
        return len(removed)

    def evict(self, n_pages: int,
              protect: Optional[Set[int]] = None) -> int:
        """Free up to ``n_pages`` pages by unpinning idle cached pages in
        LRU order, leaves first (evicting an inner node would orphan its
        children's KV mid-path). ``protect`` shields pages the caller is
        about to reuse (a match taken but not yet refcounted). Returns the
        number of pages actually freed."""
        protect = protect or set()
        freed = 0
        with self.trace.span("evict", tid="prefix"):
            while freed < n_pages:
                leaves = self._evictable(protect)
                if not leaves:
                    break
                for node in leaves:
                    if freed >= n_pages:
                        break
                    self._drop(node)
                    freed += 1
                    self.evicted_pages += 1
        return freed

    def _drop(self, node: _Node) -> None:
        assert not node.children
        del node.parent.children[node.chunk]
        del self._by_page[node.page]
        became_free = self.alloc.cache_unpin(node.page)
        assert became_free, "evicted an idle page that was still referenced"

    #: Every key ``stats()`` returns — the engine's ``prefix_stats``
    #: zero-fills these when sharing is off so metric / CSV key sets
    #: never depend on configuration.
    STAT_KEYS = (
        "lookups", "hits", "hit_rate", "hit_tokens", "shared_token_frac",
        "full_page_hits", "partial_hits", "inserted_pages",
        "evicted_pages", "cached_pages", "host_nodes")

    @staticmethod
    def zero_stats() -> Dict[str, float]:
        return {k: 0.0 for k in PrefixCache.STAT_KEYS}

    def stats(self) -> Dict[str, float]:
        return {
            "lookups": self.lookups,
            "hits": self.hits,
            "hit_rate": self.hits / self.lookups if self.lookups else 0.0,
            "hit_tokens": self.hit_tokens,
            "shared_token_frac": (self.hit_tokens / self.lookup_tokens
                                  if self.lookup_tokens else 0.0),
            "full_page_hits": self.full_page_hits,
            "partial_hits": self.partial_hits,
            "inserted_pages": self.inserted_pages,
            "evicted_pages": self.evicted_pages,
            "cached_pages": self.cached_pages,
            "host_nodes": self.host_nodes,
        }
