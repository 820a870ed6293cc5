"""Host-RAM tier of the paged engine's KV pages and recurrent state, with
copies on a side stream.

Counterpart of ``repro.runtime.host_tier``: the serving-scale form of the
paper's shared-memory streamers (PAPER.md), mixed-grained prefetching plus
dynamic allocation. The device page pool is the shared memory and pinned
host RAM its backing store: cold pages are DEMOTED to host instead of
destroyed, and the copy stream brings them back a scheduler tick ahead of
use. Three demotion sources, wired in ``runtime/serving.py``:

* idle prefix-cache pages demote before LRU eviction; a radix hit on a
  host-resident node promotes it (H2D) instead of re-prefilling;
* a preempted request swaps out whole (its full and window tables and a
  hybrid stack's recurrent state slots) and resumes by swap-in, with no
  re-prefill;
* window pages that slid out are archived (capped, FIFO).

The names, counters, ``STAT_KEYS`` order, the FIFO cap and the
``can_accept`` refusals are the reference's. What JAX's dispatch order did
for the reference, streams and events do here:

* **D2H (``HostPageStore.put``).** The engine gathers the pages into
  fresh device tensors on the current stream; ``put`` packs the blob's
  leaves into one device byte buffer there (each leaf at a 16-byte
  boundary), so the link sees one copy a blob, not one a layer. The side
  stream waits for the current stream, copies the buffer into one pinned
  host buffer with ``non_blocking=True`` and records an event; the blob's
  leaves on the host are views of that buffer. The packed device buffer
  stays referenced until ``drain`` has seen that event, and is marked
  ``record_stream(side)`` too: otherwise the caching allocator could hand
  its memory to the next prefill while the copy still reads it.
  Gather-then-free is safe only because the gather is enqueued on the
  current stream before any later write to those pages (the next prefill
  or decode writes them on the same stream, after it).
* **``drain``** waits on the pending D2H events, once per decode tick (the
  reference's visibility point, ``serving.py`` ``_step``); with nothing
  pending it returns without touching the device.
* **H2D (``CopyStream.prefetch`` / ``take``).** ``prefetch`` starts one
  ``non_blocking`` copy of the pinned buffer into a device staging buffer
  on the side stream (after the blob's own D2H, which the same stream
  orders) and records an event; the device blob's leaves are views of
  it; ``take`` makes the current stream wait on
  that event before the caller scatters. A ``take`` with no prefetch in
  flight is a demand fetch (``copy_stall_ticks``): the copy goes on the
  current stream, behind the blob's D2H event. The pinned source stays
  referenced until its copy's event has completed.
* The scatter into the pools and state slots happens on the current
  stream, in place, outside any graph, so it is ordered before the next
  replay of the decode, verify or select graph that reads those tensors.

On the CPU (``device="cpu"`` engines) the same objects run without
streams: a blob is the gathered tensors themselves, and every copy is
immediate. ``persist_dir`` checkpoints every swap record through
``repro_torch.checkpoint.ckpt.AsyncCheckpointer`` (the reference's on-disk
format); a failed background save re-raises on the next ``drain()``.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.runtime.trace import NULL_TRACER, Tracer


_ALIGN = 16                    # bytes: every packed leaf starts on one


def _paths(tree, prefix=()):
    """(path, leaf) of a nested dict of tensors, keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _leaves(tree) -> List[torch.Tensor]:
    return [t for _, t in _paths(tree)]


def _tree_nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _pack(tree) -> Tuple[torch.Tensor, list]:
    """The tree's leaves as one uint8 buffer on their device (one ``cat``,
    each leaf padded to ``_ALIGN`` bytes) and its layout, [(path, offset,
    dtype, shape)]."""
    parts, layout, off = [], [], 0
    for path, t in _paths(tree):
        n = t.numel() * t.element_size()
        layout.append((path, off, t.dtype, tuple(t.shape)))
        parts.append(t.contiguous().reshape(-1).view(torch.uint8))
        pad = -n % _ALIGN
        if pad:
            parts.append(torch.zeros(pad, dtype=torch.uint8,
                                     device=t.device))
        off += n + pad
    return torch.cat(parts), layout


def _unpack(flat: torch.Tensor, layout) -> dict:
    """The tree of ``layout``'s leaves as views of the buffer ``flat``."""
    tree: dict = {}
    for path, off, dtype, shape in layout:
        n = dtype.itemsize
        for d in shape:
            n *= d
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = flat[off: off + n].view(dtype).view(shape)
    return tree


class HostPageStore:
    """Handle-addressed store of page blobs (nested dicts of tensors) in
    pinned host RAM.

    ``put`` takes a tree of device tensors (a gather's output), starts its
    D2H copy on the side stream and returns a handle at once; the copy is
    finalized by ``drain()`` (once per decode tick) or the first ``get``,
    whichever comes first. Blobs keep the pools' dtypes (bf16, fp32 and
    int8 round-trip bit for bit)."""

    def __init__(self, *, tracer: Optional[Tracer] = None):
        self.trace = tracer if tracer is not None else NULL_TRACER
        self._next = 0
        self._blobs: Dict[int, Any] = {}       # handle -> host tree
        # handle -> (host tree, D2H event or None, device buffer kept alive)
        self._pending: Dict[int, Tuple[Any, Any, Any]] = {}
        # handle -> (pinned buffer, layout) of a blob from a CUDA device
        self._packed: Dict[int, Tuple[torch.Tensor, list]] = {}
        self._device: Dict[int, torch.device] = {}
        self._side: Dict[torch.device, Any] = {}
        self.put_events = 0
        self.bytes_stored = 0                  # current resident bytes
        self.peak_bytes = 0

    def side_stream(self, device: torch.device):
        """The copy stream of ``device`` (one per CUDA device, made at its
        first use)."""
        if device not in self._side:
            self._side[device] = torch.cuda.Stream(device)
        return self._side[device]

    def put(self, device_tree) -> int:
        handle = self._next
        self._next += 1
        dev = _leaves(device_tree)[0].device
        self._device[handle] = dev
        if dev.type == "cuda":
            flat, layout = _pack(device_tree)      # on the current stream
            side = self.side_stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                host = torch.empty(flat.shape, dtype=torch.uint8,
                                   pin_memory=True)
                host.copy_(flat, non_blocking=True)
                flat.record_stream(side)
                event = torch.cuda.Event()
                event.record(side)
            self._packed[handle] = (host, layout)
            self._pending[handle] = (_unpack(host, layout), event, flat)
        else:
            # a CPU engine's gather is already a fresh host tensor
            self._pending[handle] = (device_tree, None, None)
        self.put_events += 1
        self.bytes_stored += _tree_nbytes(device_tree)
        self.peak_bytes = max(self.peak_bytes, self.bytes_stored)
        return handle

    def _finalize(self, handle: int) -> None:
        host_tree, event, _ = self._pending.pop(handle)
        if event is not None:
            # repro-lint: disable=host-sync — the D2H copy's visibility point
            event.synchronize()
        self._blobs[handle] = host_tree

    def drain(self) -> int:
        """Finalize every pending D2H copy; returns how many were. With
        nothing pending it returns 0 and waits on nothing."""
        n = len(self._pending)
        if not n:
            return 0
        with self.trace.span("d2h_finalize", tid="tier",
                             args={"blobs": n} if self.trace else None):
            for handle in list(self._pending):
                self._finalize(handle)
        return n

    def packed(self, handle: int):
        """(pinned buffer, layout, D2H event or None once finalized) of a
        CUDA blob, without waiting: for copies ordered behind the
        event."""
        host, layout = self._packed[handle]
        entry = self._pending.get(handle)
        return host, layout, entry[1] if entry is not None else None

    def host_tree(self, handle: int):
        """A CPU engine's blob, as it was put."""
        entry = self._pending.get(handle)
        return entry[0] if entry is not None else self._blobs[handle]

    def device_of(self, handle: int) -> torch.device:
        return self._device[handle]

    def get(self, handle: int):
        """The host blob, finalized on demand (a same-tick demote -> use)."""
        if handle in self._pending:
            self._finalize(handle)
        return self._blobs[handle]

    def pop(self, handle: int) -> None:
        entry = self._pending.pop(handle, None)
        tree = entry[0] if entry is not None else self._blobs.pop(handle)
        self._device.pop(handle, None)
        self._packed.pop(handle, None)
        self.bytes_stored -= _tree_nbytes(tree)

    @property
    def pending(self) -> int:
        return len(self._pending)

    def __contains__(self, handle: int) -> bool:
        return handle in self._blobs or handle in self._pending

    def __len__(self) -> int:
        return len(self._blobs) + len(self._pending)


class CopyStream:
    """H2D prefetch over a ``HostPageStore``, keyed by handle.

    ``prefetch(handle)`` starts the blob's copy to its device on the side
    stream; ``take(handle)`` returns the device tree, the current stream
    made to wait for it: the copy in flight when one was started ahead (a
    prefetch hit), else a demand fetch counted as a stall."""

    def __init__(self, store: HostPageStore, *,
                 tracer: Optional[Tracer] = None):
        self.store = store
        self.trace = tracer if tracer is not None else NULL_TRACER
        # handle -> (device tree, H2D event or None, device buffer)
        self._inflight: Dict[int, Tuple[Any, Any, Any]] = {}
        # (event, pinned source): kept until the copy reading it is done
        self._retired: List[Tuple[Any, Any]] = []
        self.prefetch_starts = 0
        self.prefetch_hits = 0
        self.demand_fetches = 0

    def _h2d(self, handle: int, stream):
        """Copy ``handle``'s blob to its device on ``stream`` (behind the
        blob's D2H event), one copy of its pinned buffer. Returns (device
        tree, event after the copy, device buffer)."""
        dev = self.store.device_of(handle)
        if dev.type != "cuda":
            return self.store.host_tree(handle), None, None
        host, layout, d2h = self.store.packed(handle)
        with torch.cuda.stream(stream):
            if d2h is not None:
                stream.wait_event(d2h)
            flat = host.to(dev, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        self._retired.append((event, host))
        return _unpack(flat, layout), event, flat

    def prefetch(self, handle: int) -> None:
        if handle in self._inflight or handle not in self.store:
            return
        dev = self.store.device_of(handle)
        side = self.store.side_stream(dev) if dev.type == "cuda" else None
        self._inflight[handle] = self._h2d(handle, side)
        self.prefetch_starts += 1
        self.trace.instant("h2d_prefetch", tid="tier")

    def take(self, handle: int):
        hit = self._inflight.pop(handle, None)
        if hit is not None:
            self.prefetch_hits += 1
            self.trace.instant("h2d_hit", tid="tier")
            dev_tree, event, flat = hit
            if event is not None:
                cur = torch.cuda.current_stream(
                    self.store.device_of(handle))
                cur.wait_event(event)
                flat.record_stream(cur)   # staged on the side stream
            return dev_tree
        # copy-stream stall: the consumer arrived before any prefetch (the
        # counter view of this span is tier.copy_stall_ticks)
        self.demand_fetches += 1
        with self.trace.span("h2d_demand_fetch", tid="tier"):
            dev = self.store.device_of(handle)
            cur = torch.cuda.current_stream(dev) \
                if dev.type == "cuda" else None
            return self._h2d(handle, cur)[0]

    def cancel(self, handle: int) -> None:
        self._inflight.pop(handle, None)

    def trim(self) -> None:
        """Release the pinned sources whose copies have completed (an
        event query: never waits)."""
        self._retired = [(e, src) for e, src in self._retired
                         if not e.query()]


@dataclasses.dataclass
class SwapRecord:
    """Everything needed to resume a preempted request without re-prefill:
    its decode position and the store handles of its full-attention pages,
    its live window pages (+ their base offset) and its recurrent state."""
    rid: int
    pos: int
    full: Optional[int] = None       # store handle of full-attn page blob
    full_pages: int = 0              # page count
    win: Optional[int] = None        # store handle of window page blob
    win_pages: int = 0
    win_base: int = 0                # logical blocks below the blob
    state: Optional[int] = None      # store handle of state-slot export

    def handles(self) -> List[int]:
        return [h for h in (self.full, self.win, self.state)
                if h is not None]


class HostTier:
    """The engine-facing facade: one page store, one copy stream, the swap
    records, the slid-out window archive, and the telemetry.

    ``max_bytes`` caps the store (None = unbounded): a demotion past the
    cap is refused (``can_accept``) and the caller falls back to the
    destructive path (evict, or preempt for re-prefill), counted.
    ``persist_dir`` also checkpoints every swap record (a failed save
    re-raises on the next ``drain()``)."""

    WIN_ARCHIVE_PAGES = 64           # default cap on archived slid-out pages

    def __init__(self, *, max_bytes: Optional[int] = None,
                 persist_dir: Optional[str] = None,
                 win_archive_pages: Optional[int] = None,
                 tracer: Optional[Tracer] = None):
        self.trace = tracer if tracer is not None else NULL_TRACER
        self.store = HostPageStore(tracer=self.trace)
        self.stream = CopyStream(self.store, tracer=self.trace)
        self.max_bytes = max_bytes
        self._swaps: Dict[int, SwapRecord] = {}
        # rid -> [(base_block, n_pages, handle)]: slid-out window pages,
        # archived for a future hybrid prefix cache (nothing reads them
        # yet; the cap bounds them meanwhile)
        self._win_archive: Dict[int, List[Tuple[int, int, int]]] = {}
        self._win_archive_order: List[Tuple[int, int]] = []  # (rid, handle)
        self.win_archive_pages_cap = (self.WIN_ARCHIVE_PAGES
                                      if win_archive_pages is None
                                      else win_archive_pages)
        self.win_archived_pages = 0      # currently archived
        self.win_archive_drops = 0       # cap evictions
        self.demoted_pages = 0
        self.promoted_pages = 0
        self.cache_demotions = 0         # prefix-cache nodes demoted
        self.cache_promotions = 0        # prefix-cache nodes promoted back
        self.swap_outs = 0
        self.swap_ins = 0
        self.refused_demotions = 0       # cap refusals (fell back)
        self.reprefill_tokens_saved = 0  # tokens resumed without re-prefill
        self._ckpt = None
        self.persist_dir = persist_dir
        if persist_dir is not None:
            from repro_torch.checkpoint.ckpt import AsyncCheckpointer
            self._ckpt = AsyncCheckpointer()

    # -- capacity ---------------------------------------------------------
    def can_accept(self, nbytes: int) -> bool:
        if self.max_bytes is None:
            return True
        if self.store.bytes_stored + nbytes <= self.max_bytes:
            return True
        self.refused_demotions += 1
        return False

    # -- swap records (request-granular) ----------------------------------
    def record_swap(self, rec: SwapRecord) -> None:
        if rec.rid in self._swaps:
            raise ValueError(f"rid {rec.rid} already swapped out")
        self._swaps[rec.rid] = rec
        self.swap_outs += 1
        if self._ckpt is not None:
            blobs = {str(h): self.store.get(h) for h in rec.handles()}
            self._ckpt.save(
                os.path.join(self.persist_dir, f"swap_{rec.rid}"), blobs,
                extra={"rid": rec.rid, "pos": rec.pos,
                       "full_pages": rec.full_pages,
                       "win_pages": rec.win_pages,
                       "win_base": rec.win_base})

    def has_swap(self, rid: int) -> bool:
        return rid in self._swaps

    def swapped_rids(self) -> List[int]:
        return list(self._swaps)

    def peek_swap(self, rid: int) -> SwapRecord:
        return self._swaps[rid]

    def pop_swap(self, rid: int) -> SwapRecord:
        rec = self.drop_swap(rid)
        self.swap_ins += 1
        self.reprefill_tokens_saved += rec.pos
        return rec

    def drop_swap(self, rid: int) -> SwapRecord:
        """Discard a swap record without counting a resume (also the tail
        of ``pop_swap``)."""
        rec = self._swaps.pop(rid)
        for h in rec.handles():
            self.stream.cancel(h)
            self.store.pop(h)
        return rec

    # -- window archive (slid-out pages) ----------------------------------
    def archive_window(self, rid: int, base_block: int, n_pages: int,
                       handle: int) -> None:
        self._win_archive.setdefault(rid, []).append(
            (base_block, n_pages, handle))
        self._win_archive_order.append((rid, handle))
        self.win_archived_pages += n_pages
        while self.win_archived_pages > self.win_archive_pages_cap \
                and self._win_archive_order:
            old_rid, old_h = self._win_archive_order.pop(0)
            entries = self._win_archive.get(old_rid, [])
            for i, (_, n, h) in enumerate(entries):
                if h == old_h:
                    entries.pop(i)
                    self.store.pop(h)
                    self.win_archived_pages -= n
                    self.win_archive_drops += 1
                    break

    # -- per-tick maintenance ---------------------------------------------
    def drain(self) -> int:
        """Finalize pending D2H copies and release finished H2D sources;
        the engine calls this once per decode tick. Re-raises a failed
        persist."""
        if self._ckpt is not None and self._ckpt.last_error is not None:
            self._ckpt.wait()
        self.stream.trim()
        return self.store.drain()

    def reset_counters(self) -> None:
        """Zero the telemetry (after a warm-up, so the timed run reports
        its own rates); store contents, swap records and the window archive
        stay."""
        self.demoted_pages = self.promoted_pages = 0
        self.cache_demotions = self.cache_promotions = 0
        self.swap_outs = self.swap_ins = 0
        self.refused_demotions = 0
        self.reprefill_tokens_saved = 0
        self.win_archive_drops = 0
        self.stream.prefetch_starts = 0
        self.stream.prefetch_hits = 0
        self.stream.demand_fetches = 0
        self.store.put_events = 0
        self.store.peak_bytes = self.store.bytes_stored

    # -- telemetry ---------------------------------------------------------

    #: Every key ``stats()`` returns, in order; the engine's ``tier_stats``
    #: zero-fills them when the tier is off.
    STAT_KEYS = (
        "demoted_pages", "promoted_pages", "cache_demotions",
        "cache_promotions", "swap_outs", "swap_ins", "refused_demotions",
        "reprefill_tokens_saved", "prefetch_starts", "prefetch_hits",
        "copy_stall_ticks", "prefetch_hit_rate", "host_bytes",
        "host_bytes_peak", "win_archived_pages", "win_archive_drops")

    @staticmethod
    def zero_stats() -> Dict[str, float]:
        return {k: 0.0 for k in HostTier.STAT_KEYS}

    def stats(self) -> Dict[str, float]:
        hits, stalls = self.stream.prefetch_hits, self.stream.demand_fetches
        return {
            "demoted_pages": float(self.demoted_pages),
            "promoted_pages": float(self.promoted_pages),
            "cache_demotions": float(self.cache_demotions),
            "cache_promotions": float(self.cache_promotions),
            "swap_outs": float(self.swap_outs),
            "swap_ins": float(self.swap_ins),
            "refused_demotions": float(self.refused_demotions),
            "reprefill_tokens_saved": float(self.reprefill_tokens_saved),
            "prefetch_starts": float(self.stream.prefetch_starts),
            "prefetch_hits": float(hits),
            "copy_stall_ticks": float(stalls),
            "prefetch_hit_rate": hits / (hits + stalls)
            if hits + stalls else 0.0,
            "host_bytes": float(self.store.bytes_stored),
            "host_bytes_peak": float(self.store.peak_bytes),
            "win_archived_pages": float(self.win_archived_pages),
            "win_archive_drops": float(self.win_archive_drops),
        }
