"""Draft-token proposers for speculative decoding.

Counterpart of ``repro.runtime.drafter``. Two proposers share one interface
(``propose(rid, ctx, k)`` -> up to k token ids, ``drop(rid)`` when a request
finishes or is preempted, ``kind`` and ``stats()`` for telemetry), both
deterministic, so the verify step's acceptance ``u < p(draft)`` is the full
rejection-sampling rule (``runtime/sampling.py``):

* ``ngram_propose`` / ``NgramDrafter`` — prompt lookup: the longest suffix
  n-gram of the context that occurred earlier (the most recent occurrence
  wins) proposes the tokens that followed it. Host-side, stateless; a copy
  of the reference's.
* ``DraftModelDrafter`` — a second model greedy-decodes k draft tokens,
  kept in step with each request's context through its own paged KV cache
  (its own ``PageAllocator`` and page pools, apart from the engine's): per
  call it truncates to the longest common prefix of its cached tokens and
  the context (rejected drafts roll back, accepted ones are cached
  already), ingests the rest in blocks padded to a power of two (at most
  ``max_ingest``), then drafts one token at a time. Its ``decode_step``
  runs eagerly through the paged kernel (or the gather baseline, its
  default, as the reference's). It degrades to no draft when its pool
  cannot hold the context.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import api
from repro_torch.models import transformer as tfm
from repro_torch.runtime.kv_cache import SCRATCH_PAGE, PageAllocator


def ngram_propose(ctx: Sequence[int], k: int, *,
                  max_ngram: int = 3) -> List[int]:
    """Up to ``k`` draft tokens continuing ``ctx`` by prompt lookup: match
    the longest suffix n-gram (``max_ngram`` down to 1) against the rest of
    the context and return the tokens that followed its most recent
    earlier occurrence. Empty list = no match."""
    n_ctx = len(ctx)
    if k <= 0 or n_ctx < 2:
        return []
    ctx = list(ctx)
    for n in range(min(max_ngram, n_ctx - 1), 0, -1):
        suffix = ctx[n_ctx - n:]
        for start in range(n_ctx - n - 1, -1, -1):
            if ctx[start:start + n] == suffix:
                cont = ctx[start + n:start + n + k]
                if cont:
                    return cont
    return []


class NgramDrafter:
    """The prompt-lookup proposer behind the drafter interface (stateless:
    ``drop`` does nothing)."""

    kind = "ngram"

    def __init__(self, max_ngram: int = 3):
        self.max_ngram = max_ngram

    def propose(self, rid: int, ctx: Sequence[int], k: int) -> List[int]:
        return ngram_propose(ctx, k, max_ngram=self.max_ngram)

    def drop(self, rid: int) -> None:
        pass

    def stats(self) -> Dict[str, float]:
        return {}


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class DraftModelDrafter:
    """Greedy draft model over a private paged cache (see the module
    docstring). ``params`` live on ``device`` (CUDA by default; raises
    without it unless ``device="cpu"``). Needs a config the port serves
    (attention-only)."""

    kind = "model"

    def __init__(self, cfg, params, *, page_size: int = 16,
                 num_pages: int = 128, max_len: int = 512,
                 max_ingest: int = 32, attn_impl: str = "gather",
                 device="cuda"):
        kinds = set(tfm.layer_kinds(cfg))     # raises on unported kinds
        if not kinds <= set(tfm.PAGEABLE_KINDS):
            raise ValueError(
                f"draft-model drafter needs an attention-only decoder "
                f"(kinds within {sorted(tfm.PAGEABLE_KINDS)}); {cfg.name!r} "
                f"has {sorted(kinds)}: windowed and recurrent draft models "
                f"would need their own window tables or state slots; use "
                f"the n-gram drafter for those stacks")
        if page_size < 1 or page_size & (page_size - 1):
            raise ValueError(f"page_size must be a power of two, got "
                             f"{page_size}")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"drafter on {self.device}")
        self.cfg = dataclasses.replace(cfg, paged_attn_impl=attn_impl)
        self.params = params
        self.page_size = page_size
        self.max_len = -(-max_len // page_size) * page_size
        self.max_blocks = self.max_len // page_size
        self.max_ingest = max(1, _next_pow2(max_ingest))
        self.alloc = PageAllocator(num_pages, page_size)
        # pool row 0 is the scratch page (padding rows land there)
        self.cache = api.paged_cache_init(self.cfg, num_pages + 1, page_size,
                                          device=self.device)
        self._tables: Dict[int, torch.Tensor] = {}  # rid -> (1, blocks) row
        self._toks: Dict[int, List[int]] = {}       # rid -> tokens in cache
        self._ntok: Dict[int, int] = {}             # rid -> allocator tokens
        self.proposed = 0
        self.ingested_tokens = 0
        self.decode_calls = 0
        self.pool_rejects = 0

    # -- paged-cache bookkeeping ------------------------------------------

    def _sync_row(self, rid: int) -> None:
        """Rebuild rid's device table row from the allocator: its pages in
        block order, scratch past them (an ingest block's padding rows can
        only write scratch)."""
        row = np.full((1, self.max_blocks), SCRATCH_PAGE, np.int32)
        t = self.alloc.block_table(rid)
        row[0, : len(t)] = t
        self._tables[rid] = torch.from_numpy(row).to(self.device)

    def _drop_table(self, rid: int) -> None:
        if rid in self._tables:
            self.alloc.free_request(rid)
            del self._tables[rid]
        self._toks.pop(rid, None)
        self._ntok.pop(rid, None)

    def _evict_others(self, keep: int) -> bool:
        dropped = False
        for other in list(self._tables):
            if other != keep:
                self._drop_table(other)
                dropped = True
        return dropped

    def _ensure(self, rid: int, n_tokens: int) -> bool:
        """Cover ``n_tokens`` of rid's context with pages, evicting other
        requests' draft caches under pressure (they re-ingest later).
        False = the pool cannot hold it even alone."""
        page = self.page_size
        if rid not in self._tables:
            got = self.alloc.allocate(rid, n_tokens)
            if got is None:
                if not self._evict_others(rid):
                    return False
                got = self.alloc.allocate(rid, n_tokens)
                if got is None:
                    return False
            self._ntok[rid] = n_tokens
            self._sync_row(rid)
            return True
        # advance through extend_to (one page a call) even when the pages
        # cover the target: it keeps the allocator's token count current
        # for a later truncate_to
        while self._ntok[rid] < n_tokens:
            step = min(n_tokens, self._ntok[rid] + page)
            got = self.alloc.extend_to(rid, step)
            if got is None:
                if not self._evict_others(rid):
                    return False
                continue
            self._ntok[rid] = step
            if got:
                self._sync_row(rid)
        return True

    # -- the drafter interface --------------------------------------------

    def _run(self, rid: int, block: np.ndarray, pos: int) -> np.ndarray:
        """One eager decode_step of a (1, T) block at ``pos``; the greedy
        token of each row, on the host."""
        dev = self.device
        logits, _ = api.decode_step(
            self.cfg, self.params, self.cache,
            torch.from_numpy(block).to(dev),
            torch.full((1,), pos, dtype=torch.int32, device=dev),
            block_table=self._tables[rid])
        self.decode_calls += 1
        out = torch.argmax(logits[..., : self.cfg.vocab], -1)
        # repro-lint: disable=host-sync — host-side drafting by design
        return out.cpu().numpy().reshape(-1)

    def propose(self, rid: int, ctx: Sequence[int], k: int) -> List[int]:
        if k <= 0 or not ctx:
            return []
        ctx = list(ctx)
        L = len(ctx)
        if L + k >= self.max_len:
            return []                 # out of drafter context: degrade
        prev = self._toks.get(rid, [])
        common = 0
        for a, b in zip(prev, ctx):
            if a != b:
                break
            common += 1
        # keep at least the last context token un-ingested: its row's
        # logits seed the first draft
        have = min(common, L - 1)
        if prev:
            if have == 0:
                self._drop_table(rid)
            elif have < len(prev):
                # rejected drafts roll back: disown whole pages past the
                # keep point; stale rows in kept pages are overwritten by
                # the re-ingest before any query reads them
                self.alloc.truncate_to(rid, have)
                self._ntok[rid] = have
                self._sync_row(rid)

        pending = ctx[have:]
        pos = have
        last_tok: Optional[int] = None
        while pending:
            real = min(len(pending), self.max_ingest)
            T = _next_pow2(real)
            if not self._ensure(rid, pos + real):
                self.pool_rejects += 1
                self._drop_table(rid)
                return []
            block = np.zeros((1, T), np.int64)
            block[0, :real] = pending[:real]
            out = self._run(rid, block, pos)
            pos += real
            pending = pending[real:]
            self.ingested_tokens += real
            if not pending:
                last_tok = int(out[real - 1])
        drafts = [last_tok]
        # greedy drafting; each draft's KV is cached, so an accepted draft
        # is ingested already at the next call
        while len(drafts) < k:
            if not self._ensure(rid, pos + 1):
                self.pool_rejects += 1
                break
            out = self._run(rid, np.asarray([[drafts[-1]]], np.int64), pos)
            pos += 1
            self.ingested_tokens += 1
            drafts.append(int(out[-1]))
        self._toks[rid] = ctx + drafts[:-1]
        self.proposed += len(drafts)
        return drafts

    def drop(self, rid: int) -> None:
        """The request finished or was preempted: free its draft pages."""
        self._drop_table(rid)

    def stats(self) -> Dict[str, float]:
        return {
            "draft_proposed": float(self.proposed),
            "draft_ingested_tokens": float(self.ingested_tokens),
            "draft_decode_calls": float(self.decode_calls),
            "draft_pool_rejects": float(self.pool_rejects),
        }
