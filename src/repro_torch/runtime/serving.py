"""Paged serving engine: continuous batching over a shared KV page pool.

Counterpart of the core of ``repro.runtime.serving.PagedServingEngine``:

* full-attention KV lives in per-layer page pools addressed through
  per-request block tables (``runtime/kv_cache.PageAllocator``); pages are
  allocated as decode crosses page boundaries and reclaimed on finish;
* prompts are right-padded to power-of-two buckets and prefilled through
  the flash-MHA kernel, then scattered into their pages;
* each decode step runs the whole stack once (the flash-decode kernel walks
  the block tables), keeps position / EOS / budget bookkeeping on the
  device, and copies ONE small tensor (tokens and done flags) to the host;
* on pool exhaustion the youngest live request is preempted and later
  resumes by re-prefilling its prompt plus what it generated.

Greedy decoding only. The prefix cache, speculative decode, sampling,
sliding windows and recurrent state slots, tensor parallelism, the host tier
and the tracer are not ported yet.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import api
from repro_torch.models import transformer as tfm
from repro_torch.runtime.kv_cache import SCRATCH_PAGE, PageAllocator, PoolStats
from repro_torch.runtime.sampling import greedy


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    preemptions: int = 0


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def percentile(xs: List[float], q: float) -> float:
    """Nearest-rank-with-interpolation percentile; 0.0 on empty input."""
    if not xs:
        return 0.0
    s = sorted(xs)
    pos = (len(s) - 1) * q
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


class PagedServingEngine:
    """Continuous batching over a paged KV cache with bucketed prefill.

    ``params`` must already live on ``device`` (``api.init_params`` or
    ``convert.params_from_jax``). ``device`` defaults to CUDA and raises
    when none is present; tests pass ``device="cpu"``, which runs every
    kernel's plain PyTorch version."""

    def __init__(self, cfg, params, *, slots: int = 4, max_len: int = 256,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 eos_id: int = -1, device="cuda"):
        self.device = resolve_device(device)
        tfm.layer_kinds(cfg)                  # raises on unported kinds
        if page_size < 1 or page_size & (page_size - 1):
            raise ValueError(f"page_size must be a power of two, got "
                             f"{page_size}")
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine on {self.device}")
        self.cfg, self.params = cfg, params
        self.page_size = page_size
        self.max_len = -(-max_len // page_size) * page_size
        self.max_blocks = self.max_len // page_size
        self.slots = slots
        self.eos_id = eos_id
        usable = num_pages if num_pages is not None \
            else slots * self.max_blocks
        self.alloc = PageAllocator(usable, page_size)
        # pool row 0 is the scratch page -> usable + 1 physical pages
        self.cache = api.paged_cache_init(cfg, usable + 1, page_size,
                                          device=self.device)

        def dev(n, dtype, cols=None):
            shape = (n,) if cols is None else (n, cols)
            return torch.zeros(shape, dtype=dtype, device=self.device)

        # device-side slot state: one decode step reads and advances it
        # without the host (dead slots hold an all-scratch table)
        self.block_table = dev(slots, torch.int32, self.max_blocks)
        self.pos = dev(slots, torch.int32)
        self.cur_tok = dev(slots, torch.int64, 1)
        self.live_mask = dev(slots, torch.bool)
        self.gen_cnt = dev(slots, torch.int32)
        self.max_new_arr = dev(slots, torch.int32)

        self.live: List[Optional[Request]] = [None] * slots
        self._pos_host = [0] * slots          # mirror of self.pos for live
        self._admit_seq = [0] * slots         # admission order (preemption)
        self._admit_counter = 0

        # telemetry
        self.decode_steps = 0
        self.decoded_tokens = 0
        self.prefills = 0                     # prefill calls, re-prefills too
        self.buckets: set = set()             # distinct prefill lengths
        self.step_wall_s = 0.0                # decode steps, to the host copy
        self.prefill_wall_s = 0.0             # admissions that prefilled
        self._arrival_at: Dict[int, float] = {}
        self.first_token_at: Dict[int, float] = {}
        self._last_token_at: Dict[int, float] = {}
        self._tokens_emitted: Dict[int, int] = {}

    # -- request lifecycle stamps -------------------------------------------

    def note_arrival(self, rid: int) -> None:
        """Stamp a request's arrival (the earliest stamp wins); the
        scheduler calls it at enqueue so TTFT includes queue wait."""
        self._arrival_at.setdefault(rid, time.perf_counter())

    def _note_emitted(self, rid: int) -> None:
        now = time.perf_counter()
        self._arrival_at.setdefault(rid, now)
        self.first_token_at.setdefault(rid, now)
        self._last_token_at[rid] = now
        self._tokens_emitted[rid] = self._tokens_emitted.get(rid, 0) + 1

    # -- admission ------------------------------------------------------------

    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.live):
            if r is None:
                return i
        return None

    def _bucket(self, n: int) -> int:
        return min(max(self.page_size, _next_pow2(n)), self.max_len)

    def submit(self, req: Request) -> bool:
        """Prefill ``req`` into a free slot. False if out of slots or pages
        (admission rejection — never touches a live neighbor's pages). A
        request that can never be served (prompt too long for max_len, no
        generation budget left, more pages than the pool has) is dropped as
        done with what it has."""
        self.note_arrival(req.rid)
        slot = self._free_slot()
        if slot is None:
            return False
        toks = list(req.prompt) + list(req.generated)   # resume-on-preempt
        L = len(toks)
        remaining = req.max_new - len(req.generated)
        worst = min(L + remaining, self.max_len)
        if (L >= self.max_len - 1 or remaining <= 0
                or self.alloc.pages_for(worst) > self.alloc.num_pages):
            req.done = True
            return True
        t0 = time.perf_counter()
        table = self.alloc.allocate(req.rid, L)
        if table is None:
            return False                      # pool full: reject admission

        bucket = self._bucket(L)
        nb = bucket // self.page_size
        pages = np.full((nb,), SCRATCH_PAGE, np.int64)
        pages[: len(table)] = table
        tok_arr = np.zeros((1, bucket), np.int64)
        tok_arr[0, :L] = toks
        dev = self.device
        logits, kv, _ = api.prefill(
            self.cfg, self.params, torch.from_numpy(tok_arr).to(dev),
            length=torch.full((1,), L, dtype=torch.int32, device=dev))
        # scatter the prompt's kv blocks into this request's pages (bucket
        # padding past the allocation lands on the scratch page)
        pages_d = torch.from_numpy(pages).to(dev)
        for pool, e in zip(self.cache, kv):
            for name in ("k", "v"):
                pool[name][pages_d] = e[name][0].reshape(
                    (nb, self.page_size) + pool[name].shape[2:])
        tok = greedy(logits, self.cfg.vocab)[0]
        row = np.zeros((self.max_blocks,), np.int32)
        row[: len(table)] = table
        self.block_table[slot] = torch.from_numpy(row).to(dev)
        self.pos[slot] = L
        self.cur_tok[slot, 0] = tok
        self.live_mask[slot] = True
        self.gen_cnt[slot] = 1
        self.max_new_arr[slot] = remaining
        # repro-lint: disable=host-sync — admission reads its first token
        t = int(tok.item())
        self.prefill_wall_s += time.perf_counter() - t0
        self.prefills += 1
        self.buckets.add(bucket)

        self.live[slot] = req
        self._pos_host[slot] = L
        self._admit_counter += 1
        self._admit_seq[slot] = self._admit_counter
        req.generated.append(t)
        self._note_emitted(req.rid)
        if t == self.eos_id or len(req.generated) >= req.max_new:
            self._finish_slot(slot)
        return True

    def _release_slot(self, slot: int) -> Request:
        """Reclaim a slot's pages; its table becomes all-scratch so a dead
        slot can only ever write to the scratch page, and its position 0 so
        the decode kernel walks one scratch page for it, not its old
        length."""
        req = self.live[slot]
        self.live[slot] = None
        self.alloc.free_request(req.rid)
        self.block_table[slot] = SCRATCH_PAGE
        self.pos[slot] = 0
        self.live_mask[slot] = False
        return req

    def _finish_slot(self, slot: int) -> None:
        self._release_slot(slot).done = True

    def _evict_slot(self, slot: int) -> Request:
        """Preempt: reclaim pages, return the request for re-admission (it
        resumes by re-prefilling prompt + generated-so-far)."""
        req = self._release_slot(slot)
        req.preemptions += 1
        return req

    def _reclaim_one_page(self, keep_slot: int,
                          preempted: List[Request]) -> bool:
        """Preempt the youngest live request other than ``keep_slot``; False
        if there is none."""
        victims = [s for s, r in enumerate(self.live)
                   if r is not None and s != keep_slot]
        if not victims:
            return False
        youngest = max(victims, key=lambda s: self._admit_seq[s])
        preempted.append(self._evict_slot(youngest))
        return True

    def ensure_decode_capacity(self) -> List[Request]:
        """Allocate the page each live request's next token is written
        into, oldest request first; on pool exhaustion preempt the youngest
        until the rest fit. Returns the preempted requests (resubmit them to
        resume)."""
        preempted: List[Request] = []
        for slot in sorted((s for s, r in enumerate(self.live)
                            if r is not None),
                           key=lambda s: self._admit_seq[s]):
            req = self.live[slot]
            if req is None:                   # preempted by an older slot
                continue
            target = min(self._pos_host[slot] + 1, self.max_len)
            while True:
                got = self.alloc.extend_to(req.rid, target)
                if got is None:
                    if not self._reclaim_one_page(slot, preempted):
                        raise RuntimeError(
                            "page pool too small for a single request")
                    continue
                if got:                       # fresh page: publish it
                    self.block_table[slot, (target - 1)
                                     // self.page_size] = got
                break
        return preempted

    # -- decode ---------------------------------------------------------------

    def step(self) -> List[Request]:
        """Advance every live slot one token: one pass through the stack,
        one device->host copy. Tops up pages first and returns the requests
        that top-up preempted, for the caller to resubmit."""
        if not self.has_live():
            return []
        evicted = self.ensure_decode_capacity()
        t0 = time.perf_counter()
        logits, _ = api.decode_step(self.cfg, self.params, self.cache,
                                    self.cur_tok, self.pos,
                                    block_table=self.block_table)
        toks = greedy(logits, self.cfg.vocab)
        live = self.live_mask
        livei = live.to(torch.int32)
        pos2 = self.pos + livei
        gen2 = self.gen_cnt + livei
        done = live & ((toks == self.eos_id) | (gen2 >= self.max_new_arr)
                       | (pos2 >= self.max_len - 1))
        self.live_mask = live & ~done
        self.cur_tok = torch.where(live[:, None], toks[:, None], self.cur_tok)
        self.pos, self.gen_cnt = pos2, gen2
        # repro-lint: disable=host-sync — THE one device->host copy per step
        host = torch.stack([toks, done.to(torch.int64)]).cpu().numpy()
        self.step_wall_s += time.perf_counter() - t0
        self.decode_steps += 1
        for i, r in enumerate(self.live):
            if r is None:
                continue
            r.generated.append(int(host[0, i]))
            self._pos_host[i] += 1
            self.decoded_tokens += 1
            self._note_emitted(r.rid)
            if host[1, i]:
                self._finish_slot(i)
        return evicted

    # -- queries --------------------------------------------------------------

    def has_live(self) -> bool:
        return any(r is not None for r in self.live)

    def pool_stats(self) -> PoolStats:
        return PoolStats.of(self.alloc, self.slots, self.max_len)

    def metrics(self) -> Dict[str, float]:
        """Throughput counters, latency percentiles (seconds) and wall-clock
        split of the run so far."""
        ttfts = [t - self._arrival_at[rid]
                 for rid, t in self.first_token_at.items()]
        tpots = [(self._last_token_at[rid] - self.first_token_at[rid])
                 / (n - 1) for rid, n in self._tokens_emitted.items()
                 if n > 1]
        return {
            "engine.decode_steps": float(self.decode_steps),
            "engine.decoded_tokens": float(self.decoded_tokens),
            "engine.prefills": float(self.prefills),
            "engine.prefill_buckets": float(len(self.buckets)),
            "latency.requests": float(len(ttfts)),
            "latency.ttft_p50_s": percentile(ttfts, 0.50),
            "latency.ttft_p95_s": percentile(ttfts, 0.95),
            "latency.tpot_p50_s": percentile(tpots, 0.50),
            "latency.tpot_p95_s": percentile(tpots, 0.95),
            "util.step_wall_s": self.step_wall_s,
            "util.prefill_wall_s": self.prefill_wall_s,
        }

    def run_to_completion(self, requests: List[Request],
                          max_steps: int = 10_000) -> List[Request]:
        """Drive ``requests`` through a Scheduler until all finish (raises
        SchedulerExhausted if ``max_steps`` ticks are not enough)."""
        from repro_torch.runtime.scheduler import Scheduler
        sched = Scheduler(self)
        for r in requests:
            sched.add(r)
        sched.drain(max_steps=max_steps)
        return [r for r in requests if r.done]
