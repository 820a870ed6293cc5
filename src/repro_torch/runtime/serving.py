"""Paged serving engine: continuous batching over a shared KV page pool.

Counterpart of the core of ``repro.runtime.serving``:

* ``ServingMetricsMixin``, the reference's metrics surface: request
  lifecycle stamps (arrival at enqueue, first and last token), the timed
  and traced ``submit``/``step`` wrappers, and one flat ``metrics()``
  snapshot whose key set is the reference engine's, key for key;
* full-attention KV lives in per-layer page pools addressed through
  per-request block tables (``runtime/kv_cache.PageAllocator``); pages are
  allocated as decode crosses page boundaries and reclaimed on finish;
* prompts are right-padded to power-of-two buckets and prefilled through
  the flash-MHA kernel, then scattered into their pages;
* each decode step is one device program: the step body (the whole stack
  with the flash-decode kernel walking the block tables, the greedy pick,
  the position / EOS / budget bookkeeping) reads and writes only tensors
  allocated once by the constructor. On CUDA the first ``step()`` captures
  it as a CUDA graph and every step replays it (the reference's
  ``jax.jit`` step); on the CPU the body runs as it is. One small tensor
  (tokens and done flags) comes back to the host per step;
* on pool exhaustion the youngest live request is preempted and later
  resumes by re-prefilling its prompt plus what it generated;
* ``attn_impl="gather"`` swaps the flash-decode kernel for the reference's
  measured baseline: a dense ``pool[block_table]`` gather and a plain
  online-softmax attention (``layers.attend_decode``), inside the same
  step body.

Greedy decoding only. The prefix cache, speculative decode, sampling,
sliding windows and recurrent state slots, tensor parallelism and the host
tier are not ported yet: their ``metrics()`` keys read as the reference's
do with those subsystems switched off (zeros, ``"none"``, ``""``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import api
from repro_torch.models import transformer as tfm
from repro_torch.runtime.kv_cache import SCRATCH_PAGE, PageAllocator, PoolStats
from repro_torch.runtime.sampling import greedy
from repro_torch.runtime.trace import Tracer, default_tracer, percentile

ATTN_IMPLS = ("kernel", "gather")
# the reference's PrefixCache.STAT_KEYS and HostTier.STAT_KEYS: reported as
# zeros until those subsystems are ported
PREFIX_STAT_KEYS = (
    "lookups", "hits", "hit_rate", "hit_tokens", "shared_token_frac",
    "full_page_hits", "partial_hits", "inserted_pages", "evicted_pages",
    "cached_pages", "host_nodes")
TIER_STAT_KEYS = (
    "demoted_pages", "promoted_pages", "cache_demotions", "cache_promotions",
    "swap_outs", "swap_ins", "refused_demotions", "reprefill_tokens_saved",
    "prefetch_starts", "prefetch_hits", "copy_stall_ticks",
    "prefetch_hit_rate", "host_bytes", "host_bytes_peak",
    "win_archived_pages", "win_archive_drops")


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


class ServingMetricsMixin:
    """The reference's observability layer (``repro.runtime.serving.
    ServingMetricsMixin``): lifecycle stamps, the timed ``submit``/``step``
    wrappers around the engine's ``_submit``/``_step``, the wall-clock
    accumulators and the ``metrics()`` snapshot.

    * ``step_wall_s``: decode steps from dispatch to the host copy;
    * ``tick_wall_s``: whole decode ticks (only ticks with live slots);
    * ``prefill_wall_s``: successful admissions;
    * ``util.temporal`` = step_wall_s / tick_wall_s: the share of each
      decode tick spent in the device program and its one host sync.

    TTFT is arrival -> first token, arrival being the earliest of
    ``Scheduler.add`` (queue wait included) and the first ``submit``. TPOT
    is (last - first) / (tokens - 1) per request with two tokens or more.
    """

    def _init_metrics(self, tracer: Optional[Tracer]) -> None:
        """Install the tracer (the process default when None: see
        ``trace.set_default_tracer``) and zero the mixin's counters."""
        self.trace = tracer if tracer is not None else default_tracer()
        self.decode_steps = 0
        self.decoded_tokens = 0
        self.step_wall_s = 0.0
        self.tick_wall_s = 0.0
        self.prefill_wall_s = 0.0
        self.first_token_at: Dict[int, float] = {}
        self._arrival_at: Dict[int, float] = {}
        self._last_token_at: Dict[int, float] = {}
        self._tokens_emitted: Dict[int, int] = {}

    # -- request lifecycle -------------------------------------------------

    def note_arrival(self, rid: int) -> None:
        """Stamp a request's arrival (the earliest stamp wins);
        ``Scheduler.add`` calls it at enqueue so TTFT includes queue
        wait."""
        if rid not in self._arrival_at:
            self._arrival_at[rid] = time.perf_counter()
            self.trace.begin_async("request", rid)

    def _note_emitted(self, rid: int, n: int = 1) -> None:
        now = time.perf_counter()
        if rid not in self.first_token_at:
            self._arrival_at.setdefault(rid, now)
            self.first_token_at[rid] = now
            if self.trace:
                self.trace.instant("first_token", args={"rid": rid})
        self._last_token_at[rid] = now
        self._tokens_emitted[rid] = self._tokens_emitted.get(rid, 0) + n

    def _note_finished(self, rid: int) -> None:
        self.trace.end_async("request", rid)

    # -- timed wrappers ----------------------------------------------------

    def submit(self, req: Request) -> bool:
        """Admit ``req`` (see ``_submit``), timed and traced."""
        self.note_arrival(req.rid)
        tr = self.trace
        t0 = time.perf_counter()
        with tr.span("admit", args={"rid": req.rid} if tr else None):
            ok = self._submit(req)
        if ok:
            self.prefill_wall_s += time.perf_counter() - t0
        return ok

    def step(self) -> List[Request]:
        """Advance every live slot (see ``_step``), timed and traced. A
        tick with no live slot runs untimed."""
        if not self.has_live():
            return self._step()
        t0 = time.perf_counter()
        with self.trace.span("decode_tick"):
            out = self._step()
        self.tick_wall_s += time.perf_counter() - t0
        return out

    # -- the snapshot --------------------------------------------------------

    def _latency_samples(self):
        ttfts = [t - self._arrival_at[rid]
                 for rid, t in self.first_token_at.items()
                 if rid in self._arrival_at]
        tpots = [(self._last_token_at[rid] - self.first_token_at[rid])
                 / (n - 1) for rid, n in self._tokens_emitted.items()
                 if n > 1 and rid in self.first_token_at]
        return ttfts, tpots

    def metrics(self) -> Dict[str, object]:
        """One flat snapshot under the reference's keys: ``engine.*``,
        ``latency.*`` (seconds), ``util.*``, and each subsystem's stats
        under ``pool.*`` / ``spec.*`` / ``prefix.*`` / ``tier.*`` /
        ``shard.*`` / ``sampling.*``."""
        ttfts, tpots = self._latency_samples()
        tick = self.tick_wall_s
        m: Dict[str, object] = {
            "engine.kind": type(self).__name__,
            "engine.decode_steps": float(self.decode_steps),
            "engine.decoded_tokens": float(self.decoded_tokens),
            "engine.prefill_traces": float(self.prefill_traces),
            "latency.requests": float(len(ttfts)),
            "latency.ttft_p50_s": percentile(ttfts, 0.50),
            "latency.ttft_p95_s": percentile(ttfts, 0.95),
            "latency.ttft_mean_s": (sum(ttfts) / len(ttfts)
                                    if ttfts else 0.0),
            "latency.tpot_p50_s": percentile(tpots, 0.50),
            "latency.tpot_p95_s": percentile(tpots, 0.95),
            "latency.tpot_mean_s": (sum(tpots) / len(tpots)
                                    if tpots else 0.0),
            "util.step_wall_s": self.step_wall_s,
            "util.tick_wall_s": tick,
            "util.prefill_wall_s": self.prefill_wall_s,
            "util.temporal": self.step_wall_s / tick if tick > 0 else 0.0,
        }
        for ns, stats in (
                ("pool", dataclasses.asdict(self.pool_stats())),
                ("spec", self.spec_stats()),
                ("prefix", self.prefix_stats()),
                ("tier", self.tier_stats()),
                ("shard", self.shard_stats()),
                ("sampling", self.sampling_stats())):
            for k, v in stats.items():
                m[f"{ns}.{k}"] = float(v) if isinstance(v, int) else v
        return m

    def reset_metrics(self) -> None:
        """The single reset point between a warm-up and a timed run: zero
        the latency and wall-clock counters, then the engine's own
        (``_reset_subsystem_counters``). Trace events stay (a
        ``reset_metrics`` instant marks the boundary), and so do lifetime
        facts: ``prefill_traces`` and ``step_traces``."""
        self.decode_steps = 0
        self.decoded_tokens = 0
        self.step_wall_s = 0.0
        self.tick_wall_s = 0.0
        self.prefill_wall_s = 0.0
        self.first_token_at.clear()
        self._arrival_at.clear()
        self._last_token_at.clear()
        self._tokens_emitted.clear()
        self.trace.instant("reset_metrics")
        self._reset_subsystem_counters()

    def _reset_subsystem_counters(self) -> None:
        pass


class PagedServingEngine(ServingMetricsMixin):
    """Continuous batching over a paged KV cache with bucketed prefill.

    ``params`` must already live on ``device`` (``api.init_params`` or
    ``convert.params_from_jax``). ``device`` defaults to CUDA and raises
    when none is present; tests pass ``device="cpu"``, which runs every
    kernel's plain PyTorch version. ``attn_impl`` picks paged decode
    attention: ``"kernel"`` (flash-decode through the block tables) or
    ``"gather"`` (the reference's dense-gather baseline)."""

    def __init__(self, cfg, params, *, slots: int = 4, max_len: int = 256,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 eos_id: int = -1, attn_impl: str = "kernel",
                 tracer: Optional[Tracer] = None, device="cuda"):
        self.device = resolve_device(device)
        tfm.layer_kinds(cfg)                  # raises on unported kinds
        if page_size < 1 or page_size & (page_size - 1):
            raise ValueError(f"page_size must be a power of two, got "
                             f"{page_size}")
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be kernel|gather: {attn_impl}")
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine on {self.device}")
        # the impl rides on the config to layers.attention_decode, as in
        # the reference
        self.cfg = dataclasses.replace(cfg, paged_attn_impl=attn_impl)
        self.attn_impl = attn_impl
        self.params = params
        self.page_size = page_size
        self.max_len = -(-max_len // page_size) * page_size
        self.max_blocks = self.max_len // page_size
        self.slots = slots
        self.eos_id = eos_id
        self._init_metrics(tracer)
        usable = num_pages if num_pages is not None \
            else slots * self.max_blocks
        self.alloc = PageAllocator(usable, page_size)
        # pool row 0 is the scratch page -> usable + 1 physical pages
        self.cache = api.paged_cache_init(self.cfg, usable + 1, page_size,
                                          device=self.device)

        def dev(n, dtype, cols=None):
            shape = (n,) if cols is None else (n, cols)
            return torch.zeros(shape, dtype=dtype, device=self.device)

        # device-side slot state, allocated once: the step body reads and
        # advances it in place (a captured graph holds these addresses) and
        # the host writes it in place between steps, on the same stream.
        # Dead slots hold an all-scratch table at position 0.
        self.block_table = dev(slots, torch.int32, self.max_blocks)
        self.pos = dev(slots, torch.int32)
        self.cur_tok = dev(slots, torch.int64, 1)
        self.live_mask = dev(slots, torch.bool)
        self.gen_cnt = dev(slots, torch.int32)
        self.max_new_arr = dev(slots, torch.int32)
        self._step_out = dev(2, torch.int64, slots)   # tokens, done flags
        self.last_logits: Optional[torch.Tensor] = None

        self.live: List[Optional[Request]] = [None] * slots
        self._pos_host = [0] * slots          # mirror of self.pos for live
        self._admit_seq = [0] * slots         # admission order (preemption)
        self._admit_counter = 0

        # telemetry beyond the mixin's
        self.prefills = 0                     # prefill calls, re-prefills too
        self.prefill_traces = 0               # distinct prefill buckets
        self._seen_buckets: set = set()
        self.prompt_tokens = 0
        self.prefilled_tokens = 0
        self.greedy_requests = 0
        self.greedy_tokens = 0
        self.step_traces = 0                  # captures of the decode graph
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._graph_launches: Dict[str, int] = {}

    # -- admission ------------------------------------------------------------

    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.live):
            if r is None:
                return i
        return None

    def _bucket(self, n: int) -> int:
        return min(max(self.page_size, _next_pow2(n)), self.max_len)

    def _submit(self, req: Request) -> bool:
        """Prefill ``req`` into a free slot. False if out of slots or pages
        (admission rejection — never touches a live neighbor's pages). A
        request that can never be served (prompt too long for max_len, no
        generation budget left, more pages than the pool has) is dropped as
        done with what it has."""
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
            self._note_finished(req.rid)
            return True
        table = self.alloc.allocate(req.rid, L)
        if table is None:
            return False                      # pool full: reject admission

        bucket = self._bucket(L)
        nb = bucket // self.page_size
        pages = np.full((nb,), SCRATCH_PAGE, np.int64)
        pages[: len(table)] = table
        tok_arr = np.zeros((1, bucket), np.int64)
        tok_arr[0, :L] = toks
        row = np.zeros((self.max_blocks,), np.int32)
        row[: len(table)] = table
        if bucket not in self._seen_buckets:
            self._seen_buckets.add(bucket)
            self.prefill_traces += 1
        dev = self.device
        tr = self.trace
        with tr.span("prefill_dispatch",
                     args={"bucket": bucket} if tr else None):
            logits, kv, _ = api.prefill(
                self.cfg, self.params, torch.from_numpy(tok_arr).to(dev),
                length=torch.full((1,), L, dtype=torch.int32, device=dev))
            # scatter the prompt's kv blocks into this request's pages
            # (bucket padding past the allocation lands on the scratch page)
            pages_d = torch.from_numpy(pages).to(dev)
            for pool, e in zip(self.cache, kv):
                for name in ("k", "v"):
                    pool[name][pages_d] = e[name][0].reshape(
                        (nb, self.page_size) + pool[name].shape[2:])
            tok = greedy(logits, self.cfg.vocab)[0]
            self.block_table[slot] = torch.from_numpy(row).to(dev)
            self.pos[slot] = L
            self.cur_tok[slot, 0] = tok
            self.live_mask[slot] = True
            self.gen_cnt[slot] = 1
            self.max_new_arr[slot] = remaining
        # repro-lint: disable=host-sync — admission reads its first token
        t = int(tok.item())
        self.prefills += 1
        self.prefilled_tokens += L
        self.prompt_tokens += L

        self.live[slot] = req
        self._pos_host[slot] = L
        self._admit_counter += 1
        self._admit_seq[slot] = self._admit_counter
        if req.rid not in self.first_token_at:
            self.greedy_requests += 1
        req.generated.append(t)
        self.greedy_tokens += 1
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
        req = self._release_slot(slot)
        req.done = True
        self._note_finished(req.rid)

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
        self.trace.instant("preempt")
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

    def _step_body(self) -> None:
        """One decode step on the device, the counterpart of the reference's
        traced step: the stack over every slot, the greedy pick, and the
        position / budget / EOS bookkeeping. It reads and writes only
        tensors the constructor allocated (slot state, block tables, pools,
        ``_step_out``), in place, so a CUDA graph of it stays valid for the
        engine's life; dead slots advance nothing and write only the
        scratch page. ``last_logits`` is the step's (slots, Vp) logits (on
        the card, the graph's output buffer)."""
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
        cur2 = torch.where(live[:, None], toks[:, None], self.cur_tok)
        self.live_mask.copy_(live & ~done)
        self.cur_tok.copy_(cur2)
        self.pos.copy_(pos2)
        self.gen_cnt.copy_(gen2)
        self._step_out[0].copy_(toks)
        self._step_out[1].copy_(done)
        self.last_logits = logits

    def _capture(self) -> None:
        """Record ``_step_body`` as a CUDA graph. A warm-up run first, on a
        side stream: it builds the kernels and raises their shared-memory
        limits (neither may happen inside a capture) and lets cuBLAS pick
        its kernels. The warm-up must not advance the engine, so the slot
        state is snapshotted before it and restored after; its pool writes
        land where the first replay writes the same values. The capture
        launches nothing, so the wrappers' counters are set back to their
        values before the warm-up, and the launches the graph holds are
        added on each replay instead. Any failure raises: there is no eager
        fallback."""
        state = (self.cur_tok, self.pos, self.gen_cnt, self.live_mask,
                 self._step_out)
        saved = [t.clone() for t in state]
        before = ops.launch_counts()
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self._step_body()
        main.wait_stream(side)
        for t, s in zip(state, saved):
            t.copy_(s)
        warm = ops.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._step_body()
        held = {k: n - warm[k] for k, n in ops.launch_counts().items()}
        ops.add_launch_counts({k: before[k] - n
                               for k, n in ops.launch_counts().items()})
        self._graph = graph
        self._graph_launches = {k: n for k, n in held.items() if n}
        self.step_traces += 1

    def _dispatch(self) -> None:
        """Enqueue one step body: a replay of the captured graph on CUDA
        (captured at the first call), the body itself on the CPU."""
        if self.device.type != "cuda":
            self._step_body()
            return
        if self._graph is None:
            self._capture()
        self._graph.replay()
        ops.add_launch_counts(self._graph_launches)

    def _step(self) -> List[Request]:
        """Advance every live slot one token: one device program, one
        device->host copy. Tops up pages first and returns the requests
        that top-up preempted, for the caller to resubmit. (Callers use
        ``step()``, the mixin's timed wrapper.)"""
        if not self.has_live():
            return []
        tr = self.trace
        with tr.span("ensure_capacity"):
            evicted = self.ensure_decode_capacity()
        t0 = time.perf_counter()
        with tr.span("device_dispatch"):
            self._dispatch()
        with tr.span("host_sync"):
            # repro-lint: disable=host-sync — THE one device->host copy
            host = self._step_out.cpu().numpy()
        self.step_wall_s += time.perf_counter() - t0
        self.decode_steps += 1
        for i, r in enumerate(self.live):
            if r is None:
                continue
            r.generated.append(int(host[0, i]))
            self._pos_host[i] += 1
            self.decoded_tokens += 1
            self.greedy_tokens += 1
            self._note_emitted(r.rid)
            if host[1, i]:
                self._finish_slot(i)
        if tr:
            tr.counter("pool_pages", {
                "allocated": float(self.alloc.allocated_pages),
                "free": float(self.alloc.free_pages)})
        return evicted

    # -- queries --------------------------------------------------------------

    def has_live(self) -> bool:
        return any(r is not None for r in self.live)

    def pool_stats(self) -> PoolStats:
        return PoolStats.of(self.alloc, self.slots, self.max_len)

    def spec_stats(self) -> Dict[str, object]:
        return {"spec_k": 0.0, "spec_drafted": 0.0, "spec_accepted": 0.0,
                "accept_rate": 0.0, "accepted_per_step": 1.0,
                "drafter": "none"}

    def prefix_stats(self) -> Dict[str, float]:
        d = {"prompt_tokens": float(self.prompt_tokens),
             "prefilled_tokens": float(self.prefilled_tokens),
             "prefill_tokens_saved": 0.0, "prefill_saved_frac": 0.0,
             "cow_copies": 0.0}
        d.update(dict.fromkeys(PREFIX_STAT_KEYS, 0.0))
        return d

    def tier_stats(self) -> Dict[str, float]:
        d = {"host_tier": 0.0}
        d.update(dict.fromkeys(TIER_STAT_KEYS, 0.0))
        return d

    def shard_stats(self) -> Dict[str, object]:
        nbytes = sum(t.numel() * t.element_size()
                     for pool in self.cache for t in pool.values())
        return {"model_shards": 1.0, "sharded_axes": "",
                "peak_pages_per_shard": float(self.alloc.peak_pages),
                "pool_bytes_per_shard": float(nbytes)}

    def sampling_stats(self) -> Dict[str, float]:
        """The reference's decode-policy keys. ``step_traces`` counts
        captures of the decode graph (a lifetime fact, like
        ``prefill_traces``): 1 on the card after the first step, 0 on the
        CPU, where nothing is captured."""
        return {"greedy_requests": float(self.greedy_requests),
                "sampled_requests": 0.0,
                "greedy_tokens": float(self.greedy_tokens),
                "sampled_tokens": 0.0,
                "step_traces": float(self.step_traces),
                "spec_traces": 0.0, "draft_proposed": 0.0,
                "draft_ingested_tokens": 0.0, "draft_decode_calls": 0.0,
                "draft_pool_rejects": 0.0}

    def _reset_subsystem_counters(self) -> None:
        """reset_metrics() tail: the engine's own rates; the allocator's
        peak rebases to the current allocation."""
        self.prefills = 0
        self.prompt_tokens = 0
        self.prefilled_tokens = 0
        self.greedy_requests = 0
        self.greedy_tokens = 0
        self.alloc.peak_pages = self.alloc.allocated_pages

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
