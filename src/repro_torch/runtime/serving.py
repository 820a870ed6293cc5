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
  with the flash-decode kernel walking the block tables, the policy draw,
  the position / EOS / budget bookkeeping) reads and writes only tensors
  allocated once by the constructor. On CUDA the first ``step()`` captures
  it as a CUDA graph and every step replays it (the reference's
  ``jax.jit`` step); on the CPU the body runs as it is. One small tensor
  (tokens and done flags) comes back to the host per step;
* decode policies (``runtime/sampling.py``): greedy, temperature, top-k
  and top-p per request, from fixed per-slot policy buffers the graph
  reads, so one graph serves every mix; a request's tokens are a function
  of (seed, rid, index) only, so it replays its stream after preemption;
* prefix sharing (``prefix_cache=True``): admission takes the longest
  cached prompt prefix from a radix tree (``runtime/prefix_cache.py``),
  shares its pages by refcount, copies a partial page on write, and
  prefills only the suffix (flash-MHA with a query offset); idle cached
  pages are evicted before a live request is preempted;
* speculative decode (``spec_k`` > 0): each step verifies up to spec_k
  drafted tokens (n-gram lookup, or a draft model: ``runtime/drafter.py``)
  as one T = spec_k + 1 block through the flash-decode kernel, in a second
  captured graph over fixed buffers; the host walks the accept bits and
  rolls pages back;
* on pool exhaustion the youngest live request is preempted and later
  resumes by re-prefilling its prompt plus what it generated;
* ``attn_impl="gather"`` swaps the flash-decode kernel for the reference's
  measured baseline: a dense ``pool[block_table]`` gather and a plain
  online-softmax attention (``layers.attend_decode``), inside the same
  step body.

Sliding windows and recurrent state slots, tensor parallelism and the host
tier are not ported yet: their ``metrics()`` keys read as the reference's
do with those subsystems switched off (zeros, ``""``).
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
from repro_torch.runtime.drafter import ngram_propose
from repro_torch.runtime.kv_cache import SCRATCH_PAGE, PageAllocator, PoolStats
from repro_torch.runtime.prefix_cache import PrefixCache
from repro_torch.runtime.sampling import (ACCEPT_DRAW, NEG_FILTER, SAMPLE_DRAW,
                                          PolicyBuffers, SamplingParams,
                                          draw_keys, fold_keys, gumbel_noise,
                                          policy_operands, request_params,
                                          sample_rows, scale_mask, uniform)
from repro_torch.runtime.trace import Tracer, default_tracer, percentile

ATTN_IMPLS = ("kernel", "gather")
# the reference's HostTier.STAT_KEYS: reported as zeros until the host tier
# is ported
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
    # per-request decode policy (runtime/sampling.py); None = the engine's
    # default
    params: Optional[SamplingParams] = None


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
    ``"gather"`` (the reference's dense-gather baseline).

    Decode policy: ``sampling`` is the default for requests without their
    own ``params``; ``temperature`` builds one when ``sampling`` is not
    given; ``seed`` seeds requests whose policy has none.
    ``prefix_cache=True`` shares prompt prefixes' pages between requests;
    ``spec_k`` > 0 verifies up to ``spec_k`` drafted tokens a step, drafted
    by ``drafter`` (``runtime/drafter.py``) or, when None, by n-gram lookup
    over the request's own context (``spec_ngram`` its longest n-gram)."""

    def __init__(self, cfg, params, *, slots: int = 4, max_len: int = 256,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 eos_id: int = -1, temperature: float = 0.0, seed: int = 0,
                 sampling: Optional[SamplingParams] = None,
                 attn_impl: str = "kernel", prefix_cache: bool = False,
                 spec_k: int = 0, spec_ngram: int = 3, drafter=None,
                 tracer: Optional[Tracer] = None, device="cuda"):
        self.device = resolve_device(device)
        tfm.layer_kinds(cfg)                  # raises on unported kinds
        if page_size < 1 or page_size & (page_size - 1):
            raise ValueError(f"page_size must be a power of two, got "
                             f"{page_size}")
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be kernel|gather: {attn_impl}")
        if drafter is not None and not spec_k:
            raise ValueError(
                "a drafter only runs inside the speculative verify step — "
                "pass spec_k > 0 with it (or drop the drafter)")
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
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
        self.default_params = (
            sampling if sampling is not None
            else SamplingParams(temperature=temperature)).validate()
        self.seed = int(seed) & 0x7FFFFFFF
        self._policy: List[Optional[SamplingParams]] = [None] * slots
        self._init_metrics(tracer)
        usable = num_pages if num_pages is not None \
            else slots * self.max_blocks
        self.alloc = PageAllocator(usable, page_size)
        # prefix sharing: a radix tree over page-aligned token chunks whose
        # pages are refcounted in the allocator (runtime/prefix_cache.py)
        self.prefix: Optional[PrefixCache] = \
            PrefixCache(self.alloc, tracer=self.trace) if prefix_cache \
            else None
        # pool row 0 is the scratch page -> usable + 1 physical pages
        self.cache = api.paged_cache_init(self.cfg, usable + 1, page_size,
                                          device=self.device)

        def dev(n, dtype, cols=None):
            shape = (n,) if cols is None else (n, cols)
            return torch.zeros(shape, dtype=dtype, device=self.device)

        # device-side slot state, allocated once: the step bodies read and
        # advance it in place (a captured graph holds these addresses) and
        # the host writes it in place between steps, on the same stream.
        # Dead slots hold an all-scratch table at position 0.
        self.block_table = dev(slots, torch.int32, self.max_blocks)
        self.pos = dev(slots, torch.int32)
        self.cur_tok = dev(slots, torch.int64, 1)
        self.live_mask = dev(slots, torch.bool)
        self.gen_cnt = dev(slots, torch.int32)
        self.max_new_arr = dev(slots, torch.int32)
        self.pol = PolicyBuffers(slots, self.device)   # per-slot policies
        self._step_out = dev(2, torch.int64, slots)   # tokens, done flags
        self.last_logits: Optional[torch.Tensor] = None

        # speculative decode: each step verifies up to spec_k drafted
        # tokens plus the current one as a T = spec_k + 1 block, through
        # fixed buffers the verify graph reads (the host fills them)
        self.spec_k = spec_k
        self.spec_ngram = spec_ngram
        self.drafter = drafter
        T = spec_k + 1
        self._tok_block = torch.zeros((slots, T), dtype=torch.int64,
                                      device=self.device)
        self._spec_pos = dev(slots, torch.int32)
        self._n_draft = dev(slots, torch.int64)
        self._spec_out = torch.zeros((2, slots, T), dtype=torch.int64,
                                     device=self.device)  # accept, emit

        self.live: List[Optional[Request]] = [None] * slots
        self._pos_host = [0] * slots          # mirror of self.pos for live
        self._admit_seq = [0] * slots         # admission order (preemption)
        self._admit_counter = 0

        # telemetry beyond the mixin's
        self.prefills = 0                     # prefill calls, re-prefills too
        self.prefill_traces = 0               # distinct prefill buckets
        self._seen_buckets: set = set()
        self.prompt_tokens = 0                # logical prompt tokens admitted
        self.prefilled_tokens = 0             # tokens actually prefilled
        self.cow_copies = 0                   # device page copies (CoW)
        self.spec_drafted = 0                 # draft tokens proposed
        self.spec_accepted = 0                # draft tokens accepted
        self.spec_slot_steps = 0              # (live slot, verify step) pairs
        self.greedy_requests = 0              # requests by effective policy
        self.sampled_requests = 0
        self.greedy_tokens = 0                # emitted tokens by policy
        self.sampled_tokens = 0
        # captures of the decode graph and of the verify graph (lifetime
        # facts, like prefill_traces): 1 each on the card once used, 0 on
        # the CPU, where nothing is captured
        self.step_traces = 0
        self.spec_traces = 0
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._graph_launches: Dict[str, int] = {}
        self._spec_graph: Optional[torch.cuda.CUDAGraph] = None
        self._spec_graph_launches: Dict[str, int] = {}

    # -- admission ------------------------------------------------------------

    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.live):
            if r is None:
                return i
        return None

    def _bucket(self, n: int) -> int:
        return min(max(self.page_size, _next_pow2(n)), self.max_len)

    def _prefill_for(self, bucket) -> None:
        """Count distinct prefill shapes (a plain bucket, or (suffix
        bucket, prefix pages) for the shared path)."""
        if bucket not in self._seen_buckets:
            self._seen_buckets.add(bucket)
            self.prefill_traces += 1

    def _count_tokens(self, pol: Optional[SamplingParams], n: int) -> None:
        """Attribute ``n`` emitted tokens to the greedy or sampled count."""
        if pol is None or pol.is_greedy:
            self.greedy_tokens += n
        else:
            self.sampled_tokens += n

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy-on-write on the device: page ``src`` -> ``dst`` in every
        layer's pools, in place, on the engine's stream between replays."""
        for pool in self.cache:
            for t in pool.values():
                t[dst].copy_(t[src])
        self.cow_copies += 1

    def _submit(self, req: Request) -> bool:
        """Prefill ``req`` into a free slot. False if out of slots or pages
        (admission rejection — never touches a live neighbor's pages). A
        request that can never be served (prompt too long for max_len, no
        generation budget left, more pages than the pool has) is dropped as
        done with what it has.

        With the prefix cache on, admission first takes the longest cached
        prefix (whole pages shared by refcount, plus at most one partial
        page copied on write), prefills only the rest, and then publishes
        the request's own full prompt pages for later arrivals."""
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

        shared: List[int] = []
        partial_page, partial_tokens = None, 0
        m = None
        if self.prefix is not None:
            # cap at L - 1: at least one token is prefilled, whose logits
            # pick the next token
            m = self.prefix.match(toks, max_tokens=L - 1)
            shared = m.pages
            partial_page, partial_tokens = m.partial_page, m.partial_tokens
            deficit = self.alloc.pages_for(L) - len(shared) \
                - self.alloc.free_pages
            if deficit > 0:
                # shed idle cached pages only if that covers the deficit
                # (flushing matchable prefixes ahead of a rejection that
                # happens anyway buys nothing); the match's pages are not
                # refcounted yet, so shield them
                keep = set(shared)
                if partial_page is not None:
                    keep.add(partial_page)
                if self.prefix.evictable_count(protect=keep) >= deficit:
                    self._shed_idle_cache(deficit, protect=keep)
        table = self.alloc.allocate_shared(req.rid, L, shared)
        if table is None:
            return False                      # pool full: reject admission
        if m is not None:
            # admission is now certain: count the lookup, touch its LRU
            self.prefix.commit(m, L)
        prefix_len = len(shared) * self.page_size + partial_tokens
        if partial_page is not None:
            # the request diverges inside a cached page: copy it into the
            # request's fresh page (rows < partial_tokens are reused, the
            # suffix prefill overwrites the rest)
            self._copy_page(partial_page, table[len(shared)])
            self.trace.instant("cow_copy", tid="prefix")

        # the prefill's draw decides generated-token index
        # len(req.generated) (> 0 on resume: the same token as before)
        pol_req = request_params(req, self.default_params)
        dev = self.device
        pol1 = policy_operands([pol_req], [req.rid], [len(req.generated)],
                               self.seed, dev)
        row = np.zeros((self.max_blocks,), np.int32)
        row[: len(table)] = table
        tr = self.trace
        if prefix_len == 0:
            bucket = self._bucket(L)
            nb = bucket // self.page_size
            pages = np.full((nb,), SCRATCH_PAGE, np.int64)
            pages[: len(table)] = table
            tok_arr = np.zeros((1, bucket), np.int64)
            tok_arr[0, :L] = toks
            self._prefill_for(bucket)
            with tr.span("prefill_dispatch",
                         args={"bucket": bucket} if tr else None):
                logits, kv, _ = api.prefill(
                    self.cfg, self.params, torch.from_numpy(tok_arr).to(dev),
                    length=torch.full((1,), L, dtype=torch.int32,
                                      device=dev))
                # scatter the prompt's kv blocks into this request's pages
                # (bucket padding past the allocation lands on scratch)
                pages_d = torch.from_numpy(pages).to(dev)
                for pool, e in zip(self.cache, kv):
                    for name in ("k", "v"):
                        pool[name][pages_d] = e[name][0].reshape(
                            (nb, self.page_size) + pool[name].shape[2:])
                tok = sample_rows(logits[:, : self.cfg.vocab], pol1)[0]
            self.prefilled_tokens += L
        else:
            suffix = toks[prefix_len:]
            bucket = self._bucket(len(suffix))
            # prefix pages to gather: the shared pages plus the CoW'd
            # partial one, padded to a power of two with scratch (those
            # rows sit past every real query and are masked)
            n_pref = len(shared) + (1 if partial_page is not None else 0)
            npb = min(_next_pow2(n_pref), self.max_blocks)
            pages = np.full((npb,), SCRATCH_PAGE, np.int64)
            pages[:n_pref] = table[:n_pref]
            # physical (page, row) of each suffix token: token-granular, a
            # CoW'd divergence starts mid-page; padding lands on scratch
            ab = prefix_len + np.arange(bucket)
            rows = ab % self.page_size
            phys = np.full((bucket,), SCRATCH_PAGE, np.int64)
            real = ab < L
            phys[real] = np.asarray(table, np.int64)[ab[real]
                                                     // self.page_size]
            tok_arr = np.zeros((1, bucket), np.int64)
            tok_arr[0, : len(suffix)] = suffix
            self._prefill_for(("shared", bucket, npb))
            with tr.span("prefill_dispatch",
                         args={"bucket": bucket, "shared": prefix_len}
                         if tr else None):
                pages_d = torch.from_numpy(pages).to(dev)
                prefix_kv = [{name: t[pages_d].reshape(
                    (1, npb * self.page_size) + t.shape[2:])
                    for name, t in pool.items()} for pool in self.cache]
                logits, kv, _ = api.prefill(
                    self.cfg, self.params, torch.from_numpy(tok_arr).to(dev),
                    length=torch.full((1,), len(suffix), dtype=torch.int32,
                                      device=dev),
                    prefix_kv=prefix_kv, prefix_len=prefix_len)
                phys_d = torch.from_numpy(phys).to(dev)
                rows_d = torch.from_numpy(rows).to(dev)
                for pool, e in zip(self.cache, kv):
                    for name in ("k", "v"):
                        pool[name][phys_d, rows_d] = e[name][0]
                tok = sample_rows(logits[:, : self.cfg.vocab], pol1)[0]
            self.prefilled_tokens += len(suffix)
        self.block_table[slot] = torch.from_numpy(row).to(dev)
        self.pos[slot] = L
        self.cur_tok[slot, 0] = tok
        self.live_mask[slot] = True
        self.gen_cnt[slot] = 1
        self.max_new_arr[slot] = remaining
        # repro-lint: disable=host-sync — admission reads its first token
        t = int(tok.item())
        self.prefills += 1
        self.prompt_tokens += L
        if self.prefix is not None:
            # publish the prompt's full pages (even a request that finishes
            # at prefill seeds the cache: the tree's pin keeps its pages)
            self.prefix.insert(toks, table)

        self.live[slot] = req
        self._pos_host[slot] = L
        self._policy[slot] = pol_req
        self._admit_counter += 1
        self._admit_seq[slot] = self._admit_counter
        first = req.rid not in self.first_token_at
        req.generated.append(t)
        self.pol.set_slot(slot, pol_req, req.rid, len(req.generated),
                          self.seed)
        self._note_emitted(req.rid)
        if first:
            if pol_req.is_greedy:
                self.greedy_requests += 1
            else:
                self.sampled_requests += 1
        self._count_tokens(pol_req, 1)
        if t == self.eos_id or len(req.generated) >= req.max_new:
            self._finish_slot(slot)
        return True

    def _release_slot(self, slot: int) -> Request:
        """Reclaim a slot's pages; its table becomes all-scratch so a dead
        slot can only ever write to the scratch page, its position 0 so the
        decode kernel walks one scratch page for it, and its policy row
        greedy."""
        req = self.live[slot]
        self.live[slot] = None
        self._policy[slot] = None
        self.alloc.free_request(req.rid)
        self.block_table[slot] = SCRATCH_PAGE
        self.pos[slot] = 0
        self.live_mask[slot] = False
        self.pol.clear_slot(slot)
        if self.drafter is not None:
            # the drafter's context cache for this request is stale from
            # here (a resumed request re-ingests)
            self.drafter.drop(req.rid)
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

    def _shed_idle_cache(self, n_pages: int,
                         protect: Optional[set] = None) -> int:
        """Free up to ``n_pages`` idle prefix-cache pages (LRU, leaves
        first). Returns the pages freed."""
        if self.prefix is None:
            return 0
        return self.prefix.evict(n_pages, protect=protect)

    def _reclaim_one_page(self, keep_slot: int,
                          preempted: List[Request]) -> bool:
        """Free at least one page for ``keep_slot``: shed an idle cached
        page first (it costs at most a future re-prefill), only then
        preempt the youngest other live request. False if neither has
        anything left."""
        if self._shed_idle_cache(1):
            return True
        victims = [s for s, r in enumerate(self.live)
                   if r is not None and s != keep_slot]
        if not victims:
            return False
        youngest = max(victims, key=lambda s: self._admit_seq[s])
        self.trace.instant("preempt")
        preempted.append(self._evict_slot(youngest))
        return True

    def _grow_table(self, rid: int, slot: int, target: int,
                    preempted: List[Request]) -> None:
        """Grow ``rid``'s table page by page until it covers ``target``
        tokens, publishing fresh pages to the device table and reclaiming
        (evict, then preempt the youngest) on pool exhaustion."""
        page = self.page_size
        while True:
            have = len(self.alloc.block_table(rid)) * page
            got = self.alloc.extend_to(rid, min(target, have + page))
            if got is None:
                if not self._reclaim_one_page(slot, preempted):
                    raise RuntimeError(
                        "page pool too small for a single request")
                continue
            if got:                           # fresh page: publish it
                self.block_table[slot, have // page] = got
            if have + page >= target or not got:
                break

    def ensure_decode_capacity(self, n_tokens: int = 1) -> List[Request]:
        """Allocate the pages the next step writes into: positions pos ..
        pos + n_tokens - 1 of each live request (a verify block's whole
        range), capped at max_len, oldest request first. On exhaustion,
        evict idle cached pages, then preempt the youngest until the rest
        fit. Every page the step may write must be private: a shared one
        (another table or the radix tree holds it) is copied on write
        first. Returns the preempted requests (resubmit them to resume)."""
        preempted: List[Request] = []
        page = self.page_size
        for slot in sorted((s for s, r in enumerate(self.live)
                            if r is not None),
                           key=lambda s: self._admit_seq[s]):
            req = self.live[slot]
            if req is None:                   # preempted by an older slot
                continue
            pos = self._pos_host[slot]
            target = min(pos + n_tokens, self.max_len)
            self._grow_table(req.rid, slot, target, preempted)
            for blk in range(pos // page, (target - 1) // page + 1):
                while self.alloc.ref(
                        self.alloc.block_table(req.rid)[blk]) > 1:
                    swapped = self.alloc.replace_page(req.rid, blk)
                    if swapped is not None:
                        src, dst = swapped
                        self._copy_page(src, dst)
                        self.block_table[slot, blk] = dst
                        break
                    if not self._reclaim_one_page(slot, preempted):
                        raise RuntimeError(
                            "page pool too small for a single request")
        return preempted

    # -- decode ---------------------------------------------------------------

    def _step_body(self) -> None:
        """One decode step on the device, the counterpart of the reference's
        traced step: the stack over every slot, the policy draw
        (``sample_rows`` on the per-slot policy buffers), and the position /
        budget / EOS / draw-index bookkeeping. It reads and writes only
        tensors the constructor allocated (slot state, policy buffers,
        block tables, pools, ``_step_out``), in place, so a CUDA graph of
        it stays valid for the engine's life; dead slots advance nothing
        and write only the scratch page. ``last_logits`` is the step's
        (slots, Vp) logits (on the card, the graph's output buffer)."""
        logits, _ = api.decode_step(self.cfg, self.params, self.cache,
                                    self.cur_tok, self.pos,
                                    block_table=self.block_table)
        toks = sample_rows(logits[:, : self.cfg.vocab], self.pol)
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
        self.pol.idx.add_(livei)
        self._step_out[0].copy_(toks)
        self._step_out[1].copy_(done)
        self.last_logits = logits

    def _spec_body(self) -> None:
        """The verify step on the device (the reference's
        ``_make_spec_step``): one T = spec_k + 1 ``decode_step`` over
        ``_tok_block`` at ``_spec_pos`` (each block's k/v written to its
        pages, every row scored in one causal page sweep), then per row an
        accept bit for its drafted token and the token to emit if the step
        stops there, into ``_spec_out``. A draft x is accepted iff ``u <
        p(x)`` (exact argmax match on greedy rows); a rejected row emits a
        residual sample (x masked), the bonus row a full sample. Row t of
        slot s decides generated-token index idx[s] + t, with the key the
        plain step would use there. Fixed buffers only, as ``_step_body``."""
        cfg = self.cfg
        tb = self._tok_block
        B, T = tb.shape
        logits, _ = api.decode_step(cfg, self.params, self.cache, tb,
                                    self._spec_pos,
                                    block_table=self.block_table)
        z = logits[..., : cfg.vocab].reshape(B * T, cfg.vocab)
        pol = self.pol

        def rep(a):                           # (B,) slot operand -> (B*T,)
            return a.repeat_interleave(T)

        temp = rep(pol.temp)
        z = scale_mask(z, temp, rep(pol.top_k), rep(pol.top_p))
        greedy_t = torch.argmax(z, -1)
        t_off = torch.arange(T, device=z.device).repeat(B)
        seed, rid, idx = rep(pol.seed), rep(pol.rid), rep(pol.idx) + t_off
        # the draft under test at row t is tok_block[:, t + 1]; the last
        # row has none (the bonus row)
        draft = torch.cat([tb[:, 1:], torch.zeros_like(tb[:, :1])],
                          1).reshape(-1)
        p_draft = torch.gather(torch.softmax(z, -1), 1, draft[:, None])[:, 0]
        u = uniform(draw_keys(fold_keys(seed, rid, idx), ACCEPT_DRAW))
        sampled = temp > 0
        accept = torch.where(sampled, u < p_draft, greedy_t == draft)
        is_verify = t_off < rep(self._n_draft)
        vocab_ix = torch.arange(cfg.vocab, device=z.device)
        z_res = torch.where((vocab_ix[None, :] == draft[:, None])
                            & is_verify[:, None],
                            torch.full_like(z, NEG_FILTER), z)
        # one noise draw serves both candidates: only one is consumed
        noise = sampled.float()[:, None] * gumbel_noise(
            seed, rid, idx, cfg.vocab, SAMPLE_DRAW)
        full_tok = torch.argmax(z + noise, -1)
        res_tok = torch.argmax(z_res + noise, -1)
        emit = torch.where(sampled, torch.where(is_verify, res_tok, full_tok),
                           greedy_t)
        self._spec_out[0].copy_(accept.reshape(B, T))
        self._spec_out[1].copy_(emit.reshape(B, T))

    def _capture(self, body, state) -> tuple:
        """Record ``body`` as a CUDA graph; returns (graph, the launches it
        holds). A warm-up run first, on a side stream: it builds the
        kernels and raises their shared-memory limits (neither may happen
        inside a capture) and lets cuBLAS pick its kernels. The warm-up
        must not advance the engine, so ``state`` (the tensors the body
        advances) is snapshotted before it and restored after; its pool
        writes land where the first replay writes the same values. The
        capture launches nothing, so the wrappers' counters are set back
        to their values before the warm-up, and the launches the graph
        holds are added on each replay instead. Any failure raises: there
        is no eager fallback."""
        saved = [t.clone() for t in state]
        before = ops.launch_counts()
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            body()
        main.wait_stream(side)
        for t, s in zip(state, saved):
            t.copy_(s)
        warm = ops.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            body()
        held = {k: n - warm[k] for k, n in ops.launch_counts().items()}
        ops.add_launch_counts({k: before[k] - n
                               for k, n in ops.launch_counts().items()})
        return graph, {k: n for k, n in held.items() if n}

    def _dispatch(self) -> None:
        """Enqueue one step body: a replay of the captured graph on CUDA
        (captured at the first call), the body itself on the CPU."""
        if self.device.type != "cuda":
            self._step_body()
            return
        if self._graph is None:
            self._graph, self._graph_launches = self._capture(
                self._step_body,
                (self.cur_tok, self.pos, self.gen_cnt, self.live_mask,
                 self.pol.idx, self._step_out))
            self.step_traces += 1
        self._graph.replay()
        ops.add_launch_counts(self._graph_launches)

    def _dispatch_spec(self) -> None:
        """Enqueue one verify body: a replay of the second captured graph
        on CUDA, the body itself on the CPU."""
        if self.device.type != "cuda":
            self._spec_body()
            return
        if self._spec_graph is None:
            self._spec_graph, self._spec_graph_launches = self._capture(
                self._spec_body, (self._spec_out,))
            self.spec_traces += 1
        self._spec_graph.replay()
        ops.add_launch_counts(self._spec_graph_launches)

    def _step(self) -> List[Request]:
        """Advance every live slot: one device program, one device->host
        copy. With spec_k > 0 a verify step emitting up to spec_k + 1
        tokens a request; otherwise the plain one-token step. Tops up
        pages first and returns the requests that top-up preempted, for
        the caller to resubmit. (Callers use ``step()``, the mixin's timed
        wrapper.)"""
        if not self.has_live():
            return []
        if self.spec_k:
            return self._step_speculative()
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
            self._count_tokens(self._policy[i], 1)
            self._note_emitted(r.rid)
            if host[1, i]:
                self._finish_slot(i)
        if tr:
            tr.counter("pool_pages", {
                "allocated": float(self.alloc.allocated_pages),
                "free": float(self.alloc.free_pages)})
        return evicted

    def _step_speculative(self) -> List[Request]:
        """One speculative verify step (the reference's
        ``_step_speculative``). Per live slot: draft up to spec_k tokens
        (the ``drafter``, or n-gram lookup over the request's own
        context), verify [current token, drafts...] in one replay of the
        verify graph, emit the accepted prefix plus one more token (the
        residual sample after the first rejection, or the bonus sample),
        applying the plain step's stops in emission order, then roll
        positions and pages back past the accept point (``truncate_to``;
        disowned table entries are republished as scratch). At
        temperature 0 the tokens equal the T = 1 engine's."""
        tr = self.trace
        T = self.spec_k + 1
        with tr.span("ensure_capacity"):
            evicted = self.ensure_decode_capacity(T)
        t0 = time.perf_counter()
        tok_block = np.zeros((self.slots, T), np.int64)
        n_draft = np.zeros((self.slots,), np.int64)
        spec_pos = np.zeros((self.slots,), np.int32)
        with tr.span("draft"):
            for s, r in enumerate(self.live):
                if r is None:
                    continue
                ctx = r.prompt + r.generated
                tok_block[s, 0] = ctx[-1]     # current token, not in cache
                if self.drafter is not None:
                    d = self.drafter.propose(r.rid, ctx,
                                             self.spec_k)[: self.spec_k]
                else:
                    d = ngram_propose(ctx, self.spec_k,
                                      max_ngram=self.spec_ngram)
                tok_block[s, 1:1 + len(d)] = d
                n_draft[s] = len(d)
                spec_pos[s] = self._pos_host[s]
                self.spec_drafted += len(d)
                self.spec_slot_steps += 1
        with tr.span("device_dispatch"):
            self._tok_block.copy_(torch.from_numpy(tok_block))
            self._n_draft.copy_(torch.from_numpy(n_draft))
            self._spec_pos.copy_(torch.from_numpy(spec_pos))
            self._dispatch_spec()
        with tr.span("host_sync"):
            # repro-lint: disable=host-sync — the verify step's one copy
            out = self._spec_out.cpu().numpy()
        accept, emit = out[0], out[1]
        self.step_wall_s += time.perf_counter() - t0
        self.decode_steps += 1
        with tr.span("accept_rollback"):
            upd_slot, upd_pos, upd_m, upd_tok = [], [], [], []
            for s, r in enumerate(self.live):
                if r is None:
                    continue
                pos0 = self._pos_host[s]
                a = 0                         # accepted drafts
                while a < n_draft[s] and accept[s, a]:
                    a += 1
                emitted = [int(tok_block[s, j + 1]) for j in range(a)]
                emitted.append(int(emit[s, a]))
                # the plain step's stops, in emission order: tokens past
                # the first stop are dropped
                finished = False
                m = 0
                for j, t in enumerate(emitted):
                    r.generated.append(t)
                    m += 1
                    self.decoded_tokens += 1
                    if (t == self.eos_id or len(r.generated) >= r.max_new
                            or pos0 + j + 1 >= self.max_len - 1):
                        finished = True
                        break
                self.spec_accepted += m - 1
                self._count_tokens(self._policy[s], m)
                self._note_emitted(r.rid, m)
                if finished:
                    self._finish_slot(s)      # frees every page incl. drafts
                    continue
                # rollback: disown whole pages past the accept point and
                # republish their table entries as scratch on the device
                dropped = self.alloc.truncate_to(r.rid, pos0 + m)
                if dropped:
                    keep = len(self.alloc.block_table(r.rid))
                    self.block_table[s, keep:keep + dropped] = SCRATCH_PAGE
                self._pos_host[s] = pos0 + m
                upd_slot.append(s)
                upd_pos.append(pos0 + m)
                upd_m.append(m)
                upd_tok.append(r.generated[-1])
            if upd_slot:
                # device mirrors (pos / gen / cur_tok / draw index) stay in
                # step, one in-place write per tensor
                ix = torch.tensor(upd_slot, device=self.device)
                mm = torch.tensor(upd_m, device=self.device)
                self.pos[ix] = torch.tensor(upd_pos, dtype=torch.int32,
                                            device=self.device)
                self.gen_cnt[ix] += mm.to(torch.int32)
                self.cur_tok[ix, 0] = torch.tensor(upd_tok,
                                                   device=self.device)
                self.pol.idx[ix] += mm
        return evicted

    # -- queries --------------------------------------------------------------

    def has_live(self) -> bool:
        return any(r is not None for r in self.live)

    def pool_stats(self) -> PoolStats:
        return PoolStats.of(self.alloc, self.slots, self.max_len)

    def spec_stats(self) -> Dict[str, object]:
        """Speculative-decode telemetry: draft volume, acceptance, and
        tokens emitted per request per verify step (1.0 for the plain
        engine)."""
        return {
            "spec_k": float(self.spec_k),
            "spec_drafted": float(self.spec_drafted),
            "spec_accepted": float(self.spec_accepted),
            "accept_rate": (self.spec_accepted / self.spec_drafted
                            if self.spec_drafted else 0.0),
            "accepted_per_step": (self.decoded_tokens / self.spec_slot_steps
                                  if self.spec_slot_steps else 1.0),
            "drafter": ("none" if not self.spec_k
                        else (self.drafter.kind if self.drafter is not None
                              else "ngram")),
        }

    def prefix_stats(self) -> Dict[str, float]:
        """Prefix-sharing telemetry: hit rate, prefill avoided, CoW copies
        (the prefill counters are kept with sharing off too, as a
        baseline)."""
        d = {"prompt_tokens": float(self.prompt_tokens),
             "prefilled_tokens": float(self.prefilled_tokens),
             "prefill_tokens_saved": float(self.prompt_tokens
                                           - self.prefilled_tokens),
             "prefill_saved_frac": ((self.prompt_tokens
                                     - self.prefilled_tokens)
                                    / self.prompt_tokens
                                    if self.prompt_tokens else 0.0),
             "cow_copies": float(self.cow_copies)}
        d.update(self.prefix.stats() if self.prefix is not None
                 else PrefixCache.zero_stats())
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
        """The reference's decode-policy keys: the greedy/sampled request
        and token mix, the captures of the decode and verify graphs
        (lifetime facts, like ``prefill_traces``: 1 each on the card once
        used, 0 on the CPU, where nothing is captured), and the draft
        model's counters (zeros without one)."""
        d = {"greedy_requests": float(self.greedy_requests),
             "sampled_requests": float(self.sampled_requests),
             "greedy_tokens": float(self.greedy_tokens),
             "sampled_tokens": float(self.sampled_tokens),
             "step_traces": float(self.step_traces),
             "spec_traces": float(self.spec_traces),
             "draft_proposed": 0.0, "draft_ingested_tokens": 0.0,
             "draft_decode_calls": 0.0, "draft_pool_rejects": 0.0}
        if self.drafter is not None:
            d.update(self.drafter.stats())
        return d

    def _reset_subsystem_counters(self) -> None:
        """reset_metrics() tail: the engine's own rates and the prefix
        cache's hit counters; the allocator's peak rebases to the current
        allocation (the radix tree's contents stay)."""
        self.prefills = 0
        self.prompt_tokens = 0
        self.prefilled_tokens = 0
        self.cow_copies = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_slot_steps = 0
        self.greedy_requests = 0
        self.sampled_requests = 0
        self.greedy_tokens = 0
        self.sampled_tokens = 0
        self.alloc.peak_pages = self.alloc.allocated_pages
        self.alloc.share_events = 0
        if self.prefix is not None:
            self.prefix.reset_hit_counters()

    def check(self) -> None:
        """Pool invariants: the allocator's shared-page-aware check plus
        write exclusivity — the page each live request's next token lands
        in must not be shared, or the next step would write over another
        reader's KV."""
        self.alloc.check()
        for slot, req in enumerate(self.live):
            if req is None:
                continue
            table = self.alloc.block_table(req.rid)
            blk = self._pos_host[slot] // self.page_size
            if blk < len(table):
                assert self.alloc.ref(table[blk]) == 1, (
                    f"slot {slot}: next-write page {table[blk]} is shared "
                    f"(ref {self.alloc.ref(table[blk])})")

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
