"""Serving engines: continuous batching over a shared KV page pool, the
dense-slot baseline, and the factory that picks between them.

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
  resumes by re-prefilling its prompt plus what it generated, or, with
  ``host_tier=True`` (``runtime/host_tier.py``), swaps its pages and
  recurrent state out to pinned host RAM and resumes by swapping them back
  in, with no re-prefill; the tier also demotes idle prefix-cache pages
  instead of evicting them and archives slid-out window pages;
* ``attn_impl="gather"`` swaps the flash-decode kernel for the reference's
  measured baseline: a dense ``pool[block_table]`` gather and a plain
  online-softmax attention (``layers.attend_decode``), inside the same
  step body;
* hybrid and recurrent stacks (recurrentgemma's RG-LRU + local attention,
  Mamba2): sliding-window layers read a second fixed table, ``win_table``,
  whose pages are recycled to the free list as they slide wholly below the
  window (a request holds O(window) pages; a prompt longer than the window
  is admitted without its pre-window blocks), and recurrent layers keep
  fixed per-slot state that the prefill writes whole, the decode graph
  advances in place, and a speculative step rolls back by selecting each
  slot's accepted row of the verify graph's checkpointed states (a third
  captured graph over a fixed index buffer).

``DenseServingEngine`` is the reference's seed engine, kept as the measured
baseline: one dense ``max_len`` lane a slot (a window ring on local_attn
layers), prefill at each prompt's exact length, its decode step one
captured graph too. ``ServingEngine`` returns the paged engine for every
stack it can host and the dense one otherwise (the encoder-decoder, which
neither engine can then serve: its prefill needs ``enc_embeds``).

Tensor parallelism (``mesh=``, ``parallel/tp.py``): one process a shard
of a ``launch.mesh`` mesh's ``model`` axis, every rank running this same
host logic on the same inputs (scheduler, allocator, prefix cache,
sampler keys), so the ranks stay in lockstep with no host traffic of
their own. A rank holds its KV heads' slice of every page and its part of
the attention and MLP weights; the model all-reduces over the ``model``
group at the attention out-projection and the MLP down-projection, so
every rank's logits, and so its tokens, are the same.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import api
from repro_torch.models import transformer as tfm
from repro_torch.parallel import tp
from repro_torch.parallel.sharding import NO_RULES
from repro_torch.runtime.drafter import ngram_propose
from repro_torch.runtime.host_tier import HostTier, SwapRecord, _tree_nbytes
from repro_torch.runtime.kv_cache import SCRATCH_PAGE, PageAllocator, PoolStats
from repro_torch.runtime.prefix_cache import PrefixCache, PrefixMatch
from repro_torch.runtime.sampling import (ACCEPT_DRAW, NEG_FILTER, SAMPLE_DRAW,
                                          PolicyBuffers, SamplingParams,
                                          draw_keys, fold_keys, gumbel_noise,
                                          policy_operands, request_params,
                                          sample_rows, scale_mask, uniform)
from repro_torch.runtime.trace import Tracer, default_tracer, percentile

ATTN_IMPLS = ("kernel", "gather")


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


def _win_rid(rid: int):
    """Allocator key of a request's sliding-window table (apart from its
    full-attention table: the two recycle and roll back independently)."""
    return ("win", rid)


def last_occurrences(target: np.ndarray) -> np.ndarray:
    """Ascending indices of the last occurrence of each value of the 1-D
    ``target``: writing only those rows leaves each target its last
    writer's value, the order the JAX engine's scatter leaves, where a CUDA
    scatter with duplicate indices leaves any one of them."""
    _, first_rev = np.unique(target[::-1], return_index=True)
    return np.sort(len(target) - 1 - first_rev)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def capture_graph(device, body, state) -> tuple:
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
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
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

    # -- shared by both engines ----------------------------------------------

    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.live):
            if r is None:
                return i
        return None

    def has_live(self) -> bool:
        return any(r is not None for r in self.live)

    def _count_tokens(self, pol: Optional[SamplingParams], n: int) -> None:
        """Attribute ``n`` emitted tokens to the greedy or sampled count."""
        if pol is None or pol.is_greedy:
            self.greedy_tokens += n
        else:
            self.sampled_tokens += n

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
    over the request's own context (``spec_ngram`` its longest n-gram).
    Stacks with sliding-window or recurrent layers serve too, without the
    prefix cache (``ValueError``: recurrent state cannot be rebuilt from
    shared pages, and window pages are recycled per request).
    ``host_tier=True`` backs the pool with pinned host RAM: preemption
    swaps out instead of destroying work, idle cached pages demote instead
    of being evicted.

    ``mesh`` (``launch.mesh.make_host_mesh``, made inside the world of
    ranks that serve together) shards the engine over its ``model`` axis
    (``parallel.tp.tp_plan``): this rank keeps its part of the attention
    and MLP weights (``shard_params``) and allocates the pools at KV/m
    heads when attention shards (the window pools too); every body runs
    with the plan's rules. ``params`` are the full tensors. With the host
    tier it raises ``ValueError``, as the reference does. On a CUDA device
    the decode, verify and select bodies are captured as graphs when the
    plan contracts nothing or its ``model`` group is NCCL (the all-reduces
    go inside the graph; one eager all-reduce first creates the
    communicator); over a gloo group they run uncaptured, as on the CPU:
    gloo's collectives cannot be captured."""

    def __init__(self, cfg, params, *, slots: int = 4, max_len: int = 256,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 eos_id: int = -1, temperature: float = 0.0, seed: int = 0,
                 sampling: Optional[SamplingParams] = None,
                 attn_impl: str = "kernel", prefix_cache: bool = False,
                 spec_k: int = 0, spec_ngram: int = 3, drafter=None,
                 mesh=None, host_tier: bool = False,
                 tracer: Optional[Tracer] = None, device="cuda"):
        self.device = resolve_device(device)
        if host_tier and mesh is not None:
            raise ValueError(
                "host_tier=True is single-shard only: swap blobs would "
                "have to gather/scatter each shard's KV-head slice — TP + "
                "tiering is an open item")
        if not _pageable(cfg):
            raise ValueError(f"paged serving cannot host pattern "
                             f"{tfm.pattern_for(cfg)}; use "
                             f"DenseServingEngine")
        # the block kinds split three ways: full-attention layers share one
        # block table, sliding-window layers a second (recycled) one, and
        # recurrent layers hold per-slot state beside the pools
        kinds = tfm.layer_kinds(cfg)
        self._kinds = kinds
        self.has_full = bool(set(kinds) & set(api.PAGEABLE_KINDS))
        self.has_win = bool(set(kinds) & set(api.WINDOW_KINDS))
        self.has_state = bool(set(kinds) & set(api.STATE_KINDS))
        self.window = cfg.hybrid.window if self.has_win else 0
        if prefix_cache and (self.has_win or self.has_state):
            raise ValueError(
                "prefix_cache needs an attention-only stack: recurrent "
                "state cannot be reconstructed from shared KV pages, and "
                "window pages are recycled per-request")
        if self.has_win and self.window < 1:
            raise ValueError("local_attn layers need cfg.hybrid.window >= 1")
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
        # tensor parallelism: the plan (None without a mesh) decides what
        # shards; this rank keeps its part of the sharded weights
        self.tp = tp.tp_plan(self.cfg, mesh)
        self._model_rules = self.tp.rules if self.tp is not None \
            else NO_RULES
        if self.tp is not None:
            if mesh.device.type != self.device.type:
                raise ValueError(f"the mesh puts this rank on "
                                 f"{mesh.device}, the engine on "
                                 f"{self.device}")
            if self._model_rules.contract_axes and mesh.group is None:
                raise ValueError(
                    f"a model axis of {self.tp.model_shards} needs its "
                    f"process group: make the mesh inside a "
                    f"torch.distributed world (launch.mesh.run_world)")
            params = tp.shard_params(params, self.tp, mesh.model_rank)
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
        # the host tier: a pinned host page store and its copy stream
        # (runtime/host_tier.py); off by default, since demoted blobs hold
        # host RAM that a caller metering memory opts into
        self.tier: Optional[HostTier] = \
            HostTier(tracer=self.trace) if host_tier else None
        # pool row 0 is the scratch page -> usable + 1 physical pages; the
        # recurrent layers' entries are (slots, ...) state; a sharded
        # rank's pools hold its KV heads only
        if self.tp is None:
            self.cache = api.paged_cache_init(self.cfg, usable + 1,
                                              page_size, slots=slots,
                                              device=self.device)
        else:
            self.cache = tp.paged_cache_init(self.tp, self.cfg, usable + 1,
                                             page_size, slots=slots,
                                             device=self.device)
        self._state = [(j, e) for j, (e, k) in enumerate(zip(self.cache,
                                                             kinds))
                       if k in api.STATE_KINDS]

        def dev(n, dtype, cols=None):
            shape = (n,) if cols is None else (n, cols)
            return torch.zeros(shape, dtype=dtype, device=self.device)

        # device-side slot state, allocated once: the step bodies read and
        # advance it in place (a captured graph holds these addresses) and
        # the host writes it in place between steps, on the same stream.
        # A dead slot holds an all-scratch table and keeps the position and
        # token it died with, as the reference's does: its row still runs
        # through the step (an MoE router sees it), reading and writing only
        # the scratch page.
        self.block_table = dev(slots, torch.int32, self.max_blocks)
        # the sliding-window table: logical block j still means positions
        # [j * page, (j + 1) * page), but entries that slid below the window
        # are recycled to scratch (the kernel skips them)
        self.win_table = dev(slots, torch.int32, self.max_blocks)
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
        # recurrent rollback: the verify graph checkpoints every row's state
        # into fixed (slots, T, ...) buffers; after the accept walk a third
        # graph copies row _accept_idx[s] of each into slot s's state
        self._ckpt = api.state_buffers(self.cfg, slots, T,
                                       device=self.device) \
            if spec_k and self.has_state else None
        self._accept_idx = dev(slots, torch.int64)

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
        self.win_recycled_pages = 0           # window pages slid out + freed
        self.win_peak_live = 0                # most live window pages a slot
        self.state_selects = 0                # rollback selects dispatched
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
        self.select_traces = 0
        self._select_graph: Optional[torch.cuda.CUDAGraph] = None

    # -- admission ------------------------------------------------------------

    def _bucket(self, n: int) -> int:
        return min(max(self.page_size, _next_pow2(n)), self.max_len)

    def win_pages_bound(self, n_tokens: int) -> int:
        """Most live window pages a request holds while serving
        ``n_tokens``: the window plus one step's write block (spec_k + 1
        tokens under speculative decode) straddle at most ceil((window +
        T) / page) + 1 pages; fewer if the request never grows that long."""
        t_block = self.spec_k + 1
        return min(self.alloc.pages_for(n_tokens),
                   -(-(self.window + t_block) // self.page_size) + 1)

    def _worst_case_pages(self, n_tokens: int) -> int:
        """Pages a request can ever hold at once (admission feasibility)."""
        need = 0
        if self.has_full:
            need += self.alloc.pages_for(n_tokens)
        if self.has_win:
            need += self.win_pages_bound(n_tokens)
        return need

    def state_slot_bytes(self) -> int:
        """Bytes of one slot's recurrent state over every recurrent layer."""
        return sum(t[0].numel() * t.element_size()
                   for _, e in self._state for t in e.values())

    def _prefill_for(self, bucket) -> None:
        """Count distinct prefill shapes (a plain bucket, or (suffix
        bucket, prefix pages) for the shared path)."""
        if bucket not in self._seen_buckets:
            self._seen_buckets.add(bucket)
            self.prefill_traces += 1

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
        if self.tier is not None and self.tier.has_swap(req.rid):
            # swapped out: resume from the host tier, no re-prefill. Before
            # the guard below on purpose: a request live when preempted
            # always passes it, and its footprint math describes a prefill
            with self.trace.span("swap_in"):
                return self._swap_in(req, slot)
        toks = list(req.prompt) + list(req.generated)   # resume-on-preempt
        L = len(toks)
        remaining = req.max_new - len(req.generated)
        worst = min(L + remaining, self.max_len)
        if (L >= self.max_len - 1 or remaining <= 0
                or self._worst_case_pages(worst) > self.alloc.num_pages):
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
            if self.tier is not None:
                # hits on host-resident nodes: promote them to device pages
                # (H2D, prefetched a tick ahead when the scheduler showed
                # this request) rather than let the match shrink
                with self.trace.span("promote_match"):
                    m = self._promote_match(m)
            shared = m.pages
            partial_page, partial_tokens = m.partial_page, m.partial_tokens
            deficit = self.alloc.pages_for(L) - len(shared) \
                - self.alloc.free_pages
            if deficit > 0:
                # shed idle cached pages only if that covers the deficit
                # (flushing matchable prefixes ahead of a rejection that
                # happens anyway buys nothing); the match's pages are not
                # refcounted yet, so shield them. With the tier on, shedding
                # demotes (the node stays matchable) and any idle node
                # qualifies, not only leaves
                keep = set(shared)
                if partial_page is not None:
                    keep.add(partial_page)
                can = (self.prefix.demotable_count(keep)
                       if self.tier is not None
                       else self.prefix.evictable_count(protect=keep))
                if can >= deficit:
                    self._shed_idle_cache(deficit, protect=keep)
        table: List[int] = []
        if self.has_full:
            table = self.alloc.allocate_shared(req.rid, L, shared)
            if table is None:
                return False                  # pool full: reject admission
        wtable: List[int] = []
        dead0 = 0
        if self.has_win:
            # a prompt longer than the window is admitted with its
            # pre-window blocks never allocated: every later query sits at a
            # position >= L and sees only keys > L - window
            dead0 = min(max(0, L - self.window + 1) // self.page_size,
                        self.alloc.pages_for(L) - 1)
            wtable = self.alloc.allocate(_win_rid(req.rid), L,
                                         base_blocks=dead0)
            if wtable is None:
                if self.has_full:
                    self.alloc.free_request(req.rid)
                return False                  # pool full: reject admission
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
        # the window row: logical block j of [dead0, dead0 + n) holds
        # wtable[j - dead0]; recycled lead blocks and the unwritten tail
        # stay scratch
        row_win = np.zeros((self.max_blocks,), np.int32)
        row_win[dead0: dead0 + len(wtable)] = wtable
        tr = self.trace
        if prefix_len == 0:
            bucket = self._bucket(L)
            nb = bucket // self.page_size
            pages = np.full((nb,), SCRATCH_PAGE, np.int64)
            pages[: len(table)] = table
            pages_win = row_win[:nb].astype(np.int64)
            tok_arr = np.zeros((1, bucket), np.int64)
            tok_arr[0, :L] = toks
            self._prefill_for(bucket)
            with tr.span("prefill_dispatch",
                         args={"bucket": bucket} if tr else None):
                logits, kv, _ = api.prefill(
                    self.cfg, self.params, torch.from_numpy(tok_arr).to(dev),
                    length=torch.full((1,), L, dtype=torch.int32,
                                      device=dev), rules=self._model_rules)
                self._scatter_prefill(kv, slot, pages, pages_win)
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
                    prefix_kv=prefix_kv, prefix_len=prefix_len,
                    rules=self._model_rules)
                # bucket padding lands on scratch rows, several tokens on
                # one row: write each row's last token only
                last = last_occurrences(phys * self.page_size + rows)
                phys_d = torch.from_numpy(phys[last]).to(dev)
                rows_d = torch.from_numpy(rows[last]).to(dev)
                last_d = torch.from_numpy(last).to(dev)
                for pool, e in zip(self.cache, kv):
                    for name in ("k", "v"):
                        pool[name][phys_d, rows_d] = e[name][0][last_d]
                tok = sample_rows(logits[:, : self.cfg.vocab], pol1)[0]
            self.prefilled_tokens += len(suffix)
        self.block_table[slot] = torch.from_numpy(row).to(dev)
        if self.has_win:
            self.win_table[slot] = torch.from_numpy(row_win).to(dev)
            self.win_peak_live = max(self.win_peak_live, len(wtable))
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

    def _scatter_prefill(self, kv, slot: int, pages: np.ndarray,
                         pages_win: np.ndarray) -> None:
        """Write a prefill's cache entries: full-attention k/v blocks into
        ``pages``, sliding-window ones into ``pages_win`` (host arrays;
        bucket padding and pre-window blocks are the scratch page, which
        gets the last of its blocks, as the reference's scatter leaves it),
        and every leaf of each recurrent layer's state into slot ``slot``,
        so nothing of the slot's previous request survives."""
        nb = pages.shape[0]
        dev = self.device
        dst = {}
        for name, pg in (("full", pages), ("win", pages_win)):
            last = last_occurrences(pg)
            dst[name] = (torch.from_numpy(pg[last]).to(dev),
                         torch.from_numpy(last).to(dev))
        for pool, e, kind in zip(self.cache, kv, tfm.layer_kinds(self.cfg)):
            if kind in api.STATE_KINDS:
                for name, t in pool.items():
                    t[slot].copy_(e[name][0])
                continue
            pg, last = dst["win" if kind in api.WINDOW_KINDS else "full"]
            for name in ("k", "v"):
                pool[name][pg] = e[name][0].reshape(
                    (nb, self.page_size) + pool[name].shape[2:])[last]

    def _release_slot(self, slot: int, demote: bool = False) -> Request:
        """Reclaim a slot's pages (``demote``: move its tables to the
        allocator's host-resident class instead of freeing them); its tables
        become all-scratch so a dead slot can only ever read and write the
        scratch page, and its policy row greedy. Its position and token
        stay what they were, as in the reference: the dead row still runs
        through every step, and on an MoE stack it takes expert capacity,
        so it must compute what the reference's dead row computes."""
        req = self.live[slot]
        self.live[slot] = None
        self._policy[slot] = None
        release = self.alloc.demote if demote else self.alloc.free_request
        if self.has_full:
            release(req.rid)
            self.block_table[slot] = SCRATCH_PAGE
        if self.has_win:
            release(_win_rid(req.rid))
            self.win_table[slot] = SCRATCH_PAGE
        self.live_mask[slot] = False
        self.pol.clear_slot(slot)
        if self.drafter is not None:
            # the drafter's context cache for this request is stale from
            # here (a resumed or swapped-in request re-ingests)
            self.drafter.drop(req.rid)
        return req

    def _finish_slot(self, slot: int) -> None:
        req = self._release_slot(slot)
        req.done = True
        self._note_finished(req.rid)

    def _evict_slot(self, slot: int) -> Request:
        """Preempt destructively: reclaim pages, return the request for
        re-admission (it resumes by re-prefilling prompt + generated-so-
        far). With the host tier on, ``_swap_out_slot`` is the path and
        this its fallback when the store refuses the bytes."""
        req = self._release_slot(slot)
        req.preemptions += 1
        return req

    # -- host tier: demote / promote / swap ---------------------------------

    def _gather_pages(self, kinds_ok, pages: List[int]):
        """``pages``' rows of every pool whose layer kind is in
        ``kinds_ok``, as a fresh tensor tree ``{str(layer): {"k", "v"}}``,
        enqueued on the current stream (so before any later write to those
        pages). The reference pads the page list to a power of two to bound
        its traces; nothing is traced here, so the blob holds the pages
        alone."""
        idx = torch.tensor(pages, dtype=torch.int64, device=self.device)
        return {str(j): {name: t.index_select(0, idx)
                         for name, t in pool.items()}
                for j, (pool, kind) in enumerate(zip(self.cache, self._kinds))
                if kind in kinds_ok}

    def _scatter_pages(self, pages: List[int], blob) -> None:
        """Write a gathered blob into ``pages`` of the pools it names, in
        place on the current stream (ordered before the next replay)."""
        idx = torch.tensor(pages, dtype=torch.int64, device=self.device)
        for j, entry in blob.items():
            for name, t in self.cache[int(j)].items():
                t.index_copy_(0, idx, entry[name].to(t.dtype))

    def _shed_idle_cache(self, n_pages: int,
                         protect: Optional[set] = None) -> int:
        """Free up to ``n_pages`` device pages of the idle prefix cache.
        Tier off: LRU eviction, leaves first. Tier on: demote first — gather
        the page (a one-page blob: the page-granular half of the streamer),
        hand it to the host store and free the device page while the node
        stays matchable — and evict only what the store refuses. Returns
        the pages freed."""
        if self.prefix is None:
            return 0
        if self.tier is None:
            return self.prefix.evict(n_pages, protect=protect)
        freed = 0
        for node in self.prefix.demotable(protect):
            if freed >= n_pages:
                break
            blob = self._gather_pages(api.PAGEABLE_KINDS, [node.page])
            if not self.tier.can_accept(_tree_nbytes(blob)):
                break                         # store full: evict the rest
            self.prefix.demote_node(node, self.tier.store.put(blob))
            self.tier.cache_demotions += 1
            self.tier.demoted_pages += 1
            freed += 1
        if freed < n_pages:
            freed += self.prefix.evict(n_pages - freed, protect=protect)
        return freed

    def _promote_match(self, m: PrefixMatch) -> PrefixMatch:
        """Promote every host-resident node on a match's path to a fresh
        pinned device page (H2D through the copy stream: a hit when the
        scheduler's prefetch hook saw this prompt a tick ahead). If the
        pool runs dry mid-path the match is cut at that node: the pages
        below the cut are promoted and used, the rest is prefilled."""
        for i, node in enumerate(m.path):
            if node.page is not None:
                m.pages[i] = node.page        # promoted by an earlier caller
                continue
            page = self.alloc.alloc_pinned_page()
            if page is None:
                return PrefixMatch(
                    m.pages[:i], i * self.page_size,
                    node=m.path[i - 1] if i else None, path=m.path[:i])
            handle = node.host
            self._scatter_pages([page], self.tier.stream.take(handle))
            self.tier.store.pop(handle)
            self.prefix.promote_node(node, page)
            self.tier.cache_promotions += 1
            self.tier.promoted_pages += 1
            m.pages[i] = page
        return m

    def _swap_out_slot(self, slot: int) -> Request:
        """Preempt without destroying work: gather the slot's full and
        window tables into blobs (request-granular), export its recurrent
        state, hand them to the host store, then demote the allocator's
        tables and free the pages (gather-then-free: the gathers are
        enqueued before any later write to those pages). Falls back to
        destructive eviction when the store refuses the bytes."""
        req = self.live[slot]
        tier = self.tier
        rec = SwapRecord(rid=req.rid, pos=self._pos_host[slot])
        blobs = {}
        if self.has_full:
            table = self.alloc.block_table(req.rid)
            rec.full_pages = len(table)
            blobs["full"] = self._gather_pages(api.PAGEABLE_KINDS, table)
        if self.has_win:
            wrid = _win_rid(req.rid)
            wtable = self.alloc.block_table(wrid)
            rec.win_pages = len(wtable)
            rec.win_base = self.alloc.base_blocks(wrid)
            blobs["win"] = self._gather_pages(api.WINDOW_KINDS, wtable)
        if self.has_state:
            blobs["state"] = api.state_slot_export(self.cfg, self.cache, slot)
        if not tier.can_accept(sum(_tree_nbytes(b) for b in blobs.values())):
            return self._evict_slot(slot)
        for name, blob in blobs.items():
            setattr(rec, name, tier.store.put(blob))
        self._release_slot(slot, demote=True)
        tier.demoted_pages += rec.full_pages + rec.win_pages
        tier.record_swap(rec)
        req.preemptions += 1
        return req

    def _swap_in(self, req: Request, slot: int) -> bool:
        """Resume a swapped-out request: promote its allocator tables,
        scatter the host blobs into the fresh pages (in flight already when
        the prefetch hook fired), import its recurrent state, and rebuild
        the slot where the preemption left it: position, current token,
        the remaining budget, its policy row and draw index, its admission
        order. Nothing is prefilled and no token is emitted. False (the
        request waits) if the pool cannot hold it yet: a swap-in never
        preempts anyone."""
        tier = self.tier
        rec = tier.peek_swap(req.rid)
        need = 0
        if self.has_full:
            need += self.alloc.host_pages_needed(req.rid)
        if self.has_win:
            need += self.alloc.host_pages_needed(_win_rid(req.rid))
        deficit = need - self.alloc.free_pages
        if deficit > 0:
            self._shed_idle_cache(deficit)
            if need > self.alloc.free_pages:
                return False
        table: List[int] = []
        if self.has_full:
            table = self.alloc.promote(req.rid)
        wtable: List[int] = []
        if self.has_win:
            wtable = self.alloc.promote(_win_rid(req.rid))
        if rec.full is not None:
            self._scatter_pages(table, tier.stream.take(rec.full))
        if rec.win is not None:
            self._scatter_pages(wtable, tier.stream.take(rec.win))
        if rec.state is not None:
            api.state_slot_import(self.cfg, self.cache, slot,
                                  tier.stream.take(rec.state))
        tier.promoted_pages += len(table) + len(wtable)
        dev = self.device
        row = np.zeros((self.max_blocks,), np.int32)
        row[: len(table)] = table
        self.block_table[slot] = torch.from_numpy(row).to(dev)
        if self.has_win:
            row_win = np.zeros((self.max_blocks,), np.int32)
            row_win[rec.win_base: rec.win_base + len(wtable)] = wtable
            self.win_table[slot] = torch.from_numpy(row_win).to(dev)
            self.win_peak_live = max(self.win_peak_live, len(wtable))
        self.pos[slot] = rec.pos
        self.cur_tok[slot, 0] = int(req.generated[-1])
        self.live_mask[slot] = True
        # gen restarts at 1 with a rebased budget, the re-prefill resume's
        # accounting: done when the total generated reaches max_new
        self.gen_cnt[slot] = 1
        self.max_new_arr[slot] = req.max_new - len(req.generated) + 1
        pol_req = request_params(req, self.default_params)
        # the next draw decides generated-token index len(generated): the
        # one the unpreempted run would have drawn there
        self.pol.set_slot(slot, pol_req, req.rid, len(req.generated),
                          self.seed)
        self.live[slot] = req
        self._pos_host[slot] = rec.pos
        self._policy[slot] = pol_req
        self._admit_counter += 1
        self._admit_seq[slot] = self._admit_counter
        tier.pop_swap(req.rid)
        return True

    def prefetch_pending(self, pending: List[Request]) -> None:
        """The streamer's look-ahead (``Scheduler.tick`` calls it with the
        queue between admission and decode): start the H2D copies that the
        next tick's admissions will take — a swapped-out request's whole
        swap set, or the host-resident radix nodes a prompt's match crosses
        — so they overlap this tick's decode step."""
        if self.tier is None:
            return
        for req in pending:
            if self.tier.has_swap(req.rid):
                for h in self.tier.peek_swap(req.rid).handles():
                    self.tier.stream.prefetch(h)
            elif self.prefix is not None:
                toks = list(req.prompt) + list(req.generated)
                m = self.prefix.match(toks, max_tokens=len(toks) - 1)
                for node in m.path:
                    if node.page is None:
                        self.tier.stream.prefetch(node.host)

    def _reclaim_one_page(self, keep_slot: int,
                          preempted: List[Request]) -> bool:
        """Free at least one page for ``keep_slot``: shed an idle cached
        page first (demote or evict: it costs at most a future promotion or
        re-prefill), only then preempt the youngest other live request
        (swap it out when the tier is on). False if neither has anything
        left."""
        if self._shed_idle_cache(1):
            return True
        victims = [s for s, r in enumerate(self.live)
                   if r is not None and s != keep_slot]
        if not victims:
            return False
        youngest = max(victims, key=lambda s: self._admit_seq[s])
        if self.tier is not None:
            with self.trace.span("swap_out"):
                preempted.append(self._swap_out_slot(youngest))
        else:
            self.trace.instant("preempt")
            preempted.append(self._evict_slot(youngest))
        return True

    def _grow_table(self, rid, slot: int, target: int,
                    preempted: List[Request], table: torch.Tensor) -> None:
        """Grow ``rid``'s table page by page until it covers ``target``
        tokens, publishing fresh pages to the device ``table`` (the full or
        the window one) and reclaiming (evict, then preempt the youngest)
        on pool exhaustion."""
        page = self.page_size
        while True:
            have = (self.alloc.base_blocks(rid)
                    + len(self.alloc.block_table(rid))) * page
            got = self.alloc.extend_to(rid, min(target, have + page))
            if got is None:
                if not self._reclaim_one_page(slot, preempted):
                    raise RuntimeError(
                        "page pool too small for a single request")
                continue
            if got:                           # fresh page: publish it
                table[slot, have // page] = got
            if have + page >= target or not got:
                break

    def _recycle_win(self, slot: int, rid: int, pos: int) -> None:
        """Free the slot's window pages that slid wholly below the window:
        every query from here on sits at a position >= ``pos``, so keys at
        positions <= pos - window are never read again. Their table
        entries become the scratch page on the device (the kernel skips
        them) and their pages go back to the free list (at least one block
        stays: the one being written)."""
        wrid = _win_rid(rid)
        dead = max(0, pos - self.window + 1) // self.page_size
        base = self.alloc.base_blocks(wrid)
        n = min(dead - base, len(self.alloc.block_table(wrid)) - 1)
        if n > 0:
            if self.tier is not None:
                # demotion source 3: archive the slid-out blocks (capped),
                # gathered while the pages are live, freed right after
                pages = self.alloc.block_table(wrid)[:n]
                blob = self._gather_pages(api.WINDOW_KINDS, pages)
                if self.tier.can_accept(_tree_nbytes(blob)):
                    self.tier.archive_window(rid, base, n,
                                             self.tier.store.put(blob))
            self.win_recycled_pages += self.alloc.release_prefix(wrid, n)
            self.win_table[slot, base:base + n] = SCRATCH_PAGE

    def ensure_decode_capacity(self, n_tokens: int = 1) -> List[Request]:
        """Allocate the pages the next step writes into: positions pos ..
        pos + n_tokens - 1 of each live request (a verify block's whole
        range), capped at max_len, oldest request first; window tables
        first recycle the pages that slid below the window. On exhaustion,
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
            if self.has_win:
                # recycle first: the pages that slid out may be the ones
                # this top-up needs; recycling is what holds a windowed
                # request at O(window) pages
                self._recycle_win(slot, req.rid, pos)
                self._grow_table(_win_rid(req.rid), slot, target, preempted,
                                 self.win_table)
                self._recycle_win(slot, req.rid, pos)
                self.win_peak_live = max(self.win_peak_live, len(
                    self.alloc.block_table(_win_rid(req.rid))))
            if not self.has_full:
                continue
            self._grow_table(req.rid, slot, target, preempted,
                             self.block_table)
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
                                    block_table=self.block_table,
                                    win_block_table=self._win_arg(),
                                    rules=self._model_rules)
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
                                    block_table=self.block_table,
                                    win_block_table=self._win_arg(),
                                    state_out=self._ckpt,
                                    rules=self._model_rules)
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

    def _win_arg(self) -> Optional[torch.Tensor]:
        return self.win_table if self.has_win else None

    def _select_body(self) -> None:
        """The recurrent rollback on the device (the reference's
        ``_make_select``): row ``_accept_idx[s]`` of each checkpointed
        state (the state after the last accepted row) into slot s's state,
        in place. Fixed buffers only, as ``_step_body``."""
        ix = self._accept_idx
        for j, entry in self._state:
            for name, t in entry.items():
                ck = self._ckpt[j][name]
                idx = ix.view((-1, 1) + (1,) * (ck.dim() - 2)).expand(
                    (ck.shape[0], 1) + ck.shape[2:])
                t.copy_(torch.gather(ck, 1, idx)[:, 0])

    def _state_tensors(self) -> List[torch.Tensor]:
        return [t for _, e in self._state for t in e.values()]

    def _eager(self) -> bool:
        """Whether the bodies run as they are rather than as graphs: on the
        CPU, and on a rank whose plan contracts over a gloo group (its
        collectives cannot be captured). A branch on the group's backend,
        not a fallback: an NCCL group's all-reduces are captured."""
        if self.device.type != "cuda":
            return True
        rules = self._model_rules
        return bool(self.tp is not None and rules.contract_axes
                    and "nccl" not in dist.get_backend(rules.group))

    def _capture(self, body, state) -> tuple:
        """``capture_graph`` of ``body``; on an NCCL rank one eager
        all-reduce over the model group first, so its communicator exists
        before a capture records the body's."""
        rules = self._model_rules
        if self.tp is not None and rules.contract_axes:
            dist.all_reduce(torch.zeros(1, device=self.device),
                            group=rules.group)
        return capture_graph(self.device, body, state)

    def _dispatch(self) -> None:
        """Enqueue one step body: a replay of the captured graph on CUDA
        (captured at the first call), the body itself where ``_eager``."""
        if self._eager():
            self._step_body()
            return
        if self._graph is None:
            self._graph, self._graph_launches = self._capture(
                self._step_body,
                [self.cur_tok, self.pos, self.gen_cnt, self.live_mask,
                 self.pol.idx, self._step_out] + self._state_tensors())
            self.step_traces += 1
        self._graph.replay()
        ops.add_launch_counts(self._graph_launches)

    def _dispatch_spec(self) -> None:
        """Enqueue one verify body: a replay of the second captured graph
        on CUDA, the body itself where ``_eager``."""
        if self._eager():
            self._spec_body()
            return
        if self._spec_graph is None:
            self._spec_graph, self._spec_graph_launches = self._capture(
                self._spec_body, (self._spec_out,))
            self.spec_traces += 1
        self._spec_graph.replay()
        ops.add_launch_counts(self._spec_graph_launches)

    def _dispatch_select(self) -> None:
        """Enqueue the rollback select: a replay of the third captured
        graph on CUDA (captured at its first use), the body where
        ``_eager``."""
        self.state_selects += 1
        if self._eager():
            self._select_body()
            return
        if self._select_graph is None:
            self._select_graph, _ = self._capture(
                self._select_body, self._state_tensors())
            self.select_traces += 1
        self._select_graph.replay()

    def _step(self) -> List[Request]:
        """Advance every live slot: one device program, one device->host
        copy. With spec_k > 0 a verify step emitting up to spec_k + 1
        tokens a request; otherwise the plain one-token step. Tops up
        pages first and returns the requests that top-up preempted, for
        the caller to resubmit. (Callers use ``step()``, the mixin's timed
        wrapper.)"""
        tr = self.trace
        if self.tier is not None:
            # the copy stream's visibility point: pending D2H copies are
            # finalized once per decode tick
            with tr.span("tier_drain"):
                self.tier.drain()
        if not self.has_live():
            return []
        if self.spec_k:
            return self._step_speculative()
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
        # a dead slot's block is zeros at its last position, the
        # reference's dead row
        spec_pos = np.asarray(self._pos_host, np.int32)
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
            accept_idx = np.zeros((self.slots,), np.int64)
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
                accept_idx[s] = m - 1         # recurrent state after row m-1
                self._count_tokens(self._policy[s], m)
                self._note_emitted(r.rid, m)
                if finished:
                    self._finish_slot(s)      # frees every page incl. drafts
                    continue
                # rollback: disown whole pages past the accept point and
                # republish their table entries as scratch on the device,
                # in the full and the window table alike
                if self.has_full:
                    dropped = self.alloc.truncate_to(r.rid, pos0 + m)
                    if dropped:
                        keep = len(self.alloc.block_table(r.rid))
                        self.block_table[s, keep:keep + dropped] = \
                            SCRATCH_PAGE
                if self.has_win:
                    wrid = _win_rid(r.rid)
                    dropped = self.alloc.truncate_to(wrid, pos0 + m)
                    if dropped:
                        keep = (self.alloc.base_blocks(wrid)
                                + len(self.alloc.block_table(wrid)))
                        self.win_table[s, keep:keep + dropped] = SCRATCH_PAGE
                self._pos_host[s] = pos0 + m
                upd_slot.append(s)
                upd_pos.append(pos0 + m)
                upd_m.append(m)
                upd_tok.append(r.generated[-1])
            if self._ckpt is not None:
                # the recurrent analogue of the page rollback: each slot's
                # state becomes its accepted row's checkpoint
                self._accept_idx.copy_(torch.from_numpy(accept_idx))
                self._dispatch_select()
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
        """Host-tier telemetry, the same keys with the tier off (zeros)."""
        d: Dict[str, float] = {"host_tier": float(self.tier is not None)}
        d.update(self.tier.stats() if self.tier is not None
                 else HostTier.zero_stats())
        return d

    def shard_stats(self) -> Dict[str, object]:
        """Per-shard telemetry, the reference's four keys. Pages are
        allocated on the host, the same on every rank, so
        ``peak_pages_per_shard`` is the allocator's peak; what tensor
        parallelism divides is each page's bytes: ``pool_bytes_per_shard``
        counts this rank's pools (a sharded pool at 1/m of its bytes) and
        state slots."""
        nbytes = sum(t.numel() * t.element_size()
                     for pool in self.cache for t in pool.values())
        return {"model_shards": float(self.tp.model_shards
                                      if self.tp is not None else 1),
                # "+"-joined, not ","-joined: this string lands in CSV cells
                "sharded_axes": "+".join(sorted(self.tp.sharded_axes))
                if self.tp is not None else "",
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
        """reset_metrics() tail: the engine's own rates, the prefix cache's
        hit counters and the tier's; the allocator's peak rebases to the
        current allocation (the radix tree's and the store's contents
        stay)."""
        self.prefills = 0
        self.prompt_tokens = 0
        self.prefilled_tokens = 0
        self.cow_copies = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_slot_steps = 0
        self.win_recycled_pages = 0
        self.win_peak_live = 0
        self.state_selects = 0
        self.greedy_requests = 0
        self.sampled_requests = 0
        self.greedy_tokens = 0
        self.sampled_tokens = 0
        self.alloc.peak_pages = self.alloc.allocated_pages
        self.alloc.share_events = 0
        if self.prefix is not None:
            self.prefix.reset_hit_counters()
        if self.tier is not None:
            self.tier.reset_counters()

    def check(self) -> None:
        """Pool invariants: the allocator's shared-page-aware check, write
        exclusivity — the page each live request's next token lands in
        must not be shared, or the next step would write over another
        reader's KV — no slot holding more live window pages than
        ``win_pages_bound(max_len)``, and every swapped-out request
        host-resident in the allocator (each of its tables) and in no
        slot."""
        self.alloc.check()
        if self.tier is not None:
            live = {r.rid for r in self.live if r is not None}
            for rid in self.tier.swapped_rids():
                assert rid not in live, f"rid {rid} is live and swapped out"
                if self.has_full:
                    assert self.alloc.host_resident(rid), \
                        f"swapped-out rid {rid} has no host-resident table"
                if self.has_win:
                    assert self.alloc.host_resident(_win_rid(rid)), \
                        f"swapped-out rid {rid} has no host window table"

        for slot, req in enumerate(self.live):
            if req is None:
                continue
            if self.has_full:
                table = self.alloc.block_table(req.rid)
                blk = self._pos_host[slot] // self.page_size
                if blk < len(table):
                    assert self.alloc.ref(table[blk]) == 1, (
                        f"slot {slot}: next-write page {table[blk]} is "
                        f"shared (ref {self.alloc.ref(table[blk])})")
            if self.has_win:
                live = len(self.alloc.block_table(_win_rid(req.rid)))
                bound = self.win_pages_bound(self.max_len)
                assert live <= bound, (
                    f"slot {slot}: {live} live window pages exceed the "
                    f"O(window) bound {bound}: recycling fell behind")


# ===========================================================================
# The engine factory and the dense-slot engine
# ===========================================================================

# the paged engine's feature kwargs and their defaults: what the factory
# drops when it falls back to the dense engine
_PAGED_DEFAULTS = {"page_size": 16, "num_pages": None, "attn_impl": "kernel",
                   "prefix_cache": False, "spec_k": 0, "spec_ngram": 3,
                   "drafter": None, "mesh": None, "host_tier": False}


def _pageable(cfg) -> bool:
    """Whether the paged engine can host the stack: full attention,
    sliding-window attention and recurrent state all can; only an
    encoder-decoder stack falls back to the dense engine."""
    return set(tfm.pattern_for(cfg)) <= set(tfm.SERVABLE_KINDS)


def ServingEngine(cfg, params, **kwargs):
    """Engine factory (the reference's ``ServingEngine``): the paged engine
    for every stack it can host, else ``DenseServingEngine``. The dense
    engine cannot honour the paged feature kwargs: each dropped one whose
    value differs from the paged default is named in a warning; a truthy
    ``spec_k`` and any ``drafter`` raise ``ValueError`` (they change what a
    step returns); kwargs at their defaults drop quietly (launchers pass
    the whole knob set on every call)."""
    if _pageable(cfg):
        return PagedServingEngine(cfg, params, **kwargs)
    pattern = tfm.pattern_for(cfg)
    dropped = []
    for k, default in _PAGED_DEFAULTS.items():
        if k not in kwargs:
            continue
        v = kwargs.pop(k)
        if k == "spec_k" and v:
            raise ValueError(
                f"spec_k={v} requested, but {cfg.name!r} (pattern "
                f"{pattern}) is not servable by the paged engine and the "
                f"dense fallback has no speculative decode — drop spec_k "
                f"or serve a paged-servable stack")
        if k == "drafter" and v is not None:
            raise ValueError(
                f"a drafter was passed, but {cfg.name!r} (pattern "
                f"{pattern}) is not servable by the paged engine and the "
                f"dense fallback has no speculative verify step to feed it "
                f"— drop the drafter or serve a paged-servable stack")
        if v != default:
            dropped.append(f"{k}={v!r}")
    if dropped:
        warnings.warn(
            f"{cfg.name!r} (pattern {pattern}) falls back to "
            f"DenseServingEngine, which ignores the paged-engine kwarg(s) "
            f"{dropped} — the features they configure will NOT be active",
            stacklevel=2)
    return DenseServingEngine(cfg, params, **kwargs)


class DenseServingEngine(ServingMetricsMixin):
    """Fixed-slot batch, the reference's ``DenseServingEngine``: each slot
    owns a dense ``max_len`` lane in every attention layer (a window-sized
    ring in a local_attn layer) and its recurrent state: the "separated
    memory" baseline the paged engine is measured against.

    Admission prefills the prompt alone (B = 1, its exact length: one
    prefill shape a distinct length, ``prefill_traces``) and copies the
    result into the slot's lanes. The decode step is one device program
    over every slot, as the paged engine's: the stack on the dense lanes
    (flash-MHA at one query row a slot, ``kv_valid`` on the device), the
    policy draw and the position bookkeeping, over tensors allocated once;
    on CUDA the first ``step()`` captures it as a CUDA graph and every step
    replays it, on the CPU it runs as it is. One host copy a step (the
    reference syncs once a live slot; the values are the same).

    Dead slots compute what the reference's compute: every row's current
    token becomes the token its row sampled (a dead row's greedy), while
    only live rows advance their position; a lane never used starts at
    position 0, token 0, zero lanes. On an MoE stack a dead row routes and
    takes expert capacity. Requests are done at ``eos_id``, at ``max_new``
    tokens or at position ``max_len - 1``, checked after each decode step
    only (a request's first token never finishes it, as in the
    reference). An encoder-decoder stack cannot be served:
    ``api.prefill`` raises for the missing ``enc_embeds``, as the
    reference's does."""

    def __init__(self, cfg, params, *, slots: int = 4, max_len: int = 256,
                 eos_id: int = -1, temperature: float = 0.0, seed: int = 0,
                 sampling: Optional[SamplingParams] = None,
                 tracer: Optional[Tracer] = None, device="cuda"):
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine on {self.device}")
        self.cfg, self.params = cfg, params
        self.slots, self.max_len, self.eos_id = slots, max_len, eos_id
        self.default_params = (
            sampling if sampling is not None
            else SamplingParams(temperature=temperature)).validate()
        self.temperature = self.default_params.temperature
        self.seed = int(seed) & 0x7FFFFFFF
        self._init_metrics(tracer)
        self.cache = api.cache_init(cfg, slots, max_len, device=self.device)
        self._state = [t for e, k in zip(self.cache, tfm.layer_kinds(cfg))
                       if k in api.STATE_KINDS for t in e.values()]
        dev = self.device
        # device-side slot state, allocated once: the step body reads and
        # advances it in place (a captured graph holds these addresses)
        self.pos = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self.cur_tok = torch.zeros((slots, 1), dtype=torch.int64, device=dev)
        self.live_mask = torch.zeros((slots,), dtype=torch.bool, device=dev)
        self.pol = PolicyBuffers(slots, dev)          # dead rows: greedy
        self._step_out = torch.zeros((slots,), dtype=torch.int64, device=dev)
        self.last_logits: Optional[torch.Tensor] = None
        self.live: List[Optional[Request]] = [None] * slots
        self._policy: List[Optional[SamplingParams]] = [None] * slots
        self._pos_host = [0] * slots
        self._seen_lengths: set = set()
        self.prefills = 0
        self.prompt_tokens = 0
        self.prefilled_tokens = 0     # == prompt_tokens (no sharing here)
        self.greedy_requests = 0
        self.sampled_requests = 0
        self.greedy_tokens = 0
        self.sampled_tokens = 0
        # captures of the decode graph (1 on the card once used, 0 on the
        # CPU); the dense engine has no verify step
        self.step_traces = 0
        self.spec_traces = 0
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._graph_launches: Dict[str, int] = {}

    @property
    def prefill_traces(self) -> int:
        """Distinct prompt lengths prefilled (the reference retraces its
        prefill for each)."""
        return len(self._seen_lengths)

    def _submit(self, req: Request) -> bool:
        """Prefill ``req`` (its prompt, at its exact length) and install it
        into a free slot. False if no slot is free. A prompt of max_len - 1
        tokens or more, or a request with no budget left, is done at once
        with what it has: the paged engine's guard, so that both engines
        serve the same requests."""
        slot = self._free_slot()
        if slot is None:
            return False
        if (len(req.prompt) >= self.max_len - 1
                or req.max_new - len(req.generated) <= 0):
            req.done = True
            self._note_finished(req.rid)
            return True
        L = len(req.prompt)
        self._seen_lengths.add(L)
        dev = self.device
        pol_req = request_params(req, self.default_params)
        pol1 = policy_operands([pol_req], [req.rid], [len(req.generated)],
                               self.seed, dev)
        tr = self.trace
        with tr.span("prefill_dispatch", args={"len": L} if tr else None):
            toks = torch.tensor([req.prompt], dtype=torch.int64, device=dev)
            logits, cache1, _ = api.prefill(self.cfg, self.params, toks,
                                            max_len=self.max_len)
            tok = sample_rows(logits[:, : self.cfg.vocab], pol1)[0]
            # the B = 1 lanes into slot ``slot``: every lane row, so nothing
            # of the slot's previous request survives
            for lanes, one in zip(self.cache, cache1):
                for name, t in lanes.items():
                    t[slot].copy_(one[name][0])
        self.pos[slot] = L
        self.cur_tok[slot, 0] = tok
        self.live_mask[slot] = True
        # repro-lint: disable=host-sync — admission reads its first token
        t = int(tok.item())
        first = req.rid not in self.first_token_at
        req.generated.append(t)
        self.pol.set_slot(slot, pol_req, req.rid, len(req.generated),
                          self.seed)
        self._policy[slot] = pol_req
        self._pos_host[slot] = L
        self.live[slot] = req
        if first:
            if pol_req.is_greedy:
                self.greedy_requests += 1
            else:
                self.sampled_requests += 1
        self._count_tokens(pol_req, 1)
        self.prefills += 1
        self.prompt_tokens += L
        self.prefilled_tokens += L
        self._note_emitted(req.rid)
        return True

    def _step_body(self) -> None:
        """One decode step on the device: the stack over every slot's lanes,
        the policy draw, then every row's current token becomes its draw
        and live rows advance their position and draw index, in place, on
        tensors the constructor allocated (so a CUDA graph of it stays
        valid). ``last_logits`` is the step's (slots, Vp) logits."""
        logits, _ = api.decode_step(self.cfg, self.params, self.cache,
                                    self.cur_tok, self.pos)
        toks = sample_rows(logits[:, : self.cfg.vocab], self.pol)
        livei = self.live_mask.to(torch.int32)
        self.pos.add_(livei)
        self.cur_tok.copy_(toks[:, None])
        self.pol.idx.add_(livei)
        self._step_out.copy_(toks)
        self.last_logits = logits

    def _dispatch(self) -> None:
        """Enqueue one step body: a replay of the captured graph on CUDA
        (captured at the first call), the body itself on the CPU."""
        if self.device.type != "cuda":
            self._step_body()
            return
        if self._graph is None:
            self._graph, self._graph_launches = capture_graph(
                self.device, self._step_body,
                [self.cur_tok, self.pos, self.pol.idx, self._step_out]
                + self._state)
            self.step_traces += 1
        self._graph.replay()
        ops.add_launch_counts(self._graph_launches)

    def _step(self) -> List[Request]:
        """Advance every live slot one token: one device program, one
        device->host copy. Returns [] (lanes are reserved: nothing is ever
        preempted). Callers use ``step()``, the mixin's timed wrapper."""
        if not self.has_live():
            return []
        tr = self.trace
        t0 = time.perf_counter()
        with tr.span("device_dispatch"):
            self._dispatch()
        with tr.span("host_sync"):
            # repro-lint: disable=host-sync — the step's one host copy
            host = self._step_out.cpu().numpy()
        self.step_wall_s += time.perf_counter() - t0
        self.decode_steps += 1
        for i, r in enumerate(self.live):
            if r is None:
                continue
            t = int(host[i])
            r.generated.append(t)
            self._pos_host[i] += 1
            self.decoded_tokens += 1
            self._count_tokens(self._policy[i], 1)
            self._note_emitted(r.rid)
            if (t == self.eos_id or len(r.generated) >= r.max_new
                    or self._pos_host[i] >= self.max_len - 1):
                r.done = True
                self.live[i] = None
                self._policy[i] = None
                self.live_mask[i] = False
                self.pol.clear_slot(i)
                self._note_finished(r.rid)
        return []

    # -- stats: the paged key sets, zero-filled ------------------------------

    def pool_stats(self) -> PoolStats:
        """No pool: zeros under the paged keys, and ``dense_equiv_tokens``
        the reservation a pool is measured against."""
        return PoolStats(page_size=0, num_pages=0, allocated_pages=0,
                         peak_pages=0, live_tokens=0, utilization=0.0,
                         dense_equiv_tokens=self.slots * self.max_len)

    def spec_stats(self) -> Dict[str, object]:
        return {"spec_k": 0.0, "spec_drafted": 0.0, "spec_accepted": 0.0,
                "accept_rate": 0.0, "accepted_per_step": 1.0,
                "drafter": "none"}

    def sampling_stats(self) -> Dict[str, float]:
        return {"greedy_requests": float(self.greedy_requests),
                "sampled_requests": float(self.sampled_requests),
                "greedy_tokens": float(self.greedy_tokens),
                "sampled_tokens": float(self.sampled_tokens),
                "step_traces": float(self.step_traces),
                "spec_traces": float(self.spec_traces),
                "draft_proposed": 0.0, "draft_ingested_tokens": 0.0,
                "draft_decode_calls": 0.0, "draft_pool_rejects": 0.0}

    def prefix_stats(self) -> Dict[str, float]:
        d = {"prompt_tokens": float(self.prompt_tokens),
             "prefilled_tokens": float(self.prefilled_tokens),
             "prefill_tokens_saved": 0.0, "prefill_saved_frac": 0.0,
             "cow_copies": 0.0}
        d.update(PrefixCache.zero_stats())
        return d

    def tier_stats(self) -> Dict[str, float]:
        d: Dict[str, float] = {"host_tier": 0.0}
        d.update(HostTier.zero_stats())
        return d

    def shard_stats(self) -> Dict[str, object]:
        """``pool_bytes_per_shard``: every lane's and state's bytes."""
        nbytes = sum(t.numel() * t.element_size()
                     for e in self.cache for t in e.values())
        return {"model_shards": 1.0, "sharded_axes": "",
                "peak_pages_per_shard": 0.0,
                "pool_bytes_per_shard": float(nbytes)}

    def _reset_subsystem_counters(self) -> None:
        self.prefills = 0
        self.prompt_tokens = 0
        self.prefilled_tokens = 0
        self.greedy_requests = 0
        self.sampled_requests = 0
        self.greedy_tokens = 0
        self.sampled_tokens = 0
