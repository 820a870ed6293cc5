"""Serving benchmark of the port: the reference's scenarios
(``benchmarks/serve_bench.py``) that the port has, through the paged engine.

  PYTHONPATH=src python -m repro_torch.launch.serve_bench [--arch ARCH] \
      [--scenario mixed|shared-prefix|speculative|sampling|hybrid|
                  sharded|oversubscribe|all] \
      [--smoke | --full] [--layers N] [--dtype float32|bfloat16] \
      [--slots 4] [--max-len 128] [--requests 12] [--max-new 8] \
      [--sys-len 48] [--spec-k 4] [--window W] [--seed 0] \
      [--trace-out trace.json] [--device cuda|cpu] [--cpu-shards 4]

``mixed``: a mixed-length trace (prompt i holds 3 + 5 i tokens drawn from a
``random.Random(seed)``, the reference's ``_trace``) is replayed through
``DenseServingEngine`` (one ``max_len`` lane a slot, the "separated
memory" baseline), ``PagedServingEngine(attn_impl="gather")`` (the dense
``pool[block_table]`` gather baseline) and
``PagedServingEngine(attn_impl="kernel")`` (flash-decode through the block
tables). Each engine is warmed first over the trace's prompt lengths with
two new tokens (every prefill shape runs, the decode graph is captured),
then ``reset_metrics``, then timed. The CSV has the reference's columns
(``decode_tok_s`` = decoded tokens / decode-step wall, ``trace_tok_s``,
TTFT / TPOT percentiles, ``temporal_util``, ``prefill_traces``,
``peak_kv_tokens``, ``kv_util_vs_dense``, ``attn_peak_live_bytes``) and the
``kernel/gather`` and ``kernel/dense`` ratio rows.

``shared-prefix``: every request is one ``--sys-len``-token system prompt
plus a short tail; the engine without and with ``prefix_cache``, their
prefill tokens, hit rate, shared-token share and CoW copies, and the
``prefix/noshare`` ratio row. ``speculative``: a templated trace (a
repeated motif behind a per-request salt, what n-gram drafting feeds on);
the T = 1 engine and ``spec_k`` n-gram drafts, their decode steps and
acceptance, and the ``spec{k}/T=1`` ratio row. ``sampling``: the templated
trace through three greedy engines (T = 1, n-gram spec, self-drafting
model spec) whose tokens must be identical (``tokens_match_greedy``),
then the same three sampled (temperature 0.9, top-p 0.95), with their
sampled tokens and graph captures. ``hybrid``: the reference's hybrid-stack
trace (prompts of window / 2 + (5 i mod 2 window) tokens, on both sides of
the attention window) through recurrentgemma-9b (its SMOKE config, or with
``--full`` the full-width one): the dense engine's ``dense[hybrid]`` row
(window rings and state slots), gather and kernel rows with
``win_recycled_pages``, ``win_page_bound`` and ``peak_kv_tokens``, the
``paged/dense[hybrid]`` ratio row, and ``tokens_match_hybrid`` (the three
engines' greedy tokens equal, at fp32; empty in bf16, where the gather
path rounds P to bf16 and the kernels do not). ``oversubscribe``: the
mixed trace (a decode tail of at least 24 tokens) through an uncapped
engine, then through engines whose pool is capped at 0.4 of the trace's
worst-case footprint (``_pool_cap``), evict-only (resume by re-prefill) and
with ``host_tier`` (resume by swap-in), for both attention impls; every
capped row must emit the uncapped tokens (``tokens_match_unconstrained``),
``reprefill_tokens`` counts the prefill the capped row spent again and
``reprefill_tokens_saved`` what the tier did not, beside the tier's
counters; then a prefix-cache pair (the shared-prefix trace: idle nodes
demote, hits promote) and a hybrid pair (recurrentgemma, whose state swaps
with its window pages). ``sharded``: the mixed trace through the
``paged[kernel]`` engine at 1, 2 and 4 tensor-parallel shards, each count
a world of its own (``launch.mesh.run_world``: NCCL over the visible CUDA
devices, one a rank; with ``--device cpu`` gloo over ``--cpu-shards``
CPU ranks); 1 shard is the engine without a mesh, the baseline whose
greedy tokens every sharded row must emit (``tokens_match_tp1``, from
rank 0; every rank's tokens must agree too). Per-shard columns come from
``shard_stats()``: ``model_shards``, ``sharded_axes``,
``peak_pages_per_shard`` (the allocator's peak: pages are allocated on the
host, the same on every rank) and ``pool_bytes_per_shard`` (what tensor
parallelism divides). A shard count beyond the devices becomes a note row
(``skipped``), never a silent drop. ``all`` runs these seven.

The model is the arch's SMOKE config with weights drawn from a generator
seeded with 0, or with ``--full`` its full-width config (on the card);
``--layers`` cuts its depth, ``--window`` the hybrid arch's attention
window (so that a short trace straddles it at full width), and ``--dtype``
sets its dtype and its KV
cache's (an fp32 model over a bf16 cache rounds keys that differ by 1e-6
between two paths to neighbouring bf16 values, which can part greedy
streams at a near tie).
``--smoke`` shrinks the run (2 slots, 4 requests, 24 new tokens; a
24-token system prompt), as the reference's does. Runs on CUDA unless ``--device cpu``; raises without a
CUDA device otherwise. ``--trace-out`` writes every engine's spans as one
Chrome Trace Event JSON. ``repro_torch.launch.check_csv`` gates the CSV.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import random
import sys
import tempfile
import time
from typing import Dict, Iterable, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.launch.mesh import make_host_mesh, run_world, visible_devices
from repro_torch.models import api
from repro_torch.runtime.drafter import DraftModelDrafter
from repro_torch.runtime.sampling import SamplingParams
from repro_torch.runtime.scheduler import Scheduler
from repro_torch.runtime.serving import (DenseServingEngine,
                                         PagedServingEngine, Request)
from repro_torch.runtime.trace import (NULL_TRACER, Tracer,
                                       set_default_tracer)


def _trace(cfg, n_requests: int, max_new: int, seed: int) -> List[Request]:
    """Mixed-length trace: prompt lengths 3, 8, 13, ... (all distinct,
    over several power-of-two buckets), token ids from a seeded
    ``random.Random``: the reference's trace, token for token."""
    rng = random.Random(seed)
    return [Request(rid=i,
                    prompt=[rng.randrange(cfg.vocab)
                            for _ in range(3 + 5 * i)],
                    max_new=max_new)
            for i in range(n_requests)]


def _shared_trace(cfg, n_requests: int, max_new: int, seed: int,
                  sys_len: int) -> List[Request]:
    """Shared-system-prompt trace: the same ``sys_len``-token system prompt
    plus a short per-request tail (the reference's, token for token)."""
    rng = random.Random(seed)
    sys_prompt = [rng.randrange(cfg.vocab) for _ in range(sys_len)]
    return [Request(rid=i,
                    prompt=sys_prompt + [rng.randrange(cfg.vocab)
                                         for _ in range(2 + i % 5)],
                    max_new=max_new)
            for i in range(n_requests)]


def _spec_trace(cfg, n_requests: int, max_new: int, seed: int,
                motif_len: int = 6, reps: int = 4) -> List[Request]:
    """Templated trace: a repeated motif behind a short per-request salt
    (the reference's, token for token)."""
    rng = random.Random(seed)
    motif = [rng.randrange(cfg.vocab) for _ in range(motif_len)]
    return [Request(rid=i,
                    prompt=[rng.randrange(cfg.vocab)
                            for _ in range(i % 3)] + motif * reps,
                    max_new=max_new)
            for i in range(n_requests)]


def _hybrid_trace(cfg, n_requests: int, max_new: int, seed: int,
                  window: int) -> List[Request]:
    """Prompts straddling the attention window (some shorter, most
    longer), so admission, recycling and the window's masking all run in
    the timed replay (the reference's, token for token)."""
    rng = random.Random(seed)
    return [Request(rid=i,
                    prompt=[rng.randrange(cfg.vocab)
                            for _ in range(window // 2
                                           + (5 * i) % (2 * window))],
                    max_new=max_new)
            for i in range(n_requests)]


def _warm(engine, mk_trace) -> None:
    """Replay the trace's prompt lengths with two new tokens (every prefill
    bucket and the decode graph's capture), then zero the telemetry the
    timed replay reports."""
    sched = Scheduler(engine)
    for r in mk_trace(2):
        sched.add(r)
    sched.drain(max_steps=1000)
    engine.reset_metrics()


def _attn_peak_live_bytes(cfg, engine) -> int:
    """Peak live bytes of a layer's decode-attention KV working set, as the
    reference counts them: one K and one V page tile a kernel program (in
    the pool's dtype); else the whole (slots, lane, KV, D) K and V in a
    2-byte activation dtype, the lane being max_len (the gather's table,
    a dense lane), or the window for a dense engine whose attention is all
    sliding-window (its rings)."""
    kv, hd = cfg.kv_heads, cfg.resolved_head_dim
    paged = isinstance(engine, PagedServingEngine)
    if paged and engine.attn_impl == "kernel":
        itemsize = 1 if cfg.kv_cache_dtype == "int8" else 2
        return 2 * engine.page_size * kv * hd * itemsize
    seq = engine.max_len
    if not paged and cfg.hybrid is not None \
            and not set(cfg.hybrid.pattern) & set(api.PAGEABLE_KINDS):
        seq = min(seq, cfg.hybrid.window)
    return 2 * engine.slots * seq * kv * hd * 2


def _drive(engine, reqs: List[Request], max_steps: int, cfg,
           name: Optional[str] = None) -> Dict:
    sched = Scheduler(engine)
    for r in reqs:
        sched.add(r)
    t0 = time.perf_counter()
    sched.drain(max_steps=max_steps, on_exhaust="warn")
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    wall = time.perf_counter() - t0
    done = [r for r in reqs if r.done]
    toks = sum(len(r.generated) for r in done)
    m = engine.metrics()
    st = engine.pool_stats()
    paged = isinstance(engine, PagedServingEngine)
    if name is None:
        name = type(engine).__name__
        if paged:
            name += f"[{engine.attn_impl}]"
    # the dense engine reserves every lane: its peak is the reservation
    peak = st.peak_pages * st.page_size if paged else st.dense_equiv_tokens
    return {
        "engine": name,
        "requests_done": len(done),
        "tokens": toks,
        "wall_s": wall,
        "decode_tok_s": engine.decoded_tokens / engine.step_wall_s
        if engine.step_wall_s else 0.0,
        "trace_tok_s": toks / wall if wall else 0.0,
        "ttft_mean_s": m["latency.ttft_mean_s"],
        "ttft_p50": m["latency.ttft_p50_s"],
        "ttft_p95": m["latency.ttft_p95_s"],
        "tpot_p50": m["latency.tpot_p50_s"],
        "tpot_p95": m["latency.tpot_p95_s"],
        "temporal_util": m["util.temporal"],
        "prefill_traces": engine.prefill_traces,
        "sched_exhausted": int(sched.exhausted),
        "peak_kv_tokens": peak,
        "kv_util_vs_dense": peak / st.dense_equiv_tokens,
        "attn_peak_live_bytes": _attn_peak_live_bytes(cfg, engine),
    }


def _run_mixed(cfg, params, slots, max_len, n_requests, max_new, seed,
               device) -> List[Dict]:
    def mk(new):
        return _trace(cfg, n_requests, new, seed)

    rows = []
    dense = DenseServingEngine(cfg, params, slots=slots, max_len=max_len,
                               device=device)
    _warm(dense, mk)
    rows.append(_drive(dense, mk(max_new), 4000, cfg))
    for impl in ("gather", "kernel"):
        paged = PagedServingEngine(cfg, params, slots=slots,
                                   max_len=max_len, attn_impl=impl,
                                   device=device)
        _warm(paged, mk)
        rows.append(_drive(paged, mk(max_new), 4000, cfg))
    d, g, k = rows

    def ratio_row(name: str, base: Dict) -> Dict:
        """The kernel engine against ``base``: counts as deltas, times and
        bytes as base / kernel speedups or kernel / base footprints."""
        return {
            "engine": name,
            "requests_done": k["requests_done"] - base["requests_done"],
            "tokens": k["tokens"] - base["tokens"],
            "wall_s": base["wall_s"] / k["wall_s"],
            "decode_tok_s": k["decode_tok_s"] / base["decode_tok_s"],
            "trace_tok_s": k["trace_tok_s"] / base["trace_tok_s"],
            "ttft_mean_s": base["ttft_mean_s"] / k["ttft_mean_s"]
            if k["ttft_mean_s"] else 0.0,
            "prefill_traces": k["prefill_traces"] - base["prefill_traces"],
            "peak_kv_tokens": k["peak_kv_tokens"] - base["peak_kv_tokens"],
            "kv_util_vs_dense": k["kv_util_vs_dense"],
            "attn_peak_live_bytes": k["attn_peak_live_bytes"]
            / base["attn_peak_live_bytes"],
        }

    rows.append(ratio_row("kernel/gather", g))
    rows.append(ratio_row("kernel/dense", d))
    return rows


def _run_shared_prefix(cfg, params, slots, max_len, n_requests, max_new,
                       seed, sys_len, device) -> List[Dict]:
    def mk(new):
        return _shared_trace(cfg, n_requests, new, seed, sys_len)

    rows = []
    for share, name in ((False, "paged[kernel,noshare]"),
                        (True, "paged[kernel,prefix]")):
        eng = PagedServingEngine(cfg, params, slots=slots, max_len=max_len,
                                 attn_impl="kernel", prefix_cache=share,
                                 device=device)
        _warm(eng, mk)
        row = _drive(eng, mk(max_new), 4000, cfg, name=name)
        ps = eng.prefix_stats()
        row["prefill_tokens"] = int(ps["prefilled_tokens"])
        row["prefill_saved_frac"] = ps["prefill_saved_frac"]
        row["prefix_hit_rate"] = ps.get("hit_rate", 0.0)
        row["shared_token_frac"] = ps.get("shared_token_frac", 0.0)
        row["cow_copies"] = int(ps["cow_copies"])
        rows.append(row)
    base, pref = rows
    rows.append({
        "engine": "prefix/noshare",
        "requests_done": pref["requests_done"] - base["requests_done"],
        "tokens": pref["tokens"] - base["tokens"],
        "wall_s": base["wall_s"] / pref["wall_s"] if pref["wall_s"] else 0.0,
        "trace_tok_s": pref["trace_tok_s"] / base["trace_tok_s"]
        if base["trace_tok_s"] else 0.0,
        "ttft_mean_s": base["ttft_mean_s"] / pref["ttft_mean_s"]
        if pref["ttft_mean_s"] else 0.0,
        "prefill_tokens": pref["prefill_tokens"] - base["prefill_tokens"],
        "prefill_saved_frac": 1.0 - (pref["prefill_tokens"]
                                     / base["prefill_tokens"])
        if base["prefill_tokens"] else 0.0,
        "peak_kv_tokens": pref["peak_kv_tokens"] - base["peak_kv_tokens"],
        "kv_util_vs_dense": pref["kv_util_vs_dense"],
        "prefix_hit_rate": pref["prefix_hit_rate"],
        "shared_token_frac": pref["shared_token_frac"],
    })
    return rows


def _run_speculative(cfg, params, slots, max_len, n_requests, max_new,
                     seed, spec_k, device) -> List[Dict]:
    def mk(new):
        return _spec_trace(cfg, n_requests, new, seed)

    rows = []
    for k, name in ((0, "paged[kernel,T=1]"),
                    (spec_k, f"paged[kernel,spec{spec_k}]")):
        eng = PagedServingEngine(cfg, params, slots=slots, max_len=max_len,
                                 attn_impl="kernel", spec_k=k, device=device)
        _warm(eng, mk)
        row = _drive(eng, mk(max_new), 4000, cfg, name=name)
        ss = eng.spec_stats()
        row["decode_steps"] = eng.decode_steps
        row["accepted_per_step"] = ss["accepted_per_step"]
        row["accept_rate"] = ss["accept_rate"]
        row["spec_drafted"] = int(ss["spec_drafted"])
        row["spec_accepted"] = int(ss["spec_accepted"])
        rows.append(row)
    base, spec = rows
    rows.append({
        "engine": f"spec{spec_k}/T=1",
        "requests_done": spec["requests_done"] - base["requests_done"],
        "tokens": spec["tokens"] - base["tokens"],
        "wall_s": base["wall_s"] / spec["wall_s"] if spec["wall_s"] else 0.0,
        "decode_tok_s": spec["decode_tok_s"] / base["decode_tok_s"]
        if base["decode_tok_s"] else 0.0,
        "trace_tok_s": spec["trace_tok_s"] / base["trace_tok_s"]
        if base["trace_tok_s"] else 0.0,
        "decode_steps": spec["decode_steps"] - base["decode_steps"],
        "accepted_per_step": spec["accepted_per_step"],
        "accept_rate": spec["accept_rate"],
    })
    return rows


def _run_sampling(cfg, params, slots, max_len, n_requests, max_new,
                  seed, spec_k, device) -> List[Dict]:
    """Three greedy engines (T = 1, n-gram spec, self-drafting model spec)
    that must emit identical tokens (``tokens_match_greedy``), then the
    same three under a sampled policy (temperature 0.9, top-p 0.95), whose
    claim is acceptance at an unchanged distribution (the match cell stays
    empty: token equality is not the sampled contract)."""
    sampled = SamplingParams(temperature=0.9, top_p=0.95, seed=seed)

    def mk(new, pol=None):
        reqs = _spec_trace(cfg, n_requests, new, seed)
        for r in reqs:
            r.params = pol
        return reqs

    def draft():
        # self-draft: the target model doubles as the draft model
        return DraftModelDrafter(cfg, params, max_len=max_len, device=device)

    rows: List[Dict] = []
    greedy_toks = None
    for name, kw, pol in (
            ("paged[kernel,greedy]", {}, None),
            (f"paged[kernel,spec{spec_k},greedy]", {"spec_k": spec_k},
             None),
            (f"paged[kernel,draft{spec_k},greedy]",
             {"spec_k": spec_k, "drafter": draft()}, None),
            ("paged[kernel,sampled]", {}, sampled),
            (f"paged[kernel,spec{spec_k},sampled]", {"spec_k": spec_k},
             sampled),
            (f"paged[kernel,draft{spec_k},sampled]",
             {"spec_k": spec_k, "drafter": draft()}, sampled)):
        eng = PagedServingEngine(cfg, params, slots=slots, max_len=max_len,
                                 attn_impl="kernel", device=device, **kw)
        _warm(eng, lambda n, _p=pol: mk(n, _p))
        reqs = mk(max_new, pol)
        row = _drive(eng, reqs, 4000, cfg, name=name)
        m = eng.metrics()
        row["sampled_tokens"] = int(m["sampling.sampled_tokens"])
        # one capture of each graph, whatever the policy mix
        row["step_traces"] = int(m["sampling.step_traces"])
        row["spec_traces"] = int(m["sampling.spec_traces"])
        if kw.get("spec_k"):
            ss = eng.spec_stats()
            row["accept_rate"] = ss["accept_rate"]
            row["accepted_per_step"] = ss["accepted_per_step"]
            row["drafter_kind"] = ss["drafter"]
        if pol is None:
            toks = [list(r.generated) for r in reqs]
            if greedy_toks is None:
                greedy_toks = toks
            row["tokens_match_greedy"] = int(toks == greedy_toks)
        rows.append(row)
    return rows


def _run_hybrid(cfg, params, slots, max_len, n_requests, max_new, seed,
                device) -> List[Dict]:
    """The hybrid stack's dense, gather and kernel rows and the
    ``paged/dense[hybrid]`` ratio (the reference's ``_run_hybrid``)."""
    window = cfg.hybrid.window

    def mk(new):
        return _hybrid_trace(cfg, n_requests, new, seed, window)

    rows: List[Dict] = []
    toks = []
    dense = DenseServingEngine(cfg, params, slots=slots, max_len=max_len,
                               device=device)
    _warm(dense, mk)
    reqs = mk(max_new)
    rows.append(_drive(dense, reqs, 4000, cfg, name="dense[hybrid]"))
    toks.append([list(r.generated) for r in reqs])
    for impl in ("gather", "kernel"):
        paged = PagedServingEngine(cfg, params, slots=slots,
                                   max_len=max_len, attn_impl=impl,
                                   device=device)
        _warm(paged, mk)
        reqs = mk(max_new)
        row = _drive(paged, reqs, 4000, cfg, name=f"paged[{impl},hybrid]")
        row["win_recycled_pages"] = paged.win_recycled_pages
        row["win_page_bound"] = paged.win_pages_bound(max_len)
        rows.append(row)
        toks.append([list(r.generated) for r in reqs])
    # at fp32 the three rows are one function (sums in another order): their
    # greedy tokens must match; in bf16 the gather path rounds P to bf16
    # before P V and the kernels do not, so a near tie may part them and
    # the cell stays empty (not a claim there)
    if cfg.dtype == "float32":
        for row in rows:
            row["tokens_match_hybrid"] = int(toks[0] == toks[1] == toks[2])
    d, k = rows[0], rows[2]
    rows.append({
        "engine": "paged/dense[hybrid]",
        "requests_done": k["requests_done"] - d["requests_done"],
        "tokens": k["tokens"] - d["tokens"],
        "wall_s": d["wall_s"] / k["wall_s"] if k["wall_s"] else 0.0,
        "decode_tok_s": k["decode_tok_s"] / d["decode_tok_s"]
        if d["decode_tok_s"] else 0.0,
        "trace_tok_s": k["trace_tok_s"] / d["trace_tok_s"]
        if d["trace_tok_s"] else 0.0,
        # the headline: peak physical KV, O(window)-recycled pages against
        # the dense engine's slots * max_len reservation
        "peak_kv_tokens": k["peak_kv_tokens"] - d["peak_kv_tokens"],
        "kv_util_vs_dense": k["kv_util_vs_dense"],
        "win_recycled_pages": k["win_recycled_pages"],
        "win_page_bound": k["win_page_bound"],
    })
    return rows


def _sharded_rank(rank: int, spec: Dict, shards: int):
    """One rank of the sharded scenario's world of ``shards``: the model
    (from ``spec``, the ``run`` arguments that make it), the mixed trace
    through the kernel engine on this rank's part of a ``shards``-wide
    mesh (none at 1 shard), warmed then timed. Returns (rank's row, its
    greedy tokens)."""
    cpu = spec["device"] == "cpu"
    device = torch.device("cpu") if cpu else torch.device("cuda", rank)
    if not cpu:
        torch.cuda.set_device(device)
    cfg, params = _model(spec["arch"], spec, device)
    mesh = make_host_mesh(shards, devices=["cpu"] * shards if cpu
                          else visible_devices()[:shards]) \
        if shards > 1 else None

    def mk(new):
        return _trace(cfg, spec["n_requests"], new, spec["seed"])

    eng = PagedServingEngine(cfg, params, slots=spec["slots"],
                             max_len=spec["max_len"], attn_impl="kernel",
                             mesh=mesh, device=device)
    _warm(eng, mk)
    reqs = mk(spec["max_new"])
    row = _drive(eng, reqs, 4000, cfg, name=f"paged[kernel,tp{shards}]")
    st = eng.shard_stats()
    row["model_shards"] = int(st["model_shards"])
    row["sharded_axes"] = st["sharded_axes"] or "-"
    row["peak_pages_per_shard"] = int(st["peak_pages_per_shard"])
    row["pool_bytes_per_shard"] = int(st["pool_bytes_per_shard"])
    return row, [r.generated for r in reqs]


def _run_sharded(spec: Dict, n_dev: int) -> List[Dict]:
    """Tensor-parallel rows at 1, 2 and 4 shards (the reference's
    ``_run_sharded``), each count a world of spawned ranks; counts beyond
    ``n_dev`` devices are note rows."""
    backend = "gloo" if spec["device"] == "cpu" else "nccl"
    rows: List[Dict] = []
    baseline = None
    for s in (1, 2, 4):
        if s > n_dev:
            rows.append({"engine": f"paged[kernel,tp{s}]",
                         "model_shards": s, "skipped":
                         f"needs {s} devices, have {n_dev}"})
            continue
        with tempfile.TemporaryDirectory() as tmp:
            out = run_world(_sharded_rank, s, backend=backend,
                            init_file=os.path.join(tmp, "rendezvous"),
                            args=(spec, s))
        row, toks = out[0]
        if baseline is None:
            baseline = toks
        # every shard count must emit the single-shard tokens, on every
        # rank: a row that did not is a fault, and the CSV says so
        row["tokens_match_tp1"] = int(all(t == baseline for _, t in out))
        rows.append(row)
    return rows


def _pool_cap(reqs: List[Request], max_len: int, page_size: int,
              frac: float = 0.4) -> int:
    """Device-pool cap (in pages) of the oversubscribe scenario: ``frac``
    of the trace's worst-case KV footprint, floored one page above the
    largest request (below that the engine rejects the request as
    infeasible rather than thrashing). The reference's."""
    need = [-(-min(len(r.prompt) + r.max_new, max_len) // page_size)
            for r in reqs]
    return max(int(sum(need) * frac), max(need) + 1)


def _run_oversubscribe(cfg, params, hybrid, slots, max_len, n_requests,
                       max_new, seed, sys_len, device) -> List[Dict]:
    """The working set far above the device pool (the reference's
    ``_run_oversubscribe``): uncapped, evict@cap and tiered@cap rows per
    attention impl, the prefix-cache pair and the hybrid pair (``hybrid``
    = (cfg, params) of recurrentgemma). A capped row may change when tokens
    are computed, never which (``tokens_match_unconstrained``)."""
    rows: List[Dict] = []

    def mk(new):
        return _trace(cfg, n_requests, new, seed)

    def engine(c, p, **kw):
        return PagedServingEngine(c, p, slots=slots, max_len=max_len,
                                  device=device, **kw)

    def capped(eng, c, mk_trace, new, name, cap, base_toks):
        _warm(eng, mk_trace)
        reqs = mk_trace(new)
        row = _drive(eng, reqs, 8000, c, name=name)
        row["pool_pages"] = cap
        row["preemptions"] = sum(r.preemptions for r in reqs)
        row["tokens_match_unconstrained"] = \
            int([list(r.generated) for r in reqs] == base_toks)
        return row

    def uncapped(eng, c, mk_trace, new, name):
        _warm(eng, mk_trace)
        reqs = mk_trace(new)
        row = _drive(eng, reqs, 8000, c, name=name)
        row["pool_pages"] = eng.alloc.num_pages
        return row, [list(r.generated) for r in reqs], eng.prefilled_tokens

    for impl in ("gather", "kernel"):
        base = engine(cfg, params, attn_impl=impl)
        cap = _pool_cap(mk(max_new), max_len, base.page_size)
        row, base_toks, base_prefilled = uncapped(
            base, cfg, mk, max_new, f"paged[{impl},uncapped]")
        rows.append(row)
        evict_reprefill = 0
        for tier, name in ((False, f"paged[{impl},evict@cap]"),
                           (True, f"paged[{impl},tiered@cap]")):
            eng = engine(cfg, params, attn_impl=impl, num_pages=cap,
                         host_tier=tier)
            row = capped(eng, cfg, mk, max_new, name, cap, base_toks)
            # prefill spent again on preemption-resume
            row["reprefill_tokens"] = eng.prefilled_tokens - base_prefilled
            if not tier:
                evict_reprefill = row["reprefill_tokens"]
            else:
                ts = eng.tier_stats()
                row["reprefill_tokens_saved"] = \
                    evict_reprefill - row["reprefill_tokens"]
                for k in ("swap_outs", "swap_ins", "demoted_pages",
                          "promoted_pages", "prefetch_hit_rate",
                          "copy_stall_ticks", "host_bytes_peak"):
                    row[k] = ts[k]
            rows.append(row)

    # prefix-cache pair: idle radix nodes demote before LRU eviction, hits
    # on host nodes promote (prefetched a tick ahead)
    def mk_shared(new):
        return _shared_trace(cfg, n_requests, new, seed, sys_len)

    base = engine(cfg, params, attn_impl="kernel", prefix_cache=True)
    cap = _pool_cap(mk_shared(max_new), max_len, base.page_size)
    row, base_toks, _ = uncapped(base, cfg, mk_shared, max_new,
                                 "paged[kernel,prefix,uncapped]")
    rows.append(row)
    eng = engine(cfg, params, attn_impl="kernel", prefix_cache=True,
                 num_pages=cap, host_tier=True)
    row = capped(eng, cfg, mk_shared, max_new,
                 "paged[kernel,prefix,tiered@cap]", cap, base_toks)
    ts = eng.tier_stats()
    for k in ("cache_demotions", "cache_promotions", "prefetch_hit_rate",
              "copy_stall_ticks", "host_bytes_peak"):
        row[k] = ts[k]
    rows.append(row)

    # hybrid pair: a preempted recurrentgemma request swaps its recurrent
    # state and its window pages
    hcfg, hparams = hybrid
    hn, hnew = max(4, n_requests // 2), max(max_new, 24)

    def mk_hybrid(new):
        return _hybrid_trace(hcfg, hn, new, seed, hcfg.hybrid.window)

    base = engine(hcfg, hparams, attn_impl="gather")
    cap = _pool_cap(mk_hybrid(hnew), max_len, base.page_size)
    row, base_toks, _ = uncapped(base, hcfg, mk_hybrid, hnew,
                                 "paged[hybrid,uncapped]")
    rows.append(row)
    eng = engine(hcfg, hparams, attn_impl="gather", num_pages=cap,
                 host_tier=True)
    row = capped(eng, hcfg, mk_hybrid, hnew, "paged[hybrid,tiered@cap]",
                 cap, base_toks)
    ts = eng.tier_stats()
    for k in ("swap_outs", "swap_ins", "win_archived_pages",
              "prefetch_hit_rate", "copy_stall_ticks", "host_bytes_peak"):
        row[k] = ts[k]
    rows.append(row)
    return rows


# the reference's scenarios, all ported
SCENARIOS = ("mixed", "shared-prefix", "speculative", "sampling", "hybrid",
             "sharded", "oversubscribe", "all")


def _model(name: str, spec: Dict, device, window=None):
    """The config ``name`` as ``spec`` sizes it (``full``, ``layers``,
    ``dtype``; ``window`` for the hybrid arch) and its weights, drawn on
    ``device`` from a generator seeded with 0."""
    cfg = get_config(name) if spec["full"] else get_smoke_config(name)
    if window is not None:
        cfg = dataclasses.replace(cfg, hybrid=dataclasses.replace(
            cfg.hybrid, window=window))
    if spec["layers"] is not None:
        cfg = dataclasses.replace(cfg, num_layers=spec["layers"])
    if spec["dtype"] is not None:
        cfg = dataclasses.replace(cfg, dtype=spec["dtype"],
                                  kv_cache_dtype=spec["dtype"])
    return cfg, api.init_params(cfg, torch.Generator(device=device)
                                .manual_seed(0), device=device)


def run(arch: str = "qwen2.5-3b", slots: int = 4, max_len: int = 128,
        n_requests: int = 12, max_new: int = 8, smoke: bool = False,
        full: bool = False, seed: int = 0, scenario: str = "all",
        sys_len: int = 48, spec_k: int = 4, layers: Optional[int] = None,
        dtype: Optional[str] = None, trace_out: Optional[str] = None,
        window: Optional[int] = None, device="cuda",
        cpu_shards: int = 4) -> List[Dict]:
    if scenario not in SCENARIOS:
        raise ValueError(f"unknown scenario {scenario!r}: one of "
                         f"{', '.join(SCENARIOS)}")
    device = resolve_device(device)
    if smoke:
        slots, max_len, n_requests, max_new = 2, 128, 4, 24
        sys_len = 24
    spec = dict(arch=arch, full=full, layers=layers, dtype=dtype,
                slots=slots, max_len=max_len, n_requests=n_requests,
                max_new=max_new, seed=seed, device=device.type)

    def model(name, window=None):
        return _model(name, spec, device, window)

    if scenario not in ("hybrid", "sharded"):
        cfg, params = model(arch)
    tracer = Tracer(enabled=True) if trace_out else None
    if tracer is not None:
        set_default_tracer(tracer)
    try:
        rows: List[Dict] = []
        if scenario in ("mixed", "all"):
            rows += _run_mixed(cfg, params, slots, max_len, n_requests,
                               max_new, seed, device)
        if scenario in ("shared-prefix", "all"):
            rows += _run_shared_prefix(cfg, params, slots, max_len,
                                       n_requests, max_new, seed, sys_len,
                                       device)
        if scenario in ("speculative", "all"):
            # a decode-heavy trace: speculation is a decode-tail story
            rows += _run_speculative(cfg, params, slots, max_len,
                                     n_requests, max(max_new, 24), seed,
                                     spec_k, device)
        if scenario in ("sampling", "all"):
            rows += _run_sampling(cfg, params, slots, max_len, n_requests,
                                  max(max_new, 24), seed, spec_k, device)
        if scenario in ("hybrid", "all"):
            # the hybrid stack pins its own arch and a decode tail long
            # enough to slide past the window
            cfg, params = model("recurrentgemma-9b", window)
            rows += _run_hybrid(cfg, params, slots, max_len,
                                max(4, n_requests // 2), max(max_new, 24),
                                seed, device)
        if scenario in ("sharded", "all"):
            rows += _run_sharded(spec, cpu_shards if device.type == "cpu"
                                 else torch.cuda.device_count())
        if scenario in ("oversubscribe", "all"):
            # a preemption story: decode tails long enough that capped
            # pools must preempt mid-generation
            if scenario == "all":
                cfg, params = model(arch)
            rows += _run_oversubscribe(
                cfg, params, model("recurrentgemma-9b", window), slots,
                max_len, n_requests, max(max_new, 24), seed, sys_len,
                device)
        return rows
    finally:
        if tracer is not None:
            set_default_tracer(NULL_TRACER)
            tracer.export(trace_out)
            print(f"# wrote {trace_out}: {len(tracer.events())} events "
                  f"({tracer.dropped_events} dropped)", file=sys.stderr)


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    s = str(v)
    if "," in s or '"' in s or "\n" in s:
        s = '"' + s.replace('"', '""') + '"'
    return s


def emit(rows: Iterable[Dict]) -> str:
    """CSV of ``rows`` under the union of their keys (a copy of
    ``benchmarks.common.emit``)."""
    rows = list(rows)
    if not rows:
        return ""
    keys = list(dict.fromkeys(k for r in rows for k in r))
    return "\n".join([",".join(keys)] + [
        ",".join(_fmt(r.get(k, "")) for k in keys) for r in rows])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b", choices=ARCHS)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0,
                    help="trace seed (same seed -> same trace)")
    ap.add_argument("--scenario", choices=SCENARIOS, default="all",
                    help="the reference's scenario names (hybrid pins "
                         "recurrentgemma-9b; oversubscribe adds it)")
    ap.add_argument("--sys-len", type=int, default=48,
                    help="shared system-prompt length for shared-prefix")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="drafted tokens per verify step")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config's depth to N layers")
    ap.add_argument("--window", type=int, default=None,
                    help="the hybrid scenario's attention window (default: "
                         "the config's)")
    ap.add_argument("--dtype", default=None,
                    choices=["float32", "bfloat16"],
                    help="the model's and its KV cache's dtype (default: "
                         "the config's)")
    size = ap.add_mutually_exclusive_group()
    size.add_argument("--smoke", action="store_true",
                      help="tiny run: 2 slots, 4 requests, 24 new tokens")
    size.add_argument("--full", action="store_true",
                      help="the arch's full-width config, not its SMOKE")
    ap.add_argument("--trace-out", default=None, metavar="TRACE.JSON",
                    help="export a Chrome Trace Event JSON of the run")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a CUDA device) or "
                         "cpu (plain PyTorch versions of the kernels)")
    ap.add_argument("--cpu-shards", type=int, default=4,
                    help="the sharded scenario's devices with --device cpu: "
                         "this many gloo ranks (on CUDA: the visible "
                         "devices)")
    args = ap.parse_args(argv)
    rows = run(args.arch, args.slots, args.max_len, args.requests,
               args.max_new, smoke=args.smoke, full=args.full,
               seed=args.seed, scenario=args.scenario, sys_len=args.sys_len,
               spec_k=args.spec_k, layers=args.layers, dtype=args.dtype,
               trace_out=args.trace_out, window=args.window,
               device=args.device, cpu_shards=args.cpu_shards)
    print(emit(rows))


if __name__ == "__main__":
    main()
