"""Serving benchmark of the port: the reference's scenarios
(``benchmarks/serve_bench.py``) that the port has, through the paged engine.

  PYTHONPATH=src python -m repro_torch.launch.serve_bench [--arch ARCH] \
      [--scenario mixed|shared-prefix|speculative|sampling|all] \
      [--smoke | --full] [--layers N] [--dtype float32|bfloat16] \
      [--slots 4] [--max-len 128] [--requests 12] [--max-new 8] \
      [--sys-len 48] [--spec-k 4] [--seed 0] [--trace-out trace.json] \
      [--device cuda|cpu]

``mixed``: a mixed-length trace (prompt i holds 3 + 5 i tokens drawn from a
``random.Random(seed)``, the reference's ``_trace``) is replayed through
``PagedServingEngine(attn_impl="gather")`` (the dense ``pool[block_table]``
gather baseline) and ``PagedServingEngine(attn_impl="kernel")`` (flash-
decode through the block tables). Each engine is warmed first over the
trace's prompt lengths with two new tokens (every prefill bucket runs, the
decode graph is captured), then ``reset_metrics``, then timed. The CSV has
the reference's columns (``decode_tok_s`` = decoded tokens / decode-step
wall, ``trace_tok_s``, TTFT / TPOT percentiles, ``temporal_util``,
``prefill_traces``, ``peak_kv_tokens``, ``kv_util_vs_dense``,
``attn_peak_live_bytes``) and the ``kernel/gather`` ratio row. The dense
engine's row and the ``kernel/dense`` ratio wait for the port of the dense
engine.

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
sampled tokens and graph captures. ``all`` runs these four; the
reference's hybrid, sharded and oversubscribe scenarios are not ported.

The model is the arch's SMOKE config with weights drawn from a generator
seeded with 0, or with ``--full`` its full-width config (on the card);
``--layers`` cuts its depth and ``--dtype`` sets its dtype and its KV
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
import random
import sys
import time
from typing import Dict, Iterable, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.models import api
from repro_torch.runtime.drafter import DraftModelDrafter
from repro_torch.runtime.sampling import SamplingParams
from repro_torch.runtime.scheduler import Scheduler
from repro_torch.runtime.serving import PagedServingEngine, Request
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
    """Peak live bytes of a layer's decode-attention KV working set: one K
    and one V page tile a kernel program (in the pool's dtype), or the
    gather's whole (slots, max_len, KV, D) K and V in a 2-byte activation
    dtype, as the reference counts them."""
    kv, hd = cfg.kv_heads, cfg.resolved_head_dim
    if engine.attn_impl == "kernel":
        itemsize = 1 if cfg.kv_cache_dtype == "int8" else 2
        return 2 * engine.page_size * kv * hd * itemsize
    return 2 * engine.slots * engine.max_len * kv * hd * 2


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
    return {
        "engine": name or f"{type(engine).__name__}[{engine.attn_impl}]",
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
        "peak_kv_tokens": st.peak_pages * st.page_size,
        "kv_util_vs_dense": (st.peak_pages * st.page_size
                             / st.dense_equiv_tokens),
        "attn_peak_live_bytes": _attn_peak_live_bytes(cfg, engine),
    }


def _run_mixed(cfg, params, slots, max_len, n_requests, max_new, seed,
               device) -> List[Dict]:
    def mk(new):
        return _trace(cfg, n_requests, new, seed)

    rows = []
    for impl in ("gather", "kernel"):
        paged = PagedServingEngine(cfg, params, slots=slots,
                                   max_len=max_len, attn_impl=impl,
                                   device=device)
        _warm(paged, mk)
        rows.append(_drive(paged, mk(max_new), 4000, cfg))
    g, k = rows
    rows.append({
        "engine": "kernel/gather",
        "requests_done": k["requests_done"] - g["requests_done"],
        "tokens": k["tokens"] - g["tokens"],
        "wall_s": g["wall_s"] / k["wall_s"],
        "decode_tok_s": k["decode_tok_s"] / g["decode_tok_s"],
        "trace_tok_s": k["trace_tok_s"] / g["trace_tok_s"],
        "ttft_mean_s": g["ttft_mean_s"] / k["ttft_mean_s"]
        if k["ttft_mean_s"] else 0.0,
        "prefill_traces": k["prefill_traces"] - g["prefill_traces"],
        "peak_kv_tokens": k["peak_kv_tokens"] - g["peak_kv_tokens"],
        "kv_util_vs_dense": k["kv_util_vs_dense"],
        "attn_peak_live_bytes": k["attn_peak_live_bytes"]
        / g["attn_peak_live_bytes"],
    })
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


# the reference's scenarios; those the port has
SCENARIOS = ("mixed", "shared-prefix", "speculative", "sampling", "hybrid",
             "sharded", "oversubscribe", "all")
PORTED = ("mixed", "shared-prefix", "speculative", "sampling", "all")


def run(arch: str = "qwen2.5-3b", slots: int = 4, max_len: int = 128,
        n_requests: int = 12, max_new: int = 8, smoke: bool = False,
        full: bool = False, seed: int = 0, scenario: str = "all",
        sys_len: int = 48, spec_k: int = 4, layers: Optional[int] = None,
        dtype: Optional[str] = None, trace_out: Optional[str] = None,
        device="cuda") -> List[Dict]:
    if scenario not in PORTED:
        raise ValueError(f"scenario {scenario!r} is not ported (the port "
                         f"has {', '.join(PORTED)})")
    device = resolve_device(device)
    if smoke:
        slots, max_len, n_requests, max_new = 2, 128, 4, 24
        sys_len = 24
    cfg = get_config(arch) if full else get_smoke_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype, kv_cache_dtype=dtype)
    params = api.init_params(cfg, torch.Generator(device=device)
                             .manual_seed(0), device=device)
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
                    help="the reference's scenario names; hybrid, sharded "
                         "and oversubscribe are not ported and raise")
    ap.add_argument("--sys-len", type=int, default=48,
                    help="shared system-prompt length for shared-prefix")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="drafted tokens per verify step")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config's depth to N layers")
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
    args = ap.parse_args(argv)
    rows = run(args.arch, args.slots, args.max_len, args.requests,
               args.max_new, smoke=args.smoke, full=args.full,
               seed=args.seed, scenario=args.scenario, sys_len=args.sys_len,
               spec_k=args.spec_k, layers=args.layers, dtype=args.dtype,
               trace_out=args.trace_out, device=args.device)
    print(emit(rows))


if __name__ == "__main__":
    main()
