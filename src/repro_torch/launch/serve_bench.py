"""Serving benchmark of the port: the reference's ``mixed`` scenario
(``benchmarks/serve_bench.py``) through the paged engine under both decode
attention impls.

  PYTHONPATH=src python -m repro_torch.launch.serve_bench [--arch ARCH] \
      [--smoke | --full] [--slots 4] [--max-len 128] [--requests 12] \
      [--max-new 8] [--seed 0] [--trace-out trace.json] [--device cuda|cpu]

A mixed-length trace (prompt i holds 3 + 5 i tokens drawn from a
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

The model is the arch's SMOKE config with weights drawn from a generator
seeded with 0, or with ``--full`` its full-width config (on the card).
``--smoke`` shrinks the run (2 slots, 4 requests, 24 new tokens), as the
reference's does. Runs on CUDA unless ``--device cpu``; raises without a
CUDA device otherwise. ``--trace-out`` writes every engine's spans as one
Chrome Trace Event JSON. ``repro_torch.launch.check_csv`` gates the CSV.
"""
from __future__ import annotations

import argparse
import random
import sys
import time
from typing import Dict, Iterable, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.models import api
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


def _drive(engine, reqs: List[Request], max_steps: int, cfg) -> Dict:
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
        "engine": f"{type(engine).__name__}[{engine.attn_impl}]",
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


def run(arch: str = "qwen2.5-3b", slots: int = 4, max_len: int = 128,
        n_requests: int = 12, max_new: int = 8, smoke: bool = False,
        full: bool = False, seed: int = 0,
        trace_out: Optional[str] = None, device="cuda") -> List[Dict]:
    device = resolve_device(device)
    if smoke:
        slots, max_len, n_requests, max_new = 2, 128, 4, 24
    cfg = get_config(arch) if full else get_smoke_config(arch)
    params = api.init_params(cfg, torch.Generator(device=device)
                             .manual_seed(0), device=device)
    tracer = Tracer(enabled=True) if trace_out else None
    if tracer is not None:
        set_default_tracer(tracer)
    try:
        return _run_mixed(cfg, params, slots, max_len, n_requests, max_new,
                          seed, device)
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
               seed=args.seed, trace_out=args.trace_out, device=args.device)
    print(emit(rows))


if __name__ == "__main__":
    main()
