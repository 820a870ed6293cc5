"""Serving launcher of the PyTorch port: batched serving on a GPU.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
      [--smoke] [--slots 4] [--requests 8] [--max-new 12] [--max-len 128] \
      [--temperature 0.8 --top-k 20 --top-p 0.95] [--prefix-cache] \
      [--spec-k 3 [--draft-model ARCH]] [--host-tier] \
      [--engine auto|paged|dense] [--page-size 16] [--num-pages N] \
      [--paged-attn kernel|gather] [--trace [trace.json]] \
      [--device cuda|cpu]

``--engine``: ``auto`` (the default) goes through the ``ServingEngine``
factory (the paged engine for every stack it can host, the dense-slot
engine otherwise, with a warning naming the paged knobs it drops);
``paged`` and ``dense`` force one. Weights are drawn on the device from a
generator seeded with 0 (a draft model's, smoke-sized, with 1). Runs on
CUDA by default and raises if there is none; ``--device cpu`` runs every
kernel's plain PyTorch version instead. Prints the JAX launcher's summary lines (prefix cache, host tier,
speculative decode, draft model, decode policy, and for the hybrid archs
the sliding window's recycled pages) plus the recurrent state slots' bytes,
each CUDA kernel's launch count and the graphs' captures. ``--trace`` records the engine's and scheduler's spans and
prints the wall time per phase; with a file name it also writes Chrome
Trace Event JSON (open in Perfetto; ``python -m repro_torch.runtime.trace
FILE`` validates it).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.models import api
from repro_torch.models import transformer as tfm
from repro_torch.runtime.drafter import DraftModelDrafter
from repro_torch.runtime.sampling import SamplingParams
from repro_torch.runtime.serving import (DenseServingEngine,
                                         PagedServingEngine, Request,
                                         ServingEngine)
from repro_torch.runtime.trace import Tracer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCHS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="decode policy: 0 = greedy (default), > 0 samples "
                         "(works with --spec-k: rejection-sampled "
                         "verification)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="keep only the K highest logits before sampling "
                         "(0 = off)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling: keep the smallest logit prefix "
                         "with cumulative mass >= P (1.0 = off)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share KV pages across requests with a common "
                         "prompt prefix (radix tree, refcounted "
                         "copy-on-write pages)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decode: verify up to K drafted tokens "
                         "a step (exact greedy at temperature 0)")
    ap.add_argument("--draft-model", default=None, metavar="ARCH",
                    help="draft with a second model (smoke-sized) instead "
                         "of n-gram prompt lookup; needs --spec-k > 0")
    ap.add_argument("--host-tier", action="store_true",
                    help="two-tier KV: demote idle and preempted pages (and "
                         "recurrent state) to pinned host RAM and bring "
                         "them back through a prefetch stream instead of "
                         "evict + re-prefill")
    ap.add_argument("--engine", choices=["auto", "paged", "dense"],
                    default="auto",
                    help="auto: the ServingEngine factory; paged or dense "
                         "force one engine")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=None,
                    help="usable KV pages (default: slots*max_len/page)")
    ap.add_argument("--paged-attn", choices=["kernel", "gather"],
                    default="kernel",
                    help="paged decode attention: flash-decode through the "
                         "block tables, or the dense pool gather baseline")
    ap.add_argument("--trace", nargs="?", const="", default=None,
                    metavar="TRACE.JSON",
                    help="record per-tick spans and print the per-phase "
                         "wall breakdown; with a file name, also export "
                         "Chrome Trace Event JSON (open in Perfetto)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a CUDA device) or "
                         "cpu (plain PyTorch versions of the kernels)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    print(f"[launch.serve] {cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
          f"{args.slots} slots, device {device}")
    gen = torch.Generator(device=device).manual_seed(0)
    params = api.init_params(cfg, gen, device=device)
    sampling = SamplingParams(temperature=args.temperature,
                              top_k=args.top_k, top_p=args.top_p).validate()
    drafter = None
    if args.draft_model is not None:
        if args.spec_k <= 0:
            raise SystemExit("--draft-model drafts feed the speculative "
                             "verify step — pass --spec-k > 0 with it")
        if args.draft_model not in ARCHS:
            raise SystemExit(f"--draft-model must be one of {ARCHS}")
        dcfg = get_smoke_config(args.draft_model)
        dgen = torch.Generator(device=device).manual_seed(1)
        dparams = api.init_params(dcfg, dgen, device=device)
        drafter = DraftModelDrafter(dcfg, dparams, max_len=args.max_len,
                                    attn_impl=args.paged_attn, device=device)
        print(f"[launch.serve] draft model: {dcfg.name} "
              f"({dcfg.param_count()/1e6:.1f}M params)")
    tracer = Tracer(enabled=True) if args.trace is not None else None
    common = dict(slots=args.slots, max_len=args.max_len, sampling=sampling,
                  tracer=tracer, device=device)
    paged_kw = dict(page_size=args.page_size, num_pages=args.num_pages,
                    attn_impl=args.paged_attn,
                    prefix_cache=args.prefix_cache, spec_k=args.spec_k,
                    drafter=drafter, host_tier=args.host_tier)
    if args.engine == "dense":
        eng = DenseServingEngine(cfg, params, **common)
    else:
        builder = PagedServingEngine if args.engine == "paged" \
            else ServingEngine
        eng = builder(cfg, params, **paged_kw, **common)
    paged = isinstance(eng, PagedServingEngine)
    print(f"[launch.serve] engine: {type(eng).__name__}"
          f"{f'[{eng.attn_impl}]' if paged else ''}")
    # every request opens with the same system prompt, tails vary in length
    sys_prompt = [(5 * j + 2) % cfg.vocab for j in range(2 * args.page_size)]
    reqs = [Request(rid=i,
                    prompt=sys_prompt
                    + [(11 * i + j) % cfg.vocab for j in range(4 + i % 5)],
                    max_new=args.max_new)
            for i in range(args.requests)]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run_to_completion(reqs, max_steps=5000)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    toks = sum(len(r.generated) for r in done)
    m = eng.metrics()
    print(f"[launch.serve] {len(done)}/{len(reqs)} requests, {toks} tokens, "
          f"{toks/dt:.1f} tok/s, {int(m['engine.prefill_traces'])} prefill "
          f"traces")
    st = eng.pool_stats()
    if not paged:
        print(f"[launch.serve] dense lanes: {st.dense_equiv_tokens} tokens "
              f"reserved ({eng.slots} slots x {eng.max_len}), "
              f"{eng.shard_stats()['pool_bytes_per_shard']:.0f} bytes")
        _report_latency_and_launches(cfg, eng, m, tracer, args, device)
        return
    print(f"[launch.serve] kv pages: peak {st.peak_pages}/{st.num_pages} "
          f"({st.peak_pages * st.page_size} tokens reserved at peak vs "
          f"{st.dense_equiv_tokens} dense)")
    if eng.has_win:
        print(f"[launch.serve] sliding window ({eng.window} tokens): "
              f"{eng.win_recycled_pages} pages recycled as they slid out; "
              f"most live window pages a request held "
              f"{eng.win_peak_live}, bound "
              f"{eng.win_pages_bound(args.max_len)}")
    if eng.has_state:
        print(f"[launch.serve] state slots: {eng.state_slot_bytes()} bytes "
              f"a slot x {eng.slots} slots "
              f"({eng.state_slot_bytes() * eng.slots} bytes)")
    if eng.prefix is not None:
        ps = eng.prefix_stats()
        print(f"[launch.serve] prefix cache: hit rate "
              f"{ps['hit_rate']:.2f}, {ps['shared_token_frac']:.0%} of "
              f"prompt tokens served from cache, "
              f"{ps['prefill_tokens_saved']:.0f} prefill tokens saved, "
              f"{ps['cow_copies']:.0f} CoW copies")
    if eng.tier is not None:
        ts = eng.tier_stats()
        print(f"[launch.serve] host tier: {ts['swap_outs']:.0f} swap-"
              f"outs / {ts['swap_ins']:.0f} swap-ins, "
              f"{ts['demoted_pages']:.0f} pages demoted / "
              f"{ts['promoted_pages']:.0f} promoted, "
              f"{ts['reprefill_tokens_saved']:.0f} re-prefill tokens "
              f"saved, prefetch hit rate {ts['prefetch_hit_rate']:.2f}, "
              f"{ts['host_bytes_peak']:.0f} host bytes at peak")
    if eng.spec_k:
        ss = eng.spec_stats()
        print(f"[launch.serve] speculative (K={eng.spec_k}, drafter "
              f"{ss['drafter']}): "
              f"{ss['accepted_per_step']:.2f} tokens/request/step, "
              f"accept rate {ss['accept_rate']:.2f} "
              f"({ss['spec_accepted']:.0f}/{ss['spec_drafted']:.0f} "
              f"drafts)")
        if drafter is not None:
            ds = drafter.stats()
            print(f"[launch.serve] draft model: "
                  f"{ds['draft_proposed']:.0f} tokens proposed over "
                  f"{ds['draft_decode_calls']:.0f} decode calls, "
                  f"{ds['draft_ingested_tokens']:.0f} tokens ingested, "
                  f"{ds['draft_pool_rejects']:.0f} pool rejects")
    if not sampling.is_greedy:
        print(f"[launch.serve] decode policy: temperature "
              f"{sampling.temperature}, top_k {sampling.top_k}, top_p "
              f"{sampling.top_p} — {m['sampling.sampled_tokens']:.0f} "
              f"sampled tokens, "
              f"{m['sampling.step_traces'] + m['sampling.spec_traces']:.0f} "
              f"graph captures (policy-mix invariant)")
    _report_latency_and_launches(cfg, eng, m, tracer, args, device)


def _report_latency_and_launches(cfg, eng, m, tracer, args, device) -> None:
    """The summary's tail: latency percentiles, each kernel's launches and
    the graphs' captures, and the tracer's per-phase walls."""
    print(f"[launch.serve] latency: ttft p50 {m['latency.ttft_p50_s']:.4f}s "
          f"/ p95 {m['latency.ttft_p95_s']:.4f}s, tpot p50 "
          f"{m['latency.tpot_p50_s']:.4f}s / p95 "
          f"{m['latency.tpot_p95_s']:.4f}s")
    counts = ops.launch_counts()
    n_attn = sum(k not in api.STATE_KINDS for k in tfm.layer_kinds(cfg))
    steps = int(m["engine.decode_steps"])
    cpu = " — CPU: plain versions ran instead" if device.type == "cpu" \
        else ""
    if isinstance(eng, PagedServingEngine):
        print(f"[launch.serve] kernel launches: paged_attention "
              f"{counts['paged_attention']} ({steps} decode steps x "
              f"{n_attn} attention layers), mha {counts['mha']} "
              f"({eng.prefills} prefills x {n_attn} attention layers), "
              f"sampler_noise {counts['sampler_noise']}, "
              f"{int(m['sampling.step_traces'])} decode, "
              f"{int(m['sampling.spec_traces'])} verify and "
              f"{eng.select_traces} rollback-select graph capture(s){cpu}")
    else:
        print(f"[launch.serve] kernel launches: mha {counts['mha']} "
              f"(({steps} decode steps + {eng.prefills} prefills) x "
              f"{n_attn} attention layers), sampler_noise "
              f"{counts['sampler_noise']}, "
              f"{int(m['sampling.step_traces'])} decode graph "
              f"capture(s){cpu}")
    if tracer is not None:
        print("[launch.serve] trace: per-phase wall time")
        print(tracer.format_phase_walls())
        if args.trace:
            tracer.export(args.trace)
            print(f"[launch.serve] wrote {args.trace}: "
                  f"{len(tracer.events())} events "
                  f"({tracer.dropped_events} dropped) — open in Perfetto")


if __name__ == "__main__":
    main()
