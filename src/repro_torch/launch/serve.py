"""Serving launcher of the PyTorch port: batched serving on a GPU.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
      [--smoke] [--slots 4] [--requests 8] [--max-new 12] [--max-len 128] \
      [--temperature 0.8 --top-k 20 --top-p 0.95] [--prefix-cache] \
      [--spec-k 3 [--draft-model ARCH]] [--host-tier] \
      [--engine auto|paged|dense] [--page-size 16] [--num-pages N] \
      [--paged-attn kernel|gather] [--trace [trace.json]] \
      [--shards M] [--replicas R] [--route hash|least_loaded] \
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

``--shards M`` shards each paged engine over M ranks (tensor parallelism:
KV-head pools, attention and MLP weights, an all-reduce at the out- and
down-projections); ``--replicas R`` puts R engines behind a router
(``--route``). With M x R > 1 the launcher starts a world of M x R ranks
itself (``launch.mesh.run_world``): NCCL over the first M x R CUDA devices
(one each; raises when there are fewer), gloo over M x R CPU ranks with
``--device cpu``. Every rank serves the same requests in lockstep; rank 0
prints, and adds the reference's shard line for each replica.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_host_mesh, run_world, visible_devices
from repro_torch.models import api
from repro_torch.models import transformer as tfm
from repro_torch.runtime.drafter import DraftModelDrafter
from repro_torch.runtime.router import make_replicas
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
    ap.add_argument("--shards", type=int, default=1,
                    help="tensor-parallel shards per engine: KV pools and "
                         "attn/mlp weights shard over this many ranks "
                         "(paged engine only)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="data-parallel engine replicas behind a router "
                         "(each --shards ranks wide; paged engine only)")
    ap.add_argument("--route", choices=["hash", "least_loaded"],
                    default="hash", help="replica routing policy")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a CUDA device) or "
                         "cpu (plain PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    world = args.shards * args.replicas
    if world > 1 and args.engine == "dense":
        raise SystemExit("--shards and --replicas need the paged engine")
    if world == 1:
        _serve(args, device, 0)
        return
    if device.type == "cuda" and world > torch.cuda.device_count():
        raise SystemExit(f"--shards x --replicas = {world} ranks need "
                         f"{world} CUDA devices, one each; have "
                         f"{torch.cuda.device_count()}")
    backend = "gloo" if device.type == "cpu" else "nccl"
    with tempfile.TemporaryDirectory() as tmp:
        run_world(_serve_rank, world, backend=backend,
                  init_file=os.path.join(tmp, "rendezvous"), args=(args,))


def _serve_rank(rank: int, args) -> None:
    """One rank of a ``--shards`` / ``--replicas`` world."""
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    _serve(args, device, rank)


def _quiet(*_args, **_kwargs) -> None:
    pass


def _serve(args, device: torch.device, rank: int) -> None:
    """Build the model, the engine (or this rank's replica) and the
    traffic, serve it and print the summary (rank 0 only)."""
    say = print if rank == 0 else _quiet
    world = args.shards * args.replicas
    devs = (["cpu"] * world if device.type == "cpu"
            else visible_devices()) if world > 1 else [device]
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    say(f"[launch.serve] {cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
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
        say(f"[launch.serve] draft model: {dcfg.name} "
            f"({dcfg.param_count()/1e6:.1f}M params)")
    tracer = Tracer(enabled=True) if args.trace is not None else None
    common = dict(slots=args.slots, max_len=args.max_len, sampling=sampling,
                  tracer=tracer, device=device)
    paged_kw = dict(page_size=args.page_size, num_pages=args.num_pages,
                    attn_impl=args.paged_attn,
                    prefix_cache=args.prefix_cache, spec_k=args.spec_k,
                    drafter=drafter, host_tier=args.host_tier)
    router = None
    if args.replicas > 1:
        router = make_replicas(cfg, params, replicas=args.replicas,
                               model=args.shards, devices=devs,
                               policy=args.route, **paged_kw, **common)
        eng = next(e for e in router.engines if e is not None)
        say(f"[launch.serve] router: {args.replicas} replica(s) x "
            f"{args.shards} shard(s) over {world} rank(s), policy "
            f"{args.route}")
    elif args.engine == "dense":
        eng = DenseServingEngine(cfg, params, **common)
    else:
        mesh = make_host_mesh(args.shards, devices=devs) \
            if args.shards > 1 else None
        builder = PagedServingEngine if args.engine == "paged" \
            else ServingEngine
        eng = builder(cfg, params, mesh=mesh, **paged_kw, **common)
    paged = isinstance(eng, PagedServingEngine)
    say(f"[launch.serve] engine: {type(eng).__name__}"
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
    driver = router if router is not None else eng
    done = driver.run_to_completion(reqs, max_steps=5000)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    toks = sum(len(r.generated) for r in done)
    m = eng.metrics()
    say(f"[launch.serve] {len(done)}/{len(reqs)} requests, {toks} tokens, "
        f"{toks/dt:.1f} tok/s, {int(m['engine.prefill_traces'])} prefill "
        f"traces")
    if router is not None:
        rs = router.stats()
        say(f"[launch.serve] routed per replica: {rs['routed']}, peak "
            f"pages per replica: "
            f"{[int(p) for p in rs['peak_pages_per_replica']]}, "
            f"preemptions: {rs['preempted']}")
    st = eng.pool_stats()
    if not paged:
        say(f"[launch.serve] dense lanes: {st.dense_equiv_tokens} tokens "
            f"reserved ({eng.slots} slots x {eng.max_len}), "
            f"{eng.shard_stats()['pool_bytes_per_shard']:.0f} bytes")
        _report_latency_and_launches(cfg, eng, m, tracer, args, device, say)
        return
    shards = router.replica_shard_stats() if router is not None \
        else [eng.shard_stats()]
    for e_i, ss in enumerate(shards):
        if ss["model_shards"] > 1:
            say(f"[launch.serve] replica {e_i}: "
                f"{int(ss['model_shards'])} shards "
                f"({ss['sharded_axes']}), peak "
                f"{int(ss['peak_pages_per_shard'])} pages/shard, "
                f"{int(ss['pool_bytes_per_shard'])} pool bytes/shard")
    say(f"[launch.serve] kv pages: peak {st.peak_pages}/{st.num_pages} "
        f"({st.peak_pages * st.page_size} tokens reserved at peak vs "
        f"{st.dense_equiv_tokens} dense)")
    if eng.has_win:
        say(f"[launch.serve] sliding window ({eng.window} tokens): "
            f"{eng.win_recycled_pages} pages recycled as they slid out; "
            f"most live window pages a request held "
            f"{eng.win_peak_live}, bound "
            f"{eng.win_pages_bound(args.max_len)}")
    if eng.has_state:
        say(f"[launch.serve] state slots: {eng.state_slot_bytes()} bytes "
            f"a slot x {eng.slots} slots "
            f"({eng.state_slot_bytes() * eng.slots} bytes)")
    if eng.prefix is not None:
        ps = eng.prefix_stats()
        say(f"[launch.serve] prefix cache: hit rate "
            f"{ps['hit_rate']:.2f}, {ps['shared_token_frac']:.0%} of "
            f"prompt tokens served from cache, "
            f"{ps['prefill_tokens_saved']:.0f} prefill tokens saved, "
            f"{ps['cow_copies']:.0f} CoW copies")
    if eng.tier is not None:
        ts = eng.tier_stats()
        say(f"[launch.serve] host tier: {ts['swap_outs']:.0f} swap-"
            f"outs / {ts['swap_ins']:.0f} swap-ins, "
            f"{ts['demoted_pages']:.0f} pages demoted / "
            f"{ts['promoted_pages']:.0f} promoted, "
            f"{ts['reprefill_tokens_saved']:.0f} re-prefill tokens "
            f"saved, prefetch hit rate {ts['prefetch_hit_rate']:.2f}, "
            f"{ts['host_bytes_peak']:.0f} host bytes at peak")
    if eng.spec_k:
        ss = eng.spec_stats()
        say(f"[launch.serve] speculative (K={eng.spec_k}, drafter "
            f"{ss['drafter']}): "
            f"{ss['accepted_per_step']:.2f} tokens/request/step, "
            f"accept rate {ss['accept_rate']:.2f} "
            f"({ss['spec_accepted']:.0f}/{ss['spec_drafted']:.0f} "
            f"drafts)")
        if drafter is not None:
            ds = drafter.stats()
            say(f"[launch.serve] draft model: "
                f"{ds['draft_proposed']:.0f} tokens proposed over "
                f"{ds['draft_decode_calls']:.0f} decode calls, "
                f"{ds['draft_ingested_tokens']:.0f} tokens ingested, "
                f"{ds['draft_pool_rejects']:.0f} pool rejects")
    if not sampling.is_greedy:
        say(f"[launch.serve] decode policy: temperature "
            f"{sampling.temperature}, top_k {sampling.top_k}, top_p "
            f"{sampling.top_p} — {m['sampling.sampled_tokens']:.0f} "
            f"sampled tokens, "
            f"{m['sampling.step_traces'] + m['sampling.spec_traces']:.0f} "
            f"graph captures (policy-mix invariant)")
    _report_latency_and_launches(cfg, eng, m, tracer, args, device, say)


def _report_latency_and_launches(cfg, eng, m, tracer, args, device,
                                 say) -> None:
    """The summary's tail: latency percentiles, each kernel's launches and
    the graphs' captures, and the tracer's per-phase walls."""
    say(f"[launch.serve] latency: ttft p50 {m['latency.ttft_p50_s']:.4f}s "
        f"/ p95 {m['latency.ttft_p95_s']:.4f}s, tpot p50 "
        f"{m['latency.tpot_p50_s']:.4f}s / p95 "
        f"{m['latency.tpot_p95_s']:.4f}s")
    counts = ops.launch_counts()
    n_attn = sum(k not in api.STATE_KINDS for k in tfm.layer_kinds(cfg))
    steps = int(m["engine.decode_steps"])
    cpu = " — CPU: plain versions ran instead" if device.type == "cpu" \
        else ""
    if isinstance(eng, PagedServingEngine):
        say(f"[launch.serve] kernel launches: paged_attention "
              f"{counts['paged_attention']} ({steps} decode steps x "
              f"{n_attn} attention layers), mha {counts['mha']} "
              f"({eng.prefills} prefills x {n_attn} attention layers), "
              f"sampler_noise {counts['sampler_noise']}, "
              f"{int(m['sampling.step_traces'])} decode, "
              f"{int(m['sampling.spec_traces'])} verify and "
              f"{eng.select_traces} rollback-select graph capture(s){cpu}")
    else:
        say(f"[launch.serve] kernel launches: mha {counts['mha']} "
              f"(({steps} decode steps + {eng.prefills} prefills) x "
              f"{n_attn} attention layers), sampler_noise "
              f"{counts['sampler_noise']}, "
              f"{int(m['sampling.step_traces'])} decode graph "
              f"capture(s){cpu}")
    if tracer is not None:
        say("[launch.serve] trace: per-phase wall time")
        say(tracer.format_phase_walls())
        if args.trace and say is print:
            tracer.export(args.trace)
            say(f"[launch.serve] wrote {args.trace}: "
                f"{len(tracer.events())} events "
                f"({tracer.dropped_events} dropped) — open in Perfetto")


if __name__ == "__main__":
    main()
