"""Serving launcher of the PyTorch port: batched greedy serving on a GPU.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
      [--smoke] [--slots 4] [--requests 8] [--max-new 12] [--max-len 128] \
      [--page-size 16] [--num-pages N] [--device cuda|cpu]

Weights are drawn on the device from a generator seeded with 0. Runs on
CUDA by default and raises if there is none; ``--device cpu`` runs every
kernel's plain PyTorch version instead. Prints the JAX launcher's summary
lines plus each CUDA kernel's launch count.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.models import api
from repro_torch.runtime.serving import PagedServingEngine, Request


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCHS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=None,
                    help="usable KV pages (default: slots*max_len/page)")
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
    eng = PagedServingEngine(cfg, params, slots=args.slots,
                             max_len=args.max_len, page_size=args.page_size,
                             num_pages=args.num_pages, device=device)
    print(f"[launch.serve] engine: {type(eng).__name__}")
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
          f"{toks/dt:.1f} tok/s, {int(m['engine.prefill_buckets'])} prefill "
          f"buckets")
    st = eng.pool_stats()
    print(f"[launch.serve] kv pages: peak {st.peak_pages}/{st.num_pages} "
          f"({st.peak_pages * st.page_size} tokens reserved at peak vs "
          f"{st.dense_equiv_tokens} dense)")
    print(f"[launch.serve] latency: ttft p50 {m['latency.ttft_p50_s']:.4f}s "
          f"/ p95 {m['latency.ttft_p95_s']:.4f}s, tpot p50 "
          f"{m['latency.tpot_p50_s']:.4f}s / p95 "
          f"{m['latency.tpot_p95_s']:.4f}s")
    counts = ops.launch_counts()
    print(f"[launch.serve] kernel launches: paged_attention "
          f"{counts['paged_attention']} ({int(m['engine.decode_steps'])} "
          f"decode steps x {cfg.num_layers} layers), mha {counts['mha']} "
          f"({int(m['engine.prefills'])} prefills x {cfg.num_layers} "
          f"layers){' — CPU: plain versions ran instead' if device.type == 'cpu' else ''}")


if __name__ == "__main__":
    main()
