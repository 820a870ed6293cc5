"""The paged engine's decode step on the card with dead slots at high
positions: CUDA-event ms of one replay of its captured graph at 8 slots, 4
of them dead.

    PYTHONPATH=src python -m repro_torch.launch.step_probe --arch qwen2.5-3b
    python src/repro_torch/launch/step_probe.py --port-src OTHER/src

bf16, full width and depth, seeded weights. 8 requests of 560-600 prompt
tokens are admitted; 4 of them finish after 24 new tokens, so their
slots die at positions of about 580-625 while the other 4 decode on. Then
5 runs of 30 replays each; prints the dead slots' positions, each run's ms
a replay and their median beside the card's name and power limit. A dead
row runs through every step (an MoE router sees it), so the paged kernel
sweeps its all-scratch table up to its position, and every row's pool
write goes through the last-writer rows. ``--port-src`` imports another
checkout's ``repro_torch`` (run this file by path then), so that two
versions are timed on one card in one call, in turns.
"""
from __future__ import annotations

import argparse
import subprocess
import sys

SLOTS, DYING, DYING_NEW, MAX_LEN = 8, 4, 24, 1024


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--port-src", default=None,
                    help="a checkout's src/ whose repro_torch is timed "
                         "(default: the one on the path)")
    args = ap.parse_args(argv)
    if args.port_src:
        sys.path.insert(0, args.port_src)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("step_probe: needs a CUDA device")
    from repro_torch.configs import get_config
    from repro_torch.launch.kernel_bench import cuda_ms
    from repro_torch.models import api
    from repro_torch.runtime.serving import PagedServingEngine, Request

    cfg = get_config(args.arch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = api.init_params(cfg, gen, device="cuda")
    rng = np.random.default_rng(1)
    eng = PagedServingEngine(cfg, params, slots=SLOTS, max_len=MAX_LEN,
                             page_size=16, device="cuda")
    for i, n in enumerate(rng.integers(560, 601, SLOTS)):
        if not eng.submit(Request(rid=i, prompt=[
                int(t) for t in rng.integers(0, cfg.vocab, int(n))],
                max_new=DYING_NEW if i < DYING else MAX_LEN)):
            raise SystemExit("step_probe: admission rejected")
    for _ in range(DYING_NEW + 1):
        if sum(r is not None for r in eng.live) == SLOTS - DYING:
            break
        eng.step()
    dead = [s for s, r in enumerate(eng.live) if r is None]
    if len(dead) != DYING:
        raise SystemExit(f"step_probe: {len(dead)} dead slots, not {DYING}")
    pos = eng.pos.tolist()
    torch.cuda.synchronize()
    runs = [cuda_ms(eng._graph.replay, iters=30) for _ in range(5)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"step_probe [{args.port_src or 'repro_torch'}] {cfg.name}, "
          f"{cfg.num_layers} layers, B={SLOTS}, dead slots at positions "
          f"{[pos[s] for s in dead]}: ms a replay "
          f"{', '.join(f'{x:.4f}' for x in runs)}, median "
          f"{sorted(runs)[2]:.4f} ({smi})", flush=True)


if __name__ == "__main__":
    main()
