"""Paged flash-decode's device time under its plan and under other splits of
the page sweep, on the card.

    PYTHONPATH=src python -m repro_torch.launch.paged_probe
    python src/repro_torch/launch/paged_probe.py --port-src OTHER/src

bf16 at the serving widths (16 query heads over 2 KV heads, head dim 128,
pages of 16): B = 8 at contexts drawn from a seeded generator in the serve
phase's range (tables of 64 pages), and B = 16 at 2048 tokens each (tables
of 128 pages). Each call reads one of several pools, together past three
times the 50 MB L2 cache, as the 36 layers of the serving path do. Per
case: device ms per call (``gemm_probe.device_ms``, torch.profiler's kernel
time) through the wrapper, which takes its plan (``split_plan``), and
through the bare C launch at S = 1, 2, 4, 5 and 8 ranges. ``--port-src``
imports another checkout's ``repro_torch`` (run this file by path then),
so that two versions are timed on one card in one call; a tree without
``split_plan`` (one CTA per request and KV head) is timed through its
wrapper only.
"""
from __future__ import annotations

import argparse
import math
import sys

L2_BYTES = 50e6
HBM_BYTES_S = 3.35e12     # H100 SXM device memory rate (data sheet)
H, KV, D, PAGE = 16, 2, 128, 16
SPLITS = (1, 2, 4, 5, 8)


def paged_inputs(rng, B, lengths, n_blocks):
    """bf16 (q, k_pool, v_pool, block_table, lengths) on the card: each
    request's pages scattered through the pool by a shuffled table."""
    import numpy as np
    import torch
    n_live = [-(-n // PAGE) for n in lengths]
    P = 1 + sum(n_live)
    perm = rng.permutation(np.arange(1, P)).astype(np.int32)
    table = np.zeros((B, n_blocks), np.int32)
    nxt = 0
    for b, n in enumerate(n_live):
        table[b, :n] = perm[nxt:nxt + n]
        nxt += n

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.bfloat16,
                            device="cuda")
    return (t(B, 1, H, D), t(P, PAGE, KV, D), t(P, PAGE, KV, D),
            torch.tensor(table, device="cuda"),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"))


def paged_rows(label, B, lengths, n_blocks, seed):
    """Lines of one case: the wrapper (its plan), then each other split."""
    import numpy as np
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import paged_attention as pk
    from repro_torch.launch.gemm_probe import device_ms
    rng = np.random.default_rng(seed)
    live = sum(lengths) * 2 * D * KV * 2          # K and V, bf16
    copies = [paged_inputs(rng, B, lengths, n_blocks)
              for _ in range(max(2, math.ceil(3 * L2_BYTES / live)))]
    bound = (live + 2 * copies[0][0].numel() * 2 + B * n_blocks * 4
             + B * 4) / HBM_BYTES_S * 1e3
    n = 2 * len(copies)
    sessions = 9   # a session on the card now and then loses its events

    def line(name, ms):
        return (f"paged {label} [{name}]: device {ms:.4f} ms ({bound / ms:.1%}"
                f" of the {bound:.4f} ms bound)")
    split = hasattr(pk, "split_plan")
    name = "wrapper"
    if split:
        plan = pk.split_plan(B, KV, n_blocks, PAGE, H // KV,
                             build.sm_count(0))
        name += f", plan S={plan}"
    rows = [line(name, device_ms(
        lambda j: pk.paged_attention(*copies[j % len(copies)]), n, sessions))]
    if not split:
        return rows
    lib = pk._lib()
    outs = [torch.empty_like(c[0]) for c in copies]

    def launch(j, S):
        q, kp, vp, table, lens = copies[j % len(copies)]
        err = build.launch_on(
            q.device, lib.paged_attention_launch, q.data_ptr(), kp.data_ptr(),
            vp.data_ptr(), table.data_ptr(), lens.data_ptr(),
            outs[j % len(copies)].data_ptr(), B, 1, H, KV, D, PAGE, n_blocks,
            1, 1, D ** -0.5, 1.0, 0, S)
        if err:
            raise RuntimeError(f"paged launch at S={S}: CUDA error {err}")
    for S in SPLITS:
        rows.append(line(f"S={S}", device_ms(lambda j, S=S: launch(j, S), n,
                                             sessions)))
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port-src", default=None,
                    help="a checkout's src/ whose repro_torch is timed "
                         "(default: the one on the path)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.port_src:
        sys.path.insert(0, args.port_src)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("paged_probe times kernels on a CUDA device")
    label = args.port_src or "repro_torch"
    serve = sorted(int(n) for n in np.random.default_rng(args.seed).integers(
        237, 585, 8))
    rows = paged_rows(f"B=8, contexts {serve[0]}-{serve[-1]}", 8, serve, 64,
                      args.seed + 1)
    rows += paged_rows("B=16 x 2048", 16, [2048] * 16, 128, args.seed + 2)
    for row in rows:
        print(f"[{label}] {row}", flush=True)


if __name__ == "__main__":
    main()
