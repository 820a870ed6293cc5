"""Host microseconds per call of the flash-MHA, conv_im2col and gemm_os
wrappers, on the card, split into what the wrapper adds and what the launch
itself costs.

    PYTHONPATH=src python -m repro_torch.launch.host_cost
    python src/repro_torch/launch/host_cost.py --port-src OTHER/src

Prints one line per case: bf16 paged flash-decode at the serving step (8
requests of 237-584 tokens, H16 KV2 D128, pages of 16; the wrapper launches
through ``build.launch_on``), bf16 mha at the serving shape (B1 S1024 H16 KV2
D128, causal), the bf16 ResNet-50 stage-3 conv (1x28x28x128 -> 128, 3x3),
gemm_os at the BERT-Base FFN (bf16 512x768x3072; int8 512x3072x768
with the quant epilogue), and the fp32 paths where they split the depth
(gemm_os 128x4096x128, the stage-3 conv; the wrapper allocates their
workspace each call), each through its wrapper, through
``kernels.ops``, as a bare ``ctypes`` launch of the same C function, and as
the PyTorch call beside it (SDPA, ``F.conv2d``, ``torch.matmul``,
``torch._int_mm`` without the epilogue); mha also with an int
``kv_valid``, which fills a (B,) tensor on the device before the launch. A call's host time is the
wall time of 20 back-to-back calls before the card is waited for, the
least over 5 batches: where the card keeps up, what the host pays per
call. ``--port-src`` times another checkout's ``repro_torch`` (run this
file by path then), so that two versions of the wrappers are compared in
one process on one card.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Dict


def host_us(fn: Callable[[], object], iters: int = 20,
            batches: int = 5) -> float:
    """Host microseconds per call of ``fn``: the least, over ``batches``
    batches, of the wall time of ``iters`` back-to-back calls before the
    card is waited for (other processes on the host only ever add)."""
    import torch
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(batches):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        best = min(best, (time.perf_counter() - t0) / iters * 1e6)
        torch.cuda.synchronize()
    return best


def cases(seed: int = 0) -> Dict[str, Dict[str, Callable[[], object]]]:
    """The calls to time, by kernel and by route, on fresh seeded inputs."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import (attention, build, conv_im2col, gemm_os,
                                     ops, paged_attention)
    if not torch.cuda.is_available():
        raise RuntimeError("host_cost times launches on a CUDA device")
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.bfloat16,
                            device="cuda")
    H, KV, D, S = 16, 2, 128, 1024
    q, k, v = t(1, S, H, D), t(1, S, KV, D), t(1, S, KV, D)
    out = torch.empty_like(q)
    valid = torch.full((1,), S, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    mha_lib = attention._lib()
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    x, w = t(1, 28, 28, 128), t(3, 3, 128, 128)
    y = torch.empty((1, 28, 28, 128), dtype=torch.bfloat16, device="cuda")
    conv_lib = conv_im2col._lib()
    xp = F.pad(x, (0, 0, 1, 1, 1, 1)).permute(0, 3, 1, 2)
    wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    gemm_lib = gemm_os._lib()
    a, b = t(512, 768), t(768, 3072)
    ab = torch.empty((512, 3072), dtype=torch.bfloat16, device="cuda")

    def int8(*shape):
        return torch.tensor(rng.integers(-128, 128, shape), dtype=torch.int8,
                            device="cuda")
    qa, qb = int8(512, 3072), int8(3072, 768)
    qab = torch.empty((512, 768), dtype=torch.int8, device="cuda")

    def f32(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device="cuda")
    # fp32 with the depth split: the wrapper allocates the workspace per
    # call, the bare launch gets one made beforehand
    sms = build.sm_count(torch.cuda.current_device())
    fa, fb = f32(128, 4096), f32(4096, 128)
    fab = torch.empty((128, 128), device="cuda")
    gplan = gemm_os.f32_plan(128, 128, 4096, sms)
    gws = torch.empty(gemm_os.workspace_numel(128, 128, gplan),
                      device="cuda")
    fx, fw = f32(1, 28, 28, 128), f32(3, 3, 128, 128)
    fy = torch.empty((1, 28, 28, 128), device="cuda")
    cplan = conv_im2col.f32_plan(28 * 28, 128, 128, 3, 3, sms)
    cws = torch.empty(gemm_os.workspace_numel(28 * 28, 128, cplan),
                      device="cuda")
    fxp = F.pad(fx, (0, 0, 1, 1, 1, 1)).permute(0, 3, 1, 2)
    fwl = fw.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    # paged flash-decode at the serving step: 8 requests, tables of 64 pages
    pq = t(8, H, D)
    lens = [int(n) for n in rng.integers(237, 585, 8)]
    n_pages = [-(-n // 16) for n in lens]
    pk, pv = t(1 + sum(n_pages), 16, KV, D), t(1 + sum(n_pages), 16, KV, D)
    table = torch.zeros((8, 64), dtype=torch.int32)
    nxt = 1
    for row, n in enumerate(n_pages):
        table[row, :n] = torch.arange(nxt, nxt + n)
        nxt += n
    table = table.to("cuda")
    plen = torch.tensor(lens, dtype=torch.int32, device="cuda")
    pout = torch.empty_like(pq)
    splits = paged_attention.split_plan(8, KV, 64, 16, H // KV, sms)
    paged_lib = paged_attention._lib()
    return {
        f"paged_attention bf16 B8 H16 KV2 D128 ({splits} ranges)": {
            "wrapper": lambda: paged_attention.paged_attention(
                pq, pk, pv, table, plen),
            "ops.paged_attention": lambda: ops.paged_attention(
                pq, pk, pv, table, plen),
            "bare C launch": lambda: paged_lib.paged_attention_launch(
                pq.data_ptr(), pk.data_ptr(), pv.data_ptr(),
                table.data_ptr(), plen.data_ptr(), pout.data_ptr(), 8, 1,
                H, KV, D, 16, 64, 1, 1, D ** -0.5, 1.0, 0, splits, stream)},
        "mha bf16 B1 S1024 H16 KV2 D128": {
            "wrapper": lambda: attention.mha(q, k, v, causal=True),
            "wrapper, int kv_valid": lambda: attention.mha(
                q, k, v, causal=True, kv_valid=S),
            "ops.attention": lambda: ops.attention(q, k, v, causal=True),
            "bare C launch": lambda: mha_lib.mha_fwd_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
                out.data_ptr(), 1, S, S, H, KV, D, 1, 1, D ** -0.5, 0, stream),
            "SDPA": lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)},
        "conv_im2col bf16 28x28x128->128 3x3": {
            "wrapper": lambda: conv_im2col.conv2d(x, w),
            "ops.conv2d": lambda: ops.conv2d(x, w),
            "bare C launch": lambda: conv_lib.conv_im2col_launch(
                x.data_ptr(), w.data_ptr(), y.data_ptr(), 1, 28, 28, 128, 3,
                3, 128, 28, 28, 1, 1, 1, 1, stream),
            "F.conv2d": lambda: F.conv2d(xp, wl)},
        "gemm_os bf16 512x768x3072": {
            "wrapper": lambda: gemm_os.gemm_os(a, b),
            "ops.matmul": lambda: ops.matmul(a, b),
            "bare C launch": lambda: gemm_lib.gemm_os_launch(
                a.data_ptr(), b.data_ptr(), ab.data_ptr(), 512, 3072, 768, 1,
                1, 0, 0.0, stream),
            "torch.matmul": lambda: torch.matmul(a, b)},
        "gemm_os int8 + epilogue 512x3072x768": {
            "wrapper": lambda: gemm_os.gemm_os(qa, qb, quant_scale=0.002),
            "ops.quant_matmul": lambda: ops.quant_matmul(qa, qb, 0.002),
            "bare C launch": lambda: gemm_lib.gemm_os_launch(
                qa.data_ptr(), qb.data_ptr(), qab.data_ptr(), 512, 768, 3072,
                2, 2, 1, 0.002, stream),
            "torch._int_mm": lambda: torch._int_mm(qa, qb)},
        f"gemm_os fp32 128x4096x128 ({gplan[3]} ranges)": {
            "wrapper": lambda: gemm_os.gemm_os(fa, fb),
            "ops.matmul": lambda: ops.matmul(fa, fb),
            "bare C launch": lambda: gemm_lib.gemm_os_f32_launch(
                fa.data_ptr(), fb.data_ptr(), fab.data_ptr(), gws.data_ptr(),
                128, 128, 4096, 0, gplan[2], stream),
            "torch.matmul": lambda: torch.matmul(fa, fb)},
        f"conv_im2col fp32 28x28x128->128 3x3 ({cplan[3]} ranges)": {
            "wrapper": lambda: conv_im2col.conv2d(fx, fw),
            "ops.conv2d": lambda: ops.conv2d(fx, fw),
            "bare C launch": lambda: conv_lib.conv_im2col_f32_launch(
                fx.data_ptr(), fw.data_ptr(), fy.data_ptr(), cws.data_ptr(),
                1, 28, 28, 128, 3, 3, 128, 28, 28, 1, 1, 1, cplan[2],
                stream),
            "F.conv2d": lambda: F.conv2d(fxp, fwl)},
    }


def measure(seed: int = 0) -> Dict[str, Dict[str, float]]:
    """Host µs per call of every case (``cases``)."""
    return {kernel: {route: host_us(fn) for route, fn in routes.items()}
            for kernel, routes in cases(seed).items()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port-src", default=None,
                    help="a checkout's src/ whose repro_torch is timed "
                         "(default: the one on the path)")
    args = ap.parse_args(argv)
    if args.port_src:
        sys.path.insert(0, args.port_src)
    label = args.port_src or "repro_torch"
    for kernel, routes in measure().items():
        print(f"host us/call [{label}] {kernel}: " + ", ".join(
            f"{route} {us:.1f}" for route, us in routes.items()), flush=True)


if __name__ == "__main__":
    main()
