"""What sets the time of gemm_os's tensor-core paths, and which plan suits
its fp32 path and conv_im2col's, on the card: a probe.

    PYTHONPATH=src python -m repro_torch.launch.gemm_probe [--f32]

Builds ``kernels/csrc/gemm_probe.cu`` (tc_tile.cuh's mainloop with
gemm_os.cu's loaders under other tiles, copies through L1 or L2 only, and
without its global loads or without its MMAs; "no MMAs" still reads the
fragments with ldmatrix) and prints one line per (shape, variant): the
profiler's device
milliseconds per call on hot inputs (the same x and w every call) and on
cold ones (cycling through copies that exceed the 50 MB L2 cache), with
the check of each full variant's output against ``ref.gemm_ref`` (float:
``ref.sum_order_error``; int8: bitwise). Then the PyTorch call at the same
shape. The shapes: the BERT-Base FFN's two products (bf16 512x768x3072,
int8 512x3072x768 with the quant epilogue) and the kernel benchmark's
256x1024x256, where the launcher takes 32 x 32 tiles.

``--f32`` instead times the fp32 paths of gemm_os.cu and conv_im2col.cu
with the depth cut into other numbers of ranges than their launchers' plan
(``F32_CASES``), through the same C launch functions the wrappers call, and
prints each split's device ms hot and cold, its check against the plain
version (``ref.sum_order_error``), which split the launcher picks, and the
PyTorch call (TF32 off). Needs a CUDA card; measures nothing
on the CPU.
"""
from __future__ import annotations

import ctypes
import functools
import subprocess
from typing import Callable, List

import numpy as np
import torch

from repro_torch.kernels import build, ref

# index in gemm_probe.cu: (dtype, tile (BM x BN x BK), copies, mode)
VARIANTS = {
    0: ("bf16", "64x64x32", ".ca", "full (gemm_os.cu)"),
    1: ("bf16", "64x64x32", ".ca", "no MMAs"),
    2: ("bf16", "64x64x32", ".ca", "no loads"),
    3: ("bf16", "64x64x32", ".cg", "full"),
    4: ("bf16", "64x64x32", ".cg", "no MMAs"),
    5: ("bf16", "128x128x32", ".cg", "full"),
    6: ("bf16", "128x128x32", ".cg", "no MMAs"),
    7: ("bf16", "128x64x32", ".cg", "full"),
    8: ("bf16", "64x128x64", ".cg", "full"),
    9: ("bf16", "32x32x64", ".ca", "full (gemm_os.cu)"),
    10: ("int8", "64x64x128", ".ca", "full (gemm_os.cu)"),
    11: ("int8", "64x64x128", ".ca", "no MMAs"),
    12: ("int8", "64x64x128", ".ca", "no loads"),
    13: ("int8", "64x64x128", ".cg", "full"),
    14: ("int8", "64x64x64", ".ca", "full"),
    15: ("int8", "32x32x128", ".ca", "full (gemm_os.cu)"),
    16: ("int8", "32x32x128", ".ca", "no MMAs"),
}
# (dtype, (M, K, N), variants)
CASES = [
    ("bf16", (512, 768, 3072), [0, 1, 2, 3, 4, 5, 6, 7, 8, 9]),
    ("int8", (512, 3072, 768), [10, 11, 12, 13, 14, 15, 16]),
    ("bf16", (256, 1024, 256), [0, 9]),
    ("int8", (256, 1024, 256), [10, 15]),
]
SCALE = 0.002


@functools.lru_cache(maxsize=None)
def _launch() -> Callable:
    fn = build.library("gemm_probe").gemm_probe_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [i, p, p, p, i, i, i, f, p]
    fn.restype = ctypes.c_int
    return fn


def device_ms(fn: Callable[[int], object], n: int = 20, sessions: int = 5
              ) -> float:
    """Median over profiler sessions of the kernels' device ms per call of
    ``fn(j)``, j = 0 .. n-1; sessions that lost events are dropped (NaN if
    all did)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(0)
    torch.cuda.synchronize()
    got = []
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for j in range(n):
                fn(j)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        if sum(e.count for e in events) >= n:
            got.append(sum(e.self_device_time_total for e in events) / 1e3
                       / n)
    return float(np.median(got)) if got else float("nan")


def _inputs(rng, dtype: str, M: int, K: int, N: int):
    if dtype == "int8":
        return tuple(torch.tensor(rng.integers(-128, 128, s),
                                  dtype=torch.int8, device="cuda")
                     for s in ((M, K), (K, N)))
    return tuple(torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                              device="cuda").to(torch.bfloat16)
                 for s in ((M, K), (K, N)))


def run() -> List[str]:
    if not torch.cuda.is_available():
        raise RuntimeError("gemm_probe measures kernels on a CUDA device")
    launch = _launch()
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(0)
    lines = []
    for dtype, (M, K, N), variants in CASES:
        n_copies = max(2, int(np.ceil(3 * 50e6 / ((M * K + K * N) * (
            1 if dtype == "int8" else 2)))))
        copies = [_inputs(rng, dtype, M, K, N) for _ in range(n_copies)]
        integer = dtype == "int8"
        out = torch.empty((M, N), dtype=torch.int8 if integer
                          else torch.bfloat16, device="cuda")
        x0, w0 = copies[0]
        want = ref.gemm_ref(x0, w0, quant_scale=SCALE if integer else None)
        absp = ref.gemm_ref(x0.abs().float(), w0.abs().float())
        for v in variants:
            def call(j, v=v):
                x, w = copies[j % len(copies)]
                err = launch(v, x.data_ptr(), w.data_ptr(), out.data_ptr(),
                             M, N, K, SCALE, stream)
                if err:
                    raise RuntimeError(f"gemm_probe variant {v}: CUDA error "
                                       f"{err}")
            call(0)
            torch.cuda.synchronize()
            _, tile, copy, mode = VARIANTS[v]
            check = ""
            if mode.startswith("full"):
                if integer:
                    ok = ref.bitwise_equal(out, want)
                else:
                    # repro-lint: disable=host-sync — a check, outside timing
                    ok = ref.sum_order_error(out, want, absp, K).item() <= 1
                check = ", agrees" if ok else ", DISAGREES"
            hot = device_ms(lambda j: call(0))
            cold = device_ms(call)
            lines.append(f"gemm_probe {dtype} {M}x{K}x{N} [{v}] {tile} "
                         f"{copy} {mode}: device {hot:.4f} ms hot, "
                         f"{cold:.4f} ms cold{check}")
            print(lines[-1], flush=True)
        if integer:
            wc = w0.t().contiguous().t()
            lib = [("torch._int_mm, w row-major", lambda j: torch._int_mm(
                x0, w0)), ("torch._int_mm, w column-major",
                           lambda j: torch._int_mm(x0, wc))]
        else:
            lib = [("torch.matmul", lambda j: torch.matmul(x0, w0))]
        for name, fn in lib:
            lines.append(f"gemm_probe {dtype} {M}x{K}x{N} {name}: device "
                         f"{device_ms(fn):.4f} ms hot")
            print(lines[-1], flush=True)
    return lines


# (kind, shape, ranges to time): gemm (M, K, N); conv (H, W, C, Cout, R,
# stride), batch 1. The kernel bench's fp32 rows and the paper's.
F32_CASES = [
    ("gemm", (128, 4096, 128), [1, 8, 16, 32, 64]),
    ("gemm", (512, 512, 512), [1, 2, 4, 8]),
    ("gemm", (1024, 1024, 1024), [1, 2, 4]),
    ("gemm", (512, 768, 3072), [1, 2]),
    ("conv", (28, 28, 128, 128, 3, 1), [1, 5, 9, 18, 36]),
    ("conv", (28, 28, 64, 128, 3, 1), [1, 5, 9, 18]),
    ("conv", (224, 224, 3, 64, 7, 2), [1, 2, 3]),
]


def _f32_case(rng, kind, shape):
    """(call(x, w, out, ws, chunk), the launcher's plan, depth, M, N,
    inputs, out, plain version, |x| * |w|, PyTorch call) of one F32_CASES
    entry."""
    import torch.nn.functional as F

    from repro_torch.kernels import conv_im2col, gemm_os
    stream = torch.cuda.current_stream().cuda_stream
    sms = build.sm_count(torch.cuda.current_device())

    def normal(*s):
        return torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                            device="cuda")
    if kind == "gemm":
        M, K, N = shape
        x, w = normal(M, K), normal(K, N)
        out = torch.empty((M, N), device="cuda")

        def call(x, w, out, ws, chunk):
            return gemm_os._lib().gemm_os_f32_launch(
                x.data_ptr(), w.data_ptr(), out.data_ptr(), ws, M, N, K, 0,
                chunk, stream)
        return (call, gemm_os.f32_plan(M, N, K, sms), K, M, N, (x, w), out,
                ref.gemm_ref(x, w), ref.gemm_ref(x.abs(), w.abs()),
                lambda: torch.matmul(x, w))
    H, W, C, Co, R, st = shape
    x, w = normal(1, H, W, C), normal(R, R, C, Co)
    OH, OW, (pt, pb), (pl, pr) = ref.same_padding(H, W, R, R, st)
    out = torch.empty((1, OH, OW, Co), device="cuda")

    def call(x, w, out, ws, chunk):
        return conv_im2col._lib().conv_im2col_f32_launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), ws, 1, H, W, C, R, R,
            Co, OH, OW, st, pt, pl, chunk, stream)
    xp = F.pad(x, (0, 0, pl, pr, pt, pb)).permute(0, 3, 1, 2)
    wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return (call, conv_im2col.f32_plan(OH * OW, Co, C, R, R, sms), R * R * C,
            OH * OW, Co, (x, w), out, ref.conv2d_ref(x, w, stride=st),
            ref.conv2d_ref(x.abs(), w.abs(), stride=st),
            lambda: F.conv2d(xp, wl, stride=st))


def run_f32() -> List[str]:
    """The fp32 splits of F32_CASES on the card; one line per split."""
    if not torch.cuda.is_available():
        raise RuntimeError("gemm_probe measures kernels on a CUDA device")
    from repro_torch.kernels.gemm_os import workspace_numel
    from repro_torch.launch.kernel_bench import fp32_exact
    rng = np.random.default_rng(1)
    lines = []
    with fp32_exact():
        for kind, shape, counts in F32_CASES:
            (call, own, depth, M, N, (x, w), out, want, absp,
             library) = _f32_case(rng, kind, shape)
            n_bytes = 4 * (x.numel() + w.numel())
            copies = [(x, w)] + [(x.clone(), w.clone()) for _ in range(
                max(1, int(np.ceil(3 * 50e6 / n_bytes))) - 1)]
            label = f"gemm_probe f32 {kind} {'x'.join(map(str, shape))}"
            stages = -(-depth // 16)
            chunks = [16 * -(-stages // n) for n in counts]
            for chunk in chunks + ([] if own[2] in chunks else [own[2]]):
                ranges = -(-depth // chunk)
                ws = torch.empty(max(1, workspace_numel(
                    M, N, own[:2] + (chunk, ranges))), device="cuda")

                def one(j, chunk=chunk, ws=ws):
                    a, b = copies[j % len(copies)]
                    err = call(a, b, out, ws.data_ptr(), chunk)
                    if err:
                        raise RuntimeError(f"{label} chunk {chunk}: CUDA "
                                           f"error {err}")
                one(0)
                torch.cuda.synchronize()
                # repro-lint: disable=host-sync — a check, outside timing
                ok = ref.sum_order_error(out, want, absp, depth).item() <= 1
                hot = device_ms(lambda j: one(0))
                cold = device_ms(one)
                tag = " (the launcher's plan)" if chunk == own[2] else ""
                lines.append(f"{label} chunk {chunk} ranges {ranges}{tag}: "
                             f"device {hot:.4f} ms hot, {cold:.4f} ms cold, "
                             f"{'agrees' if ok else 'DISAGREES'}")
                print(lines[-1], flush=True)
            lines.append(f"{label} PyTorch call: device "
                         f"{device_ms(lambda j: library()):.4f} ms hot")
            print(lines[-1], flush=True)
    return lines


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--f32", action="store_true",
                    help="time the fp32 splits (F32_CASES) instead")
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or "nvidia-smi unavailable", flush=True)
    run_f32() if args.f32 else run()


if __name__ == "__main__":
    main()
