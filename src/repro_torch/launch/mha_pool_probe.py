"""Device times of flash-MHA's fp32 path under each layout of its plan, and
of max-pool beside variants it does not keep and an empty kernel on its
grid, on the card.

    PYTHONPATH=src python -m repro_torch.launch.mha_pool_probe
    python src/repro_torch/launch/mha_pool_probe.py --port-src OTHER/src

mha fp32, causal: the kernel bench's row (B1 S1024 H8 KV2 D64), the
serving heads (B1 S1024 H16 KV2 D128) and a ragged Sq = Sk = 100 at the
serving heads; per case the wrapper (its plan, ``attention.f32_plan``) and
the bare C launch at each layout the kernel builds (rg = 4 or 2 row groups
of 16 rows a CTA). mha bf16, causal, through the wrapper: the serving
heads at 512 and 1024, and (a tree whose mha takes ``window``)
recurrentgemma's prefill, B1 S4096 H16 KV1 D256 with a 2048-key band. max-pool, the ResNet-50 stem's 1x112x112x64 3x3/2 in
fp32 and bf16 at batch 1 and 8: the wrapper, the kernel's bare C launch,
``csrc/maxpool_probe.cu``'s variants (16-byte vectors or one element a
thread, strips of 1 or 2 outputs) and an empty kernel on the kernel's grid
(the floor a launch of that shape costs); each bare launch writes an output
of its own copy and is first checked bitwise against the plain version.
Inputs are cycled past three times the 50 MB L2 cache;
device ms per call from torch.profiler (``gemm_probe.device_ms``, median of
the sessions that kept their events). ``--port-src`` imports another
checkout's ``repro_torch`` (run this file by path then), so that two
versions are timed on one card in one call; a tree without mha's plan or
the maxpool probe source is timed without the layouts or variants.
"""
from __future__ import annotations

import argparse
import math
import sys

L2_BYTES = 50e6
SESSIONS = 7
MHA_CASES = [  # label, B, S, H, KV, D
    ("bench B1 S1024 H8 KV2 D64", 1, 1024, 8, 2, 64),
    ("serve B1 S1024 H16 KV2 D128", 1, 1024, 16, 2, 128),
    ("ragged B1 S100 H16 KV2 D128", 1, 100, 16, 2, 128),
]


def _copies(make, n_bytes):
    return [make() for _ in range(max(2, math.ceil(3 * L2_BYTES / n_bytes)))]


def mha_rows(label, B, S, H, KV, D, seed):
    import numpy as np
    import torch
    from repro_torch.kernels import attention as mk
    from repro_torch.kernels import build
    from repro_torch.launch.gemm_probe import device_ms
    rng = np.random.default_rng(seed)

    def make():
        return tuple(torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                                  device="cuda")
                     for s in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D)))
    copies = _copies(make, 4 * B * S * (H + 2 * KV) * D)
    n = 2 * len(copies)
    rows = []
    name = "wrapper"
    planned = hasattr(mk, "f32_plan")
    if planned:
        name += f", plan rg={mk.f32_plan(B, S, S, H, D, True, build.sm_count(0))}"
    rows.append((name, device_ms(
        lambda j: mk.mha(*copies[j % len(copies)], causal=True), n,
        SESSIONS)))
    if not planned:
        return [f"mha fp32 {label} [{k}]: device {ms:.4f} ms" for k, ms in rows]
    lib = mk._lib()
    outs = [torch.empty_like(c[0]) for c in copies]

    def launch(j, rg):
        q, k, v = copies[j % len(copies)]
        err = build.launch_on(q.device, lib.mha_fwd_launch, q.data_ptr(),
                              k.data_ptr(), v.data_ptr(), 0,
                              outs[j % len(copies)].data_ptr(), B, S, S, H,
                              KV, D, 0, 1, D ** -0.5, rg)
        if err:
            raise RuntimeError(f"mha launch at rg={rg}: CUDA error {err}")
    for rg in (4, 2) if D <= 64 else (4,):
        rows.append((f"rg={rg}", device_ms(lambda j, rg=rg: launch(j, rg), n,
                                           SESSIONS)))
    return [f"mha fp32 {label} [{k}]: device {ms:.4f} ms" for k, ms in rows]


MHA_BF16_CASES = [  # label, B, S, H, KV, D, window
    ("serve B1 S512 H16 KV2 D128", 1, 512, 16, 2, 128, 0),
    ("serve B1 S1024 H16 KV2 D128", 1, 1024, 16, 2, 128, 0),
    ("recurrentgemma B1 S4096 H16 KV1 D256 window 2048", 1, 4096, 16, 1,
     256, 2048),
]


def mha_bf16_rows(label, B, S, H, KV, D, window, seed):
    import inspect

    import numpy as np
    import torch
    from repro_torch.kernels import attention as mk
    from repro_torch.launch.gemm_probe import device_ms
    if window and "window" not in inspect.signature(mk.mha).parameters:
        return [f"mha bf16 {label}: not built by this tree"]
    kw = {"window": window} if window else {}
    rng = np.random.default_rng(seed)

    def make():
        return tuple(torch.tensor(rng.standard_normal(s), dtype=torch.bfloat16,
                                  device="cuda")
                     for s in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D)))
    copies = _copies(make, 2 * B * S * (H + 2 * KV) * D)
    ms = device_ms(lambda j: mk.mha(*copies[j % len(copies)], causal=True,
                                    **kw), 2 * len(copies), SESSIONS)
    return [f"mha bf16 {label} [wrapper]: device {ms:.4f} ms"]


def pool_rows(dtype_name, N, seed):
    import ctypes

    import numpy as np
    import torch
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import maxpool as pk
    from repro_torch.launch.gemm_probe import device_ms
    dt = getattr(torch, dtype_name)
    H, W, C, win, st = 112, 112, 64, 3, 2
    OH = OW = (H - win) // st + 1
    rng = np.random.default_rng(seed)

    def make():
        return torch.tensor(rng.standard_normal((N, H, W, C)),
                            dtype=torch.float32, device="cuda").to(dt)
    esz = torch.empty(0, dtype=dt).element_size()
    copies = _copies(make, N * H * W * C * esz)
    n = 2 * len(copies)
    bound = (N * H * W * C + N * OH * OW * C) * esz / 3.35e12 * 1e3
    outs = [torch.empty((N, OH, OW, C), dtype=dt, device="cuda")
            for _ in copies]
    want = ref.maxpool2d_ref(copies[0], window=win, stride=st)
    stream = torch.cuda.current_stream().cuda_stream
    code = 0 if dt == torch.float32 else 1

    def timed(label, launch):
        """``launch(x, out)`` checked bitwise on the first copy, then timed
        over the copies, each into an output of its own."""
        out = outs[0].zero_()
        if launch(copies[0], out):
            raise RuntimeError(f"maxpool {label}: launch failed")
        if not ref.bitwise_equal(out, want):
            raise RuntimeError(f"maxpool {label}: differs from the plain "
                               "version")
        return label, device_ms(lambda j: launch(copies[j % len(copies)],
                                                 outs[j % len(copies)]),
                                n, SESSIONS)
    lib = pk._lib()
    rows = [("wrapper", device_ms(
        lambda j: pk.maxpool2d(copies[j % len(copies)], window=win,
                               stride=st), n, SESSIONS)),
            timed("kernel, bare launch", lambda x, o: lib.maxpool_launch(
                x.data_ptr(), o.data_ptr(), N, H, W, C, OH, OW, win, st,
                code, stream))]
    if (build.CSRC / "maxpool_probe.cu").exists():
        probe = build.library("maxpool_probe")
        i = ctypes.c_int
        probe.maxpool_probe_launch.argtypes = \
            [ctypes.c_void_p] * 2 + [i] * 9 + [ctypes.c_void_p]
        probe.maxpool_empty_launch.argtypes = [i] * 4 + [ctypes.c_void_p]
        for vec in (16 // esz, 1):
            for strip in (1, 2):
                rows.append(timed(
                    f"variant vec={vec} strip={strip}",
                    lambda x, o, v=vec, s=strip: probe.maxpool_probe_launch(
                        x.data_ptr(), o.data_ptr(), N, H, W, C, OH, OW, code,
                        v, s, stream)))

        def empty(j):
            if probe.maxpool_empty_launch(N, C, OH, OW, stream):
                raise RuntimeError("empty launch failed")
        rows.append(("empty kernel on the kernel's grid",
                     device_ms(empty, n, SESSIONS)))
    return [f"maxpool {N}x{H}x{W}x{C} {win}x{win}/{st} {dtype_name} [{k}]: "
            f"device {ms:.4f} ms (bound {bound:.4f} ms, {bound / ms:.1%})"
            for k, ms in rows]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port-src", default=None,
                    help="a checkout's src/ whose repro_torch is timed "
                         "(default: the one on the path)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=("mha", "maxpool"), default=None)
    args = ap.parse_args(argv)
    if args.port_src:
        sys.path.insert(0, args.port_src)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("mha_pool_probe times kernels on a CUDA device")
    label = args.port_src or "repro_torch"
    rows = []
    if args.only != "maxpool":
        for i, case in enumerate(MHA_CASES):
            rows += mha_rows(*case, seed=args.seed + i)
        for i, case in enumerate(MHA_BF16_CASES):
            rows += mha_bf16_rows(*case, seed=args.seed + 20 + i)
    if args.only != "mha":
        for N in (1, 8):
            for dt in ("float32", "bfloat16"):
                rows += pool_rows(dt, N, args.seed + 10)
    for row in rows:
        print(f"[{label}] {row}", flush=True)


if __name__ == "__main__":
    main()
