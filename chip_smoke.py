#!/usr/bin/env python3
"""The quickest proof that the PyTorch port starts and serves on the GPU.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Phases, each failing loudly (non-zero exit, no result line):

1. card: the GPU's name and power limit (``nvidia-smi``); no CUDA -> exit 1.
2. build: every CUDA kernel of ``src/repro_torch/kernels/csrc`` from source,
   one ``nvcc`` per file, all at once.
3. correctness: each kernel against its plain PyTorch version on the card,
   at the serving path's widths (qwen2.5-3b: 16 query heads over 2 KV heads,
   head dim 128, bf16) plus small cases for the kernels' other features.
4. times: CUDA-event times of each kernel, its plain version and (for mha)
   PyTorch's SDPA, beside the card's least time for the same work.
5. kernel layer (gemm_os float and int8 with the quant epilogue,
   conv_im2col, maxpool, blocked_layout, tiled_transpose; built in phase 2),
   drawing from a generator of its own so that phase 6's traffic does not
   depend on it: each kernel against its plain version on the card at the
   JAX tests' cases and the paper's workload shapes (BERT-Base FFN,
   ResNet-50), mha at the benchmark's head dim 64, a check that each
   tolerance has teeth (fp32 and bf16), times beside the bound and a
   PyTorch yardstick, then one run of the kernel benchmark port
   (``repro_torch.launch.kernel_bench``) at full shapes, which must launch
   every kernel, give finite rows, and hold each row's output against its
   plain version on the same inputs.
6. serve: qwen2.5-3b at full width with seeded random weights, through the
   paged engine and the scheduler; checks every request finished, the
   kernel launch counts, and a 2-layer full-width prefill/decode against an
   fp32 CPU reference.

The line before the last is a JSON ``{"kernels": [...]}`` summary; the last
line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import attention as mha_kernel  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import conv_im2col as conv_kernel  # noqa: E402
from repro_torch.kernels import gemm_os as gemm_kernel  # noqa: E402
from repro_torch.kernels import maxpool as pool_kernel  # noqa: E402
from repro_torch.kernels import paged_attention as paged_kernel  # noqa: E402
from repro_torch.kernels import reshuffle as reshuffle_kernel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import kernel_bench as bench  # noqa: E402
from repro_torch.launch.kernel_bench import cuda_ms  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.runtime.serving import PagedServingEngine, Request  # noqa: E402

SEED = 0

# serving configuration of phase 6 (and the shapes phase 4 times at)
SLOTS, MAX_LEN, PAGE, MAX_NEW, N_REQ = 8, 1024, 16, 32, 16
H, KV, D = 16, 2, 128


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"[chip_smoke] FAILED: {msg}")


# ---------------------------------------------------------------------------
# phases 1-2
# ---------------------------------------------------------------------------


def card() -> str:
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "nvidia-smi unavailable"
    log(f"card: {torch.cuda.get_device_name(0)} "
        f"(torch {torch.__version__}, CUDA {torch.version.cuda})")
    return line


def build_kernels() -> None:
    t0 = time.perf_counter()
    reports = build.build_all()
    log(f"build: {len(reports)} CUDA sources in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in reports.items():
        for ln in text.splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"  {name}: {ln.strip()}")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def paged_case(rng, B, T, Hq, KVh, Dh, page, lengths, n_blocks, dtype,
               kv_scale=None):
    """Random q and pools whose live pages are scattered through the pool by
    a shuffled block table; scratch page 0, unowned table entries and the
    rows past each length hold finite garbage (1e4)."""
    dev = "cuda"
    n_live = [-(-n // page) for n in lengths]
    P = 1 + sum(n_live)
    perm = rng.permutation(np.arange(1, P)).astype(np.int32)
    table = np.zeros((B, n_blocks), np.int32)
    nxt = 0
    for b, n in enumerate(n_live):
        table[b, :n] = perm[nxt:nxt + n]
        nxt += n
    q = torch.tensor(rng.standard_normal((B, T, Hq, Dh)), dtype=dtype,
                     device=dev)

    def pool():
        x = torch.tensor(rng.standard_normal((P, page, KVh, Dh)),
                         dtype=torch.float32, device=dev)
        x[0] = 1e4
        for b, n in enumerate(lengths):
            if n % page:
                x[int(table[b, n // page]), n % page:] = 1e4
        if kv_scale is not None:
            return torch.clamp(torch.round(x * (127.0 / kv_scale)), -127,
                               127).to(torch.int8)
        return x.to(dtype)

    return (q, pool(), pool(), torch.tensor(table, device=dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


def agrees(name, got, want) -> float:
    """Logs and checks one case: on every query row the error over the
    row's largest reference output stays within ref.ROW_TOL. Returns the
    case's max abs error."""
    err = (got.float() - want.float()).abs().max().item()
    worst = ref.row_error(got, want).max().item()
    tol = ref.ROW_TOL[got.dtype]
    ok = worst <= tol
    log(f"{name}: max abs err {err:.3g}, worst row {worst:.3g} of its "
        f"largest output (tolerance {tol:g}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err


def mask_shift_caught(name, shifted, want) -> None:
    """The tolerance must fail a kernel whose mask is off by one key:
    ``shifted``, the plain version with the mask moved by one key, has to
    miss ``want`` on every row. Run at fp32, where rounding leaves the most
    room below the shift; the masking code is the same for every dtype."""
    least = ref.row_error(shifted, want).min().item()
    tol = ref.ROW_TOL[want.dtype]
    log(f"{name}: one-key mask shift, least row error {least:.3g} (must "
        f"exceed {tol:g})")
    if not least > tol:
        fail(f"{name}: the tolerance lets a one-key mask shift pass")


def check_paged(rng) -> float:
    """Max abs error of the paged kernel against paged_attention_ref."""
    bf16, f32 = torch.bfloat16, torch.float32
    serve = ([1, 17, 64, 200, 333, 512, 600, 1000], MAX_LEN // PAGE)
    cases = [
        # name, B, T, page, lengths, n_blocks, dtype, kv_scale, window
        ("serve widths, ragged", SLOTS, 1, PAGE, *serve, bf16, None, 0),
        ("serve widths, ragged, fp32", SLOTS, 1, PAGE, *serve, f32, None, 0),
        ("T=4 block", 3, 4, PAGE, [4, 37, 300], 32, bf16, None, 0),
        ("window 48, T=2", 3, 2, PAGE, [2, 49, 400], 32, bf16, None, 48),
        ("int8 pools", 3, 1, PAGE, [5, 130, 511], 32, bf16, 8.0, 0),
        ("page 64, fp32", 2, 1, 64, [70, 500], 8, f32, None, 0),
    ]
    worst = 0.0
    for name, B, T, page, lengths, nb, dtype, scale, window in cases:
        q, kp, vp, table, lens = paged_case(rng, B, T, H, KV, D, page,
                                            lengths, nb, dtype, scale)
        got = paged_kernel.paged_attention(q, kp, vp, table, lens,
                                           kv_scale=scale, window=window)
        torch.cuda.synchronize()
        want = ref.paged_attention_ref(q, kp, vp, table, lens,
                                       kv_scale=scale, window=window)
        worst = max(worst, agrees(f"paged_attention [{name}]", got, want))
        if name == "serve widths, ragged, fp32":  # drop each row's last key
            mask_shift_caught(f"paged_attention [{name}]",
                              ref.paged_attention_ref(q, kp, vp, table,
                                                      lens - 1), want)
    return worst


MHA_SERVE = [
    # name, B, Sq, Sk, causal, kv_valid, dtype; at (H, KV, D) of serving
    ("prefill 1024, causal", 1, 1024, 1024, True, None, torch.bfloat16),
    ("prefill 1024, causal, fp32", 1, 1024, 1024, True, None, torch.float32),
    ("kv_valid (200, 0), causal", 2, 256, 256, True, [200, 0],
     torch.bfloat16),
    ("kv_valid (77, 300), cross", 2, 100, 300, False, [77, 300],
     torch.bfloat16),
    ("ragged fp32", 1, 100, 100, True, None, torch.float32),
]
MHA_BENCH = [  # the kernel benchmark's kernel_mha row: H 8, KV 2, D 64
    ("bench B1 S1024 H8 kv2 D64, causal", 1, 1024, 1024, True, None,
     torch.bfloat16),
    ("bench B1 S1024 H8 kv2 D64, causal, fp32", 1, 1024, 1024, True, None,
     torch.float32),
]


def check_mha(rng, cases, heads=(H, KV, D)) -> float:
    """Max abs error of the mha kernel against mha_ref over ``cases``, at
    ``heads`` = (query heads, KV heads, head dim)."""
    Hq, KVh, Dh = heads
    worst = 0.0
    for name, B, Sq, Sk, causal, valid, dtype in cases:
        def t(*shape):
            return torch.tensor(rng.standard_normal(shape), dtype=dtype,
                                device="cuda")
        q, k, v = t(B, Sq, Hq, Dh), t(B, Sk, KVh, Dh), t(B, Sk, KVh, Dh)
        kv_valid = None if valid is None else torch.tensor(
            valid, dtype=torch.int32, device="cuda")
        got = mha_kernel.mha(q, k, v, causal=causal, kv_valid=kv_valid)
        torch.cuda.synchronize()
        want = ref.mha_ref(q, k, v, causal=causal, kv_valid=kv_valid)
        worst = max(worst, agrees(f"mha [{name}]", got, want))
        if causal and Sq == Sk == 1024 and dtype == torch.float32:
            # row i sees keys < i
            mask_shift_caught(f"mha [{name}]", ref.mha_ref(
                q[:, 1:], k[:, :-1], v[:, :-1], causal=True), want[:, 1:])
    return worst


# ---------------------------------------------------------------------------
# phase 4: times
# ---------------------------------------------------------------------------


def time_paged(rng, B, lengths, label):
    """Times at (B, lengths): a pool per layer, cycled through so that the
    pools together exceed the 50 MB L2 cache, as the serving path's 36
    layers do."""
    n_blocks = MAX_LEN // PAGE if max(lengths) <= MAX_LEN else \
        -(-max(lengths) // PAGE)
    live = sum(lengths) * KV * D * 2 * 2          # K and V, bf16
    n_pools = max(2, int(np.ceil(3 * 50e6 / live)))
    layers = [paged_case(rng, B, 1, H, KV, D, PAGE, lengths, n_blocks,
                         torch.bfloat16) for _ in range(n_pools)]
    it = {"i": 0}

    def run(fn):
        def call():
            q, kp, vp, table, lens = layers[it["i"] % n_pools]
            it["i"] += 1
            fn(q, kp, vp, table, lens)
        return call

    ms = cuda_ms(run(paged_kernel.paged_attention), iters=4 * n_pools)
    plain = cuda_ms(run(ref.paged_attention_ref), iters=n_pools, warmup=1)
    q = layers[0][0]
    n_bytes = live + 2 * q.numel() * q.element_size() + B * n_blocks * 4 + B * 4
    flops = 4 * sum(lengths) * H * D
    bms, by = bench.bound_ms(n_bytes, flops, torch.bfloat16)
    log(f"paged_attention time [{label}]: {ms:.4f} ms/launch, plain "
        f"{plain:.4f} ms, bound {bms:.4f} ms ({by}), "
        f"{bms / ms:.1%} of bound")
    return ms, plain, bms, by


def time_mha(rng, Sq, label):
    def t(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.bfloat16,
                            device="cuda")
    q, k, v = t(1, Sq, H, D), t(1, Sq, KV, D), t(1, Sq, KV, D)
    ms = cuda_ms(lambda: mha_kernel.mha(q, k, v, causal=True))
    plain = cuda_ms(lambda: ref.mha_ref(q, k, v, causal=True), iters=5)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    n_bytes = 2 * q.numel() * 2 + 2 * k.numel() * 2
    flops = 4 * H * D * Sq * (Sq + 1) / 2
    bms, by = bench.bound_ms(n_bytes, flops, torch.bfloat16)
    log(f"mha time [{label}]: {ms:.4f} ms/launch, plain {plain:.4f} ms, "
        f"SDPA {lib:.4f} ms, bound {bms:.4f} ms ({by}), "
        f"{bms / ms:.1%} of bound")
    return ms, plain, bms, by, lib


# ---------------------------------------------------------------------------
# phase 5: the kernel layer
# ---------------------------------------------------------------------------


def same_bits(name, got, want) -> float:
    """Logs and checks a case that must be bitwise equal
    (``ref.bitwise_equal``). Returns its max abs error (0)."""
    ok = ref.bitwise_equal(got, want)
    log(f"{name}: {'bitwise equal' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name} differs from its plain version")
    return 0.0


def sum_order(name, got, want, abs_product, depth) -> float:
    """Logs and checks one float GEMM or conv case: each element within
    depth * 2^-24 * (|x| @ |w|) of the plain version (+ one bf16 step of
    |want| for a bf16 output; ref.sum_order_error). Returns its max abs
    error."""
    err = (got.double() - want.double()).abs().max().item()
    worst = ref.sum_order_error(got, want, abs_product, depth).item()
    log(f"{name}: max abs err {err:.3g}, worst element at {worst:.3g} of "
        f"its limit {'ok' if worst <= 1 else 'MISMATCH'}")
    if not worst <= 1:
        fail(f"{name} disagrees with its plain version")
    return err


def has_teeth(name, wrong, want, abs_product, depth) -> None:
    """The limit must reject a plain version with a known fault."""
    ratio = ref.sum_order_ratio(wrong, want, abs_product, depth)
    worst, n_out = ratio.max().item(), int((ratio > 1).sum())
    log(f"{name}: worst element at {worst:.3g} of its limit, {n_out} of "
        f"{want.numel()} elements outside (must be rejected)")
    if not worst > 1:
        fail(f"{name}: the tolerance lets a known fault pass")


def _rand(rng, shape, dtype):
    if dtype == torch.int8:
        return torch.tensor(rng.integers(-128, 128, shape), dtype=dtype,
                            device="cuda")
    return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                        device="cuda").to(dtype)


def check_gemm(rng):
    """Max abs errors (float, int8) of gemm_os against gemm_ref: the JAX
    tests' shapes in fp32, bf16 and int8, the quant scales, the int32
    accumulation, the BERT-Base FFN at token size 512, and an output type
    other than the input's (``out_dtype``) both ways."""
    f32, bf16, i8 = torch.float32, torch.bfloat16, torch.int8
    tests = [(8, 8, 8), (100, 300, 200), (128, 128, 128), (1, 512, 96),
             (257, 129, 65)]
    ffn = (512, 768, 3072)
    float_cases = [(s, dt, dt) for dt in (f32, bf16) for s in tests] + [
        (ffn, bf16, bf16), (ffn, f32, f32)] + [
        (s, a, b) for s in ((257, 129, 65), ffn)
        for a, b in ((f32, bf16), (bf16, f32))]
    err_f = 0.0
    for (M, K, N), dt, out in float_cases:
        x, w = _rand(rng, (M, K), dt), _rand(rng, (K, N), dt)
        got = gemm_kernel.gemm_os(x, w, out_dtype=out)
        torch.cuda.synchronize()
        want = ref.gemm_ref(x, w, out_dtype=out)
        absp = ref.gemm_ref(x.abs().float(), w.abs().float())
        types = f"{dt}" if out == dt else f"{dt} -> {out}"
        err_f = max(err_f, sum_order(f"gemm_os [{M}x{K}x{N} {types}]", got,
                                     want, absp, K))
        if (M, K, N) == ffn and out == dt:
            has_teeth(f"gemm_os [{types}, last K tile of 16 dropped]",
                      ref.gemm_ref(x[:, :-16], w[:-16]), want, absp, K)
    err_i = 0.0
    for M, K, N in tests:
        x, w = _rand(rng, (M, K), i8), _rand(rng, (K, N), i8)
        err_i = max(err_i, same_bits(f"gemm_os int8 [{M}x{K}x{N}]",
                                     gemm_kernel.gemm_os(x, w),
                                     ref.gemm_ref(x, w)))
    quant = [((64, 256, 96), s) for s in (1.0, 0.01, 0.0005)] + [
        ((512, 3072, 768), 0.002)]
    for (M, K, N), scale in quant:
        x, w = _rand(rng, (M, K), i8), _rand(rng, (K, N), i8)
        err_i = max(err_i, same_bits(
            f"gemm_os int8 quant [{M}x{K}x{N}, scale {scale}]",
            gemm_kernel.gemm_os(x, w, quant_scale=scale),
            ref.gemm_ref(x, w, quant_scale=scale)))
    ones = torch.full((8, 512), 127, dtype=i8, device="cuda")
    acc = gemm_kernel.gemm_os(ones, ones.t().contiguous())
    err_i = max(err_i, same_bits("gemm_os int8 [512 * 127 * 127 in int32]",
                                 acc, torch.full_like(acc, 512 * 127 * 127)))
    return err_f, err_i


CONV_TESTS = [  # (N, H, W, C, K, R, stride), tests/test_kernels.py's specs
    (2, 12, 12, 16, 24, 3, 1), (2, 12, 12, 16, 24, 3, 2),
    (2, 8, 8, 8, 32, 1, 1), (2, 14, 14, 16, 8, 7, 2), (2, 9, 9, 16, 8, 3, 2)]
CONV_PAPER = [  # ResNet-50: the stem, and a stage-3 3x3
    (1, 224, 224, 3, 64, 7, 2), (1, 28, 28, 128, 128, 3, 1)]


def check_conv(rng) -> float:
    """Max abs error of conv_im2col against conv2d_ref."""
    err = 0.0
    for dt in (torch.float32, torch.bfloat16):
        for N, H, W, C, K, R, st in CONV_TESTS + CONV_PAPER:
            x, w = _rand(rng, (N, H, W, C), dt), _rand(rng, (R, R, C, K), dt)
            got = conv_kernel.conv2d(x, w, stride=st)
            torch.cuda.synchronize()
            want = ref.conv2d_ref(x, w, stride=st)
            absp = ref.conv2d_ref(x.abs().float(), w.abs().float(),
                                  stride=st)
            err = max(err, sum_order(
                f"conv_im2col [{N}x{H}x{W}x{C}->{K} {R}x{R}/{st} {dt}]", got,
                want, absp, R * R * C))
            if (H, R) == (224, 7):
                # the input moved down one row = the padding shifted by one
                shifted = torch.nn.functional.pad(x, (0, 0, 0, 0, 1, 0))[:, :-1]
                has_teeth(f"conv_im2col [stem {dt}, padding shifted by one "
                          f"row]", ref.conv2d_ref(shifted, w, stride=st),
                          want, absp, R * R * C)
    return err


def check_layout(rng):
    """Max abs errors (all must be 0) of maxpool, blocked_layout and
    tiled_transpose against their plain versions."""
    errs = {"maxpool": 0.0, "blocked_layout": 0.0, "tiled_transpose": 0.0}
    pools = [(2, 8, 8, 16, 2, 2), (2, 9, 9, 8, 3, 2), (2, 12, 12, 32, 3, 3),
             (2, 10, 10, 8, 5, 1), (1, 112, 112, 64, 3, 2)]
    blocks = [(5, 6, 256, 8), (5, 6, 256, 32), (5, 6, 256, 128),
              (4, 4, 100, 128), (56, 56, 256, 8), (56, 56, 256, 128),
              (28, 28, 100, 128)]
    mats = [(128, 128), (100, 70), (257, 33), (1, 129), (3072, 768),
            (1000, 3001)]
    for dt in (torch.float32, torch.bfloat16):
        for N, H, W, C, win, st in pools:
            x = _rand(rng, (N, H, W, C), dt)
            errs["maxpool"] = max(errs["maxpool"], same_bits(
                f"maxpool [{N}x{H}x{W}x{C} {win}x{win}/{st} {dt}]",
                pool_kernel.maxpool2d(x, window=win, stride=st),
                ref.maxpool2d_ref(x, window=win, stride=st)))
        x = _rand(rng, (2, 9, 9, 8), dt)
        x[0, 4, 4, 3] = float("nan")
        x[1, 0, 0, 0] = float("nan")
        errs["maxpool"] = max(errs["maxpool"], same_bits(
            f"maxpool [NaN in two windows, {dt}]",
            pool_kernel.maxpool2d(x, window=3, stride=2),
            ref.maxpool2d_ref(x, window=3, stride=2)))
        for H, W, C, cb in blocks:
            x = _rand(rng, (H, W, C), dt)
            errs["blocked_layout"] = max(errs["blocked_layout"], same_bits(
                f"blocked_layout [{H}x{W}x{C} cb{cb} {dt}]",
                reshuffle_kernel.blocked_layout(x, cb),
                ref.blocked_layout_ref(x, cb)))
        for M, N in mats:
            x = _rand(rng, (M, N), dt)
            errs["tiled_transpose"] = max(errs["tiled_transpose"], same_bits(
                f"tiled_transpose [{M}x{N} {dt}]",
                reshuffle_kernel.tiled_transpose(x), ref.transpose_ref(x)))
    return errs


def device_ms(fn, copies) -> float:
    """Device milliseconds per call of ``fn`` over one pass through
    ``copies``, from torch.profiler's kernel events: the kernel's own time,
    without the host's gaps between launches that the CUDA-event time
    includes when the host issues calls slower than the card runs them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(*copies[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for args in copies:
            fn(*args)
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)
    return busy / 1e3 / len(copies)


def time_layer() -> dict:
    """Times of each kernel at the paper's workload shapes; the first case
    of each name is the one the kernels line reports."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        ("gemm_os", bench.gemm_case(512, 768, 3072, bf16, "cuda")),
        ("gemm_os", bench.gemm_case(512, 768, 3072, f32, "cuda")),
        ("gemm_os_int8", bench.gemm_case(512, 3072, 768, torch.int8, "cuda",
                                         quant_scale=0.002)),
    ] + [("conv_im2col", bench.conv_case("cuda", N, H, W, C, K, R, st, dt,
                                         shape=f"{H}x{W}x{C}->{K} "
                                         f"{R}x{R}/{st}"))
         for dt in (bf16, f32) for N, H, W, C, K, R, st in CONV_PAPER] + [
        ("maxpool", bench.pool_case(1, 112, 112, 64, 3, 2, f32, "cuda")),
        ("maxpool", bench.pool_case(1, 112, 112, 64, 3, 2, bf16, "cuda")),
        ("blocked_layout", bench.blocked_case(56, 56, 256, 8, f32, "cuda")),
        ("blocked_layout", bench.blocked_case(56, 56, 256, 128, f32, "cuda")),
        ("blocked_layout", bench.blocked_case(28, 28, 100, 128, f32, "cuda")),
        ("tiled_transpose", bench.transpose_case(3072, 768, f32, "cuda")),
        ("tiled_transpose", bench.transpose_case(1000, 3001, f32, "cuda")),
    ]
    first = {}
    for name, c in cases:
        m = bench.measure(c)
        dev = device_ms(c["fn"], bench.cold_copies(c["args"], c["n_bytes"]))
        dtype = c["args"][0].dtype
        lib = "none" if m["library_ms"] is None else \
            f"{m['library_ms']:.4f} ms"
        log(f"{name} time [{c['shape']} {dtype}]: {m['ms']:.4f} ms/launch "
            f"(device {dev:.4f} ms), plain {m['plain_ms']:.4f} ms, library "
            f"{lib}, bound {m['bound_ms']:.4f} ms ({m['bound_by']}), "
            f"{m['bound_ms'] / m['ms']:.1%} of bound")
        first.setdefault(name, m)
    return first


def run_kernel_bench() -> dict:
    """The kernel layer's main path: the benchmark port at full shapes,
    through ``ops``. Returns the launch counts over this run."""
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rows = bench.run(smoke=False, device="cuda")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    log(f"kernel bench: {len(rows)} rows in {time.perf_counter() - t0:.1f} s")
    for r in rows:
        log("kernel bench: " + ",".join(
            f"{v:.6g}" if isinstance(v, float) else str(v)
            for v in r.values()))
    for r in rows:
        for k in ("ms", "plain_ms", "library_ms", "bound_us"):
            if r[k] != "" and not (isinstance(r[k], float)
                                   and np.isfinite(r[k]) and r[k] > 0):
                fail(f"kernel bench: {r['bench']} {r['shape']} {k} = {r[k]}")
    # bench.run raised already if a row disagreed with its plain version
    checked = [r["err_of_limit"] for r in rows if r["err_of_limit"] != ""]
    log(f"kernel bench: {len(checked)} of {len(rows)} rows held against "
        f"their plain versions, worst error at {max(checked):.3g} of its "
        f"limit")
    log(f"kernel bench: kernel launches {counts}")
    idle = [k for k, n in counts.items() if n == 0]
    if idle:
        fail(f"kernel bench: kernels never launched: {idle}")
    return counts


def kernel_layer(rng):
    """Phase 5; returns the kernels line's entries of the six new kernel
    datapaths, and mha's max abs error at the benchmark's head dim 64."""
    with bench.fp32_exact():     # plain versions and yardsticks in fp32
        err_mha = check_mha(rng, MHA_BENCH, heads=(8, 2, 64))
        err_gemm, err_int8 = check_gemm(rng)
        err_conv = check_conv(rng)
        errs = check_layout(rng)
        times = time_layer()
    counts = run_kernel_bench()
    src = "src/repro_torch/kernels/csrc/"
    jax = "src/repro/kernels/"
    meta = [("gemm_os", "gemm_os.cu", "gemm_os.py:35", err_gemm),
            ("gemm_os_int8", "gemm_os.cu", "gemm_os.py:35", err_int8),
            ("conv_im2col", "conv_im2col.cu", "conv_im2col.py:31", err_conv),
            ("maxpool", "maxpool.cu", "maxpool.py:19", errs["maxpool"]),
            ("blocked_layout", "reshuffle.cu", "reshuffle.py:22",
             errs["blocked_layout"]),
            ("tiled_transpose", "reshuffle.cu", "reshuffle.py:44",
             errs["tiled_transpose"])]
    return [{"name": name, "route": "cuda", "source": src + cu,
             "replaces": jax + at, "launches": counts[name],
             "max_abs_err": err, "ms": times[name]["ms"],
             "plain_ms": times[name]["plain_ms"],
             "bound_ms": times[name]["bound_ms"],
             "bound_by": times[name]["bound_by"],
             "library_ms": times[name]["library_ms"]}
            for name, cu, at, err in meta], err_mha


# ---------------------------------------------------------------------------
# phase 6: serve
# ---------------------------------------------------------------------------


def check_model(rng) -> float:
    """qwen2.5-3b at full width cut to 2 layers: the decode logits of the
    port on the card (flash-MHA prefill, pages, flash-decode) against an
    fp32 CPU prefill of the same tokens from the same weights. Returns the
    error relative to the largest reference logit."""
    cfg = dataclasses.replace(get_config("qwen2.5-3b"), num_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    params = api.init_params(cfg, gen, device="cuda")
    prompt = [int(t) for t in rng.integers(0, cfg.vocab, 40)]
    eng = PagedServingEngine(cfg, params, slots=1, max_len=128,
                             page_size=PAGE, device="cuda")
    req = Request(rid=0, prompt=prompt, max_new=4)
    if not eng.submit(req):
        fail("model check: admission rejected")
    eng.ensure_decode_capacity()
    logits, _ = api.decode_step(cfg, params, eng.cache, eng.cur_tok, eng.pos,
                                block_table=eng.block_table)
    seq = torch.tensor([prompt + req.generated], dtype=torch.int64)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    def to_cpu32(tree):
        if isinstance(tree, dict):
            return {k: to_cpu32(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_cpu32(v) for v in tree]
        return tree.float().cpu()

    params32 = to_cpu32(params)
    want, _, _ = api.prefill(cfg32, params32, seq)
    got = logits[0].float().cpu()
    err = ((got - want[0]).abs().max() / want[0].abs().max()).item()
    same = int(got[:cfg.vocab].argmax()) == int(want[0, :cfg.vocab].argmax())
    # bf16 weights and activations through 2 layers and a 2048-wide head
    # against fp32 arithmetic: ~1% of the logit scale; 5% is the limit
    log(f"model check (2 layers, full width): decode logits vs fp32 CPU "
        f"prefill: max err {err:.3g} of the logit scale (limit 0.05), "
        f"same argmax: {same}")
    if not err < 0.05 or not torch.isfinite(logits).all():
        fail("decode logits disagree with the fp32 reference")
    return err


def serve(rng):
    """The main path: qwen2.5-3b, full width, seeded weights on the card,
    paged engine + scheduler, greedy. Returns the kernels' launch counts
    over this run."""
    cfg = get_config("qwen2.5-3b")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = api.init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    log(f"serve: {cfg.name}, {cfg.param_count() / 1e9:.2f}B params, "
        f"{cfg.num_layers} layers, bf16, weights drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")

    def engine():
        return PagedServingEngine(cfg, params, slots=SLOTS, max_len=MAX_LEN,
                                  page_size=PAGE, device="cuda")

    # warm-up (cuBLAS heuristics, allocator) on a throwaway engine
    engine().run_to_completion([Request(rid=-1, prompt=list(range(64)),
                                        max_new=2)])
    system = [int(t) for t in rng.integers(0, cfg.vocab, 32)]
    lengths = rng.integers(64, 601, N_REQ)
    reqs = [Request(rid=i, prompt=system + [
        int(t) for t in rng.integers(0, cfg.vocab, int(n) - 32)],
        max_new=MAX_NEW) for i, n in enumerate(lengths)]
    eng = engine()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run_to_completion(reqs, max_steps=20 * N_REQ * MAX_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    m = eng.metrics()
    n_tok = sum(len(r.generated) for r in done)
    log(f"serve: {len(done)}/{N_REQ} requests (prompts "
        f"{int(lengths.min())}-{int(lengths.max())} tokens), {n_tok} tokens "
        f"in {wall:.2f} s = {n_tok / wall:.1f} tok/s, ttft p50 "
        f"{m['latency.ttft_p50_s']:.4f} s, tpot p50 "
        f"{m['latency.tpot_p50_s']:.4f} s, {int(m['engine.decode_steps'])} "
        f"decode steps, {int(m['engine.prefills'])} prefills, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"serve: kernel launches {counts}")
    if len(done) != N_REQ or any(len(r.generated) != MAX_NEW for r in done):
        fail("serve: not every request finished with max_new tokens")
    if any(not 0 <= t < cfg.vocab for r in done for t in r.generated):
        fail("serve: a token outside the vocabulary")
    want = dict.fromkeys(counts, 0)
    want.update({"paged_attention": cfg.num_layers * eng.decode_steps,
                 "mha": cfg.num_layers * eng.prefills})
    if counts != want:
        fail(f"serve: launches {counts} != {want} (layers x decode steps, "
             f"layers x prefills, no other kernel)")
    eng.alloc.check_no_aliasing()
    profile_decode(engine, rng, cfg.vocab)
    return counts


def profile_decode(eng_factory, rng, vocab) -> None:
    """torch.profiler over a short serve run (8 requests of 256 tokens, 8
    new tokens each): the card's busy share of the wall time and the
    kernels that take it, largest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    eng = eng_factory()
    reqs = [Request(rid=i, prompt=[int(t) for t in rng.integers(0, vocab,
                                                                256)],
                    max_new=8) for i in range(SLOTS)]
    for r in reqs:                  # admit outside the window: decode only
        if not eng.submit(r):
            fail("profile: admission rejected")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while eng.has_live():
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (kernels, copies): CPU ops also carry the
    # device time of what they launched and would count it twice
    rows = [(e.self_device_time_total, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(t for t, _ in rows)
    if busy <= 0:
        log("profile: no device time in the trace (not measured)")
        return
    log(f"profile: {eng.decode_steps} decode steps (B={SLOTS}, ~260-token "
        f"contexts), wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy / 1e3:.2f} ms = {busy / wall_us:.1%} (idle "
        f"{1 - busy / wall_us:.1%})")
    for t, key in sorted(rows, reverse=True)[:6]:
        log(f"profile:   {t / 1e3:8.3f} ms {t / busy:6.1%}  {key[:70]}")


def main() -> None:
    smi = card()
    build_kernels()
    rng = np.random.default_rng(SEED)
    err_paged = check_paged(rng)
    err_mha = check_mha(rng, MHA_SERVE)
    serve_lengths = [int(n) for n in rng.integers(64 + 32, 632, SLOTS)]
    paged_t = time_paged(rng, SLOTS, serve_lengths,
                         f"serve shapes: B={SLOTS}, contexts "
                         f"{min(serve_lengths)}-{max(serve_lengths)}")
    time_paged(rng, 16, [2048] * 16, "B=16, 2048-token contexts")
    mha_t = time_mha(rng, 1024, "serve shapes: B=1, Sq=Sk=1024 bucket")
    time_mha(rng, 512, "B=1, Sq=Sk=512 bucket")
    layer, err_mha64 = kernel_layer(np.random.default_rng(SEED + 2))
    err_mha = max(err_mha, err_mha64)
    check_model(rng)
    counts = serve(rng)
    print(smi, flush=True)
    print(json.dumps({"kernels": [
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:78",
         "launches": counts["paged_attention"], "max_abs_err": err_paged,
         "ms": paged_t[0], "plain_ms": paged_t[1], "bound_ms": paged_t[2],
         "bound_by": paged_t[3], "library_ms": None},
        {"name": "mha", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/mha.cu",
         "replaces": "src/repro/kernels/attention.py:32",
         "launches": counts["mha"], "max_abs_err": err_mha, "ms": mha_t[0],
         "plain_ms": mha_t[1], "bound_ms": mha_t[2], "bound_by": mha_t[3],
         "library_ms": mha_t[4]},
    ] + layer}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
