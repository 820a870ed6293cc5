#!/usr/bin/env python3
"""The quickest proof that the PyTorch port starts and serves on the GPU.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Phases, each failing loudly (non-zero exit, no result line):

1. card: the GPU's name and power limit (``nvidia-smi``); no CUDA -> exit 1.
2. build: every CUDA kernel of ``src/repro_torch/kernels/csrc`` from source,
   one ``nvcc`` per file, all at once; each source's build time.
3. correctness: each kernel against its plain PyTorch version on the card,
   at the serving path's widths (qwen2.5-3b: 16 query heads over 2 KV heads,
   head dim 128, bf16) plus small cases for the kernels' other features,
   and bf16 mha on inputs whose scores peak on one key, where a one-key
   mask shift must miss every row; fp32 mha with kv_valid 0 and 1, Sq !=
   Sk and Sq = 1 (a generator of its own), twice bit for bit at 1024.
   Paged flash-decode at every (q, pool) dtype pair, with its pages split
   over CTAs by the wrapper's plan (the largest split and none among the
   cases), fp32 also against its summation structure
   (``ref.paged_attention_split_ref``), twice bit for bit, and the split
   reference with one range dropped must miss every row that range fed.
4. times: CUDA-event and profiler device times of each kernel, its plain
   version and (for mha) PyTorch's SDPA, beside the card's least time for
   the same work; host microseconds per call of the paged, mha, conv and
   gemm_os wrappers (``repro_torch.launch.host_cost``).
5. kernel layer (gemm_os float and int8 with the quant epilogue,
   conv_im2col, maxpool, blocked_layout, tiled_transpose; built in phase 2),
   drawing from a generator of its own so that phase 6's traffic does not
   depend on it: each kernel against its plain version on the card at the
   JAX tests' cases and the paper's workload shapes (BERT-Base FFN,
   ResNet-50), gemm_os on the tensor cores through every loader and tile
   (views off a 16-byte boundary, two runs bit for bit, int8 at +-127, the
   epilogue's ties and clipping), maxpool at channel counts of whole
   16-byte vectors and not, off a 16-byte boundary, with NaN in shared
   columns and windows of -inf, mha at the benchmark's head dim 64 (fp32
   also with kv_valid 0 and 1, cross and Sq = 1; timed there and at the
   serving heads), a check that each tolerance has teeth (fp32 and
   bf16), event, device and host times beside the bound and a PyTorch
   yardstick's event and device times (int8 also ``torch._int_mm`` with w
   column-major), then one run of the kernel benchmark port
   (``repro_torch.launch.kernel_bench``) at full shapes, which must launch
   every kernel, give finite rows, and hold each row's output against its
   plain version on the same inputs.
6. serve: qwen2.5-3b at full width with seeded random weights, through the
   paged engine and the scheduler, each decode step a replay of the
   engine's CUDA graph (captured by a warm-up request on the same engine,
   then ``reset_metrics``); checks every request finished, the kernel
   launch counts (the paged kernel's by replay: layers x decode steps), one
   capture through admissions between steps, and a 2-layer full-width
   prefill/decode against an fp32 CPU reference; logs the tracer's host ms
   per decode step; holds one step's bf16 logits of the graph against the
   uncaptured step body at full depth; profiles a decode window (also
   timed without the profiler) and a prefill window.
7. the decode graph and the rest of the slice: at fp32, full width, 4 of
   36 layers, 16 steps of the graph against the uncaptured body and of the
   gather baseline against the kernel (equal greedy tokens, logits at a
   near tie); yi-6b, qwen1.5-4b and granite-3-2b at full width and depth
   (their paged and mha shapes against the plain versions, 4 requests of
   16 tokens, launch counts, one capture, peak memory); one
   ``repro_torch.launch.serve_bench --full --scenario mixed`` run, its CSV
   printed and gated by ``repro_torch.launch.check_csv``.
8. decode policies, the prefix cache, speculative decode (generators of
   their own): mha with a query offset (0, 1, 15, 16, 37, 512; Sq != Sk -
   offset) at the serving heads and D 64 in bf16 and fp32, and on peaked
   inputs where a mask shifted by one key must miss; paged flash-decode at
   T = 5 and T = 32; the sampler's Threefry keys and bits on the card
   equal the CPU's, its Gumbel noise within 1e-6 of its plain version;
   times of the noise kernel, a suffix prefill's mha (beside SDPA with the
   same mask) and the verify step's paged call. At fp32, full width, 4
   layers: prefix-cache, n-gram and self-drafting speculative greedy
   tokens equal the plain engine's; a sampled stream equals itself alone,
   in a batch and after a forced preemption; one capture a graph; the
   verify graph's outputs equal its uncaptured body's. At full depth,
   bf16, the serve phase's 16 requests greedy, with the prefix cache,
   sampled and speculative (tok/s, TTFT, TPOT, each run's launch counts).
   ``serve_bench --scenario shared-prefix|speculative|sampling`` at fp32
   on 4 layers, gated (``tokens_match_greedy`` must pass), then at bf16
   and full depth for the times.

The line before the last is a JSON ``{"kernels": [...]}`` summary (the
seven TPU kernels' counterparts and the sampler's noise kernel); the last
line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import os
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
from repro_torch.launch import host_cost  # noqa: E402
from repro_torch.launch import kernel_bench as bench  # noqa: E402
from repro_torch.launch.host_cost import host_us  # noqa: E402
from repro_torch.launch.kernel_bench import cuda_ms  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.runtime.serving import PagedServingEngine, Request  # noqa: E402
from repro_torch.runtime.trace import Tracer  # noqa: E402

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
        f"{time.perf_counter() - t0:.1f} s, all at once; each: " + ", ".join(
            f"{name} {sec:.1f} s" for name, (_, sec) in reports.items()))
    for name, (text, _) in reports.items():
        for ln in text.splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"  {name}: {ln.strip()}")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def paged_case(rng, B, T, Hq, KVh, Dh, page, lengths, n_blocks, dtype,
               kv_scale=None, pool_dtype=None):
    """Random q (``dtype``) and pools (``pool_dtype``, default q's; int8 with
    ``kv_scale``) whose live pages are scattered through the pool by a
    shuffled block table; scratch page 0, unowned table entries and the
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
        return x.to(dtype if pool_dtype is None else pool_dtype)

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
    miss ``want`` on every row."""
    least = ref.row_error(shifted, want).min().item()
    tol = ref.ROW_TOL[want.dtype]
    log(f"{name}: one-key mask shift, least row error {least:.3g} (must "
        f"exceed {tol:g})")
    if not least > tol:
        fail(f"{name}: the tolerance lets a one-key mask shift pass")


def paged_plan(B, T, n_blocks, page=PAGE) -> int:
    """The split plan of the paged wrapper at serving heads on this card."""
    return paged_kernel.split_plan(B, KV, n_blocks, page, T * (H // KV),
                                   build.sm_count(0))


def dropped_range_caught(name, args, splits, want) -> None:
    """The tolerance must fail a kernel that loses one range's partial:
    the split reference with its largest range dropped has to miss ``want``
    on every query row that range fed (sees a key of)."""
    q, kp, _, table, lens = args
    T = q.shape[1]
    first, last = ref.live_pages(lens, T, kp.shape[1], table.shape[1])
    ranges = ref.split_ranges(first, last, splits)
    rank = int((ranges[..., 1] - ranges[..., 0]).sum(0).argmax())
    wrong = ref.paged_attention_split_ref(*args, splits=splits, drop=rank)
    err = ref.row_error(wrong, want)                          # (B, T)
    lo, hi = ranges[:, rank, 0], ranges[:, rank, 1]
    qlen = lens.long()[:, None] - T + torch.arange(T, device=lens.device) + 1
    fed = lo[:, None] * kp.shape[1] < torch.minimum(hi[:, None] * kp.shape[1],
                                                    qlen)
    least = err[fed].min().item()
    tol = ref.ROW_TOL[want.dtype]
    log(f"{name}: range {rank} of {splits} dropped, least error over the "
        f"{int(fed.sum())} rows it fed {least:.3g} (must exceed {tol:g})")
    if not least > tol:
        fail(f"{name}: the tolerance lets a dropped range pass")


def check_paged(rng) -> float:
    """Max abs error of the paged kernel against paged_attention_ref, and
    for fp32 against its summation structure at the plan's split
    (paged_attention_split_ref, 1e-5 of each row's largest output)."""
    bf16, f32 = torch.bfloat16, torch.float32
    serve = ([1, 17, 64, 200, 333, 512, 600, 1000], MAX_LEN // PAGE)
    # the cases drawn from ``rng`` stay as they were, so that the serve
    # phase's traffic does too; the others draw from a generator of their own
    own = np.random.default_rng(SEED + 5)
    cases = [
        # name, generator, B, T, page, lengths, n_blocks, q dtype, pool
        # dtype, kv_scale, window
        ("serve widths, ragged", rng, SLOTS, 1, PAGE, *serve, bf16, bf16,
         None, 0),
        ("serve widths, ragged, fp32", rng, SLOTS, 1, PAGE, *serve, f32, f32,
         None, 0),
        ("T=4 block", rng, 3, 4, PAGE, [4, 37, 300], 32, bf16, bf16, None, 0),
        ("window 48, T=2", rng, 3, 2, PAGE, [2, 49, 400], 32, bf16, bf16,
         None, 48),
        ("int8 pools", rng, 3, 1, PAGE, [5, 130, 511], 32, bf16, None, 8.0,
         0),
        ("page 64, fp32", rng, 2, 1, 64, [70, 500], 8, f32, f32, None, 0),
        ("serve widths, bf16 q over fp32 pools", own, SLOTS, 1, PAGE, *serve,
         bf16, f32, None, 0),
        ("serve widths, fp32 q over bf16 pools", own, SLOTS, 1, PAGE, *serve,
         f32, bf16, None, 0),
        ("int8 pools, fp32 q", own, 3, 1, PAGE, [5, 130, 511], 32, f32, None,
         8.0, 0),
        ("one request, the largest split", own, 1, 1, PAGE, [1000], 64, bf16,
         bf16, None, 0),
        ("one request, the largest split, fp32", own, 1, 1, PAGE, [1000], 64,
         f32, f32, None, 0),
        ("B=66: one range", own, 66, 1, PAGE, [int(n) for n in own.integers(
            1, 1001, 66)], 64, bf16, bf16, None, 0),
    ]
    worst = 0.0
    for name, gen, B, T, page, lengths, nb, qt, pt, scale, window in cases:
        q, kp, vp, table, lens = paged_case(gen, B, T, H, KV, D, page,
                                            lengths, nb, qt, scale,
                                            pool_dtype=pt)
        S = paged_plan(B, T, nb, page)
        label = f"paged_attention [{name}, S={S}]"
        got = paged_kernel.paged_attention(q, kp, vp, table, lens,
                                           kv_scale=scale, window=window)
        torch.cuda.synchronize()
        want = ref.paged_attention_ref(q, kp, vp, table, lens,
                                       kv_scale=scale, window=window)
        worst = max(worst, agrees(label, got, want))
        if qt == f32:
            split = ref.paged_attention_split_ref(
                q, kp, vp, table, lens, kv_scale=scale, window=window,
                splits=S)
            err = ref.row_error(got, split).max().item()
            log(f"{label}: worst row {err:.3g} of its largest output against "
                f"the split reference (limit 1e-05)")
            if not err <= 1e-5:
                fail(f"{label} disagrees with its summation structure")
        if name.startswith("serve widths, ragged"):
            same_bits(f"{label}: two runs", got, paged_kernel.paged_attention(
                q, kp, vp, table, lens, kv_scale=scale, window=window))
        if name == "serve widths, ragged":
            for form, other in (("on the host", lens.cpu()),
                                ("as a list", lens.tolist())):
                same_bits(f"{label}: lengths {form}", got,
                          paged_kernel.paged_attention(q, kp, vp, table,
                                                       other))
        if name == "serve widths, ragged, fp32":  # drop each row's last key
            mask_shift_caught(label, ref.paged_attention_ref(
                q, kp, vp, table, lens - 1), want)
            dropped_range_caught(label, (q, kp, vp, table, lens), S, want)
    # head dims past 256: the wide body, for every pair
    for dh, qt, pt, scale, window in ((512, bf16, bf16, None, 0),
                                      (1024, f32, None, 8.0, 0),
                                      (1432, bf16, f32, None, 40)):
        q, kp, vp, table, lens = paged_case(own, 3, 2, H, KV, dh, PAGE,
                                            [2, 100, 700], 64, qt, scale,
                                            pool_dtype=pt)
        label = (f"paged_attention [head dim {dh}, {qt} q over "
                 f"{kp.dtype} pools, S={paged_plan(3, 2, 64)}]")
        got = paged_kernel.paged_attention(q, kp, vp, table, lens,
                                           kv_scale=scale, window=window)
        torch.cuda.synchronize()
        worst = max(worst, agrees(label, got, ref.paged_attention_ref(
            q, kp, vp, table, lens, kv_scale=scale, window=window)))
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
MHA_SERVE_F32 = [
    # fp32 at the serving heads: kv_valid 0 and 1 (a fully masked batch is
    # 0), Sq != Sk both ways, one query row, non-causal
    ("kv_valid (200, 1, 0), causal, fp32", 3, 256, 256, True, [200, 1, 0],
     torch.float32),
    ("kv_valid (77, 300), cross, fp32", 2, 100, 300, False, [77, 300],
     torch.float32),
    ("Sq 1 against 300 keys, kv_valid (300, 1), fp32", 2, 1, 300, False,
     [300, 1], torch.float32),
    ("Sq 150 > Sk 70, causal, fp32", 1, 150, 70, True, None, torch.float32),
]
MHA_BENCH = [  # the kernel benchmark's kernel_mha row: H 8, KV 2, D 64
    ("bench B1 S1024 H8 kv2 D64, causal", 1, 1024, 1024, True, None,
     torch.bfloat16),
    ("bench B1 S1024 H8 kv2 D64, causal, fp32", 1, 1024, 1024, True, None,
     torch.float32),
    # fp32 at D 64, where the plan takes 32-row blocks in 4 key splits
    ("bench heads, kv_valid (0, 1, 700), causal, fp32", 3, 1024, 1024, True,
     [0, 1, 700], torch.float32),
    ("bench heads, cross 300 x 1000, kv_valid (1000, 555), fp32", 2, 300,
     1000, False, [1000, 555], torch.float32),
    ("bench heads, Sq 1 against 333 keys, fp32", 2, 1, 333, True, None,
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
        if causal and Sq == Sk == 1024 and dtype == torch.float32 and \
                valid is None:
            # row i sees keys < i
            mask_shift_caught(f"mha [{name}]", ref.mha_ref(
                q[:, 1:], k[:, :-1], v[:, :-1], causal=True), want[:, 1:])
            # one summation order per output: the same bits again
            same_bits(f"mha [{name}], two runs", mha_kernel.mha(
                q, k, v, causal=causal, kv_valid=kv_valid), got)
        if valid is not None and 0 in valid and got[valid.index(0)].any():
            fail(f"mha [{name}]: a batch with kv_valid 0 is not all zeros")
    return worst


def mha_bf16_teeth(rng) -> float:
    """bf16 at serving widths, on inputs whose scores peak on one key
    (``ref.peaked_mha_inputs``): the kernel agrees with its plain version,
    and the plain version with its causal mask, or its kv_valid, shifted by
    one key misses on every row. On random inputs a shift moves a row by
    less than the bf16 tolerance. Returns the max abs error."""
    def cuda(arrays):
        return [torch.tensor(a, dtype=torch.bfloat16, device="cuda")
                for a in arrays]
    q, k, v = cuda(ref.peaked_mha_inputs(rng, 1, 1024, H, KV, D))
    got = mha_kernel.mha(q, k, v, causal=True)
    torch.cuda.synchronize()
    want = ref.mha_ref(q, k, v, causal=True)
    err = agrees("mha [peaked on the diagonal, causal 1024]", got, want)
    mask_shift_caught("mha [peaked on the diagonal, causal 1024]",
                      ref.mha_ref(q[:, 1:], k[:, :-1], v[:, :-1],
                                  causal=True), want[:, 1:])
    valid = [300, 123]
    q, k, v = cuda(ref.peaked_mha_inputs(rng, 2, 300, H, KV, D,
                                         last_key=[n - 1 for n in valid]))
    kv_valid = torch.tensor(valid, dtype=torch.int32, device="cuda")
    got = mha_kernel.mha(q, k, v, causal=False, kv_valid=kv_valid)
    torch.cuda.synchronize()
    want = ref.mha_ref(q, k, v, causal=False, kv_valid=kv_valid)
    err = max(err, agrees("mha [peaked on the last valid key, kv_valid "
                          "(300, 123)]", got, want))
    mask_shift_caught("mha [peaked on the last valid key, kv_valid "
                      "(300, 123)]", ref.mha_ref(
                          q, k, v, causal=False, kv_valid=kv_valid - 1), want)
    return err


# ---------------------------------------------------------------------------
# phase 4: times
# ---------------------------------------------------------------------------


def host_split(seed: int) -> None:
    """Where the host time of an mha, a conv and a gemm_os call goes
    (``repro_torch.launch.host_cost``): wrapper, ``ops``, bare C launch,
    and the PyTorch call beside it."""
    for kernel, routes in host_cost.measure(seed).items():
        log(f"host us/call, {kernel}: " + ", ".join(
            f"{route} {us:.1f}" for route, us in routes.items()))


def time_paged(rng, B, lengths, label):
    """Times at (B, lengths): a pool per layer, cycled through so that the
    pools together exceed the 50 MB L2 cache, as the serving path's 36
    layers do; CUDA-event and profiler device ms, the split plan."""
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
    dev = device_ms(paged_kernel.paged_attention, layers)
    plain = cuda_ms(run(ref.paged_attention_ref), iters=n_pools, warmup=1)
    host = host_us(lambda: paged_kernel.paged_attention(*layers[0]))
    q = layers[0][0]
    n_bytes = live + 2 * q.numel() * q.element_size() + B * n_blocks * 4 + B * 4
    flops = 4 * sum(lengths) * H * D
    bms, by = bench.bound_ms(n_bytes, flops, torch.bfloat16)
    log(f"paged_attention time [{label}, S={paged_plan(B, 1, n_blocks)}]: "
        f"{ms:.4f} ms/launch (device {dev:.4f} ms, host {host:.1f} us/call), "
        f"plain {plain:.4f} ms, bound {bms:.4f} ms ({by}), {bms / ms:.1%} "
        f"of bound ({bms / dev:.1%} on the device)")
    return ms, plain, bms, by


def time_mha(rng, Sq, label):
    def t(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.bfloat16,
                            device="cuda")
    q, k, v = t(1, Sq, H, D), t(1, Sq, KV, D), t(1, Sq, KV, D)
    def kernel():
        mha_kernel.mha(q, k, v, causal=True)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def sdpa():
        torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
    ms = cuda_ms(kernel)
    dev = device_ms(kernel, [()] * 20)
    plain = cuda_ms(lambda: ref.mha_ref(q, k, v, causal=True), iters=5)
    lib = cuda_ms(sdpa)
    lib_dev = device_ms(sdpa, [()] * 20)
    host = host_us(kernel)
    n_bytes = 2 * q.numel() * 2 + 2 * k.numel() * 2
    flops = 4 * H * D * Sq * (Sq + 1) / 2
    bms, by = bench.bound_ms(n_bytes, flops, torch.bfloat16)
    log(f"mha time [{label}]: {ms:.4f} ms/launch (device {dev:.4f} ms, host "
        f"{host:.1f} us/call), plain {plain:.4f} ms, SDPA {lib:.4f} ms "
        f"(device {lib_dev:.4f} ms), bound {bms:.4f} ms ({by}), "
        f"{bms / ms:.1%} of bound ({bms / dev:.1%} on the device)")
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


# gemm_os on the tensor cores: each loader variant (x by 16-byte copies
# where K is a whole number of 16-byte chunks, w where N is; else scalar
# loads) under each tile the launcher picks on an H100 (32 x 32 for the
# 100-row grids, 64 x 64 for 1000 x 1000), and M = 1
GEMM_TC = [(100, 256, 192), (100, 250, 192), (100, 256, 190), (100, 250, 190),
           (100, 248, 200), (1, 768, 3072), (1000, 256, 1024),
           (1000, 250, 1024), (1000, 256, 1002), (1000, 250, 1002)]


# gemm_os fp32 with the depth split over CTAs: the kernel bench's float
# rows, M = N = 1, and a depth no multiple of a range or a stage
GEMM_SPLIT = [(128, 4096, 128), (512, 512, 512), (1024, 1024, 1024),
              (1, 4096, 1), (100, 4099, 72)]


def _offset(a: torch.Tensor) -> torch.Tensor:
    """``a`` as a contiguous view one element past a 16-byte boundary."""
    buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)
    view = buf[1:].view(a.shape)
    view.copy_(a)
    return view


def f32_plan_label(plan) -> str:
    """A launcher's fp32 plan (``f32_plan``) as a log label."""
    bm, bn, chunk, splits = plan
    return f"tile {bm}x{bn}, {splits} range{'s' if splits > 1 else ''} " \
        f"of {chunk} deep"


def gemm_plan(M, K, N):
    return gemm_kernel.f32_plan(M, N, K, build.sm_count(0))


def conv_plan(N, H, W, C, K, R, stride):
    OH, OW, _, _ = ref.same_padding(H, W, R, R, stride)
    return conv_kernel.f32_plan(N * OH * OW, K, C, R, R,
                                build.sm_count(0))


def check_gemm(rng):
    """Max abs errors (float, int8) of gemm_os against gemm_ref: the JAX
    tests' shapes in fp32, bf16 and int8, the quant scales, the int32
    accumulation, the BERT-Base FFN at token size 512, an output type other
    than the input's (``out_dtype``) both ways, fp32 with its depth split
    over CTAs (the kernel bench's shapes, M = N = 1, a depth no multiple of
    a range; two runs bit for bit; 16 depth values dropped from the middle
    of one range must be rejected), and for the tensor-core paths (bf16,
    int8) every loader variant under each tile, views off a 16-byte
    boundary, two runs giving the same bits, int8 at K = 3072 with every
    input at +-127, and the epilogue's ties and clipping."""
    f32, bf16, i8 = torch.float32, torch.bfloat16, torch.int8
    tests = [(8, 8, 8), (100, 300, 200), (128, 128, 128), (1, 512, 96),
             (257, 129, 65)]
    ffn, ffn2 = (512, 768, 3072), (512, 3072, 768)
    float_cases = [(s, dt, dt) for dt in (f32, bf16) for s in tests] + [
        (s, bf16, bf16) for s in GEMM_TC] + [
        (ffn, bf16, bf16), (ffn, f32, f32)] + [
        (s, f32, f32) for s in GEMM_SPLIT] + [
        (s, a, b) for s in ((257, 129, 65), (1000, 256, 1024), ffn)
        for a, b in ((f32, bf16), (bf16, f32))]
    err_f = 0.0

    def float_case(label, x, w, out):
        got = gemm_kernel.gemm_os(x, w, out_dtype=out)
        torch.cuda.synchronize()
        want = ref.gemm_ref(x, w, out_dtype=out)
        absp = ref.gemm_ref(x.abs().float(), w.abs().float())
        return sum_order(label, got, want, absp, x.shape[1]), want, absp

    for (M, K, N), dt, out in float_cases:
        x, w = _rand(rng, (M, K), dt), _rand(rng, (K, N), dt)
        types = f"{dt}" if out == dt else f"{dt} -> {out}"
        plan = f", {f32_plan_label(gemm_plan(M, K, N))}" if dt == f32 else ""
        err, want, absp = float_case(f"gemm_os [{M}x{K}x{N} {types}{plan}]",
                                     x, w, out)
        err_f = max(err_f, err)
        if (M, K, N) == ffn and out == dt:
            has_teeth(f"gemm_os [{types}, last K tile of 16 dropped]",
                      ref.gemm_ref(x[:, :-16], w[:-16]), want, absp, K)
        if (M, K, N) == GEMM_SPLIT[0]:
            chunk = gemm_plan(M, K, N)[2]
            mid = K // chunk // 2 * chunk + chunk // 2 - 8
            dropped = x.clone()
            dropped[:, mid:mid + 16] = 0
            has_teeth(f"gemm_os [{M}x{K}x{N} {types}, 16 depth values "
                      f"dropped from the middle of range {mid // chunk}]",
                      ref.gemm_ref(dropped, w), want, absp, K)
    for which in ("x", "w", "both"):     # (96, 256, 160) admits copies
        x, w = _rand(rng, (96, 256), bf16), _rand(rng, (256, 160), bf16)
        x = _offset(x) if which != "w" else x
        w = _offset(w) if which != "x" else w
        err_f = max(err_f, float_case(
            f"gemm_os [96x256x160 bf16, {which} off a 16-byte boundary]", x,
            w, bf16)[0])
    err_i = 0.0
    for M, K, N in tests + GEMM_TC + [ffn, ffn2]:
        x, w = _rand(rng, (M, K), i8), _rand(rng, (K, N), i8)
        err_i = max(err_i, same_bits(f"gemm_os int8 [{M}x{K}x{N}]",
                                     gemm_kernel.gemm_os(x, w),
                                     ref.gemm_ref(x, w)))
    quant = [((64, 256, 96), s) for s in (1.0, 0.01, 0.0005)] + [
        (ffn2, 0.002), ((1000, 250, 1002), 0.002)]
    for (M, K, N), scale in quant:
        x, w = _rand(rng, (M, K), i8), _rand(rng, (K, N), i8)
        err_i = max(err_i, same_bits(
            f"gemm_os int8 quant [{M}x{K}x{N}, scale {scale}]",
            gemm_kernel.gemm_os(x, w, quant_scale=scale),
            ref.gemm_ref(x, w, quant_scale=scale)))
    for which in ("x", "w", "both"):
        x, w = _rand(rng, (96, 256), i8), _rand(rng, (256, 160), i8)
        x = _offset(x) if which != "w" else x
        w = _offset(w) if which != "x" else w
        err_i = max(err_i, same_bits(
            f"gemm_os int8 quant [96x256x160, {which} off a 16-byte "
            f"boundary]", gemm_kernel.gemm_os(x, w, quant_scale=0.01),
            ref.gemm_ref(x, w, quant_scale=0.01)))
    for (M, K, N), dt, scale in ((ffn, bf16, None), (ffn2, i8, None),
                                 (ffn2, i8, 0.002), (ffn, f32, None),
                                 (GEMM_SPLIT[0], f32, None)):
        x, w = _rand(rng, (M, K), dt), _rand(rng, (K, N), dt)
        same_bits(f"gemm_os [{M}x{K}x{N} {dt}, scale {scale}: two runs]",
                  gemm_kernel.gemm_os(x, w, quant_scale=scale),
                  gemm_kernel.gemm_os(x, w, quant_scale=scale))
    ones = torch.full((8, 512), 127, dtype=i8, device="cuda")
    acc = gemm_kernel.gemm_os(ones, ones.t().contiguous())
    err_i = max(err_i, same_bits("gemm_os int8 [512 * 127 * 127 in int32]",
                                 acc, torch.full_like(acc, 512 * 127 * 127)))
    sign = torch.tensor([-127, 127], dtype=i8, device="cuda")
    x = sign[torch.tensor(rng.integers(0, 2, (64, 3072)), device="cuda")]
    w = sign[torch.tensor(rng.integers(0, 2, (3072, 96)), device="cuda")]
    x[0], w[:, 0] = 127, 127
    acc = gemm_kernel.gemm_os(x, w)
    err_i = max(err_i, same_bits("gemm_os int8 [64x3072x96, every input "
                                 "+-127]", acc, ref.gemm_ref(x, w)))
    if int(acc[0, 0]) != 3072 * 127 * 127:
        fail("gemm_os int8: 3072 * 127^2 not exact in int32")
    # the epilogue's edges: scale 0.5 puts every odd acc on a tie; rows of x
    # at +-127 push acc * scale far past +-127 (K, N: 16-byte copies)
    x = torch.tensor(rng.integers(-3, 4, (64, 64)), dtype=i8, device="cuda")
    x[32:] = sign[torch.tensor(rng.integers(0, 2, (32, 64)), device="cuda")]
    w = torch.tensor(rng.integers(-3, 4, (64, 48)), dtype=i8, device="cuda")
    q = ref.gemm_ref(x, w).double() * 0.5
    log(f"gemm_os int8 quant [64x64x48, scale 0.5]: {int((q % 1 == 0.5).sum())}"
        f" ties, {int((q > 127).sum())} above 127, {int((q < -128).sum())} "
        f"below -128 of {q.numel()}")
    err_i = max(err_i, same_bits(
        "gemm_os int8 quant [64x64x48, scale 0.5: ties and clipping]",
        gemm_kernel.gemm_os(x, w, quant_scale=0.5),
        ref.gemm_ref(x, w, quant_scale=0.5)))
    return err_f, err_i


CONV_TESTS = [  # (N, H, W, C, K, R, stride), tests/test_kernels.py's specs
    (2, 12, 12, 16, 24, 3, 1), (2, 12, 12, 16, 24, 3, 2),
    (2, 8, 8, 8, 32, 1, 1), (2, 14, 14, 16, 8, 7, 2), (2, 9, 9, 16, 8, 3, 2)]
CONV_PAPER = [  # ResNet-50: the stem, and a stage-3 3x3
    (1, 224, 224, 3, 64, 7, 2), (1, 28, 28, 128, 128, 3, 1)]
CONV_BENCH = (1, 28, 28, 64, 128, 3, 1)  # the kernel bench's conv row


def check_conv(rng) -> float:
    """Max abs error of conv_im2col against conv2d_ref; fp32 at stage 3
    (taps split over CTAs) also twice, bit for bit."""
    err = 0.0
    for dt in (torch.float32, torch.bfloat16):
        for N, H, W, C, K, R, st in CONV_TESTS + CONV_PAPER + [CONV_BENCH]:
            x, w = _rand(rng, (N, H, W, C), dt), _rand(rng, (R, R, C, K), dt)
            got = conv_kernel.conv2d(x, w, stride=st)
            torch.cuda.synchronize()
            want = ref.conv2d_ref(x, w, stride=st)
            absp = ref.conv2d_ref(x.abs().float(), w.abs().float(),
                                  stride=st)
            plan = f", {f32_plan_label(conv_plan(N, H, W, C, K, R, st))}" \
                if dt == torch.float32 else ""
            label = f"conv_im2col [{N}x{H}x{W}x{C}->{K} {R}x{R}/{st} {dt}"
            err = max(err, sum_order(f"{label}{plan}]", got, want, absp,
                                     R * R * C))
            if dt == torch.float32 and (N, H, W, C, K, R, st) == \
                    CONV_PAPER[1]:
                same_bits(f"{label}: two runs]", got,
                          conv_kernel.conv2d(x, w, stride=st))
            if (H, R) == (224, 7):
                # the input moved down one row = the padding shifted by one
                shifted = torch.nn.functional.pad(x, (0, 0, 0, 0, 1, 0))[:, :-1]
                has_teeth(f"conv_im2col [stem {dt}, padding shifted by one "
                          f"row]", ref.conv2d_ref(shifted, w, stride=st),
                          want, absp, R * R * C)
                dropped = w.clone()
                dropped[-1, -1] = 0          # the last tap (kh, kw) = (6, 6)
                has_teeth(f"conv_im2col [stem {dt}, last tap dropped]",
                          ref.conv2d_ref(x, dropped, stride=st), want, absp,
                          R * R * C)
    return err


def check_layout(rng):
    """Max abs errors (all must be 0) of maxpool, blocked_layout and
    tiled_transpose against their plain versions."""
    errs = {"maxpool": 0.0, "blocked_layout": 0.0, "tiled_transpose": 0.0}
    pools = [(2, 8, 8, 16, 2, 2), (2, 9, 9, 8, 3, 2), (2, 12, 12, 32, 3, 3),
             (2, 10, 10, 8, 5, 1), (1, 112, 112, 64, 3, 2)]
    # the tests' cases (16-byte vectors where cb and C allow, else elements:
    # odd C, cb 3 and 6), the paper's, and two views off a 16-byte boundary
    blocks = [(5, 6, 256, 8), (5, 6, 256, 32), (5, 6, 256, 128),
              (4, 4, 100, 128), (5, 6, 6, 8), (5, 6, 30, 3), (5, 6, 36, 6),
              (4, 4, 104, 64), (56, 56, 256, 8), (56, 56, 256, 128),
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
        errs["maxpool"] = max(errs["maxpool"], check_pool_edges(rng, dt))
        for H, W, C, cb in blocks:
            x = _rand(rng, (H, W, C), dt)
            errs["blocked_layout"] = max(errs["blocked_layout"], same_bits(
                f"blocked_layout [{H}x{W}x{C} cb{cb} {dt}]",
                reshuffle_kernel.blocked_layout(x, cb),
                ref.blocked_layout_ref(x, cb)))
        for H, W, C, cb in ((5, 6, 256, 8), (4, 4, 104, 64)):
            x = _offset(_rand(rng, (H, W, C), dt))
            errs["blocked_layout"] = max(errs["blocked_layout"], same_bits(
                f"blocked_layout [{H}x{W}x{C} cb{cb} {dt}, off a 16-byte "
                f"boundary]", reshuffle_kernel.blocked_layout(x, cb),
                ref.blocked_layout_ref(x, cb)))
        # more channel blocks than a grid's y dimension takes
        for H, W, C, cb in ((1, 2, 70001, 1), (2, 1, 560008, 8)):
            x = torch.arange(1, H * W * C + 1, device="cuda",
                             dtype=torch.float32).reshape(H, W, C).to(dt)
            errs["blocked_layout"] = max(errs["blocked_layout"], same_bits(
                f"blocked_layout [{H}x{W}x{C} cb{cb} {dt}, {-(-C // cb)} "
                f"channel blocks]", reshuffle_kernel.blocked_layout(x, cb),
                ref.blocked_layout_ref(x, cb)))
        for M, N in mats:
            x = _rand(rng, (M, N), dt)
            errs["tiled_transpose"] = max(errs["tiled_transpose"], same_bits(
                f"tiled_transpose [{M}x{N} {dt}]",
                reshuffle_kernel.tiled_transpose(x), ref.transpose_ref(x)))
    return errs


def check_pool_edges(rng, dt) -> float:
    """maxpool at channel counts of no whole 16-byte vector (C = 3, 6, 13)
    and of whole ones (C = 8, 64) at windows the kernel fixes (2/2, 3/2,
    3/3) and others (1/1, 2/3, 5/1); on views off a 16-byte boundary; at
    the stem's batch 8; with a NaN in a column that two windows share; on
    windows of only -inf or only negative values. All bitwise; returns 0."""
    def case(label, x, win, st):
        same_bits(f"maxpool [{label}, {win}x{win}/{st} {dt}]",
                  pool_kernel.maxpool2d(x, window=win, stride=st),
                  ref.maxpool2d_ref(x, window=win, stride=st))
    for C in (3, 6, 13, 8, 64):
        for win, st in ((1, 1), (2, 3), (3, 2), (3, 3), (5, 1), (2, 2)):
            case(f"2x11x13x{C}", _rand(rng, (2, 11, 13, C), dt), win, st)
    for win, st in ((3, 2), (2, 2), (5, 1)):
        case("2x12x12x64 off a 16-byte boundary",
             _offset(_rand(rng, (2, 12, 12, 64), dt)), win, st)
    # the stem's pool at batch 8
    case("8x112x112x64", _rand(rng, (8, 112, 112, 64), dt), 3, 2)
    x = _rand(rng, (2, 11, 11, 8), dt)
    x[0, 4, 4, 1] = float("nan")      # four windows share it
    x[1, 3, 6, 7] = float("nan")      # two windows of one row share it
    case("NaN in shared columns", x, 3, 2)
    neg = -1.0 - _rand(rng, (2, 9, 9, 8), dt).abs()
    x = torch.full_like(neg, float("-inf"))
    x[1] = neg[1]
    for win, st in ((3, 2), (2, 2), (2, 3)):
        case("only negative values", neg, win, st)
        case("only -inf, and negatives", x, win, st)
    return 0.0


def device_ms(fn, copies, want: int = 3, tries: int = 12) -> float:
    """Device milliseconds per call of ``fn`` over one pass through
    ``copies``, from torch.profiler's kernel events: the kernel's own time,
    without the host's gaps between launches that the CUDA-event time
    includes when the host issues calls slower than the card runs them.
    On the H100 a profiler session now and then loses some or all of its
    kernel events, several sessions in a row at times. A session counts
    only if it recorded at least one kernel per call; the pass is profiled
    until ``want`` sessions count (at most ``tries``), and their median is
    returned. NaN, logged as not measured, if none counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(*copies[0])
    torch.cuda.synchronize()
    busy = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for args in copies:
                fn(*args)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        if sum(e.count for e in events) >= len(copies):
            busy.append(sum(e.self_device_time_total for e in events))
            if len(busy) == want:
                break
    if not busy:
        log(f"device time not measured: torch.profiler lost the kernel "
            f"events of all {tries} sessions")
        return float("nan")
    busy.sort()
    return busy[len(busy) // 2] / 1e3 / len(copies)


def time_layer() -> dict:
    """Times of each kernel at the paper's workload shapes, and of fp32
    gemm_os, conv_im2col and mha at the kernel bench's too (each fp32 gemm
    and conv row also logs its launcher's plan); the first case of each
    name is the one the kernels line reports (mha's comes from time_mha)."""
    f32, bf16 = torch.float32, torch.bfloat16

    def conv(dt, N, H, W, C, K, R, st):
        c = bench.conv_case("cuda", N, H, W, C, K, R, st, dt,
                            shape=f"{H}x{W}x{C}->{K} {R}x{R}/{st}")
        OH, OW, _, _ = ref.same_padding(H, W, R, R, st)
        c["plan"] = (conv_plan(N, H, W, C, K, R, st), N * OH * OW, K)
        return "conv_im2col", c

    def gemm(M, K, N, dt):
        c = bench.gemm_case(M, K, N, dt, "cuda")
        c["plan"] = (gemm_plan(M, K, N), M, N)
        return "gemm_os", c
    cases = [
        gemm(512, 768, 3072, bf16), gemm(512, 768, 3072, f32),
    ] + [gemm(M, K, N, f32) for M, K, N in GEMM_SPLIT[:3]] + [
        ("gemm_os_int8", bench.gemm_case(512, 3072, 768, torch.int8, "cuda",
                                         quant_scale=0.002)),
    ] + [conv(dt, *spec) for dt in (bf16, f32) for spec in CONV_PAPER] + [
        conv(f32, *CONV_BENCH),
        ("mha", bench.mha_case(False, "cuda")),   # the bench's fp32 row
        ("mha", bench.mha_case(False, "cuda", heads=(H, KV, D))),  # serve
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
        copies = bench.cold_copies(c["args"], c["n_bytes"])
        dev = device_ms(c["fn"], copies)
        host = host_us(lambda: c["fn"](*c["args"]))
        dtype = c["args"][0].dtype
        lib = "none"
        if m["library_ms"] is not None:
            lib_dev = device_ms(c["library"], bench.cold_copies(
                c["lib_args"], c["n_bytes"]))
            lib = f"{m['library_ms']:.4f} ms (device {lib_dev:.4f} ms)"
        log(f"{name} time [{c['shape']} {dtype}]: {m['ms']:.4f} ms/launch "
            f"(device {dev:.4f} ms, host {host:.1f} us/call), plain "
            f"{m['plain_ms']:.4f} ms, library {lib}, bound "
            f"{m['bound_ms']:.4f} ms ({m['bound_by']}), "
            f"{m['bound_ms'] / m['ms']:.1%} of bound "
            f"({m['bound_ms'] / dev:.1%} on the device)")
        if name == "gemm_os_int8":
            int_mm_col_major(c)
        if dtype == f32 and name in ("gemm_os", "conv_im2col"):
            log_plan(name, c)
        first.setdefault(name, m)
    return first


def log_plan(name, c) -> None:
    """The plan the fp32 launcher took for a timed case (``f32_plan``, kept
    in the case as ``c["plan"]`` = (plan, output rows, output columns)):
    its tile, its depth ranges, and the CTAs they give."""
    (bm, bn, chunk, splits), rows, cols = c["plan"]
    log(f"{name} plan [{c['shape']} torch.float32]: "
        f"{f32_plan_label((bm, bn, chunk, splits))}, "
        f"{-(-rows // bm) * -(-cols // bn) * splits} CTAs on "
        f"{build.sm_count(0)} SMs")


def int_mm_col_major(c) -> None:
    """A second yardstick for the int8 row: ``torch._int_mm`` with w given
    column-major (``w.t().contiguous().t()``, made outside the timed
    call). The row-major call (the row's library column) runs far below
    the tensor cores' rate, which suggests cuBLAS took a slow route for
    that layout; this call shows whether the layout is the cause."""
    x, w = c["lib_args"]
    wc = w.t().contiguous().t()
    copies = bench.cold_copies((x, wc), c["n_bytes"])
    ms = bench.cold_ms(torch._int_mm, copies)
    dev = device_ms(torch._int_mm, copies)
    log(f"gemm_os_int8 yardstick [{c['shape']}]: torch._int_mm with w "
        f"column-major {ms:.4f} ms (device {dev:.4f} ms), no epilogue")


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
    # the sampler's noise kernel serves the decode step, not a bench row
    idle = [k for k, n in counts.items() if n == 0 and k != "sampler_noise"]
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


class UncapturedEngine(PagedServingEngine):
    """The engine with its step body run as it is on the card, uncaptured:
    what the replayed CUDA graph must reproduce."""

    def _dispatch(self):
        self._step_body()


# logits of two runs of the port on the card, over the largest |logit|. fp32
# activations over the configs' bf16 KV cache: a key that differs by 1e-6
# between two runs (another order of the attention sums) can round to the
# neighbouring bf16 value, 2^-8 of it, so logits part by up to 5e-5 of the
# largest on the SMOKE config over 16 steps (CPU); 1e-3 is the bound. bf16
# is held to tests/test_torch_model.py's bound
F32_LOGIT_TOL = 1e-3
BF16_LOGIT_TOL = 2e-2


def lockstep(name, eng_a, eng_b, prompts, steps, tol, *,
             logits=False) -> None:
    """Admit ``prompts`` (one slot each) into both engines and step both
    ``steps`` times: engine b's greedy tokens must equal engine a's at every
    step. At a step whose tokens differ, every differing row's top-2 logit
    gap (engine a) and the step's logits must be within ``tol`` of the
    largest |logit| (a near tie, logged); the two runs part there and the
    comparison stops. ``logits=True`` holds every step's logits to ``tol``
    too. Logs the worst logit difference."""
    reqs = {}
    for key, eng in (("a", eng_a), ("b", eng_b)):
        reqs[key] = [Request(rid=i, prompt=p, max_new=steps + 1)
                     for i, p in enumerate(prompts)]
        for r in reqs[key]:
            if not eng.submit(r):
                fail(f"{name}: admission rejected")
    if [r.generated for r in reqs["a"]] != [r.generated for r in reqs["b"]]:
        fail(f"{name}: the prefills' tokens differ")
    V = eng_a.cfg.vocab
    worst = 0.0
    for s in range(1, steps + 1):
        eng_a.step()
        eng_b.step()
        la = eng_a.last_logits[:, :V].float()
        lb = eng_b.last_logits[:, :V].float()
        scale = la.abs().max().item()
        err = (la - lb).abs().max().item() / scale
        worst = max(worst, err)
        if not torch.isfinite(lb).all() or (logits and not err <= tol):
            fail(f"{name}: step {s}: logits differ by {err:.3g} of the "
                 f"largest (tolerance {tol:g})")
        ta = [r.generated[-1] for r in reqs["a"]]
        tb = [r.generated[-1] for r in reqs["b"]]
        if ta != tb:
            rows = [i for i in range(len(ta)) if ta[i] != tb[i]]
            top2 = la[rows].topk(2, dim=-1).values
            gap = (top2[:, 0] - top2[:, 1]).max().item() / scale
            log(f"{name}: step {s}: rows {rows} part on a near tie (top-2 "
                f"gap {gap:.3g} of the largest logit, logits within "
                f"{err:.3g}; tolerance {tol:g}); compared {s} steps")
            if not (gap < tol and err <= tol):
                fail(f"{name}: step {s}: greedy tokens differ")
            return
    log(f"{name}: {steps} step(s) x {len(prompts)} requests, equal greedy "
        f"tokens, logits within {worst:.3g} of the largest (tolerance "
        f"{tol:g}{', every step' if logits else ', at a near tie'})")


def phase_walls_per_step(tracer, steps: int) -> str:
    walls = tracer.phase_walls()
    return ", ".join(
        f"{name} {walls[name][1] / steps * 1e3:.3f}"
        for name in ("decode_tick", "ensure_capacity", "device_dispatch",
                     "host_sync") if name in walls)


def serve(rng):
    """The main path: qwen2.5-3b, full width, seeded weights on the card,
    paged engine + scheduler, greedy, each decode step a replay of the
    engine's CUDA graph. Returns the kernels' launch counts over this
    run, the weights and the run's prompts."""
    cfg = get_config("qwen2.5-3b")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = api.init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    log(f"serve: {cfg.name}, {cfg.param_count() / 1e9:.2f}B params, "
        f"{cfg.num_layers} layers, bf16, weights drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")

    def engine(tracer=None, cls=PagedServingEngine):
        return cls(cfg, params, slots=SLOTS, max_len=MAX_LEN,
                   page_size=PAGE, tracer=tracer, device="cuda")

    # warm-up (the decode graph's capture, cuBLAS heuristics, allocator) on
    # the engine that serves, then the reference's single reset point
    tracer = Tracer(enabled=True)
    eng = engine(tracer)
    t0 = time.perf_counter()
    eng.run_to_completion([Request(rid=-1, prompt=list(range(64)),
                                   max_new=2)])
    log(f"serve: warm-up request with the decode graph's capture "
        f"{time.perf_counter() - t0:.2f} s")
    eng.reset_metrics()
    tracer.clear()
    system = [int(t) for t in rng.integers(0, cfg.vocab, 32)]
    lengths = rng.integers(64, 601, N_REQ)
    traffic = [system + [int(t) for t in rng.integers(0, cfg.vocab,
                                                       int(n) - 32)]
               for n in lengths]
    reqs = [Request(rid=i, prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(traffic)]
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
    steps = eng.decode_steps
    log(f"serve: {len(done)}/{N_REQ} requests (prompts "
        f"{int(lengths.min())}-{int(lengths.max())} tokens), {n_tok} tokens "
        f"in {wall:.2f} s = {n_tok / wall:.1f} tok/s, ttft p50 "
        f"{m['latency.ttft_p50_s']:.4f} s, tpot p50 "
        f"{m['latency.tpot_p50_s']:.4f} s, {steps} decode steps (graph "
        f"replays), {eng.prefills} prefills, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"serve: tracer, host ms per decode step: "
        f"{phase_walls_per_step(tracer, steps)}; util.temporal "
        f"{m['util.temporal']:.3f}")
    log(f"serve: tracer, per phase:\n" + tracer.format_phase_walls())
    log(f"serve: kernel launches {counts} (the graph holds "
        f"{eng._graph_launches})")
    if len(done) != N_REQ or any(len(r.generated) != MAX_NEW for r in done):
        fail("serve: not every request finished with max_new tokens")
    if any(not 0 <= t < cfg.vocab for r in done for t in r.generated):
        fail("serve: a token outside the vocabulary")
    if m["sampling.step_traces"] != 1.0:
        fail(f"serve: {m['sampling.step_traces']} decode graph captures "
             f"after admissions between steps (must be 1)")
    want = serving_launches(cfg, eng)
    if counts != want:
        fail(f"serve: launches {counts} != {want} (layers x decode steps, "
             f"layers x prefills, a sampler launch a step and a prefill, "
             f"no other kernel)")
    eng.alloc.check_no_aliasing()
    # the graph against the uncaptured body at full depth: one step, bf16
    own = np.random.default_rng(SEED + 8)
    prompts = [[int(t) for t in own.integers(0, cfg.vocab, int(n))]
               for n in own.integers(64, 601, 4)]
    lockstep("graph vs uncaptured body, bf16, 36 layers",
             engine(cls=UncapturedEngine), engine(), prompts, 1,
             BF16_LOGIT_TOL, logits=True)
    profile_decode(engine, rng, cfg.vocab)
    profile_prefill(engine, rng, cfg.vocab)
    return counts, params, traffic


def serving_launches(cfg, eng) -> dict:
    """The launches a serve run must count: the paged kernel once a layer
    a decode step (a replay of either graph), mha once a layer a prefill,
    the sampler's noise kernel once a step and once a prefill, nothing
    else."""
    want = dict.fromkeys(ops.launch_counts(), 0)
    want.update({"paged_attention": cfg.num_layers * eng.decode_steps,
                 "mha": cfg.num_layers * eng.prefills,
                 "sampler_noise": eng.decode_steps + eng.prefills})
    return want


def profile_decode(eng_factory, rng, vocab) -> None:
    """torch.profiler over a short serve run (8 requests of 256 tokens, 9
    new tokens each; the first decode step, which captures the graph, runs
    before the window): the card's busy share of the wall time and the
    kernels that take it, largest first. The same window runs once more
    without the profiler on an engine of its own, since the profiler's
    recording of each kernel a replay launches lengthens the wall; the
    busy share is given against both walls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    prompts = [[int(t) for t in rng.integers(0, vocab, 256)]
               for _ in range(SLOTS)]

    def ready():
        eng = eng_factory()
        for i, p in enumerate(prompts):   # admit outside the window
            if not eng.submit(Request(rid=i, prompt=p, max_new=9)):
                fail("profile: admission rejected")
        eng.step()                        # the capture
        torch.cuda.synchronize()
        return eng

    def window(eng):
        t0 = time.perf_counter()
        while eng.has_live():
            eng.step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e6

    plain_us = window(ready())
    eng = ready()
    steps0 = eng.decode_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_us = window(eng)
    # device-side events only (kernels, copies): CPU ops also carry the
    # device time of what they launched and would count it twice
    rows = [(e.self_device_time_total, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(t for t, _ in rows)
    if busy <= 0:
        log("profile: no device time in the trace (not measured)")
        return
    paged_rows = sum(1 for _, key in rows if "paged_decode" in key)
    n = eng.decode_steps - steps0
    log(f"profile: {n} decode steps as graph replays (B={SLOTS}, ~260-token "
        f"contexts), wall {wall_us / 1e3:.2f} ms under the profiler, "
        f"{plain_us / 1e3:.2f} ms without; device busy {busy / 1e3:.2f} ms "
        f"= {busy / wall_us:.1%} of the profiled wall (idle "
        f"{1 - busy / wall_us:.1%}), {busy / plain_us:.1%} of the plain "
        f"wall (idle {1 - busy / plain_us:.1%})"
        + ("" if paged_rows else "; the profiler recorded no paged kernel "
           "row inside the replays: busy is what it recorded"))
    for t, key in sorted(rows, reverse=True)[:6]:
        log(f"profile:   {t / 1e3:8.3f} ms {t / busy:6.1%}  {key[:70]}")


def profile_prefill(eng_factory, rng, vocab) -> None:
    """torch.profiler over the prefills of 4 prompts of 512 tokens (one
    bucket): the card's busy share of the wall time, and the flash-MHA
    kernel's device time and share of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    eng = eng_factory()
    reqs = [Request(rid=i, prompt=[int(t) for t in rng.integers(0, vocab,
                                                                512)],
                    max_new=2) for i in range(4)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for r in reqs:
            if not eng.submit(r):
                fail("profile: admission rejected")
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(e.self_device_time_total, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(t for t, _ in rows)
    if busy <= 0:
        log("profile prefill: no device time in the trace (not measured)")
        return
    mha_us = sum(t for t, key in rows if "mha_" in key)
    log(f"profile prefill: 4 prefills of 512 tokens, wall "
        f"{wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms = "
        f"{busy / wall_us:.1%} (idle {1 - busy / wall_us:.1%}); flash-MHA "
        f"{mha_us / 1e3:.3f} ms = {mha_us / busy:.1%} of the device time")
    for t, key in sorted(rows, reverse=True)[:6]:
        log(f"profile prefill:   {t / 1e3:8.3f} ms {t / busy:6.1%}  "
            f"{key[:70]}")


# ---------------------------------------------------------------------------
# phase 7: the decode graph's checks, the other dense configs, serve_bench
# ---------------------------------------------------------------------------


def check_graph_and_gather() -> None:
    """qwen2.5-3b at full width in fp32, cut to 4 of its 36 layers (two
    fp32 engines of the whole stack would hold 27 GB of weights): over 16
    decode steps of 4 requests, the replayed graph against the uncaptured
    step body, then the gather baseline against the kernel (each in its own
    graph). The kernel's plan splits each request's pages over a cluster
    of CTAs at this batch."""
    cfg = dataclasses.replace(get_config("qwen2.5-3b"), num_layers=4,
                              dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    params = api.init_params(cfg, gen, device="cuda")
    rng = np.random.default_rng(SEED + 7)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab, int(n))]
               for n in rng.integers(64, 601, 4)]

    def engine(cls=PagedServingEngine, impl="kernel"):
        return cls(cfg, params, slots=len(prompts), max_len=MAX_LEN,
                   page_size=PAGE, attn_impl=impl, device="cuda")

    splits = paged_kernel.split_plan(len(prompts), KV, MAX_LEN // PAGE,
                                     PAGE, H // KV, build.sm_count(0))
    eager, graph = engine(UncapturedEngine), engine()
    lockstep(f"graph vs uncaptured body, fp32, 4 layers, paged split "
             f"{splits}", eager, graph, prompts, 16, F32_LOGIT_TOL)
    gather, kernel = engine(impl="gather"), engine()
    lockstep("gather vs kernel, fp32, 4 layers", gather, kernel, prompts,
             16, F32_LOGIT_TOL)
    if (eager.step_traces, graph.step_traces, gather.step_traces,
            kernel.step_traces) != (0, 1, 1, 1):
        fail("graph checks: captures are not one an engine")


NEW_CONFIGS = ("yi-6b", "qwen1.5-4b", "granite-3-2b")


def serve_configs() -> None:
    """Each dense config the port added after qwen2.5-3b at full width and
    full depth, seeded weights drawn on the card: its paged flash-decode
    and flash-MHA shapes against their plain versions, then 4 requests of
    16 new tokens through the engine, with the launch counts, one capture
    and the peak memory."""
    for k, arch in enumerate(NEW_CONFIGS):
        cfg = get_config(arch)
        hd = cfg.resolved_head_dim
        rng = np.random.default_rng(SEED + 10 + k)
        lengths = [int(n) for n in rng.integers(1, 700, 4)]
        args = paged_case(rng, 4, 1, cfg.num_heads, cfg.kv_heads, hd, PAGE,
                          lengths, MAX_LEN // PAGE, torch.bfloat16)
        got = paged_kernel.paged_attention(*args)
        torch.cuda.synchronize()
        agrees(f"paged [{arch} heads H{cfg.num_heads} KV{cfg.kv_heads} "
               f"D{hd}, B=4]", got, ref.paged_attention_ref(*args))
        check_mha(rng, [("prefill 512, causal", 1, 512, 512, True, None,
                         torch.bfloat16)],
                  heads=(cfg.num_heads, cfg.kv_heads, hd))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(SEED + 10 + k)
        params = api.init_params(cfg, gen, device="cuda")
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        eng = PagedServingEngine(cfg, params, slots=4, max_len=MAX_LEN,
                                 page_size=PAGE, device="cuda")
        reqs = [Request(rid=i, prompt=[int(t) for t in rng.integers(
            0, cfg.vocab, int(n))], max_new=16)
            for i, n in enumerate(rng.integers(64, 601, 4))]
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        done = eng.run_to_completion(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        want = serving_launches(cfg, eng)
        log(f"config {arch}: {cfg.param_count() / 1e9:.2f}B params, "
            f"{cfg.num_layers} layers, H{cfg.num_heads} KV{cfg.kv_heads} "
            f"D{hd}, vocab {cfg.vocab}{', tied' if cfg.tie_embeddings else ''}"
            f"; weights in {t_init:.1f} s; {len(done)}/4 requests, "
            f"{eng.decode_steps} decode steps in {wall:.2f} s (capture "
            f"included), launches paged {counts['paged_attention']} mha "
            f"{counts['mha']}, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if counts != want:
            fail(f"config {arch}: launches {counts} != {want}")
        if len(done) != 4 or any(len(r.generated) != 16 for r in done) \
                or any(not 0 <= t < cfg.vocab for r in done
                       for t in r.generated):
            fail(f"config {arch}: requests unfinished or tokens outside "
                 f"the vocabulary")
        if eng.step_traces != 1 or not torch.isfinite(eng.last_logits).all():
            fail(f"config {arch}: {eng.step_traces} captures or non-finite "
                 f"logits")
        eng.alloc.check_no_aliasing()
        del eng, params
        torch.cuda.empty_cache()


def run_serve_bench() -> None:
    """``launch/serve_bench.py --full`` in a process of its own: its CSV
    on lines of their own, gated by ``launch/check_csv.py`` (the three
    scenarios the port lacks are the only violations allowed)."""
    from repro_torch.launch import check_csv
    t0 = time.perf_counter()
    text = bench_csv(["--full", "--scenario", "mixed"])
    log(f"serve_bench --full (qwen2.5-3b, 4 slots, 12 requests, 8 new "
        f"tokens, mixed trace) in {time.perf_counter() - t0:.1f} s:")
    print(text, flush=True)
    errors = check_csv.check(text)
    if errors != check_csv.missing_scenario_errors(check_csv.REQUIRED):
        fail(f"serve_bench CSV: {errors}")
    rows = [dict(zip(text.splitlines()[0].split(","), line.split(",")))
            for line in text.splitlines()[1:]]
    for row in rows[:2]:
        if row["requests_done"] != "12" or row["sched_exhausted"] != "0":
            fail(f"serve_bench: {row['engine']} did not finish its trace")
    log(f"serve_bench: CSV passes the gate but for the "
        f"{len(errors)} equivalence columns its scenario does not carry")


def bench_csv(args) -> str:
    """``launch/serve_bench.py`` with ``args`` in a process of its own;
    its CSV."""
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_bench", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    if r.returncode != 0:
        fail(f"serve_bench {' '.join(args)} exited {r.returncode}:\n"
             f"{r.stderr[-3000:]}")
    return r.stdout.strip()


# ---------------------------------------------------------------------------
# phase 8: decode policies, the prefix cache, speculative decode
# ---------------------------------------------------------------------------

# mha with a query offset (suffix-only prefill against a cached prefix):
# the offsets a wrong tile skip shows at (not multiples of a tile, and
# multiples), each against a query count other than Sk - offset
MHA_OFFSETS = ((0, 77), (1, 128), (15, 1), (16, 300), (37, 64), (512, 200))


def check_mha_offsets(rng) -> float:
    """mha with ``q_offset`` against mha_ref at the serving heads (H16 KV2
    D128) and at D 64 (H8 KV2), bf16 and fp32: keys run 29 past the last
    query, so the causal mask at the offset, not Sk, ends every row; then
    bf16 on inputs peaked on the diagonal at offset 37, where a mask
    shifted by one key must miss every row. Returns the max abs error."""
    worst = 0.0
    for heads in ((H, KV, D), (8, 2, 64)):
        Hq, KVh, Dh = heads
        for dtype in (torch.bfloat16, torch.float32):
            for off, Sq in MHA_OFFSETS:
                Sk = off + Sq + 29

                def t(*shape):
                    return torch.tensor(rng.standard_normal(shape),
                                        dtype=dtype, device="cuda")
                q, k, v = t(2, Sq, Hq, Dh), t(2, Sk, KVh, Dh), t(2, Sk, KVh,
                                                                 Dh)
                got = mha_kernel.mha(q, k, v, causal=True, q_offset=off)
                torch.cuda.synchronize()
                want = ref.mha_ref(q, k, v, causal=True, q_offset=off)
                worst = max(worst, agrees(
                    f"mha [q_offset {off}, Sq {Sq}, Sk {Sk}, H{Hq} KV{KVh} "
                    f"D{Dh}, {str(dtype)[6:]}]", got, want))
    off = 37
    q, k, v = (torch.tensor(a, dtype=torch.bfloat16, device="cuda")
               for a in ref.peaked_mha_inputs(rng, 1, 512, H, KV, D))
    q = q[:, off:].contiguous()
    got = mha_kernel.mha(q, k, v, causal=True, q_offset=off)
    torch.cuda.synchronize()
    want = ref.mha_ref(q, k, v, causal=True, q_offset=off)
    name = f"mha [peaked on the diagonal, q_offset {off}, Sq {512 - off}]"
    worst = max(worst, agrees(name, got, want))
    mask_shift_caught(name, ref.mha_ref(q, k, v, causal=True,
                                        q_offset=off - 1), want)
    return worst


def check_paged_blocks(rng) -> float:
    """Paged flash-decode at the verify step's T = 5 (B = 8: 40 query rows
    a KV head) and the draft model's ingest blocks of T = 32 (256 rows),
    bf16 and fp32, against its plain version. Returns the max abs
    error."""
    worst = 0.0
    for B, T, lengths in ((SLOTS, 5, [5, 17, 64, 200, 333, 512, 600, 1000]),
                          (2, 32, [32, 700])):
        for dt in (torch.bfloat16, torch.float32):
            args = paged_case(rng, B, T, H, KV, D, PAGE, lengths,
                              MAX_LEN // PAGE, dt)
            got = paged_kernel.paged_attention(*args)
            torch.cuda.synchronize()
            worst = max(worst, agrees(
                f"paged_attention [T={T}, B={B}, {str(dt)[6:]}, "
                f"S={paged_plan(B, T, MAX_LEN // PAGE)}]", got,
                ref.paged_attention_ref(*args)))
    return worst


def check_sampler(rng) -> float:
    """The sampler's Threefry on the card against the CPU's, bit for bit
    (integer arithmetic): the row keys of the plain version on both
    devices, and the noise kernel's raw bits against the plain version's
    on the CPU; its Gumbel noise within 1e-6 of the plain version on the
    card (the same libm log), and within 2e-6 of the CPU's (another log:
    one ulp of a value in [8, 16) is 9.5e-7). At a serving step's (8,
    152064). Returns the noise's max abs error on the card."""
    V = get_config("qwen2.5-3b").vocab
    n = SLOTS
    seed, rid, idx = (torch.tensor(rng.integers(0, 2**31, n), dtype=torch.int64)
                      for _ in range(3))
    cuda = [x.cuda() for x in (seed, rid, idx)]
    from repro_torch.runtime.sampling import SAMPLE_DRAW
    for draw in (0, SAMPLE_DRAW):
        if not torch.equal(ref.row_keys(seed, rid, idx, draw),
                           ref.row_keys(*cuda, draw).cpu()):
            fail(f"sampler: row keys (draw {draw}) differ card vs CPU")
    bits_cpu = ref.sampler_noise_ref(seed, rid, idx, V, draw=SAMPLE_DRAW,
                                     bits=True)
    bits = ops.sampler_noise(*cuda, V, draw=SAMPLE_DRAW, bits=True)
    if not torch.equal(bits.cpu(), bits_cpu):
        fail("sampler: the kernel's bits differ from the plain version's")
    got = ops.sampler_noise(*cuda, V, draw=SAMPLE_DRAW)
    torch.cuda.synchronize()
    err = (got - ref.sampler_noise_ref(*cuda, V, draw=SAMPLE_DRAW)
           ).abs().max().item()
    err_cpu = (got.cpu() - ref.gumbel_from_bits(bits_cpu)).abs().max().item()
    log(f"sampler: keys and {n} x {V} bits equal card vs CPU; Gumbel noise "
        f"max abs err {err:.3g} against the plain version on the card "
        f"(limit 1e-06), {err_cpu:.3g} against the CPU's (limit 2e-06)")
    if not (err <= 1e-6 and err_cpu <= 2e-6 and torch.isfinite(got).all()):
        fail("sampler: the Gumbel noise disagrees with its plain version")
    return err


def time_sampler(rng):
    """The noise kernel at a serving step's (8, 152064) beside its plain
    version; the bound counts the one hash an element needs (the three key
    folds are per row), each 32-bit integer operation against the 67
    TFLOP/s fp32 rate (the data sheet gives no integer rate, so the bound
    is low), and the 4.9 MB written."""
    from repro_torch.runtime.sampling import SAMPLE_DRAW
    V = get_config("qwen2.5-3b").vocab
    seed, rid, idx = (torch.tensor(rng.integers(0, 2**31, SLOTS),
                                   dtype=torch.int64, device="cuda")
                      for _ in range(3))

    def kernel():
        ops.sampler_noise(seed, rid, idx, V, draw=SAMPLE_DRAW)
    ms = cuda_ms(kernel)
    dev = device_ms(kernel, [()] * 20)
    plain = cuda_ms(lambda: ref.sampler_noise_ref(seed, rid, idx, V,
                                                  draw=SAMPLE_DRAW), iters=5)
    # a Threefry-2x32: 20 rounds of add, rotate, xor, 5 key injections of
    # 3 adds, 4 more; then the float's 3 operations and two logs
    ops_per = 20 * 3 + 5 * 3 + 4 + 3 + 2
    bms, by = bench.bound_ms(SLOTS * V * 4, SLOTS * V * ops_per,
                             torch.float32)
    log(f"sampler_noise time [8 x {V}]: {ms:.4f} ms/launch (device "
        f"{dev:.4f} ms), plain {plain:.4f} ms, bound {bms:.4f} ms ({by}), "
        f"{bms / ms:.1%} of bound ({bms / dev:.1%} on the device)")
    return ms, plain, bms, by


def time_mha_offset(rng):
    """A suffix prefill's mha at the serving heads: 512 suffix rows after
    a 512-token prefix (Sk 1024 = the prefix buffer and the suffix), bf16,
    beside SDPA with the same mask as a boolean attn_mask."""
    off, Sq = 512, 512

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.bfloat16,
                            device="cuda")
    q, k, v = t(1, Sq, H, D), t(1, off + Sq, KV, D), t(1, off + Sq, KV, D)

    def kernel():
        mha_kernel.mha(q, k, v, causal=True, q_offset=off)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = (torch.arange(off + Sq, device="cuda")[None, :]
            <= off + torch.arange(Sq, device="cuda")[:, None])

    def sdpa():
        torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
    ms = cuda_ms(kernel)
    dev = device_ms(kernel, [()] * 20)
    plain = cuda_ms(lambda: ref.mha_ref(q, k, v, causal=True, q_offset=off),
                    iters=5)
    lib = cuda_ms(sdpa)
    lib_dev = device_ms(sdpa, [()] * 20)
    n_bytes = 2 * q.numel() * 2 + 2 * k.numel() * 2
    flops = 4 * H * D * Sq * (off + (Sq + 1) / 2)
    bms, by = bench.bound_ms(n_bytes, flops, torch.bfloat16)
    log(f"mha time [suffix 512 after a 512-token prefix, q_offset 512, "
        f"bf16]: {ms:.4f} ms/launch (device {dev:.4f} ms), plain "
        f"{plain:.4f} ms, SDPA with the mask {lib:.4f} ms (device "
        f"{lib_dev:.4f} ms), bound {bms:.4f} ms ({by}), {bms / ms:.1%} of "
        f"bound ({bms / dev:.1%} on the device)")


def time_paged_t5(rng):
    """The verify step's paged call at the serving shapes: B = 8, T = 5,
    contexts of the serve phase's range."""
    lengths = [int(n) for n in rng.integers(64 + 37, 637, SLOTS)]
    args = paged_case(rng, SLOTS, 5, H, KV, D, PAGE, lengths,
                      MAX_LEN // PAGE, torch.bfloat16)

    def kernel():
        paged_kernel.paged_attention(*args)
    ms = cuda_ms(kernel)
    dev = device_ms(kernel, [()] * 20)
    plain = cuda_ms(lambda: ref.paged_attention_ref(*args), iters=5)
    q = args[0]
    n_bytes = sum(lengths) * KV * D * 2 * 2 + 2 * q.numel() * 2 \
        + SLOTS * (MAX_LEN // PAGE) * 4 + SLOTS * 4
    flops = 4 * sum(lengths) * 5 * H * D
    bms, by = bench.bound_ms(n_bytes, flops, torch.bfloat16)
    log(f"paged_attention time [verify block T=5, B={SLOTS}, contexts "
        f"{min(lengths)}-{max(lengths)}, S={paged_plan(SLOTS, 5, MAX_LEN // PAGE)}]: "
        f"{ms:.4f} ms/launch (device {dev:.4f} ms), plain {plain:.4f} ms, "
        f"bound {bms:.4f} ms ({by}), {bms / ms:.1%} of bound "
        f"({bms / dev:.1%} on the device)")


class UncapturedSpecEngine(PagedServingEngine):
    """The engine with its verify body run as it is on the card, uncaptured:
    what the replayed verify graph must reproduce."""

    def _dispatch_spec(self):
        self._spec_body()


def check_policies_exact() -> None:
    """qwen2.5-3b at full width in fp32 cut to 4 of 36 layers (as phase 7
    cuts it), on the serve phase's kind of traffic (a 32-token system
    prompt, so the prefix cache hits whole pages at page 16): the
    prefix-cache engine's greedy tokens equal the no-share engine's;
    speculative greedy tokens (n-gram drafts, and the model drafting for
    itself) equal the T = 1 engine's; a sampled request's stream is the
    same alone, in a batch with greedy requests, and after a forced
    preemption; one capture of each graph through those runs; and the
    verify graph's outputs equal its uncaptured body's, step by step.
    The KV cache is fp32 here too: a resumed request's re-prefill computes
    its generated tokens' keys in mha where the first run computed them
    one decode step at a time, and in a bf16 cache a 1e-6 difference can
    round to the neighbouring bf16 value (2^-8 of it), which can move a
    sampled token."""
    from repro_torch.runtime.drafter import DraftModelDrafter
    from repro_torch.runtime.sampling import SamplingParams
    cfg = dataclasses.replace(get_config("qwen2.5-3b"), num_layers=4,
                              dtype="float32", kv_cache_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    params = api.init_params(cfg, gen, device="cuda")
    own = np.random.default_rng(SEED + 9)
    system = [int(t) for t in own.integers(0, cfg.vocab, 32)]
    prompts = [system + [int(t) for t in own.integers(0, cfg.vocab, int(n))]
               for n in own.integers(8, 280, 6)]

    def run(prompts, max_new=12, policies=None, rids=None, **kw):
        eng = PagedServingEngine(cfg, params, slots=4, max_len=MAX_LEN,
                                 page_size=PAGE, device="cuda", **kw)
        rids = range(len(prompts)) if rids is None else rids
        reqs = [Request(rid=rid, prompt=p, max_new=max_new,
                        params=None if policies is None else policies[i])
                for i, (rid, p) in enumerate(zip(rids, prompts))]
        done = eng.run_to_completion(reqs)
        if len(done) != len(reqs):
            fail("policies: a request did not finish")
        eng.check()
        return [r.generated for r in reqs], eng, reqs

    base, e0, _ = run(prompts)
    t0 = time.perf_counter()
    for name, kw in (("prefix cache", {"prefix_cache": True}),
                     ("spec_k 4, n-gram", {"spec_k": 4}),
                     ("spec_k 4, self-drafting model",
                      {"spec_k": 4, "drafter": DraftModelDrafter(
                          cfg, params, max_len=MAX_LEN, device="cuda")}),
                     ("spec_k 4, n-gram, prefix cache",
                      {"spec_k": 4, "prefix_cache": True})):
        toks, eng, _ = run(prompts, **kw)
        m = eng.metrics()
        log(f"policies [{name}] vs T=1 no-share greedy, fp32, 4 layers: "
            f"tokens equal {toks == base}; hits {m['prefix.hits']:.0f}, "
            f"prefill saved {m['prefix.prefill_saved_frac']:.3f}, cow "
            f"{m['prefix.cow_copies']:.0f}, accepted/step "
            f"{m['spec.accepted_per_step']:.2f}, graph captures "
            f"{eng.step_traces} step / {eng.spec_traces} verify")
        if toks != base:
            fail(f"policies [{name}]: greedy tokens differ from the T=1 "
                 f"no-share engine's")
        if (eng.step_traces, eng.spec_traces) != \
                ((0, 1) if kw.get("spec_k") else (1, 0)):
            fail(f"policies [{name}]: graph captures are not one")
        if kw.get("prefix_cache") and not m["prefix.hits"] >= 5:
            fail(f"policies [{name}]: the system prompt did not hit")
    sp = SamplingParams(temperature=0.9, top_p=0.95, seed=11)
    last = len(prompts) - 1
    alone, _, _ = run([prompts[last]], 24, [sp], [last])
    mix = [None] * last + [sp]
    batch, eb, _ = run(prompts, 24, mix)
    # a pool the batch fills at admission, the oldest request's prompt cut
    # to whole pages: its first step needs a page, and the youngest (the
    # sampled request, admitted last) is preempted to free one; it resumes
    # by re-prefill
    tight = [p[: len(p) // PAGE * PAGE] if i == 0 else p
             for i, p in enumerate(prompts[-4:])]
    pre, ep, reqs = run(tight, 24, mix[-4:],
                        range(len(prompts) - 4, len(prompts)),
                        num_pages=sum(-(-len(p) // PAGE) for p in tight))
    log(f"policies [sampled stream, T 0.9, top-p 0.95]: alone == in a batch "
        f"{alone[0] == batch[last]}, == after {reqs[-1].preemptions} "
        f"preemption(s) {alone[0] == pre[-1]}; mixed batch: "
        f"{eb.sampled_tokens} sampled / {eb.greedy_tokens} greedy tokens, "
        f"{eb.step_traces} capture(s); {time.perf_counter() - t0:.1f} s")
    for name, other in (("in a batch", batch[last]),
                        ("after a preemption", pre[-1])):
        if other != alone[0]:
            at = next(i for i, (x, y) in enumerate(zip(alone[0], other))
                      if x != y)
            fail(f"policies: the sampled stream {name} parts from its run "
                 f"alone at token {at}: {alone[0][:at + 2]} vs "
                 f"{other[:at + 2]}")
    if reqs[-1].preemptions < 1 or eb.step_traces != 1 \
            or ep.step_traces != 1 or not eb.sampled_tokens:
        fail("policies: no forced preemption, or captures are not one")
    # the verify graph against its uncaptured body, step by step
    engs = [UncapturedSpecEngine(cfg, params, slots=4, max_len=MAX_LEN,
                                 page_size=PAGE, spec_k=4, device="cuda"),
            PagedServingEngine(cfg, params, slots=4, max_len=MAX_LEN,
                               page_size=PAGE, spec_k=4, device="cuda")]
    for eng in engs:
        for i, p in enumerate(prompts[:4]):
            eng.submit(Request(rid=i, prompt=p, max_new=40,
                               params=mix[i + 2]))
    for s in range(8):
        for eng in engs:
            eng.step()
        if not torch.equal(engs[0]._spec_out, engs[1]._spec_out):
            fail(f"policies: verify step {s}: the graph's accept bits or "
                 f"tokens differ from the uncaptured body's")
    log(f"policies: 8 verify steps, the graph's (2, 4, 5) outputs equal the "
        f"uncaptured body's bit for bit ({engs[1].spec_traces} capture)")


def serve_policies(cfg, params, prompts) -> None:
    """The serve phase's config, weights and 16 requests at full depth,
    bf16, once each: greedy (as phase 6), with the prefix cache, sampled
    (temperature 0.9, top-p 0.95) and speculative (spec_k 4, n-gram
    drafts); each engine warmed (its graph's capture) and reset first, its
    launch counts read around its run."""
    from repro_torch.runtime.sampling import SamplingParams
    sp = SamplingParams(temperature=0.9, top_p=0.95, seed=SEED)
    for name, kw, pol in (("greedy", {}, None),
                          ("prefix cache", {"prefix_cache": True}, None),
                          ("sampled T 0.9 top-p 0.95", {}, sp),
                          ("spec_k 4, n-gram", {"spec_k": 4}, None)):
        eng = PagedServingEngine(cfg, params, slots=SLOTS, max_len=MAX_LEN,
                                 page_size=PAGE, device="cuda", **kw)
        eng.run_to_completion([Request(rid=-1, prompt=list(range(64)),
                                       max_new=3, params=pol)])
        eng.reset_metrics()
        reqs = [Request(rid=i, prompt=p, max_new=MAX_NEW, params=pol)
                for i, p in enumerate(prompts)]
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        done = eng.run_to_completion(reqs, max_steps=20 * N_REQ * MAX_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        m = eng.metrics()
        n_tok = sum(len(r.generated) for r in done)
        extra = {"greedy": "",
                 "prefix cache": f", prefill_saved_frac "
                 f"{m['prefix.prefill_saved_frac']:.4f}, hits "
                 f"{m['prefix.hits']:.0f}, cow_copies "
                 f"{m['prefix.cow_copies']:.0f}",
                 "sampled T 0.9 top-p 0.95": f", sampled_tokens "
                 f"{m['sampling.sampled_tokens']:.0f}",
                 "spec_k 4, n-gram": f", accepted_per_step "
                 f"{m['spec.accepted_per_step']:.4f}, decode_steps "
                 f"{eng.decode_steps}"}[name]
        log(f"serve policies [{name}]: {len(done)}/{N_REQ} requests, {n_tok} "
            f"tokens in {wall:.2f} s = {n_tok / wall:.1f} tok/s, ttft p50 "
            f"{m['latency.ttft_p50_s']:.4f} s, tpot p50 "
            f"{m['latency.tpot_p50_s']:.4f} s, {eng.prefills} prefills, "
            f"{eng.decode_steps} steps{extra}")
        if len(done) != N_REQ or any(len(r.generated) != MAX_NEW
                                     for r in done):
            fail(f"serve policies [{name}]: a request did not finish")
        if counts != serving_launches(cfg, eng):
            fail(f"serve policies [{name}]: launches {counts} != "
                 f"{serving_launches(cfg, eng)}")
        if eng.step_traces + eng.spec_traces != 1:
            fail(f"serve policies [{name}]: captures are not one")
        del eng
        torch.cuda.empty_cache()


BENCH_SCENARIOS = ("shared-prefix", "speculative", "sampling")


def run_serve_bench_policies() -> None:
    """``serve_bench`` with the three scenarios this slice ports, each in a
    process of its own, their CSVs as one sectioned file: on the fp32
    4-layer cut, gated by ``launch/check_csv.py`` (``tokens_match_greedy``
    must pass; only the two columns of the scenarios the port lacks may
    be missing); then at bf16 and full depth for their times, where
    ``tokens_match_greedy`` is printed and not gated: the verify step
    scores 5 rows a request where the T = 1 step scores 1, so cuBLAS
    reduces the bf16 GEMMs in another order, and a near tie between two
    bf16 logits may part the streams."""
    from repro_torch.launch import check_csv
    for label, extra, gated in (
            ("fp32, 4 layers", ["--layers", "4", "--dtype", "float32"],
             True),
            ("bf16, 36 layers", [], False)):
        t0 = time.perf_counter()
        text = "\n".join(f"# {sc}\n" + bench_csv(
            ["--full", "--scenario", sc, *extra]) for sc in BENCH_SCENARIOS)
        log(f"serve_bench --full --scenario {'/'.join(BENCH_SCENARIOS)} "
            f"({label}) in {time.perf_counter() - t0:.1f} s:")
        print(text, flush=True)
        errors = check_csv.check(text)
        missing = check_csv.missing_scenario_errors()
        matches = [line.split(",") for line in text.splitlines()
                   if "greedy]" in line]
        log(f"serve_bench ({label}): tokens_match_greedy rows "
            f"{len(matches)}; gate: "
            f"{'passes but for the two unported columns' if errors == missing else errors}")
        if gated and errors != missing:
            fail(f"serve_bench ({label}) CSV: {errors}")
        if not gated and not set(missing) <= set(errors):
            fail(f"serve_bench ({label}) CSV: {errors}")


def main() -> None:
    smi = card()
    build_kernels()
    rng = np.random.default_rng(SEED)
    err_paged = check_paged(rng)
    err_mha = check_mha(rng, MHA_SERVE)
    # generators of their own: phase 6's traffic stays as it was
    err_mha = max(err_mha, mha_bf16_teeth(np.random.default_rng(SEED + 3)))
    err_mha = max(err_mha, check_mha(np.random.default_rng(SEED + 6),
                                     MHA_SERVE_F32))
    serve_lengths = [int(n) for n in rng.integers(64 + 32, 632, SLOTS)]
    paged_t = time_paged(rng, SLOTS, serve_lengths,
                         f"serve shapes: B={SLOTS}, contexts "
                         f"{min(serve_lengths)}-{max(serve_lengths)}")
    time_paged(rng, 16, [2048] * 16, "B=16, 2048-token contexts")
    mha_t = time_mha(rng, 1024, "serve shapes: B=1, Sq=Sk=1024 bucket")
    time_mha(rng, 512, "B=1, Sq=Sk=512 bucket")
    host_split(SEED + 4)
    layer, err_mha64 = kernel_layer(np.random.default_rng(SEED + 2))
    err_mha = max(err_mha, err_mha64)
    check_model(rng)
    counts, params, prompts = serve(rng)
    check_graph_and_gather()
    serve_configs()
    run_serve_bench()
    # phase 8, from generators of its own
    t8 = time.perf_counter()
    own = np.random.default_rng(SEED + 20)
    err_mha = max(err_mha, check_mha_offsets(own))
    err_paged = max(err_paged, check_paged_blocks(own))
    err_noise = check_sampler(own)
    noise_t = time_sampler(own)
    time_mha_offset(own)
    time_paged_t5(own)
    check_policies_exact()
    serve_policies(get_config("qwen2.5-3b"), params, prompts)
    del params
    torch.cuda.empty_cache()
    run_serve_bench_policies()
    log(f"phase 8 in {time.perf_counter() - t8:.1f} s")
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
        {"name": "sampler_noise", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sampler.cu",
         "replaces": "src/repro/runtime/sampling.py:180 (jax.random.gumbel "
                     "in gumbel_argmax: XLA, no Pallas kernel)",
         "launches": counts["sampler_noise"], "max_abs_err": err_noise,
         "ms": noise_t[0], "plain_ms": noise_t[1], "bound_ms": noise_t[2],
         "bound_by": noise_t[3], "library_ms": None},
    ] + layer}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
