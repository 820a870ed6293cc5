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
5. serve: qwen2.5-3b at full width with seeded random weights, through the
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
from repro_torch.kernels import paged_attention as paged_kernel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.runtime.serving import PagedServingEngine, Request  # noqa: E402

HBM_BYTES_S = 3.35e12      # H100 SXM device memory rate (data sheet)
BF16_FLOP_S = 989e12       # H100 SXM dense bf16 tensor-core rate
SEED = 0

# serving configuration of phase 5 (and the shapes phase 4 times at)
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


def check_mha(rng) -> float:
    """Max abs error of the mha kernel against mha_ref."""
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        # name, B, Sq, Sk, causal, kv_valid, dtype
        ("prefill 1024, causal", 1, 1024, 1024, True, None, bf16),
        ("prefill 1024, causal, fp32", 1, 1024, 1024, True, None, f32),
        ("kv_valid (200, 0), causal", 2, 256, 256, True, [200, 0], bf16),
        ("kv_valid (77, 300), cross", 2, 100, 300, False, [77, 300], bf16),
        ("ragged fp32", 1, 100, 100, True, None, f32),
    ]
    worst = 0.0
    for name, B, Sq, Sk, causal, valid, dtype in cases:
        def t(*shape):
            return torch.tensor(rng.standard_normal(shape), dtype=dtype,
                                device="cuda")
        q, k, v = t(B, Sq, H, D), t(B, Sk, KV, D), t(B, Sk, KV, D)
        kv_valid = None if valid is None else torch.tensor(
            valid, dtype=torch.int32, device="cuda")
        got = mha_kernel.mha(q, k, v, causal=causal, kv_valid=kv_valid)
        torch.cuda.synchronize()
        want = ref.mha_ref(q, k, v, causal=causal, kv_valid=kv_valid)
        worst = max(worst, agrees(f"mha [{name}]", got, want))
        if name == "prefill 1024, causal, fp32":  # row i sees keys < i
            mask_shift_caught(f"mha [{name}]", ref.mha_ref(
                q[:, 1:], k[:, :-1], v[:, :-1], causal=True), want[:, 1:])
    return worst


# ---------------------------------------------------------------------------
# phase 4: times
# ---------------------------------------------------------------------------


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean CUDA-event milliseconds per call of ``fn`` after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, flops: float):
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = flops / BF16_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    bms, by = bound_ms(n_bytes, flops)
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
    bms, by = bound_ms(n_bytes, flops)
    log(f"mha time [{label}]: {ms:.4f} ms/launch, plain {plain:.4f} ms, "
        f"SDPA {lib:.4f} ms, bound {bms:.4f} ms ({by}), "
        f"{bms / ms:.1%} of bound")
    return ms, plain, bms, by, lib


# ---------------------------------------------------------------------------
# phase 5: serve
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
    want = {"paged_attention": cfg.num_layers * eng.decode_steps,
            "mha": cfg.num_layers * eng.prefills}
    if counts != want:
        fail(f"serve: launches {counts} != {want} (layers x decode steps, "
             f"layers x prefills)")
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
    err_mha = check_mha(rng)
    serve_lengths = [int(n) for n in rng.integers(64 + 32, 632, SLOTS)]
    paged_t = time_paged(rng, SLOTS, serve_lengths,
                         f"serve shapes: B={SLOTS}, contexts "
                         f"{min(serve_lengths)}-{max(serve_lengths)}")
    time_paged(rng, 16, [2048] * 16, "B=16, 2048-token contexts")
    mha_t = time_mha(rng, 1024, "serve shapes: B=1, Sq=Sk=1024 bucket")
    time_mha(rng, 512, "B=1, Sq=Sk=512 bucket")
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
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
