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
   on 6 of 36 layers for the times.
9. hybrid and recurrent stacks (generators of their own): mha with a
   sliding-window band at recurrentgemma's heads (H16 KV1 D256) and the
   serving heads, bf16 and fp32, windows 0, 16 and 2048 at 1024 and at a
   2300-token prompt in a 4096 bucket, and a suffix at q_offset 337; on
   inputs peaked on each row's oldest band key, a band one key narrower
   must miss every such row; paged flash-decode at G16 D256, window 2048,
   T = 1 and 5, contexts 2100-3500 whose recycled entries point at a
   poisoned page 0; times of both beside their bounds (the band's FLOPs,
   the live window pages' bytes), plain versions and SDPA with the band
   as a mask. At fp32, full width (recurrentgemma 6 of 38 layers, window
   cut to 64; mamba2-2.7b 4 of 64): kernel against gather greedy tokens
   through a forced preemption, 8 decode-graph replays against the
   uncaptured body bit for bit, spec_k 4 greedy tokens against plain
   greedy (n-gram drafts, and drafts that are right in part). At full
   width and depth, bf16: recurrentgemma-9b (12 prompts of 256-3000
   tokens, 160 new) and mamba2-2.7b (12 of 128-2048, 64 new) through the
   scheduler, 8 slots: tok/s, TTFT, TPOT, peak memory, recycled window
   pages against their bound, state-slot bytes, launches a replay, the
   device-busy share of a decode window, and a decode step and a prefill
   by piece (the plain RG-LRU and SSD scans against the kernels). Then
   ``serve_bench --scenario hybrid`` at full width, 6 layers, window 32,
   fp32, gated (``tokens_match_hybrid`` must pass).

10. the host tier (generators of their own): at fp32, full width,
   reduced depth (qwen2.5-3b 4 layers, recurrentgemma-9b 6 with window
   64, mamba2-2.7b 4), the tiered kernel engine over a pool capped at 0.4
   of the traffic's worst case (mamba2: a swap every 5 ticks) emits the
   uncapped engine's greedy tokens with every swap-out swapped back in,
   no token prefilled twice and an empty store at the end; the copy-
   stream race (swap out, prefill another request into the freed pages
   at once, swap back in through a prefetch and through a demand fetch:
   the next 8 tokens equal the unswapped run's); at bf16, 36 layers, a
   sampled stream through a swap equals it alone (and whether one through
   an evict-only preemption does is logged), and the top-2 logit gap
   where spec_k 4 greedy parts from plain greedy; the serve phase's
   traffic at full width and depth, bf16, for qwen2.5-3b,
   recurrentgemma-9b and mamba2-2.7b: uncapped, evict@cap, tiered@cap
   (tok/s, TTFT, TPOT, the tier's counters), one request's swap-out and
   swap-in times beside a pinned ``copy_`` of its bytes, and the decode
   window's idle share with the tier on and off (qwen); then
   ``serve_bench --scenario oversubscribe`` at 4 layers, fp32, gated.
11. MoE and vlm stacks (generators of their own): paged flash-decode at
   T = 1 and 5 and mha (causal 1024, ragged 300, a 300-row suffix at
   q_offset 512) at dbrx-132b's, llama4-maverick's and internvl2-2b's
   heads, read from their configs (G 6, 5 and 2, D 128), bf16 and fp32,
   against their plain versions, and timed; dbrx at full width, 2 of 40
   layers, fp32: kernel against gather greedy tokens through a forced
   preemption (the routed slots each prefill bucket drops logged from
   the routing helper), two 8-slot runs whose slots die mid-run token
   for token, 8 decode-graph replays with dead slots against the
   uncaptured body bit for bit (llama4 too, bf16, 2 layers, and its
   gather against kernel); an internvl2 prefill of 256 x 2048 patch
   embeddings; then the serve phase's 16 requests on 8 slots, bf16, on
   dbrx (8 of 40 layers), llama4 (2 of 48) and internvl2 (whole): tok/s,
   TTFT, TPOT, peak memory, launches, one capture, and a decode step by
   piece with the expert GEMMs beside their byte bound.
12. the dense-slot engine and the encoder-decoder stack (generators of
   their own): mha at this path's shapes, bf16 and fp32, against its
   plain version: seamless's encoder (B 2, Sq = Sk = 1024, non-causal,
   H16 KV16 D64) and cross prefill (128 rows against 1024 frames), the
   dense lanes' decode row (B 8, Sq 1, a device kv_valid 1..1024) at
   qwen2.5-3b's and seamless's heads (bf16 also replayed in a graph after
   the counts change), the cross decode, and a window ring's count min(pos
   + 1, W) at recurrentgemma's heads; each timed beside SDPA and its
   bound. At fp32, full width: qwen2.5-3b at 4 layers, the dense engine's
   greedy tokens equal the paged kernel and gather engines', 8 dense graph
   replays equal the uncaptured body bit for bit; recurrentgemma-9b at 3
   layers, window 2048, the dense ring lanes' tokens equal the paged
   engine's on prompts of 1990-3400 tokens with 80 new. At full depth,
   bf16: qwen2.5-3b's serve traffic through the dense and the paged
   engine in turns (P D D P): tok/s, TTFT, TPOT, peak memory, launches,
   captures and ``kernel/dense``. seamless-m4t-large-v2 at 2 + 2 layers,
   fp32: prefill and 4 decode steps on the card against the CPU plain
   path; whole, bf16: a prefill of 8 x 128 tokens over 8 x 1024 frames
   and 32 greedy decode steps on its dense lanes, eager and as one graph
   (prefill ms, ms a step, peak memory, mha launches, equal tokens); the
   factory picks the dense engine for it and serving through it raises
   for the missing enc_embeds.
13. tensor-parallel paged serving and the replica router (generators of
   their own): paged flash-decode and mha at a rank's heads at 2 shards
   (H8 KV1 D128, G 8), fp32 and bf16, against their plain versions, and
   timed at fp32; qwen2.5-3b at full width, 4 of 36 layers, fp32 with an
   fp32 KV cache, 8 of phase 6's prompts with 16 new tokens: the plain
   engine's greedy tokens, equalled by ``make_replicas(replicas=1)``, by
   a spawned world of 1 over NCCL (``mesh=``, the decode graph captured,
   no all-reduce) and by two spawned ranks sharing cuda:0 over gloo (KV 1
   and H 8 a rank, half the pool bytes, bodies uncaptured, two all-reduces
   a layer a step and a prefill), every rank alike, each rank's launches
   the serve formula's. The card has one GPU, so no tensor-parallel time
   is taken: two ranks on one card are a correctness run. Then a world
   of 1 over NCCL whose serving ``ManualRules`` contracts "heads" and
   "ffn" anyway (a sum over one rank is a copy): the decode, verify and
   select graphs captured with the NCCL all-reduces inside, greedy and
   spec_k 4 tokens equal to the plain engine's, 8 decode and 8 verify
   replays equal to their uncaptured bodies bit for bit, recurrentgemma
   at 6 layers spec_k 4 equal to its plain greedy tokens.
14. single-device training (generators of their own): (a) the qwen2.5-3b,
   dbrx-132b and recurrentgemma-9b SMOKE configs at fp32, from one state:
   step 1's loss, aux losses and every parameter leaf's gradient on the
   card against the CPU's (present, finite, non-zero wherever the CPU's
   is, within 1e-3 of the leaf's largest), then 3 ``make_train_step``
   steps whose losses agree within rtol 1e-4; the mha, paged and sampler
   wrappers refuse a grad-requiring input under grad mode. (b) qwen2.5-3b
   at full width and depth, bf16 params, fp32 moments, remat "full", 8 x
   1024 tokens of the synthetic stream a step, the reference launcher's
   optimizer: one warm-up step and 5 timed ones (ms a step, split into
   forward + backward and the optimizer; tokens/s; model FLOP/s, 6 N
   tokens, against the 989 TFLOP/s bf16 peak; peak memory; finite
   losses); no kernel may launch there (the training forward attends
   through the plain ``flash_attention``). (c) qwen2.5-3b full width, 4 of
   36 layers, fp32: 2 train steps on the card, then ``api.prefill``'s
   last-position logits (the mha kernel) against ``api.forward``'s (plain
   attention) on 4 prompts of 512 tokens, within 1e-4 of the logit scale.
15. model- and data-parallel training at the reference's layout: (a) a
   spawned world of 1 over NCCL whose rules force every hook of the
   layout anyway (``forced_layout_rules``: the FSDP and model gathers,
   their backward reduce-scatters and parts, the heads, ffn, vocab and
   experts sums, each over one rank), qwen2.5-3b whole as in phase 14
   (bf16, remat full, 8 x 1024 tokens): a warm-up and two timed steps
   after the same steps on one device in the same process, losses and
   every parameter leaf equal bit for bit, 5 sums a layer and 11 for the
   vocab a step, the collectives a step by kind and axis, ms a step
   beside the plain step's. (b) four spawned gloo ranks sharing cuda:0
   at (data 2, model 2): qwen2.5-3b at full width cut to 2 layers, fp32,
   2 steps plain and 2 with ``compress_grads`` (attention, MLP and the
   151936-token vocab computed sharded, every ``wembed`` dim over
   ``data``), held to the same steps on one device on the card by the
   CPU tests' bounds; dbrx-132b at full width (16 experts, 8 a rank) cut
   to 1 layer with bf16 moments, 2 steps, held to one device within a
   bf16 spacing; every rank's losses equal, the collectives a step
   logged; ``compressed_psum`` over the four equal to the plain formula
   bit for bit; ``gpipe`` at 4 stages on CUDA tensors, or gloo's
   refusal, logged. No kernel launches in either.
16. the dry-run (fake tensors on the CPU device, the H100 roofline): the
   CLI ``python -m repro_torch.launch.dryrun --arch qwen2.5-3b`` (every
   shape, pod16x16, full width, train_4k extrapolated from 1 and 2
   layers; each kernel seam counted as its kernel) and ``--arch
   dbrx-132b --shape train_4k``, each in a process of its own started
   with phase 15 (they trace on the host's cores while it runs), every cell
   ok, every cell's argument bytes equal to the layout's reckoning
   (``layout_bytes``), qwen2.5-3b's prefill and decode cells' dot FLOPs
   equal to the same cells traced in this process; qwen2.5-3b SMOKE at B
   1, S 1024 with the seams' plain versions, dot FLOPs equal to the JAX
   dry-run's (``SMOKE_DOT_FLOPS``); the dry-run of phase 14's step
   beside its measured ms, peak memory and 6 N T, and of a dense decode
   cell at phase 6's batch and lane length beside that step timed here
   (eager and as a graph replay, lanes full).

17. context parallelism (the sequence over ``model``, the reference's
   ``--optimized``; generators of their own): mha at a rank's block (B1,
   Sq 1024 at q_offset 1024 against Sk 2048, H16 KV2 D128), bf16 and
   fp32 against its plain version (bf16 also peaked, where the offset one
   short must miss), timed beside SDPA with the band as a mask and its
   bound; (a) a world of 1 over NCCL whose rules take every context-
   parallel hook over one rank (``cp_forced_rules``), qwen2.5-3b at full
   width and 4 layers: a bf16 train step and an fp32 prefill equal to the
   plain path bit for bit, 8 fp32 dense-lane decode steps (plain
   attention, merged) with the plain path's greedy tokens, logits within
   1e-4 of their scale; (b) two gloo ranks sharing the card at (data 1,
   model 2), qwen2.5-3b full width, 4 layers, fp32: a 2048-token prefill,
   each rank's 1024 queries through the mha kernel at q_offset 0 and
   1024, last-position logits within the CPU tests' bound (atol = rtol =
   2e-5) of one device's, 8 greedy decode steps on the ranks' lane halves
   with one device's tokens, and one train step at the layout within the
   CPU bounds; (c) phase 16's CLIs also trace qwen2.5-3b's cells and
   dbrx-132b train_4k ``--optimized``: memory a device, t_bound and
   collective bytes by kind beside the plain cells, argument bytes equal
   to ``layout_bytes`` with the sequence split.

The line before the last is a JSON ``{"kernels": [...]}`` summary (the
seven TPU kernels' counterparts, the sampler's noise kernel, mha and
paged flash-decode again at the hybrid path's windowed shapes with that
path's launches, both again with the host tier path's launches,
both at each MoE and vlm arch's heads with its serve run's launches,
mha at the dense decode row and at seamless's encoder with those runs'
launches, both at a tensor-parallel rank's heads with one rank's
launches in the two-rank run, mha at phase 14's train-to-serve
prefill with its launches there, and mha at a context-parallel rank's
block with a rank's launches in phase 17 (b)'s prefill);
the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.utils import _pytree as pytree

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import attention as mha_kernel  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import conv_im2col as conv_kernel  # noqa: E402
from repro_torch.kernels import gemm_os as gemm_kernel  # noqa: E402
from repro_torch.kernels import maxpool as pool_kernel  # noqa: E402
from repro_torch.kernels import paged_attention as paged_kernel  # noqa: E402
from repro_torch.kernels import reshuffle as reshuffle_kernel  # noqa: E402
from repro_torch.kernels import sampler as sampler_kernel  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.data.synthetic import DataConfig, SyntheticDataset  # noqa
from repro_torch.launch import host_cost  # noqa: E402
from repro_torch.launch import kernel_bench as bench  # noqa: E402
from repro_torch.launch.host_cost import host_us  # noqa: E402
from repro_torch.launch.kernel_bench import cuda_ms  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel.sharding import NO_RULES  # noqa: E402
from repro_torch.runtime import trainer  # noqa: E402
from repro_torch.runtime.serving import (DenseServingEngine,  # noqa: E402
                                         PagedServingEngine, Request,
                                         capture_graph)
from repro_torch.runtime.trace import Tracer  # noqa: E402

SEED = 0
PHASE6 = {}         # phase 6's serve tok/s, which phase 12 compares with
PHASE14 = {}        # phase 14's full-width train step, for phase 16

# phase 16: the JAX dry-run's matmul FLOPs (repro.analysis.hlo_cost of the
# reference's compiled step) for qwen2.5-3b SMOKE at B 1, S 1024, which the
# port's fake-tensor trace must equal on this machine's torch;
# tests/test_torch_dryrun_flops.py holds these numbers to the JAX package
SMOKE_DOT_FLOPS = {"qwen2.5-3b/prefill": 687898624,
                   "qwen2.5-3b/decode": 704512,
                   "qwen2.5-3b/train": 2852126720}

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


def paged_plan(B, T, n_blocks, page=PAGE, heads=(H, KV, D)) -> int:
    """The split plan of the paged wrapper on this card, at ``heads`` =
    (query heads, KV heads, head dim), the serving heads by default."""
    Hq, KVh, _ = heads
    return paged_kernel.split_plan(B, KVh, n_blocks, page, T * (Hq // KVh),
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


def time_paged(rng, B, lengths, label, heads=(H, KV, D), T=1,
               dtype=torch.bfloat16):
    """Times at (B, lengths), T query rows a request, ``heads`` = (query
    heads, KV heads, head dim), q and pools in ``dtype``: a pool per layer,
    cycled through so that the pools together exceed the 50 MB L2 cache,
    as the serving path's 36 layers do; CUDA-event and profiler device ms,
    the split plan."""
    Hq, KVh, Dh = heads
    n_blocks = MAX_LEN // PAGE if max(lengths) <= MAX_LEN else \
        -(-max(lengths) // PAGE)
    size = torch.empty((), dtype=dtype).element_size()
    live = sum(lengths) * KVh * Dh * 2 * size     # K and V
    n_pools = max(2, int(np.ceil(3 * 50e6 / live)))
    layers = [paged_case(rng, B, T, Hq, KVh, Dh, PAGE, lengths, n_blocks,
                         dtype) for _ in range(n_pools)]
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
    flops = 4 * sum(lengths) * T * Hq * Dh
    bms, by = bench.bound_ms(n_bytes, flops, dtype)
    log(f"paged_attention time [{label}, "
        f"S={paged_plan(B, T, n_blocks, heads=heads)}]: "
        f"{ms:.4f} ms/launch (device {dev:.4f} ms, host {host:.1f} us/call), "
        f"plain {plain:.4f} ms, bound {bms:.4f} ms ({by}), {bms / ms:.1%} "
        f"of bound ({bms / dev:.1%} on the device)")
    return ms, plain, bms, by


def time_mha(rng, Sq, label, heads=(H, KV, D), dtype=torch.bfloat16, B=1):
    Hq, KVh, Dh = heads

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=dtype,
                            device="cuda")
    q, k, v = t(B, Sq, Hq, Dh), t(B, Sq, KVh, Dh), t(B, Sq, KVh, Dh)
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
    n_bytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    flops = 4 * B * Hq * Dh * Sq * (Sq + 1) / 2
    bms, by = bench.bound_ms(n_bytes, flops, dtype)
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
    PHASE6["tok_s"] = n_tok / wall
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
    """The launches a serve run must count: the paged kernel once an
    attention layer a decode step (a replay of either graph), mha once an
    attention layer a prefill, the sampler's noise kernel once a step and
    once a prefill, nothing else."""
    from repro_torch.models import transformer as tfm
    n = sum(k not in api.STATE_KINDS for k in tfm.layer_kinds(cfg))
    want = dict.fromkeys(ops.launch_counts(), 0)
    want.update({"paged_attention": n * eng.decode_steps,
                 "mha": n * eng.prefills,
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
    """``launch/serve_bench.py --full`` (``bench_csv``): its CSV on lines
    of their own, gated by ``launch/check_csv.py`` (the three
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
    for row in rows[:3]:        # the dense, gather and kernel engines
        if row["requests_done"] != "12" or row["sched_exhausted"] != "0":
            fail(f"serve_bench: {row['engine']} did not finish its trace")
    log(f"serve_bench: CSV passes the gate but for the "
        f"{len(errors)} equivalence columns its scenario does not carry")


def bench_csv(args) -> str:
    """``launch/serve_bench.py`` with ``args`` in this process: its CSV
    (what its ``main`` prints). A process of its own for each run cost its
    start, CUDA context and kernel loads: 161.7 of phase 8's 179.1 s on an
    H100 for its six runs. ``main`` sets no process-wide state but the
    default tracer, which it puts back."""
    from repro_torch.launch import serve_bench
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_bench.main(list(args))
    gc.collect()
    torch.cuda.empty_cache()
    return buf.getvalue().strip()


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
    """``serve_bench`` with the three scenarios this slice ports, all six
    runs in this process (``bench_csv``), their CSVs as one sectioned
    file: on the fp32
    4-layer cut, gated by ``launch/check_csv.py`` (``tokens_match_greedy``
    must pass; only the columns of the scenarios not in these CSVs may
    be missing); then at bf16 on 6 of 36 layers for their times, where
    ``tokens_match_greedy`` is printed and not gated: the verify step
    scores 5 rows a request where the T = 1 step scores 1, so cuBLAS
    reduces the bf16 GEMMs in another order, and a near tie between two
    bf16 logits may part the streams. The bf16 depth is cut to keep the
    script near half its time limit: the self-drafting rows decode their
    draft model eagerly, 134 of the 211 s the bf16 run took at 36 layers
    on an H100 (81.1 s at 12 layers)."""
    from repro_torch.launch import check_csv
    for label, extra, gated in (
            ("fp32, 4 layers", ["--layers", "4", "--dtype", "float32"],
             True),
            ("bf16, 6 layers", ["--layers", "6"], False)):
        t0 = time.perf_counter()
        text = "\n".join(f"# {sc}\n" + bench_csv(
            ["--full", "--scenario", sc, *extra]) for sc in BENCH_SCENARIOS)
        log(f"serve_bench --full --scenario {'/'.join(BENCH_SCENARIOS)} "
            f"({label}) in {time.perf_counter() - t0:.1f} s:")
        print(text, flush=True)
        errors = check_csv.check(text)
        missing = check_csv.missing_scenario_errors(
            ("tokens_match_tp1", "tokens_match_unconstrained"))
        matches = [line.split(",") for line in text.splitlines()
                   if "greedy]" in line]
        log(f"serve_bench ({label}): tokens_match_greedy rows "
            f"{len(matches)}; gate: "
            f"{'passes but for the two columns of other scenarios' if errors == missing else errors}")
        if gated and errors != missing:
            fail(f"serve_bench ({label}) CSV: {errors}")
        if not gated and not set(missing) <= set(errors):
            fail(f"serve_bench ({label}) CSV: {errors}")


# ---------------------------------------------------------------------------
# phase 9: hybrid and recurrent stacks (recurrentgemma-9b, mamba2-2.7b)
# ---------------------------------------------------------------------------

# recurrentgemma's local attention: 16 query heads over 1 KV head, D 256
RG_H, RG_KV, RG_D, RG_WINDOW = 16, 1, 256, 2048


def check_mha_window(rng) -> float:
    """mha with a sliding-window band against mha_ref at recurrentgemma's
    heads (H16 KV1 D256) and the serving heads (H16 KV2 D128), bf16 and
    fp32: windows 0, 16 and 2048 at Sq = Sk = 1024 and at a 2300-token
    prompt in a 4096 bucket (kv_valid 2300), and a 300-row suffix at
    q_offset 337 (no tile multiple) with windows 100 and 2048. Then the
    teeth: on inputs whose rows peak on the oldest key of their band, the
    plain version with a band one key narrower must miss every such row
    (bf16 and fp32, D 256, windows 16 and 2048). Returns the max abs
    error."""
    worst = 0.0
    for heads in ((RG_H, RG_KV, RG_D), (H, KV, D)):
        Hq, KVh, Dh = heads
        for dtype in (torch.bfloat16, torch.float32):
            cases = [(S, S, 0, w, valid) for S, valid in ((1024, None),
                                                          (4096, 2300))
                     for w in (0, 16, RG_WINDOW)]
            cases += [(300, 637, 337, w, None) for w in (100, RG_WINDOW)]
            for Sq, Sk, off, w, valid in cases:
                def t(*shape):
                    return torch.tensor(rng.standard_normal(shape),
                                        dtype=dtype, device="cuda")
                q, k, v = t(1, Sq, Hq, Dh), t(1, Sk, KVh, Dh), t(1, Sk, KVh,
                                                                 Dh)
                got = ops.attention(q, k, v, causal=True, q_offset=off,
                                    window=w, kv_valid=valid)
                torch.cuda.synchronize()
                want = ref.mha_ref(q, k, v, causal=True, q_offset=off,
                                   window=w, kv_valid=valid)
                worst = max(worst, agrees(
                    f"mha [window {w}, Sq {Sq}, Sk {Sk}, q_offset {off}, "
                    f"kv_valid {valid}, H{Hq} KV{KVh} D{Dh}, "
                    f"{str(dtype)[6:]}]", got, want))
                del q, k, v, got, want
    for dtype in (torch.bfloat16, torch.float32):
        for S, w, off in ((1024, 16, 0), (4096, RG_WINDOW, 0),
                          (2400, RG_WINDOW, 301)):
            q, k, v = (torch.tensor(a, dtype=dtype, device="cuda")
                       for a in ref.peaked_mha_inputs(rng, 1, S, RG_H, RG_KV,
                                                      RG_D, edge=w))
            q = q[:, off:].contiguous()
            got = ops.attention(q, k, v, causal=True, q_offset=off, window=w)
            torch.cuda.synchronize()
            want = ref.mha_ref(q, k, v, causal=True, q_offset=off, window=w)
            name = (f"mha [peaked on the band's oldest key, window {w}, Sq "
                    f"{S - off}, q_offset {off}, D 256, {str(dtype)[6:]}]")
            worst = max(worst, agrees(name, got, want))
            rows = slice(w - 1 - off, None)   # the rows with an edge key
            mask_shift_caught(name, ref.mha_ref(
                q, k, v, causal=True, q_offset=off, window=w - 1)[:, rows],
                want[:, rows])
            del q, k, v, got, want
    torch.cuda.empty_cache()
    return worst


def window_paged_case(rng, B, T, lengths, dtype, window=RG_WINDOW):
    """paged_case at recurrentgemma's heads whose table entries below each
    request's earliest row's window point at scratch page 0 (1e4
    throughout), as recycling leaves them."""
    args = paged_case(rng, B, T, RG_H, RG_KV, RG_D, PAGE, lengths,
                      -(-4096 // PAGE), dtype)
    table = args[3]
    for b, n in enumerate(lengths):
        table[b, : max(0, n - T - window + 1) // PAGE] = 0
    return args


def check_paged_window(rng) -> float:
    """Paged flash-decode at recurrentgemma's shapes (16 query heads over
    1 KV head: G 16, D 256, window 2048, page 16), T = 1 and 5, bf16 and
    fp32, contexts 2100-3500 whose below-window entries point at a
    poisoned page 0 (1e4): any read of a recycled entry moves a row past
    the tolerance. Returns the max abs error."""
    worst = 0.0
    lengths = [2100, 2500, 2777, 3000, 3100, 3333, 3400, 3500]
    for T in (1, 5):
        for dt in (torch.bfloat16, torch.float32):
            args = window_paged_case(rng, SLOTS, T, lengths, dt)
            got = ops.paged_attention(*args, window=RG_WINDOW)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                fail("paged [window]: non-finite output")
            worst = max(worst, agrees(
                f"paged_attention [window {RG_WINDOW}, T={T}, B={SLOTS}, "
                f"G16 D256, contexts {min(lengths)}-{max(lengths)}, "
                f"recycled entries on a poisoned page 0, {str(dt)[6:]}]",
                got, ref.paged_attention_ref(*args, window=RG_WINDOW)))
    return worst


def band_pairs(Sq, off, window, valid) -> int:
    """(query row, key) pairs inside the causal band: the work a windowed
    mha must do."""
    n = 0
    for i in range(Sq):
        p = off + i
        n += max(0, min(p + 1, valid) - max(0, p - window + 1))
    return n


def time_mha_window(rng, dtype, Sq=4096, valid=4096):
    """A windowed prefill's mha at recurrentgemma's heads (B1, Sq = Sk,
    H16 KV1 D256, window 2048), beside its plain version and SDPA with the
    band as a boolean attn_mask. The bound counts the band's FLOPs (4 D
    per visible pair) and the bytes of q, k, v and out."""
    def t(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=dtype,
                            device="cuda")
    q, k, v = t(1, Sq, RG_H, RG_D), t(1, Sq, RG_KV, RG_D), t(1, Sq, RG_KV,
                                                             RG_D)

    def kernel():
        ops.attention(q, k, v, causal=True, window=RG_WINDOW)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    pos = torch.arange(Sq, device="cuda")
    mask = (pos[None, :] <= pos[:, None]) \
        & (pos[:, None] - pos[None, :] < RG_WINDOW)

    def sdpa():
        torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
    ms = cuda_ms(kernel, iters=10)
    dev = device_ms(kernel, [()] * 10)
    plain = cuda_ms(lambda: ref.mha_ref(q, k, v, causal=True,
                                        window=RG_WINDOW), iters=2,
                    warmup=1)
    lib = cuda_ms(sdpa, iters=10)
    lib_dev = device_ms(sdpa, [()] * 10)
    size = q.element_size()
    n_bytes = 2 * q.numel() * size + 2 * k.numel() * size
    flops = 4 * RG_H * RG_D * band_pairs(Sq, 0, RG_WINDOW, valid)
    bms, by = bench.bound_ms(n_bytes, flops, dtype)
    log(f"mha time [window {RG_WINDOW}, B1 Sq=Sk={Sq}, H16 KV1 D256, "
        f"{str(dtype)[6:]}]: {ms:.4f} ms/launch (device {dev:.4f} ms), "
        f"plain {plain:.4f} ms, SDPA with the band as a mask {lib:.4f} ms "
        f"(device {lib_dev:.4f} ms), bound {bms:.4f} ms ({by}), "
        f"{bms / ms:.1%} of bound ({bms / dev:.1%} on the device)")
    del q, k, v, qt, kt, vt, mask
    torch.cuda.empty_cache()
    return ms, plain, bms, by, lib


def time_paged_window(rng, T):
    """The hybrid decode (T = 1) and verify (T = 5) step's paged call at
    recurrentgemma's shapes: B = 8, contexts 2100-3500, window 2048. The
    bound counts the bytes of the live window pages each request reads
    (its earliest row's window and the T new keys), q, out and the
    table."""
    lengths = [2100, 2500, 2777, 3000, 3100, 3333, 3400, 3500]
    args = window_paged_case(rng, SLOTS, T, lengths, torch.bfloat16)

    def kernel():
        ops.paged_attention(*args, window=RG_WINDOW)
    ms = cuda_ms(kernel)
    dev = device_ms(kernel, [()] * 20)
    plain = cuda_ms(lambda: ref.paged_attention_ref(*args, window=RG_WINDOW),
                    iters=5)
    first, last = ref.live_pages(args[4], T, PAGE, args[3].shape[1],
                                 RG_WINDOW)
    pages = int((last - first).sum())
    q = args[0]
    n_bytes = pages * PAGE * RG_KV * RG_D * 2 * 2 + 2 * q.numel() * 2 \
        + args[3].numel() * 4 + SLOTS * 4
    keys = sum(min(n, RG_WINDOW + T - 1) for n in lengths)
    flops = 4 * keys * T * RG_H * RG_D
    bms, by = bench.bound_ms(n_bytes, flops, torch.bfloat16)
    log(f"paged_attention time [window {RG_WINDOW}, T={T}, B={SLOTS}, G16 "
        f"D256, contexts {min(lengths)}-{max(lengths)}, {pages} live "
        f"pages]: {ms:.4f} ms/launch (device {dev:.4f} ms), plain "
        f"{plain:.4f} ms, bound {bms:.4f} ms ({by}), {bms / ms:.1%} of "
        f"bound ({bms / dev:.1%} on the device)")
    return ms, plain, bms, by


def check_hybrid_exact() -> None:
    """At fp32 (weights, activations and KV cache), full width: recurrent-
    gemma cut to 6 of 38 layers (two whole patterns) with its window cut
    to 64 so that it slides within the run, and mamba2-2.7b cut to 4 of 64
    layers. The kernel engine's greedy tokens equal the gather engine's on
    prompts longer than the window, through a forced preemption; 8
    replays of the decode graph equal its uncaptured body bit for bit; and
    spec_k 4 greedy tokens (drafts from the plain run's own tokens, so
    verify steps accept some and reject some) equal plain greedy."""
    f32 = dict(dtype="float32", kv_cache_dtype="float32")
    for arch, layers in (("recurrentgemma-9b", 6), ("mamba2-2.7b", 4)):
        cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                                  **f32)
        if cfg.hybrid is not None:
            cfg = dataclasses.replace(cfg, hybrid=dataclasses.replace(
                cfg.hybrid, window=64))
        gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
        params = api.init_params(cfg, gen, device="cuda")
        own = np.random.default_rng(SEED + 30)
        prompts = [[int(t) for t in own.integers(0, cfg.vocab, int(n))]
                   for n in (80, 150, 97, 230, 40, 130)]
        max_new = 24
        kw = dict(slots=4, max_len=512, page_size=PAGE)
        if cfg.hybrid is not None:
            # the first two prompts fill a pool of 9 pages at admission (4
            # and 5 window pages), so the first step needs a page that only
            # preempting the younger frees; each alone fits its bound of 6
            kw["num_pages"] = 9

        def run(**extra):
            eng = PagedServingEngine(cfg, params, device="cuda",
                                     **dict(kw, **extra))
            reqs = [Request(rid=i, prompt=p, max_new=max_new)
                    for i, p in enumerate(prompts)]
            from repro_torch.runtime.scheduler import Scheduler
            sched = Scheduler(eng)
            for r in reqs:
                sched.add(r)
            while sched.pending or eng.has_live():
                sched.tick()
                eng.check()
                if sched.steps > 2000:
                    fail(f"{arch} exact: the run did not finish")
            return [r.generated for r in reqs], eng, sched

        t0 = time.perf_counter()
        kernel, ek, sk = run()
        gather, eg, sg = run(attn_impl="gather")
        if arch == "mamba2-2.7b":
            # no pages, so nothing preempts on its own: evict one request
            # mid-decode by hand; it resumes by re-prefill
            eng = PagedServingEngine(cfg, params, device="cuda", **kw)
            req = Request(rid=0, prompt=prompts[0], max_new=max_new)
            eng.submit(req)
            for _ in range(7):
                eng.step()
            eng.submit(eng._evict_slot(0))
            while eng.has_live():
                eng.step()
            pre, n_pre = req.generated, req.preemptions
            if pre != kernel[0]:
                fail(f"{arch} exact: a preempted request's tokens differ")
        else:
            n_pre = sk.preempted
        log(f"hybrid exact [{arch}, fp32, {layers} layers"
            f"{', window 64' if cfg.hybrid else ''}]: kernel vs gather "
            f"greedy tokens equal {kernel == gather} over {len(prompts)} "
            f"requests x {max_new}; preemptions {n_pre}; recycled window "
            f"pages {ek.win_recycled_pages} (gather {eg.win_recycled_pages})"
            f", most live {ek.win_peak_live} of bound "
            f"{ek.win_pages_bound(ek.max_len) if ek.has_win else 0}; "
            f"captures {ek.step_traces}; {time.perf_counter() - t0:.1f} s")
        if kernel != gather:
            at = next((i, j) for i, (a, b) in enumerate(zip(kernel, gather))
                      for j, (x, y) in enumerate(zip(a, b)) if x != y)
            fail(f"{arch} exact: kernel and gather tokens part at request "
                 f"{at[0]} token {at[1]}")
        if n_pre < 1 or ek.step_traces != 1:
            fail(f"{arch} exact: no preemption, or captures are not one")
        if cfg.hybrid is not None and not (
                ek.win_recycled_pages > 0
                and ek.win_recycled_pages == eg.win_recycled_pages):
            fail(f"{arch} exact: window pages not recycled alike")
        # the decode graph against its uncaptured body, bit for bit
        engs = [UncapturedEngine(cfg, params, device="cuda", **kw),
                PagedServingEngine(cfg, params, device="cuda", **kw)]
        for eng in engs:
            for i, p in enumerate(prompts[:4]):
                eng.submit(Request(rid=i, prompt=p, max_new=40))
        for s in range(8):
            for eng in engs:
                eng.step()
            # rows live through the step only: dead slots (and the one the
            # step's top-up preempted) read the scratch page, which several
            # of them write in one step (garbage by design)
            live = [i for i, r in enumerate(engs[1].live) if r is not None]
            if live != [i for i, r in enumerate(engs[0].live)
                        if r is not None]:
                fail(f"{arch} exact: decode step {s}: live slots differ")
            same = torch.equal(engs[0].last_logits[live],
                               engs[1].last_logits[live]) \
                and all(torch.equal(a[live], b[live])
                        for (_, ea), (_, eb) in zip(engs[0]._state,
                                                    engs[1]._state)
                        for a, b in zip(ea.values(), eb.values()))
            if not same:
                fail(f"{arch} exact: decode step {s}: the graph's logits or "
                     f"states differ from the uncaptured body's")
        log(f"hybrid exact [{arch}]: 8 replays of the decode graph equal "
            f"the uncaptured body bit for bit (logits and every state "
            f"slot of the live requests, through a preemption)")
        # speculative greedy: drafts from the plain run's tokens, some
        # right, some wrong
        streams = {i: toks for i, toks in enumerate(kernel)}

        class Oracle:
            kind = "oracle"

            def propose(self, rid, ctx, k):
                n = len(ctx) - len(prompts[rid])
                good = streams[rid][n:n + k]
                return good if n % 2 == 0 else good[:1] + [
                    (t + 1) % cfg.vocab for t in good[1:]]

            def drop(self, rid):
                pass

            def stats(self):
                return {}

        for name, extra in (("n-gram", {}), ("oracle", {"drafter":
                                                         Oracle()})):
            spec, es, _ = run(spec_k=4, **extra)
            log(f"hybrid exact [{arch}, spec_k 4, {name} drafts]: tokens "
                f"equal plain greedy {spec == kernel}; accepted "
                f"{es.spec_accepted}/{es.spec_drafted}; {es.state_selects} "
                f"rollback selects ({es.select_traces} capture), "
                f"{es.spec_traces} verify capture")
            if spec != kernel:
                fail(f"{arch} exact: spec_k 4 ({name}) tokens differ from "
                     f"plain greedy")
            if name == "oracle" and not 0 < es.spec_accepted \
                    < es.spec_drafted:
                fail(f"{arch} exact: oracle drafts were not accepted in "
                     f"part")
        del params
        torch.cuda.empty_cache()


def graph_ms(fn, iters: int = 10) -> float:
    """CUDA-event ms per replay of ``fn`` captured alone as a CUDA graph (a
    warm-up run on a side stream first): the device's time for its
    kernels without the host's launch gaps, which an eager call of a
    piece this small is made of."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = cuda_ms(graph.replay, iters=iters)
    del graph
    return ms


def piece_times(cfg, params, eng) -> None:
    """Where a hybrid decode step and prefill spend the card's time, by
    CUDA events: one decode step as the engine's graph replays it, then
    each piece captured alone in a graph (``graph_ms``) at the step's
    shapes (B = 8 rows) times the layers that run it: the recurrent mixers
    whole and their plain recurrence + conv (``_token_step``), the paged
    kernel, the MLPs, the head and the sampler; a 2048-token prefill's
    mixers, their plain scans (the doubling scan, the SSD chunk loop) and
    causal convs, mha with the band and the MLPs. Every piece is plain
    PyTorch but the two kernels."""
    from repro_torch.models import griffin, layers, ssm
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.sampling import sample_rows
    kinds = tfm.layer_kinds(cfg)
    dt = getattr(torch, cfg.dtype)
    B, S, d = SLOTS, 2048, cfg.d_model
    gen = torch.Generator(device="cuda").manual_seed(SEED + 42)

    def rand(*shape, dtype=dt):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)
    x1, xs = rand(B, 1, d), rand(1, S, d)
    step = cuda_ms(eng._graph.replay, iters=10)
    dec, pre = {}, {}
    for kind in sorted(set(kinds)):
        n = kinds.count(kind)
        j = kinds.index(kind)
        p, c = params["blocks"][j], eng.cache[j]
        if kind == "rglru":
            mx = p["mixer"]
            u = rand(B, griffin.lru_dim(cfg))
            dec["rglru mixer"] = n * graph_ms(
                lambda: griffin.rglru_decode(cfg, mx, x1, c))
            dec["  of which recurrence + conv"] = n * graph_ms(
                lambda: griffin._token_step(mx, c["h"], c["conv"], u))
            ur = rand(1, S, griffin.lru_dim(cfg))
            a, bb = griffin._gates(mx, griffin._conv(mx, ur))
            pre["rglru mixer"] = n * graph_ms(
                lambda: griffin.rglru_apply(cfg, mx, xs, return_state=True),
                iters=5)
            pre["  of which doubling scan"] = n * graph_ms(
                lambda: griffin._scan(a, bb), iters=5)
            pre["  of which causal conv"] = n * graph_ms(
                lambda: griffin._conv(mx, ur), iters=5)
        elif kind == "ssm":
            mx = p["mixer"]
            zx = ssm._split(cfg, rand(B, mx["in_proj"].shape[1]))
            dec["ssm mixer"] = n * graph_ms(
                lambda: ssm.ssm_decode(cfg, mx, x1, c))
            dec["  of which recurrence + conv"] = n * graph_ms(
                lambda: ssm._token_step(cfg, mx, c["ssm"], c["conv"], *zx))
            d_inner, nh, conv_dim = ssm.dims(cfg)
            sc = cfg.ssm
            xin = rand(1, S, nh, sc.head_dim)
            dtv = torch.nn.functional.softplus(rand(1, S, nh,
                                                    dtype=torch.float32))
            Bm, Cm = (rand(1, S, sc.num_groups, sc.state_dim)
                      for _ in range(2))
            A = -torch.exp(mx["A_log"])
            raw = rand(1, S, conv_dim)
            pre["ssm mixer"] = n * graph_ms(
                lambda: ssm.ssm_apply(cfg, mx, xs, return_state=True),
                iters=3)
            pre["  of which SSD chunk scan"] = n * graph_ms(
                lambda: ssm._ssd_scan(xin, dtv, A, Bm, Cm, sc.chunk),
                iters=3)
            pre["  of which causal conv"] = n * graph_ms(
                lambda: ssm._conv(cfg, mx, raw), iters=3)
        else:
            win = cfg.hybrid.window if kind == "local_attn" else 0
            args = window_paged_case(np.random.default_rng(SEED + 43), B, 1,
                                     [2100, 2500, 2777, 3000, 3100, 3333,
                                      3400, 3500], dt, win)
            dec["paged_attention kernel"] = n * graph_ms(
                lambda: ops.paged_attention(*args, window=win))
            qs = rand(1, S, cfg.num_heads, cfg.resolved_head_dim)
            ks = rand(1, S, cfg.kv_heads, cfg.resolved_head_dim)
            pre["mha kernel (band)"] = n * graph_ms(
                lambda: ops.attention(qs, ks, ks, causal=True, window=win),
                iters=5)
        if "mlp" in p:
            mp = p["mlp"]
            dec["MLPs"] = dec.get("MLPs", 0.0) + n * graph_ms(
                lambda: layers.mlp_apply(cfg, mp, x1))
            pre["MLPs"] = pre.get("MLPs", 0.0) + n * graph_ms(
                lambda: layers.mlp_apply(cfg, mp, xs), iters=5)
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    logits = (x1[:, 0] @ head).float()
    dec["head"] = graph_ms(lambda: (x1[:, 0] @ head).float())
    dec["sampler (greedy)"] = graph_ms(
        lambda: sample_rows(logits[:, : cfg.vocab], eng.pol))
    log(f"pieces {cfg.name} decode step (B={B}): graph replay "
        f"{step:.3f} ms; alone: " + ", ".join(
            f"{k.strip()} {v:.3f} ms ({v / step:.1%})"
            for k, v in dec.items()))
    log(f"pieces {cfg.name} prefill of {S} tokens, alone: " + ", ".join(
        f"{k.strip()} {v:.3f} ms" for k, v in pre.items()))


def hybrid_traffic(arch, rng, vocab):
    """The phase-9 serve traffic: recurrentgemma-9b 12 prompts of 256-3000
    tokens (4 past the 2048 window, 2 of 1900-2040 that cross it while
    decoding), 160 new tokens each; mamba2-2.7b 12 prompts of 128-2048
    tokens, 64 new tokens."""
    if arch == "recurrentgemma-9b":
        lengths = [int(n) for n in rng.integers(256, 1900, 6)] \
            + [int(n) for n in rng.integers(1900, 2041, 2)] \
            + [int(n) for n in rng.integers(2100, 3001, 4)]
        max_new = 160
    else:
        lengths = [int(n) for n in rng.integers(128, 2049, 12)]
        max_new = 64
    rng.shuffle(lengths)
    return [Request(rid=i, prompt=[int(t) for t in rng.integers(0, vocab,
                                                                 n)],
                    max_new=max_new) for i, n in enumerate(lengths)]


def serve_hybrid(arch) -> dict:
    """One arch at full width and depth, bf16, seeded weights on the card,
    through the paged engine and the scheduler: 8 slots, page 16, max_len
    4096, one warm-up request (the decode graph's capture) then the
    reference's reset point, then the traffic of ``hybrid_traffic``.
    Checks every request finished in the vocabulary, the launch counts,
    one capture, every slot's live window pages within win_pages_bound at
    every tick; logs tok/s, TTFT and TPOT p50, peak memory, recycled
    window pages, the state slots' bytes, the launches a replay holds, the
    device-busy share of a decode window and the CUDA-event ms of a decode
    step and of a prefill by model piece (``piece_times``: the plain
    RG-LRU and SSD pieces against the kernels). Returns the run's launch
    counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime.scheduler import Scheduler
    cfg = get_config(arch)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    params = api.init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    log(f"serve {arch}: {cfg.param_count() / 1e9:.2f}B params, "
        f"{cfg.num_layers} layers, bf16, weights drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    eng = PagedServingEngine(cfg, params, slots=SLOTS, max_len=4096,
                             page_size=PAGE, device="cuda")
    t0 = time.perf_counter()
    eng.run_to_completion([Request(rid=-1, prompt=list(range(64)),
                                   max_new=2)])
    log(f"serve {arch}: warm-up request with the decode graph's capture "
        f"{time.perf_counter() - t0:.2f} s")
    eng.reset_metrics()
    rng = np.random.default_rng(SEED + 41)
    reqs = hybrid_traffic(arch, rng, cfg.vocab)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    sched = Scheduler(eng)
    for r in reqs:
        sched.add(r)
    bound = eng.win_pages_bound(eng.max_len) if eng.has_win else 0
    t0 = time.perf_counter()
    while sched.pending or eng.has_live():
        sched.tick()
        if eng.has_win:
            eng.check()
        if sched.steps > 5000:
            fail(f"serve {arch}: the run did not finish")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    m = eng.metrics()
    n_tok = sum(len(r.generated) for r in reqs)
    lengths = [len(r.prompt) for r in reqs]
    log(f"serve {arch}: {sum(r.done for r in reqs)}/{len(reqs)} requests "
        f"(prompts {min(lengths)}-{max(lengths)} tokens, "
        f"{sum(n > 2048 for n in lengths)} past 2048), {n_tok} tokens in "
        f"{wall:.2f} s = {n_tok / wall:.1f} tok/s, ttft p50 "
        f"{m['latency.ttft_p50_s']:.4f} s, tpot p50 "
        f"{m['latency.tpot_p50_s']:.4f} s, {eng.decode_steps} decode steps "
        f"(graph replays), {eng.prefills} prefills, {sched.preempted} "
        f"preemptions, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"serve {arch}: window pages recycled {eng.win_recycled_pages}, "
        f"most live window pages a slot held {eng.win_peak_live} of bound "
        f"{bound}; state slots {eng.state_slot_bytes()} bytes a slot, "
        f"{eng.state_slot_bytes() * eng.slots} in all; launches {counts}; "
        f"a decode replay holds {eng._graph_launches}; captures "
        f"{eng.step_traces}")
    if any(not r.done or len(r.generated) != r.max_new for r in reqs):
        fail(f"serve {arch}: not every request finished with max_new "
             f"tokens")
    if any(not 0 <= t < cfg.vocab for r in reqs for t in r.generated):
        fail(f"serve {arch}: a token outside the vocabulary")
    if eng.step_traces != 1:
        fail(f"serve {arch}: {eng.step_traces} decode graph captures")
    want = serving_launches(cfg, eng)
    if counts != want:
        fail(f"serve {arch}: launches {counts} != {want}")
    if eng.has_win and not (eng.win_recycled_pages > 0
                            and 0 < eng.win_peak_live <= bound):
        fail(f"serve {arch}: no window page recycled, or a slot over the "
             f"bound")
    eng.alloc.check()

    # a decode window: 8 requests of 2048-token prompts, 9 new tokens
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab, 2048)]
               for _ in range(SLOTS)]
    for i, p in enumerate(prompts):
        if not eng.submit(Request(rid=100 + i, prompt=p, max_new=9)):
            fail(f"profile {arch}: admission rejected")
    eng.step()
    torch.cuda.synchronize()
    steps0 = eng.decode_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while eng.has_live():
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)
    n = eng.decode_steps - steps0
    log(f"profile {arch}: {n} decode steps (B={SLOTS}, 2048-token "
        f"prompts), wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy / 1e3:.2f} ms = {busy / max(wall_us, 1):.1%} of the wall "
        f"(idle {1 - busy / max(wall_us, 1):.1%}), "
        f"{busy / 1e3 / max(n, 1):.3f} device ms a step")
    piece_times(cfg, params, eng)
    del eng, params
    torch.cuda.empty_cache()
    return counts


def run_serve_bench_hybrid() -> None:
    """``serve_bench --scenario hybrid`` at recurrentgemma-9b's full width
    cut to 6 layers and its window to 32 (the trace's 8 prompts of 16-51
    tokens then straddle it, as the SMOKE config's do its 16), at fp32,
    gated by ``launch/check_csv.py`` (``tokens_match_hybrid``, the dense
    ring lanes, gather and kernel equal, must pass) and by the paged
    rows' recycled pages."""
    from repro_torch.launch import check_csv
    t0 = time.perf_counter()
    text = bench_csv(["--full", "--scenario", "hybrid", "--layers", "6",
                      "--window", "32", "--dtype", "float32", "--slots",
                      "4", "--max-len", "512", "--requests", "16"])
    log(f"serve_bench --scenario hybrid (recurrentgemma-9b full width, 6 "
        f"layers, window 32, fp32) in {time.perf_counter() - t0:.1f} s:")
    print(text, flush=True)
    errors = check_csv.check(text)
    if errors != check_csv.missing_scenario_errors(check_csv.REQUIRED):
        fail(f"serve_bench hybrid CSV: {errors}")
    rows = [row for _, rs in check_csv.parse_sections(text) for row in rs]
    for row in rows[:3]:
        paged = row["engine"].startswith("paged[")
        if row["requests_done"] != "8" or row["tokens_match_hybrid"] != "1" \
                or (paged and not int(row["win_recycled_pages"]) > 0):
            fail(f"serve_bench hybrid: {row['engine']} did not finish, "
                 f"match or recycle")


# ---------------------------------------------------------------------------
# phase 10: the host tier (pinned host pages, side-stream copies, swaps)
# ---------------------------------------------------------------------------


def tier_drive(eng, reqs, preempt_every=0):
    """``reqs`` through a Scheduler on ``eng``, ``check()`` after every
    tick. ``preempt_every`` k > 0 also preempts the youngest live request
    every k ticks when two or more are live (swap-out with the tier on,
    evict without): mamba2 holds no pages, so no pool cap preempts it.
    Returns the scheduler."""
    from repro_torch.runtime.scheduler import Scheduler
    sched = Scheduler(eng)
    for r in reqs:
        sched.add(r)
    while sched.pending or eng.has_live():
        sched.tick()
        live = [s for s, r in enumerate(eng.live) if r is not None]
        if preempt_every and sched.steps % preempt_every == 0 \
                and len(live) >= 2:
            s = max(live, key=lambda s: eng._admit_seq[s])
            back = eng._swap_out_slot(s) if eng.tier is not None \
                else eng._evict_slot(s)
            sched.pending.appendleft(back)
            sched.preempted += 1
        eng.check()
        if sched.steps > 20000:
            fail("host tier: a run did not finish")
    return sched


def tier_cap(reqs, eng) -> int:
    """The oversubscribe scenario's pool cap (``serve_bench._pool_cap``:
    0.4 of the trace's worst-case pages, floored one page above the
    largest request); for a windowed stack each request's worst case is
    its window bound."""
    need = [eng._worst_case_pages(min(len(r.prompt) + r.max_new,
                                      eng.max_len)) for r in reqs]
    return max(int(sum(need) * 0.4), max(need) + 1)


def check_tier_exact() -> None:
    """At fp32 (weights, activations, KV cache), full width, reduced depth
    (qwen2.5-3b 4 of 36 layers; recurrentgemma-9b 6 of 38, window 64;
    mamba2-2.7b 4 of 64): the tiered kernel engine over a pool capped at
    0.4 of the traffic's worst case (mamba2: a swap every 5 ticks, as it
    holds no pages) emits the uncapped kernel engine's greedy tokens,
    swaps back in every swap-out (more than 0), prefills exactly what the
    uncapped engine prefills, and ends with an empty store (but for the
    capped archive of slid-out window pages); the evict-only engine on the
    same cap re-prefills."""
    f32 = dict(dtype="float32", kv_cache_dtype="float32")
    for arch, layers, window in (("qwen2.5-3b", 4, None),
                                 ("recurrentgemma-9b", 6, 64),
                                 ("mamba2-2.7b", 4, None)):
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                                  **f32)
        if window is not None:
            cfg = dataclasses.replace(cfg, hybrid=dataclasses.replace(
                cfg.hybrid, window=window))
        gen = torch.Generator(device="cuda").manual_seed(SEED + 60)
        params = api.init_params(cfg, gen, device="cuda")
        own = np.random.default_rng(SEED + 60)
        prompts = [[int(t) for t in own.integers(0, cfg.vocab, int(n))]
                   for n in (80, 150, 97, 230, 40, 130)]
        every = 5 if arch == "mamba2-2.7b" else 0

        def run(**kw):
            eng = PagedServingEngine(cfg, params, slots=4, max_len=512,
                                     page_size=PAGE, device="cuda", **kw)
            reqs = [Request(rid=i, prompt=p, max_new=24)
                    for i, p in enumerate(prompts)]
            sched = tier_drive(eng, reqs,
                               every if "num_pages" in kw else 0)
            return [r.generated for r in reqs], eng, sched

        want, base, _ = run()
        cap = tier_cap([Request(rid=0, prompt=p, max_new=24)
                        for p in prompts], base)
        evict, ee, es = run(num_pages=cap)
        got, eng, sched = run(num_pages=cap, host_tier=True)
        t = eng.tier
        archived = sum(len(v) for v in t._win_archive.values())
        log(f"host tier exact [{arch}, fp32, {layers} layers"
            f"{f', window {window}' if window else ''}]: pool {cap} of "
            f"{base.alloc.num_pages} pages; tiered@cap == uncapped "
            f"{got == want} (evict@cap {evict == want}); swap-outs "
            f"{t.swap_outs} / swap-ins {t.swap_ins}, prefetch hits "
            f"{t.stream.prefetch_hits} / demand {t.stream.demand_fetches}; "
            f"prefilled {eng.prefilled_tokens} vs uncapped "
            f"{base.prefilled_tokens} vs evict@cap {ee.prefilled_tokens} "
            f"({es.preempted} preemptions); store {len(t.store)} blobs "
            f"({archived} archived window blobs, "
            f"{t.win_archived_pages:.0f} pages); "
            f"{time.perf_counter() - t0:.1f} s")
        if got != want or not t.swap_ins == t.swap_outs > 0 \
                or eng.prefilled_tokens != base.prefilled_tokens \
                or len(t.store) != archived or t.swapped_rids() \
                or eng.alloc.allocated_pages:
            fail(f"host tier exact [{arch}]: tokens, swaps, prefill or the "
                 f"store's end state differ")
        if evict != want or not ee.prefilled_tokens > base.prefilled_tokens:
            fail(f"host tier exact [{arch}]: evict@cap tokens differ or it "
                 f"re-prefilled nothing")
        if eng.step_traces != 1:
            fail(f"host tier exact [{arch}]: {eng.step_traces} captures")
        del params, base, ee, eng
        torch.cuda.empty_cache()


def swap_race(cfg, params, prefetch, steps=6, after=8):
    """The copy-stream race: request A decodes ``steps`` tokens, is swapped
    out (its D2H copies left pending on the side stream), request B is
    prefilled at once into the pages A freed (the free list is LIFO), then
    A is swapped back in through a prefetch (``prefetch`` True: the hit
    path) or a demand fetch (False), and both decode ``after`` more steps.
    ``prefetch`` None runs the same schedule without the swap. Returns
    the two requests' tokens and the engine."""
    own = np.random.default_rng(SEED + 61)
    pa = [int(t) for t in own.integers(0, cfg.vocab, 300)]
    pb = [int(t) for t in own.integers(0, cfg.vocab, 260)]
    eng = PagedServingEngine(cfg, params, slots=2, max_len=MAX_LEN,
                             page_size=PAGE, host_tier=prefetch is not None,
                             device="cuda")
    a = Request(rid=0, prompt=pa, max_new=steps + after + 1)
    b = Request(rid=1, prompt=pb, max_new=after + 1)
    if not eng.submit(a):
        fail("swap race: admission rejected")
    for _ in range(steps):
        eng.step()
    if prefetch is not None:
        freed = eng.alloc.block_table(a.rid)
        eng._swap_out_slot(0)
        if not eng.tier.store.pending:
            fail("swap race: the swap-out's copies were not left pending")
        eng.submit(b)
        if not set(eng.alloc.block_table(b.rid)) & set(freed):
            fail("swap race: B's prefill did not reuse A's pages")
        if prefetch:
            eng.prefetch_pending([a])
        if not eng.submit(a):
            fail("swap race: swap-in rejected")
    else:
        eng.submit(b)
    for _ in range(after):
        eng.step()
    torch.cuda.synchronize()
    return [list(a.generated), list(b.generated)], eng


def check_swap_race() -> None:
    """qwen2.5-3b, full width, 4 layers, fp32 with an fp32 KV cache:
    ``swap_race`` through the prefetch hit path and through a demand
    fetch; the resumed request's next 8 tokens, and the other's, equal
    the run without the swap."""
    cfg = dataclasses.replace(get_config("qwen2.5-3b"), num_layers=4,
                              dtype="float32", kv_cache_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 61)
    params = api.init_params(cfg, gen, device="cuda")
    want, _ = swap_race(cfg, params, None)
    for prefetch in (True, False):
        got, eng = swap_race(cfg, params, prefetch)
        s = eng.tier.stream
        log(f"swap race [{'prefetch hit' if prefetch else 'demand fetch'}]:"
            f" resumed tokens equal the unswapped run's {got == want} "
            f"(A {got[0][-8:]}, B {got[1][-8:]}); hits {s.prefetch_hits}, "
            f"demand fetches {s.demand_fetches}")
        if got != want or s.prefetch_hits != int(prefetch) \
                or s.demand_fetches != int(not prefetch):
            fail(f"swap race [{prefetch}]: tokens differ after the swap, or "
                 f"the copy took the wrong path")
    del params
    torch.cuda.empty_cache()


def check_bf16_swap_stream(cfg, params) -> None:
    """ROADMAP Queue 3 check 2 on the card: qwen2.5-3b at full depth, bf16
    weights and KV cache, two sampled requests (temperature 0.9, top-p
    0.95) through a pool their prompts fill at admission (the older one's
    cut to whole pages, so its first step needs a page and the younger is
    preempted). Alone, then evict-only (resume by re-prefill), then with
    the tier (resume by swap-in). The tiered stream must equal the stream
    alone bit for bit (nothing is re-prefilled); whether the evict-only
    stream does is logged."""
    from repro_torch.runtime.sampling import SamplingParams
    sp = SamplingParams(temperature=0.9, top_p=0.95, seed=11)
    own = np.random.default_rng(SEED + 62)
    prompts = [[int(t) for t in own.integers(0, cfg.vocab, n)]
               for n in (16 * 14, 201)]

    def run(idx, **kw):
        eng = PagedServingEngine(cfg, params, slots=2, max_len=MAX_LEN,
                                 page_size=PAGE, device="cuda", **kw)
        reqs = [Request(rid=i, prompt=prompts[i], max_new=24, params=sp)
                for i in idx]
        sched = tier_drive(eng, reqs)
        return [r.generated for r in reqs], sched

    alone = [run([i])[0][0] for i in range(2)]
    pages = sum(-(-len(p) // PAGE) for p in prompts)
    ev, es = run([0, 1], num_pages=pages)
    ti, ts = run([0, 1], num_pages=pages, host_tier=True)

    def parts(x, y):
        return next((i for i, (u, v) in enumerate(zip(x, y)) if u != v),
                    None)

    log(f"bf16 sampled stream through a preemption (36 layers, bf16 KV): "
        f"evict-only {es.preempted} preemption(s), equal to alone "
        f"{ev == alone} (parts at {[parts(a, b) for a, b in zip(alone, ev)]}"
        f"); tiered {ts.preempted} swap(s), equal to alone {ti == alone}")
    if ti != alone or ts.preempted < 1:
        fail("bf16 sampled stream: the tiered stream parts from the stream "
             "alone, or nothing was swapped")


def check_spec_gap(cfg, params) -> None:
    """ROADMAP Queue 3 check 1: the serve bench's sampling-scenario trace
    (``_spec_trace``: 12 templated requests, 24 new, 4 slots, max_len 128)
    at bf16 and full depth, plain greedy against spec_k 4 n-gram greedy.
    At the first token where a request's streams part, the plain decode
    step's logits (the graph's output row) give the gap between its two
    largest logits and between the two streams' tokens, in units of
    bf16's spacing at the top logit (the head matmul's output is bf16).
    Logged, not gated."""
    from repro_torch.launch.serve_bench import _spec_trace
    parted = {}

    def engine(cls=PagedServingEngine, **kw):
        return cls(cfg, params, slots=4, max_len=128, page_size=PAGE,
                   device="cuda", **kw)

    spec = _spec_trace(cfg, 12, 24, SEED)
    engine(spec_k=4).run_to_completion(spec)

    class Probe(PagedServingEngine):
        """Notes, per request, the first decode step whose token parts
        from its spec stream after an equal prefix, with that step's
        logits row."""

        def _step(self):
            before = [(i, r, len(r.generated))
                      for i, r in enumerate(self.live) if r is not None]
            out = super()._step()
            for i, r, n in before:
                sg = spec[r.rid].generated
                if r.rid in parted or len(r.generated) != n + 1 \
                        or n >= len(sg) or r.generated[:n] != sg[:n] \
                        or r.generated[n] == sg[n]:
                    continue
                parted[r.rid] = (n, self.last_logits[i, : cfg.vocab]
                                 .float().cpu(), sg[n])
            return out

    plain = _spec_trace(cfg, 12, 24, SEED)
    engine(Probe).run_to_completion(plain)
    same = sum(r.generated == s.generated for r, s in zip(plain, spec))
    log(f"spec gap (bf16, 36 layers): plain and spec_k 4 n-gram greedy "
        f"streams equal on {same}/12 requests; {len(parted)} part at a "
        f"decode step")
    for rid, (i, z, tok_spec) in sorted(parted.items())[:4]:
        top = torch.topk(z, 2)
        z1, z2 = float(top.values[0]), float(top.values[1])
        ulp = 2.0 ** (np.floor(np.log2(abs(z1))) - 7)
        a = plain[rid].generated[i]
        log(f"spec gap: request {rid} parts at token {i}: plain {a} "
            f"(logit {float(z[a]):.5f}), spec {tok_spec} (logit "
            f"{float(z[tok_spec]):.5f}); top-2 gap {z1 - z2:.5f} = "
            f"{(z1 - z2) / ulp:.2f} bf16 spacings at {z1:.4f} (spacing "
            f"{ulp:.5f}); plain minus spec token "
            f"{(float(z[a]) - float(z[tok_spec])) / ulp:.2f} spacings")


def tier_traffic(prompts, vocab):
    return [Request(rid=i, prompt=[t % vocab for t in p], max_new=MAX_NEW)
            for i, p in enumerate(prompts)]


def pinned_copy_ms(nbytes: int):
    """The link's yardstick: CUDA-event ms of one pinned ``copy_`` of
    ``nbytes`` each way (least of 3)."""
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    out = []
    for src, dst in ((dev, host), (host, dev)):
        best = float("inf")
        for _ in range(3):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            dst.copy_(src, non_blocking=True)
            b.record()
            b.synchronize()
            best = min(best, a.elapsed_time(b))
        out.append(best)
    return out


def time_swap(eng, req) -> None:
    """One live request's swap through the engine's tier: swap-out (gather
    + D2H) to its copies' completion, swap-in by demand fetch (H2D +
    scatter) and, after a prefetch that has landed, the swap-in's scatter
    alone; host wall to a device sync (least of 3), beside a pinned copy
    of the same bytes each way."""
    tier = eng.tier
    outs, ins, hits = [], [], []
    nbytes = 0
    for _ in range(3):
        slot = next(s for s, r in enumerate(eng.live) if r is req)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._swap_out_slot(slot)
        tier.drain()
        torch.cuda.synchronize()
        outs.append(time.perf_counter() - t0)
        nbytes = tier.store.bytes_stored
        t0 = time.perf_counter()
        if not eng.submit(req):
            fail("swap timing: swap-in rejected")
        torch.cuda.synchronize()
        ins.append(time.perf_counter() - t0)
        slot = next(s for s, r in enumerate(eng.live) if r is req)
        eng._swap_out_slot(slot)
        tier.drain()
        eng.prefetch_pending([req])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.submit(req)
        torch.cuda.synchronize()
        hits.append(time.perf_counter() - t0)
    d2h, h2d = pinned_copy_ms(nbytes)
    o, i, h = min(outs) * 1e3, min(ins) * 1e3, min(hits) * 1e3
    log(f"  swap of one request ({nbytes} B): out {o:.3f} ms = "
        f"{nbytes / o / 1e6:.2f} GB/s (pinned copy_ D2H {d2h:.3f} ms = "
        f"{nbytes / d2h / 1e6:.2f} GB/s: {d2h / o:.1%}); in, demand fetch "
        f"{i:.3f} ms = {nbytes / i / 1e6:.2f} GB/s (pinned copy_ H2D "
        f"{h2d:.3f} ms = {nbytes / h2d / 1e6:.2f} GB/s: {h2d / i:.1%}); "
        f"in after a landed prefetch (scatter only) {h:.3f} ms")


def decode_window(eng, prompts, vocab, profiled: bool):
    """A decode window of 8 requests (the given prompts, 16 new tokens):
    after its first step, the host wall ms per step over the other 15
    (``profiled`` False) or the device's idle share of them from
    ``torch.profiler`` (True)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for i, p in enumerate(prompts):
        if not eng.submit(Request(rid=1000 + i, prompt=[t % vocab for t in p],
                                  max_new=17)):
            fail("decode window: admission rejected")
    eng.step()
    torch.cuda.synchronize()

    def run():
        t0 = time.perf_counter()
        n = 0
        while eng.has_live():
            eng.step()
            n += 1
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e6, n

    if not profiled:
        wall_us, n = run()
        return wall_us / 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_us, _ = run()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)
    return 1 - busy / max(wall_us, 1)


def serve_tier(arch, prompts) -> dict:
    """One arch at full width and depth, bf16, seeded weights, the serve
    phase's traffic (16 requests of 64-600 tokens, 32 new, token ids
    modulo the arch's vocab), 8 slots: uncapped, evict@cap and tiered@cap
    with the pool at 0.4 of the traffic's worst case (mamba2, which holds
    no pages: a preemption every 8 ticks instead, the same for both rows),
    each engine warmed (its capture) and reset first. Logs tok/s, TTFT
    and TPOT p50, preemptions, the prefill spent again, the tier's
    counters, one request's swap times against a pinned copy, and (qwen)
    the decode window's idle share with the tier on and off. Every capped
    row must emit the uncapped tokens. Returns the tiered row's launches
    (qwen; counts set to 0 just before its run, read just after)."""
    cfg = get_config(arch)
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 63)
    params = api.init_params(cfg, gen, device="cuda")
    every = 8 if arch == "mamba2-2.7b" else 0
    launches, want, cap = {}, None, None
    base_prefilled = 0
    for name, kw in (("uncapped", {}), ("evict@cap", {}),
                     ("tiered@cap", {"host_tier": True})):
        if name != "uncapped" and not every:
            kw["num_pages"] = cap
        eng = PagedServingEngine(cfg, params, slots=SLOTS, max_len=MAX_LEN,
                                 page_size=PAGE, device="cuda", **kw)
        eng.run_to_completion([Request(rid=-1, prompt=list(range(64)),
                                       max_new=2)])
        eng.reset_metrics()
        reqs = tier_traffic(prompts, cfg.vocab)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        sched = tier_drive(eng, reqs, every if name != "uncapped" else 0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if name == "tiered@cap":
            launches = ops.launch_counts()
        m = eng.metrics()
        toks = [r.generated for r in reqs]
        n_tok = sum(len(t) for t in toks)
        if name == "uncapped":
            want, base_prefilled = toks, eng.prefilled_tokens
            cap = tier_cap(reqs, eng)
        line = (f"host tier serve [{arch}, {name}, pool "
                f"{eng.alloc.num_pages} pages]: {n_tok} tokens in "
                f"{wall:.2f} s = {n_tok / wall:.1f} tok/s, ttft p50 "
                f"{m['latency.ttft_p50_s']:.4f} s, tpot p50 "
                f"{m['latency.tpot_p50_s']:.4f} s, {sched.preempted} "
                f"preemptions, re-prefilled "
                f"{eng.prefilled_tokens - base_prefilled} tokens")
        if eng.tier is not None:
            ts = eng.tier_stats()
            line += (f"; swap-outs {ts['swap_outs']:.0f} / ins "
                     f"{ts['swap_ins']:.0f}, reprefill_tokens_saved "
                     f"{ts['reprefill_tokens_saved']:.0f}, prefetch_hit_rate "
                     f"{ts['prefetch_hit_rate']:.3f}, copy_stall_ticks "
                     f"{ts['copy_stall_ticks']:.0f}, host_bytes_peak "
                     f"{ts['host_bytes_peak']:.0f}")
        log(line)
        if any(len(t) != MAX_NEW for t in toks):
            fail(f"host tier serve [{arch}, {name}]: a request did not "
                 f"finish")
        if name != "uncapped":
            if not sched.preempted:
                fail(f"host tier serve [{arch}, {name}]: nothing preempted")
            # bf16: a re-prefill rounds its keys anew, so only the tiered
            # row is held to the uncapped tokens
            if name == "tiered@cap" and toks != want:
                fail(f"host tier serve [{arch}, tiered@cap]: tokens differ "
                     f"from the uncapped run's")
            if name == "evict@cap":
                log(f"  evict@cap tokens equal the uncapped run's: "
                    f"{toks == want}")
        if name == "tiered@cap":
            # a long request's swap timed by hand on the same engine
            big = max(reqs, key=lambda r: len(r.prompt))
            req = Request(rid=500, prompt=list(big.prompt), max_new=64)
            if not eng.submit(req):
                fail("swap timing: admission rejected")
            eng.step()
            time_swap(eng, req)
            while eng.has_live():
                eng.step()
        del eng
    if arch == "qwen2.5-3b":
        # what drain() costs when nothing is pending: two uncapped engines,
        # tier off and on, their decode windows in turns (off, on, on, off,
        # off, on: host ms a step without the profiler; then the same turns
        # for the idle share with it, so no window follows a profiled one
        # of the other engine more often)
        pair = [PagedServingEngine(cfg, params, slots=SLOTS,
                                   max_len=MAX_LEN, page_size=PAGE,
                                   host_tier=on, device="cuda")
                for on in (False, True)]
        turns = (0, 1, 1, 0, 0, 1)
        got = {False: [[], []], True: [[], []]}
        for profiled in (False, True):
            for k in turns:
                got[profiled][k].append(decode_window(
                    pair[k], prompts[:SLOTS], cfg.vocab, profiled))
        for k, label in enumerate(("tier off", "tier on, nothing pending")):
            ms, idle = got[False][k], got[True][k]
            log(f"  decode window (15 steps, B=8), {label}: host ms a step "
                f"{', '.join(f'{x:.3f}' for x in ms)} (median "
                f"{sorted(ms)[1]:.3f}); idle share "
                f"{', '.join(f'{x:.1%}' for x in idle)} (median "
                f"{sorted(idle)[1]:.1%})")
        del pair
    del params
    torch.cuda.empty_cache()
    return launches


def run_serve_bench_oversubscribe() -> None:
    """``serve_bench --scenario oversubscribe`` at full width, 4 layers,
    fp32 (fp32 KV cache), the hybrid pair's window cut to 32: its CSV gated
    by ``launch/check_csv.py`` (every capped row's
    ``tokens_match_unconstrained`` must be 1; the columns of the sharded
    and sampling scenarios, not in this CSV, are the only ones missing)."""
    from repro_torch.launch import check_csv
    t0 = time.perf_counter()
    text = bench_csv(["--full", "--scenario", "oversubscribe", "--layers",
                      "4", "--dtype", "float32", "--window", "32"])
    log(f"serve_bench --scenario oversubscribe (full width, 4 layers, "
        f"fp32) in {time.perf_counter() - t0:.1f} s:")
    print(text, flush=True)
    errors = check_csv.check(text)
    if errors != check_csv.missing_scenario_errors(
            ("tokens_match_tp1", "tokens_match_greedy")):
        fail(f"serve_bench oversubscribe CSV: {errors}")
    rows = [row for _, rs in check_csv.parse_sections(text) for row in rs]
    for row in rows:
        if "tiered@cap" in row["engine"] and "prefix" not in row["engine"] \
                and "hybrid" not in row["engine"] \
                and row["reprefill_tokens"] != "0":
            fail(f"serve_bench oversubscribe: {row['engine']} re-prefilled")
    log("serve_bench oversubscribe: CSV passes the gate "
        "(tokens_match_unconstrained on every capped row)")


# ---------------------------------------------------------------------------
# phase 11: MoE and vlm stacks (dbrx-132b, llama4-maverick, internvl2-2b)
# ---------------------------------------------------------------------------

MOE_ARCHS = ("dbrx-132b", "llama4-maverick-400b-a17b")
NEW_ARCHS = MOE_ARCHS + ("internvl2-2b",)
# depth the card holds at full width in bf16 (widths are never cut): dbrx's
# 40 layers are ~6.5 GB each, llama4's MoE layers ~32.5 GB each
SERVE_LAYERS = {"dbrx-132b": 8, "llama4-maverick-400b-a17b": 2,
                "internvl2-2b": 24}


def heads_of(arch):
    """(query heads, KV heads, head dim) of ``arch``, from its config."""
    cfg = get_config(arch)
    return cfg.num_heads, cfg.kv_heads, cfg.resolved_head_dim


def check_moe_kernels(rng):
    """The two kernels of the MoE and vlm path at those stacks' heads, read
    from their configs: paged flash-decode at T = 1 and at the verify
    step's T = 5, bf16 and fp32 (fp32 also against its split structure),
    B = 8 over contexts of the serve traffic's range; mha causal at a
    1024 bucket (fp32 with the one-key mask shift and two runs bit for
    bit), a ragged 300, and a 300-row suffix at q_offset 512, bf16 and
    fp32. Returns (paged, mha) max abs error per arch."""
    errs = {}
    for arch in NEW_ARCHS:
        heads = heads_of(arch)
        Hq, KVh, Dh = heads
        err_p = 0.0
        lengths = [int(n) for n in rng.integers(97, 640, SLOTS)]
        for T in (1, 5):
            for dt in (torch.bfloat16, torch.float32):
                args = paged_case(rng, SLOTS, T, Hq, KVh, Dh, PAGE, lengths,
                                  MAX_LEN // PAGE, dt)
                S = paged_plan(SLOTS, T, MAX_LEN // PAGE, heads=heads)
                got = paged_kernel.paged_attention(*args)
                torch.cuda.synchronize()
                name = (f"paged_attention [{arch} H{Hq} KV{KVh} "
                        f"G{Hq // KVh}, T={T}, {str(dt)[6:]}, S={S}]")
                err_p = max(err_p, agrees(name, got,
                                          ref.paged_attention_ref(*args)))
                if dt == torch.float32:
                    split = ref.paged_attention_split_ref(*args, splits=S)
                    worst = ref.row_error(got, split).max().item()
                    log(f"{name}: worst row {worst:.3g} against the split "
                        f"reference (limit 1e-05)")
                    if not worst <= 1e-5:
                        fail(f"{name}: disagrees with its split structure")
        cases = [("prefill 1024, causal", 1, 1024, 1024, True, None,
                  torch.bfloat16),
                 ("prefill 1024, causal, fp32", 1, 1024, 1024, True, None,
                  torch.float32),
                 ("ragged 300, causal", 1, 300, 300, True, None,
                  torch.bfloat16)]
        err_m = check_mha(rng, [(f"{arch} {c[0]}",) + c[1:] for c in cases],
                          heads)
        off, Sq = 512, 300
        for dt in (torch.bfloat16, torch.float32):
            def t(*shape):
                return torch.tensor(rng.standard_normal(shape), dtype=dt,
                                    device="cuda")
            q, k, v = t(1, Sq, Hq, Dh), t(1, off + Sq, KVh, Dh), \
                t(1, off + Sq, KVh, Dh)
            got = mha_kernel.mha(q, k, v, causal=True, q_offset=off)
            torch.cuda.synchronize()
            err_m = max(err_m, agrees(
                f"mha [{arch} H{Hq} KV{KVh}, suffix {Sq} at q_offset {off}, "
                f"{str(dt)[6:]}]", got,
                ref.mha_ref(q, k, v, causal=True, q_offset=off)))
        errs[arch] = (err_p, err_m)
    return errs


def time_moe_kernels(rng):
    """Both kernels timed at each new stack's heads: paged flash-decode at
    B = 8 over the serve traffic's contexts (T = 1, and T = 5 for the MoE
    heads' verify block), mha at a 1024 bucket beside SDPA. Returns
    {arch: (paged times, mha times)}."""
    out = {}
    for arch in NEW_ARCHS:
        heads = heads_of(arch)
        lengths = [int(n) for n in rng.integers(97, 640, SLOTS)]
        label = (f"{arch} H{heads[0]} KV{heads[1]} G{heads[0] // heads[1]}: "
                 f"B={SLOTS}, contexts {min(lengths)}-{max(lengths)}")
        paged_t = time_paged(rng, SLOTS, lengths, label, heads)
        if arch in MOE_ARCHS:
            time_paged(rng, SLOTS, lengths, label + ", verify T=5", heads,
                       T=5)
        mha_t = time_mha(rng, 1024, f"{arch} H{heads[0]} KV{heads[1]}: B=1, "
                         f"Sq=Sk=1024 bucket", heads)
        out[arch] = (paged_t, mha_t)
    return out


class PrefillDrops:
    """Counts the routed slots the MoE layers drop in each prefill bucket,
    from the routing helper (``layers.moe_route``) called again beside
    ``moe_apply`` on a prefill's input (batch 1), never inside a capture:
    the counts stay on the card until ``read``, so nothing syncs while the
    engine runs."""

    def __init__(self):
        from repro_torch.models import transformer as tfm
        self.tfm = tfm
        self.apply = tfm.moe_apply
        self.seen = []

    def __enter__(self):
        from repro_torch.models import layers

        def counted(cfg, p, x, *args, **kw):
            capturing = torch.cuda.is_current_stream_capturing()
            if x.shape[0] == 1 and not capturing:
                keep = layers.moe_route(cfg, p, x)[3]
                self.seen.append((x.shape[1], keep.numel() - keep.sum()))
            return self.apply(cfg, p, x, *args, **kw)
        self.tfm.moe_apply = counted
        return self

    def __exit__(self, *exc):
        self.tfm.moe_apply = self.apply

    def read(self):
        return [(rows, int(n)) for rows, n in self.seen]


def staggered_traffic(rng, vocab, n, lo=2, hi=40):
    """n requests of 16-300 tokens whose budgets run from ``lo`` to ``hi``
    tokens: slots die at different steps while others decode."""
    return [(([int(t) for t in rng.integers(0, vocab, int(L))]), int(b))
            for L, b in zip(rng.integers(16, 300, n), rng.integers(lo, hi, n))]


def drive(eng, traffic, check=False):
    from repro_torch.runtime.scheduler import Scheduler
    reqs = [Request(rid=i, prompt=list(p), max_new=b)
            for i, (p, b) in enumerate(traffic)]
    sched = Scheduler(eng)
    for r in reqs:
        sched.add(r)
    while sched.pending or eng.has_live():
        sched.tick()
        if check:
            eng.check()
        if sched.steps > 5000:
            fail(f"{eng.cfg.name}: the run did not finish")
    return [r.generated for r in reqs], sched


def replays_equal_body(name, cfg, params, traffic) -> None:
    """8 decode steps of the captured graph against the uncaptured body on
    the same traffic, 8 slots, budgets that end some requests within the
    8 steps (dead rows in the step beside live ones): the live rows'
    logits must be equal bit for bit; whether the dead rows' are too is
    logged (their pool writes go through the last-writer write)."""
    kw = dict(slots=SLOTS, max_len=MAX_LEN, page_size=PAGE, device="cuda")
    engs = [UncapturedEngine(cfg, params, **kw),
            PagedServingEngine(cfg, params, **kw)]
    for eng in engs:
        for i, (p, b) in enumerate(traffic):
            if not eng.submit(Request(rid=i, prompt=list(p), max_new=b)):
                fail(f"{name}: admission rejected")
    dead_same = True
    for s in range(8):
        for eng in engs:
            eng.step()
        live = [i for i, r in enumerate(engs[1].live) if r is not None]
        if live != [i for i, r in enumerate(engs[0].live) if r is not None]:
            fail(f"{name}: decode step {s}: live slots differ")
        a, b = engs[0].last_logits, engs[1].last_logits
        if not torch.equal(a[live], b[live]):
            fail(f"{name}: decode step {s}: the graph's logits differ from "
                 f"the uncaptured body's on live rows")
        dead_same = dead_same and torch.equal(a, b)
    log(f"{name}: 8 replays of the decode graph equal the uncaptured body "
        f"bit for bit on the live rows ({SLOTS} slots, "
        f"{SLOTS - len(live)} dead after the last step); dead rows equal "
        f"too: {dead_same}; captures {engs[1].step_traces}")
    if engs[1].step_traces != 1 or len(live) == SLOTS:
        fail(f"{name}: captures are not one, or no slot died")


def check_moe_exact() -> None:
    """dbrx-132b at full width, 2 of 40 layers, fp32 (weights, activations
    and KV cache): the kernel engine's greedy tokens equal the gather
    engine's through a forced preemption (4 slots over 16 pages), with the
    routed slots each prefill bucket drops logged from the routing helper;
    two serve runs at 8 slots with staggered budgets emit identical
    tokens; 8 graph replays with dead slots equal the uncaptured body.
    Then llama4-maverick at full width, 2 of 48 layers (one attn_mlp, one
    attn_moe), bf16: its 8 replays, and gather against kernel over 8
    steps (greedy tokens equal, or parting on a near tie)."""
    f32 = dict(dtype="float32", kv_cache_dtype="float32")
    cfg = dataclasses.replace(get_config("dbrx-132b"), num_layers=2, **f32)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 70)
    params = api.init_params(cfg, gen, device="cuda")
    own = np.random.default_rng(SEED + 70)
    prompts = [([int(t) for t in own.integers(0, cfg.vocab, n)], 24)
               for n in (80, 150, 97, 230, 40, 130)]
    kw = dict(slots=4, max_len=512, page_size=PAGE, device="cuda")
    t0 = time.perf_counter()
    with PrefillDrops() as drops:
        kernel, sk = drive(PagedServingEngine(cfg, params, num_pages=16,
                                              **kw), prompts, check=True)
    gather, _ = drive(PagedServingEngine(cfg, params, num_pages=16,
                                         attn_impl="gather", **kw), prompts,
                      check=True)
    log(f"moe exact [dbrx-132b, fp32, 2 layers]: kernel vs gather greedy "
        f"tokens equal {kernel == gather} over {len(prompts)} requests x "
        f"24; preemptions {sk.preempted}; routed slots dropped in the "
        f"prefill buckets (rows, dropped), each MoE layer: {drops.read()}; "
        f"{time.perf_counter() - t0:.1f} s")
    if kernel != gather:
        fail("moe exact: kernel and gather tokens differ")
    if sk.preempted < 1:
        fail("moe exact: nothing was preempted")
    traffic = staggered_traffic(own, cfg.vocab, 2 * SLOTS)
    runs = [drive(PagedServingEngine(cfg, params, slots=SLOTS,
                                     max_len=MAX_LEN, page_size=PAGE,
                                     device="cuda"), traffic)[0]
            for _ in range(2)]
    lens = sorted(len(t) for t in runs[0])
    log(f"moe exact [dbrx-132b, fp32, 2 layers, {SLOTS} slots, budgets "
        f"{lens[0]}-{lens[-1]}]: two serve runs with slots dying mid-run "
        f"emit identical tokens: {runs[0] == runs[1]}")
    if runs[0] != runs[1]:
        fail("moe exact: two identical dbrx runs emitted different tokens")
    replays_equal_body("moe exact [dbrx-132b, fp32, 2 layers]", cfg, params,
                       staggered_traffic(own, cfg.vocab, SLOTS, 3, 12))
    del params
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config("llama4-maverick-400b-a17b"),
                              num_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 71)
    params = api.init_params(cfg, gen, device="cuda")
    replays_equal_body("moe exact [llama4-maverick, bf16, 2 layers]", cfg,
                       params, staggered_traffic(own, cfg.vocab, SLOTS, 3, 12))
    kw = dict(slots=SLOTS, max_len=MAX_LEN, page_size=PAGE, device="cuda")
    lockstep("gather vs kernel, llama4-maverick, bf16, 2 layers",
             PagedServingEngine(cfg, params, attn_impl="gather", **kw),
             PagedServingEngine(cfg, params, **kw),
             [p for p, _ in staggered_traffic(own, cfg.vocab, 4)], 8,
             BF16_LOGIT_TOL)
    del params
    torch.cuda.empty_cache()


def check_vlm_prefill() -> None:
    """internvl2-2b at full width and depth, bf16: a prefill of 256 x 2048
    patch embeddings (the frontend stub's) before 64 tokens gives finite
    logits at the last position, caches of 320 rows, launches mha once a
    layer, and logits the patches move."""
    cfg = get_config("internvl2-2b")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 72)
    params = api.init_params(cfg, gen, device="cuda")
    emb = torch.randn((1, cfg.frontend_tokens, cfg.d_model), generator=gen,
                      device="cuda").to(torch.bfloat16)
    toks = torch.randint(0, cfg.vocab, (1, 64), generator=gen, device="cuda")
    before = ops.launch_counts()["mha"]
    logits, caches, pos = api.prefill(cfg, params, toks,
                                      frontend_embeds=emb)
    torch.cuda.synchronize()
    n_mha = ops.launch_counts()["mha"] - before
    plain, _, _ = api.prefill(cfg, params, toks)
    moved = (logits - plain).abs().max().item()
    finite = bool(torch.isfinite(logits).all())
    log(f"internvl2-2b prefill with {cfg.frontend_tokens} x {cfg.d_model} "
        f"patch embeddings + 64 tokens: logits {tuple(logits.shape)} finite "
        f"{finite}, next position {int(pos[0])}, cache rows "
        f"{caches[0]['k'].shape[1]}, mha launches {n_mha} for "
        f"{cfg.num_layers} layers; logits moved by the patches {moved:.3g}")
    if not finite or n_mha != cfg.num_layers or int(pos[0]) != 320 \
            or caches[0]["k"].shape[1] != 320 or not moved > 0:
        fail("internvl2-2b: the patch prefill is wrong")
    del params
    torch.cuda.empty_cache()


def moe_piece_times(cfg, params, eng) -> None:
    """Where an MoE decode step spends the card's time (B = 8 rows, one
    dispatch group): one step as the engine's graph replays it, then each
    piece captured alone in a graph (``graph_ms``) times the layers that
    run it: the paged kernel, routing + dispatch + combine, the expert
    GEMMs, the shared expert, the dense MLPs, the head and the sampler.
    The expert GEMMs beside their byte bound: the dispatch runs every
    expert at capacity C, so a step reads every expert's weights."""
    from repro_torch.models import layers
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.sampling import sample_rows
    kinds = tfm.layer_kinds(cfg)
    dt = getattr(torch, cfg.dtype)
    B, d = SLOTS, cfg.d_model
    gen = torch.Generator(device="cuda").manual_seed(SEED + 73)
    x1 = torch.randn((B, 1, d), generator=gen, device="cuda").to(dt)
    step = cuda_ms(eng._graph.replay, iters=10)
    n_attn, n_moe = len(kinds), kinds.count("attn_moe")
    heads = (cfg.num_heads, cfg.kv_heads, cfg.resolved_head_dim)
    lengths = [int(n) for n in np.random.default_rng(SEED + 74).integers(
        97, 640, B)]
    args = paged_case(np.random.default_rng(SEED + 74), B, 1, *heads, PAGE,
                      lengths, MAX_LEN // PAGE, dt)
    dec = {"paged_attention kernel": n_attn * graph_ms(
        lambda: ops.paged_attention(*args))}
    shape = f"B={B}"
    if n_moe:
        G, C = layers.moe_capacity(cfg, B)
        shape += f", {G} dispatch group, C={C}"
        mp = params["blocks"][kinds.index("attn_moe")]["moe"]
        buf = layers.moe_dispatch(cfg, x1, layers.moe_route(cfg, mp, x1)[2])
        eo = layers.moe_experts(mp, buf)

        def route_dispatch_combine():
            g, _, f, k = layers.moe_route(cfg, mp, x1)
            layers.moe_dispatch(cfg, x1, f)
            layers.moe_combine(cfg, eo, g, f, k, x1)
        dec["router + dispatch + combine"] = n_moe * graph_ms(
            route_dispatch_combine)
        dec["expert GEMMs"] = n_moe * graph_ms(
            lambda: layers.moe_experts(mp, buf))
        if cfg.moe.shared_expert:
            dec["shared expert"] = n_moe * graph_ms(
                lambda: layers.mlp_apply(cfg, mp["shared"], x1))
    if "attn_mlp" in kinds:
        mlp = params["blocks"][kinds.index("attn_mlp")]["mlp"]
        dec["MLPs"] = kinds.count("attn_mlp") * graph_ms(
            lambda: layers.mlp_apply(cfg, mlp, x1))
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    dec["head + sampler"] = graph_ms(lambda: sample_rows(
        (x1[:, 0] @ head).float()[:, : cfg.vocab], eng.pol))
    line = (f"pieces {cfg.name} ({cfg.num_layers} layers) decode step "
            f"({shape}): graph replay {step:.3f} ms; alone: " + ", ".join(
                f"{k} {v:.3f} ms ({v / step:.1%})" for k, v in dec.items()))
    if n_moe:
        m = cfg.moe
        n_bytes = n_moe * m.num_experts * 3 * d * cfg.d_ff * 2
        bms, _ = bench.bound_ms(n_bytes, 0, dt)
        line += (f"; the expert GEMMs read {n_bytes / 1e9:.2f} GB of "
                 f"weights a step, bound {bms:.3f} ms at 3.35 TB/s, "
                 f"{bms / dec['expert GEMMs']:.1%} of it reached")
    log(line)


def serve_moe(arch, prompts) -> dict:
    """One new arch at full width, bf16, seeded weights on the card, depth
    cut to what the card holds (``SERVE_LAYERS``), the serve phase's 16
    requests (token ids modulo the arch's vocab, 32 new) on 8 slots
    through the scheduler, after a warm-up request (the capture) and
    ``reset_metrics``. Checks every request finished, the launch counts
    and one capture; logs tok/s, TTFT and TPOT p50, peak memory, the
    launches and a decode step by piece (``moe_piece_times``). Returns
    the run's launch counts (set to 0 just before it, read just after)."""
    cfg = dataclasses.replace(get_config(arch),
                              num_layers=SERVE_LAYERS[arch])
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 75)
    params = api.init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    log(f"serve {arch}: {cfg.param_count() / 1e9:.2f}B params "
        f"({cfg.active_param_count() / 1e9:.2f}B active), "
        f"{cfg.num_layers} of {get_config(arch).num_layers} layers, bf16, "
        f"weights drawn on the card in {time.perf_counter() - t0:.1f} s")
    eng = PagedServingEngine(cfg, params, slots=SLOTS, max_len=MAX_LEN,
                             page_size=PAGE, device="cuda")
    eng.run_to_completion([Request(rid=-1, prompt=list(range(64)),
                                   max_new=2)])
    eng.reset_metrics()
    reqs = tier_traffic(prompts, cfg.vocab)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    eng.run_to_completion(reqs, max_steps=20 * N_REQ * MAX_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    m = eng.metrics()
    n_tok = sum(len(r.generated) for r in reqs)
    log(f"serve {arch}: {sum(r.done for r in reqs)}/{len(reqs)} requests, "
        f"{n_tok} tokens in {wall:.2f} s = {n_tok / wall:.1f} tok/s, ttft "
        f"p50 {m['latency.ttft_p50_s']:.4f} s, tpot p50 "
        f"{m['latency.tpot_p50_s']:.4f} s, {eng.decode_steps} decode steps "
        f"(graph replays), {eng.prefills} prefills, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{counts}; a replay holds {eng._graph_launches}; captures "
        f"{eng.step_traces}")
    if any(not r.done or len(r.generated) != MAX_NEW for r in reqs):
        fail(f"serve {arch}: not every request finished with max_new tokens")
    if any(not 0 <= t < cfg.vocab for r in reqs for t in r.generated):
        fail(f"serve {arch}: a token outside the vocabulary")
    if eng.step_traces != 1:
        fail(f"serve {arch}: {eng.step_traces} decode graph captures")
    want = serving_launches(cfg, eng)
    if counts != want:
        fail(f"serve {arch}: launches {counts} != {want}")
    eng.alloc.check()
    moe_piece_times(cfg, params, eng)
    del eng, params
    torch.cuda.empty_cache()
    return counts


def moe_kernel_entries(errs, times, counts) -> list:
    """The JSON entries of the new stacks' kernel calls: each arch's paged
    flash-decode and mha, at its heads, with its serve run's launches."""
    out = []
    for arch in NEW_ARCHS:
        Hq, KVh, Dh = heads_of(arch)
        (pm, pp, pb, pby), (mm, mp, mb, mby, ml) = times[arch]
        out += [
            {"name": f"paged_attention[G {Hq // KVh}, H{Hq} KV{KVh} D{Dh}, "
                     f"{arch} decode]", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
             "replaces": "src/repro/kernels/paged_attention.py:78",
             "launches": counts[arch]["paged_attention"],
             "max_abs_err": errs[arch][0], "ms": pm, "plain_ms": pp,
             "bound_ms": pb, "bound_by": pby, "library_ms": None},
            {"name": f"mha[H{Hq} KV{KVh} D{Dh}, {arch} prefill]",
             "route": "cuda", "source": "src/repro_torch/kernels/csrc/mha.cu",
             "replaces": "src/repro/kernels/attention.py:32",
             "launches": counts[arch]["mha"], "max_abs_err": errs[arch][1],
             "ms": mm, "plain_ms": mp, "bound_ms": mb, "bound_by": mby,
             "library_ms": ml}]
    return out


# ---------------------------------------------------------------------------
# phase 12: the dense-slot engine and the encoder-decoder stack
# ---------------------------------------------------------------------------

SEAMLESS = "seamless-m4t-large-v2"
DENSE_HEADS = {"qwen2.5-3b": (H, KV, D), SEAMLESS: (16, 16, 64)}


def dense_mha_cases(rng):
    """mha at the dense and encoder-decoder path's shapes, (label, q, k, v,
    causal, kv_valid) on the card, fresh from ``rng`` in ``dtype``: the
    encoder (B 2, Sq = Sk = 1024, non-causal), the cross prefill (B 8, 128
    prompt rows against 1024 frames), the dense lanes' decode (B 8, one
    row a slot, a device kv_valid from 1 up to the 1024-row lane) at
    qwen2.5-3b's and seamless's heads, the cross decode (all 1024 frames),
    and a window ring's count min(pos + 1, W) at recurrentgemma's heads
    (W 2048, positions on both sides of it)."""
    def cases(dtype):
        def t(*shape):
            return torch.tensor(rng.standard_normal(shape), dtype=dtype,
                                device="cuda")

        def valid(vals):
            return torch.tensor(vals, dtype=torch.int32, device="cuda")
        sh, skv, sd = DENSE_HEADS[SEAMLESS]
        out = [("seamless encoder, B2 Sq=Sk=1024", t(2, 1024, sh, sd),
                t(2, 1024, skv, sd), t(2, 1024, skv, sd), False, None),
               ("seamless cross prefill, B8 Sq128 x Sk1024",
                t(8, 128, sh, sd), t(8, 1024, skv, sd), t(8, 1024, skv, sd),
                False, None)]
        lane = [1, 2, 77, 256, 511, 700, 1023, 1024]
        for arch, (hq, hkv, hd) in DENSE_HEADS.items():
            out.append((f"{arch} dense decode, B8 Sq1, lane 1024, kv_valid "
                        f"1..1024", t(8, 1, hq, hd), t(8, 1024, hkv, hd),
                        t(8, 1024, hkv, hd), False, valid(lane)))
        out.append(("seamless cross decode, B8 Sq1 x 1024 frames",
                    t(8, 1, sh, sd), t(8, 1024, skv, sd), t(8, 1024, skv, sd),
                    False, None))
        rq, rkv, rd = heads_of("recurrentgemma-9b")
        W = get_config("recurrentgemma-9b").hybrid.window
        pos = [0, 5, 1500, 2046, 2047, 2048, 2600, 3499]
        out.append((f"recurrentgemma ring decode, B8 Sq1, W {W}, n = min("
                    f"pos + 1, W) at pos {pos[0]}..{pos[-1]}",
                    t(8, 1, rq, rd), t(8, W, rkv, rd), t(8, W, rkv, rd),
                    False, valid([min(p + 1, W) for p in pos])))
        return out
    return cases


def check_dense_mha(rng) -> float:
    """Each of ``dense_mha_cases`` in bf16 and fp32 against ``ref.mha_ref``
    on the same inputs (bf16 per row within ``ref.ROW_TOL``, fp32 too);
    the decode rows with kv_valid also inside a captured CUDA graph,
    replayed after the counts change in place. Returns the max abs
    error."""
    make = dense_mha_cases(rng)
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for label, q, k, v, causal, valid in make(dtype):
            got = mha_kernel.mha(q, k, v, causal=causal, kv_valid=valid)
            torch.cuda.synchronize()
            want = ref.mha_ref(q, k, v, causal=causal, kv_valid=valid)
            worst = max(worst, agrees(f"mha [{label}, {str(dtype)[6:]}]",
                                      got, want))
            if valid is None or dtype != torch.bfloat16:
                continue
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = mha_kernel.mha(q, k, v, causal=causal, kv_valid=valid)
            valid.copy_(valid.flip(0))
            graph.replay()
            torch.cuda.synchronize()
            worst = max(worst, agrees(
                f"mha [{label}, bf16, in a graph, kv_valid reversed]", out,
                ref.mha_ref(q, k, v, causal=causal, kv_valid=valid)))
    return worst


def time_dense_mha(rng) -> dict:
    """bf16 times of ``dense_mha_cases``: CUDA-event ms a
    launch (inputs cycled past the L2 cache where one call's are smaller),
    profiler device ms, the plain version, SDPA (a kv_valid as a boolean
    mask) and the bound: the valid K/V rows, q and the output once over
    3.35 TB/s, against 4 Sq D H flops a valid key. Returns {label: (ms,
    plain, bound, by, sdpa)}."""
    out = {}
    for label, q, k, v, causal, valid in dense_mha_cases(rng)(
            torch.bfloat16):
        B, Sq, Hq, Dh = q.shape
        Sk, KVh = k.shape[1], k.shape[2]
        keys = B * Sk if valid is None else int(valid.sum())
        n_bytes = 2 * q.numel() * 2 + 2 * keys * KVh * Dh * 2
        flops = 4 * Sq * Hq * Dh * keys
        bms, by = bench.bound_ms(n_bytes, flops, torch.bfloat16)
        copies = bench.cold_copies((q, k, v), n_bytes)

        def kernel(q, k, v, valid=valid):
            mha_kernel.mha(q, k, v, causal=causal, kv_valid=valid)
        ms = bench.cold_ms(kernel, copies)
        dev = device_ms(kernel, copies)
        plain = cuda_ms(lambda: ref.mha_ref(q, k, v, causal=causal,
                                            kv_valid=valid), iters=3)
        mask = None if valid is None else (
            torch.arange(Sk, device="cuda")[None, :] < valid[:, None]
        )[:, None, None, :]
        tr = [tuple(x.transpose(1, 2).contiguous() for x in c)
              for c in copies]

        def sdpa(qt, kt, vt):
            torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True)
        lib = bench.cold_ms(sdpa, tr)
        lib_dev = device_ms(sdpa, tr)
        masked = " with the mask" if mask is not None else ""
        log(f"mha time [{label}, bf16]: {ms:.4f} ms/launch (device "
            f"{dev:.4f} ms), plain {plain:.4f} ms, SDPA{masked} "
            f"{lib:.4f} ms (device {lib_dev:.4f} ms), bound {bms:.4f} ms "
            f"({by}), {bms / ms:.1%} of bound ({bms / dev:.1%} on the "
            f"device)")
        out[label] = (ms, plain, bms, by, lib)
    return out


class UncapturedDense(DenseServingEngine):
    """The dense engine with its step body run as it is, uncaptured."""

    def _dispatch(self):
        self._step_body()


def dense_replays_equal_body(name, cfg, params, traffic) -> None:
    """8 steps of the dense engine's graph against its uncaptured body, 8
    slots, budgets that end some requests within them: every row's logits
    equal bit for bit, dead rows too (a dead row's lane write and its
    sampled token are the reference's, deterministic)."""
    engs = [cls(cfg, params, slots=SLOTS, max_len=MAX_LEN, device="cuda")
            for cls in (UncapturedDense, DenseServingEngine)]
    for eng in engs:
        for i, (p, b) in enumerate(traffic):
            if not eng.submit(Request(rid=i, prompt=list(p), max_new=b)):
                fail(f"{name}: admission rejected")
    for s in range(8):
        for eng in engs:
            eng.step()
        if not torch.equal(engs[0].last_logits, engs[1].last_logits):
            fail(f"{name}: decode step {s}: the graph's logits differ from "
                 f"the uncaptured body's")
    dead = sum(r is None for r in engs[1].live)
    log(f"{name}: 8 replays of the dense decode graph equal the uncaptured "
        f"body bit for bit on every row ({SLOTS} slots, {dead} dead after "
        f"the last step); captures {engs[1].step_traces}")
    if engs[1].step_traces != 1 or dead == 0:
        fail(f"{name}: captures are not one, or no slot died")


def check_dense_exact() -> None:
    """fp32 (weights, activations, KV cache), full width. qwen2.5-3b cut to
    4 of 36 layers: the dense engine's greedy tokens equal the paged kernel
    engine's and the gather engine's (4 slots, 10 requests whose budgets
    end at different steps), and 8 dense graph replays equal the
    uncaptured body. recurrentgemma-9b cut to 3 of 38 layers (one
    pattern), window 2048 as configured: the dense engine's ring lanes
    emit the paged engine's tokens on prompts of 1990-3400 tokens whose
    generations run past the window."""
    f32 = dict(dtype="float32", kv_cache_dtype="float32")
    cfg = dataclasses.replace(get_config("qwen2.5-3b"), num_layers=4, **f32)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 90)
    params = api.init_params(cfg, gen, device="cuda")
    own = np.random.default_rng(SEED + 90)
    traffic = staggered_traffic(own, cfg.vocab, 10, 3, 24)
    kw = dict(slots=4, max_len=512, device="cuda")
    t0 = time.perf_counter()
    dense = drive(DenseServingEngine(cfg, params, **kw), traffic)[0]
    kernel = drive(PagedServingEngine(cfg, params, page_size=PAGE, **kw),
                   traffic)[0]
    gather = drive(PagedServingEngine(cfg, params, page_size=PAGE,
                                      attn_impl="gather", **kw), traffic)[0]
    log(f"dense exact [qwen2.5-3b, fp32, 4 layers, 4 slots, 10 requests]: "
        f"dense = kernel tokens {dense == kernel}, dense = gather "
        f"{dense == gather}; {time.perf_counter() - t0:.1f} s")
    if not dense == kernel == gather:
        fail("dense exact: the dense, kernel and gather tokens differ")
    dense_replays_equal_body("dense exact [qwen2.5-3b, fp32, 4 layers]",
                             cfg, params,
                             staggered_traffic(own, cfg.vocab, SLOTS, 3, 12))
    del params
    torch.cuda.empty_cache()
    arch = "recurrentgemma-9b"
    cfg = dataclasses.replace(get_config(arch), num_layers=3, **f32)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 91)
    params = api.init_params(cfg, gen, device="cuda")
    lengths = (1990, 2100, 2700, 3400)
    traffic = [([int(t) for t in own.integers(0, cfg.vocab, n)], 80)
               for n in lengths]
    kw = dict(slots=4, max_len=3520, device="cuda")
    t0 = time.perf_counter()
    dense = drive(DenseServingEngine(cfg, params, **kw), traffic)[0]
    paged = drive(PagedServingEngine(cfg, params, page_size=PAGE, **kw),
                  traffic)[0]
    log(f"dense exact [{arch}, fp32, 3 layers, window "
        f"{cfg.hybrid.window}, prompts {lengths}, 80 new]: ring lanes = "
        f"paged kernel tokens {dense == paged}; "
        f"{time.perf_counter() - t0:.1f} s")
    if dense != paged:
        fail(f"dense exact [{arch}]: the ring lanes' tokens differ from the "
             f"paged engine's")
    del params
    torch.cuda.empty_cache()


def dense_serving_launches(cfg, eng) -> dict:
    """The launches a dense serve run must count: mha once an attention
    layer a decode step (a graph replay) and a prefill, the sampler's
    noise kernel once a step and a prefill, nothing else."""
    from repro_torch.models import transformer as tfm
    n = sum(k not in api.STATE_KINDS for k in tfm.layer_kinds(cfg))
    want = dict.fromkeys(ops.launch_counts(), 0)
    want.update({"mha": n * (eng.decode_steps + eng.prefills),
                 "sampler_noise": eng.decode_steps + eng.prefills})
    return want


def serve_dense(prompts) -> dict:
    """qwen2.5-3b at full width and depth, bf16: the serve phase's 16
    requests (32 new) on 8 slots through the dense engine and the paged
    kernel engine on the same weights, each warmed (its capture) and
    reset, timed in turns paged, dense, dense, paged. Logs tok/s, decode
    tok/s (decoded tokens over the decode steps' wall), TTFT and TPOT p50,
    peak memory, launches and captures of each dense run, and the
    ``kernel/dense`` ratios (paged over dense, means of the turns). Checks
    every request finished with its 32 tokens, one capture and the
    launches. Returns the launch counts of the first dense run (set to 0
    just before it, read just after)."""
    cfg = get_config("qwen2.5-3b")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = api.init_params(cfg, gen, device="cuda")
    kw = dict(slots=SLOTS, max_len=MAX_LEN, device="cuda")
    engines = {"dense": DenseServingEngine(cfg, params, **kw),
               "paged": PagedServingEngine(cfg, params, page_size=PAGE,
                                           **kw)}
    for eng in engines.values():
        eng.run_to_completion([Request(rid=-1, prompt=list(range(64)),
                                       max_new=2)])
    rows = {"dense": [], "paged": []}
    counts = None
    for kind in ("paged", "dense", "dense", "paged"):
        eng = engines[kind]
        eng.reset_metrics()
        reqs = tier_traffic(prompts, cfg.vocab)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        eng.run_to_completion(reqs, max_steps=20 * N_REQ * MAX_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run_counts = ops.launch_counts()
        m = eng.metrics()
        n_tok = sum(len(r.generated) for r in reqs)
        row = (n_tok / wall, eng.decoded_tokens / eng.step_wall_s,
               m["latency.ttft_p50_s"], m["latency.tpot_p50_s"])
        rows[kind].append(row)
        log(f"serve {kind} [qwen2.5-3b, 36 layers, bf16]: "
            f"{sum(r.done for r in reqs)}/{len(reqs)} requests, {n_tok} "
            f"tokens in {wall:.2f} s = {row[0]:.1f} tok/s, decode "
            f"{row[1]:.1f} tok/s, ttft p50 {row[2]:.4f} s, tpot p50 "
            f"{row[3]:.4f} s, {eng.decode_steps} decode steps, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, cache "
            f"{eng.shard_stats()['pool_bytes_per_shard'] / 2**30:.3f} GiB; "
            f"launches {run_counts}; captures {eng.step_traces}")
        if any(not r.done or len(r.generated) != MAX_NEW for r in reqs):
            fail(f"serve {kind}: not every request finished with max_new "
                 f"tokens")
        if kind == "dense":
            want = dense_serving_launches(cfg, eng)
            if run_counts != want:
                fail(f"serve dense: launches {run_counts} != {want}")
            if eng.step_traces != 1:
                fail(f"serve dense: {eng.step_traces} captures")
            counts = counts or run_counts
    mean = {k: np.mean(np.asarray(v), axis=0) for k, v in rows.items()}
    log(f"kernel/dense [qwen2.5-3b, serve traffic, means of 2 turns]: "
        f"tok/s {mean['paged'][0] / mean['dense'][0]:.4f}, decode tok/s "
        f"{mean['paged'][1] / mean['dense'][1]:.4f}, TTFT p50 dense/paged "
        f"{mean['dense'][2] / mean['paged'][2]:.4f}, TPOT p50 dense/paged "
        f"{mean['dense'][3] / mean['paged'][3]:.4f}; against phase 6's "
        f"paged run {PHASE6['tok_s']:.1f} tok/s: "
        f"{PHASE6['tok_s'] / mean['dense'][0]:.4f}")
    del engines, params
    torch.cuda.empty_cache()
    return counts


def check_seamless_fp32() -> None:
    """seamless-m4t at full width cut to 2 + 2 layers, fp32: the card's
    prefill (2 prompts of 64 tokens over 512 frames) and 4 greedy decode
    steps against the CPU plain path on the same weights: logits within
    F32_LOGIT_TOL of the largest, equal tokens."""
    cfg = dataclasses.replace(get_config(SEAMLESS), num_layers=2,
                              enc_layers=2, dtype="float32",
                              kv_cache_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 92)
    params = api.init_params(cfg, gen, device="cuda")
    toks = torch.randint(0, cfg.vocab, (2, 64), generator=gen, device="cuda")
    enc = torch.randn((2, 512, cfg.d_model), generator=gen, device="cuda")

    def cpu(tree):
        if isinstance(tree, dict):
            return {k: cpu(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [cpu(v) for v in tree]
        return tree.cpu()
    out = {}
    with bench.fp32_exact():
        for dev, p in (("cuda", params), ("cpu", cpu(params))):
            logits, cache, pos = api.prefill(cfg, p, toks.to(dev),
                                             enc_embeds=enc.to(dev),
                                             max_len=128)
            seq, ts = [logits.cpu()], []
            for _ in range(4):
                t = logits[:, : cfg.vocab].argmax(-1)[:, None]
                ts.append(t.cpu())
                logits, cache = api.decode_step(cfg, p, cache, t, pos)
                pos = pos + 1
                seq.append(logits.cpu())
            out[dev] = (torch.stack(seq), torch.cat(ts, 1))
    err = ((out["cuda"][0] - out["cpu"][0]).abs().max()
           / out["cpu"][0].abs().max()).item()
    same = torch.equal(out["cuda"][1], out["cpu"][1])
    log(f"seamless exact [fp32, full width, 2 + 2 layers, 2 x 64 tokens "
        f"over 512 frames, prefill + 4 decode steps]: card vs CPU plain "
        f"logits within {err:.3g} of the largest (limit {F32_LOGIT_TOL:g}), "
        f"tokens equal {same}")
    if not (err <= F32_LOGIT_TOL and same):
        fail("seamless: the card's logits disagree with the CPU plain path")
    del params
    torch.cuda.empty_cache()


def run_seamless() -> dict:
    """seamless-m4t-large-v2 whole (24 + 24 layers), bf16, seeded weights:
    ``api.prefill`` of 8 prompts of 128 tokens over 8 x 1024 seeded frame
    embeddings (the frames stub's ``enc_embeds``), then 32 greedy
    ``api.decode_step``s on its dense lanes, eagerly (a warm-up call of
    each first). Logs prefill ms, decode ms a step, peak memory and mha
    launches (counts set to 0 just before the timed prefill, read after
    the last step: 24 + 2 x 24 in the prefill, 2 x 24 a step); checks
    finite logits and tokens in the vocabulary. The same steps again as
    one captured graph on a fresh prefill: equal tokens, ms a replay.
    Then the factory picks the
    dense engine for it, and serving through that raises as the
    reference's does. Returns the launch counts."""
    from repro_torch.runtime.serving import ServingEngine
    cfg = get_config(SEAMLESS)
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 93)
    t0 = time.perf_counter()
    params = api.init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    log(f"seamless: {cfg.param_count() / 1e9:.3f}B params, "
        f"{cfg.enc_layers} + {cfg.num_layers} layers, bf16, weights drawn "
        f"on the card in {time.perf_counter() - t0:.1f} s")
    B, S, S_enc, steps = 8, 128, 1024, 32
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen, device="cuda")
    enc = torch.randn((B, S_enc, cfg.d_model), generator=gen,
                      device="cuda").to(torch.bfloat16)
    max_len = S + steps
    logits, cache, pos = api.prefill(cfg, params, toks, enc_embeds=enc,
                                     max_len=max_len)
    api.decode_step(cfg, params, cache, logits[:, : cfg.vocab].argmax(
        -1)[:, None], pos)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache, pos = api.prefill(cfg, params, toks, enc_embeds=enc,
                                     max_len=max_len)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    finite = bool(torch.isfinite(logits).all())
    n_prefill = ops.launch_counts()["mha"]
    step_ms, out = [], []
    for _ in range(steps):
        t = logits[:, : cfg.vocab].argmax(-1)[:, None]
        out.append(t)
        t0 = time.perf_counter()
        logits, cache = api.decode_step(cfg, params, cache, t, pos)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        pos = pos + 1
        finite = finite and bool(torch.isfinite(logits).all())
    counts = ops.launch_counts()
    toks_out = torch.cat(out, 1)
    log(f"seamless [whole, bf16, {B} x {S} tokens over {B} x {S_enc} "
        f"frames]: prefill {prefill_ms:.2f} ms, {steps} eager decode steps "
        f"median {np.median(step_ms):.2f} ms (min {min(step_ms):.2f}, max "
        f"{max(step_ms):.2f}), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, mha launches "
        f"{counts['mha']} ({n_prefill} in the prefill), logits finite "
        f"{finite}, {len(set(toks_out.flatten().tolist()))} distinct "
        f"tokens, first row's first {toks_out[0, :8].tolist()}")
    n_layers = cfg.enc_layers + 2 * cfg.num_layers
    if not finite or n_prefill != n_layers \
            or counts["mha"] != n_layers + 2 * cfg.num_layers * steps \
            or not bool(((toks_out >= 0) & (toks_out < cfg.vocab)).all()):
        fail("seamless: non-finite logits, wrong launches or tokens out of "
             "the vocabulary")
    # the same greedy steps as one captured graph over fixed token and
    # position buffers, on a fresh prefill: its tokens must be the eager
    # run's, and a replay's time is the step's device time
    logits, cache, pos = api.prefill(cfg, params, toks, enc_embeds=enc,
                                     max_len=max_len)
    tok = logits[:, : cfg.vocab].argmax(-1)[:, None]

    def body():
        lg, _ = api.decode_step(cfg, params, cache, tok, pos)
        tok.copy_(lg[:, : cfg.vocab].argmax(-1)[:, None])
        pos.add_(1)
    graph, held = capture_graph(torch.device("cuda"), body, [tok, pos])
    replayed = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        graph.replay()
        replayed.append(tok.clone())
    end.record()
    torch.cuda.synchronize()
    same = torch.equal(torch.cat(replayed[:-1], 1), toks_out[:, 1:])
    replay_ms = start.elapsed_time(end) / steps
    log(f"seamless decode step as one CUDA graph: {replay_ms:.3f} ms a "
        f"replay ({steps} replays), the graph holds {held}; its tokens "
        f"equal the eager steps' {same}")
    if not same or held.get("mha") != 2 * cfg.num_layers:
        fail("seamless: the decode graph's tokens or launches are wrong")
    eng = ServingEngine(cfg, params, slots=2, max_len=64, device="cuda")
    try:
        eng.submit(Request(rid=0, prompt=[1, 2, 3], max_new=2))
    except ValueError as e:
        raised = "enc_embeds" in str(e)
    else:
        raised = False
    log(f"seamless: the factory picks {type(eng).__name__}; serving through "
        f"it raises a ValueError naming enc_embeds: {raised} (the "
        f"reference's raises KeyError('enc_embeds'))")
    if not isinstance(eng, DenseServingEngine) or not raised:
        fail("seamless: the factory or the engine's refusal is wrong")
    del eng, params, cache, graph
    torch.cuda.empty_cache()
    return counts


def dense_kernel_entries(err, times, dense_counts, seamless_counts) -> list:
    """The JSON entries of mha on the dense and encoder-decoder path: the
    dense lanes' decode row at qwen2.5-3b's heads with the dense serve
    run's launches, and the seamless encoder with the seamless run's."""
    def entry(name, label, launches):
        ms, plain, bms, by, lib = times[label]
        return {"name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/mha.cu",
                "replaces": "src/repro/kernels/attention.py:32",
                "launches": launches, "max_abs_err": err, "ms": ms,
                "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                "library_ms": lib}
    return [
        entry("mha[Sq 1, device kv_valid, dense decode, qwen2.5-3b lanes]",
              "qwen2.5-3b dense decode, B8 Sq1, lane 1024, kv_valid 1..1024",
              dense_counts["mha"]),
        entry("mha[non-causal, seamless-m4t encoder, H16 KV16 D64]",
              "seamless encoder, B2 Sq=Sk=1024", seamless_counts["mha"])]


# ---------------------------------------------------------------------------
# phase 13: tensor-parallel paged serving and the replica router
# ---------------------------------------------------------------------------

# qwen2.5-3b at full width, fp32 with an fp32 KV cache (the sharded
# engine's exactness contract), cut to 4 of 36 layers as phase 7 cuts it;
# 8 of phase 6's prompts, 16 new tokens each
TP_LAYERS, TP_REQ, TP_NEW = 4, 8, 16
TP_HEADS = (H // 2, KV // 2, D)        # a rank's heads at 2 shards: H8 KV1


def tp_config():
    return dataclasses.replace(get_config("qwen2.5-3b"), num_layers=TP_LAYERS,
                               dtype="float32", kv_cache_dtype="float32")


def tp_params():
    return api.init_params(tp_config(), torch.Generator(device="cuda")
                           .manual_seed(SEED + 130), device="cuda")


def tp_engine(cfg, params, **kw):
    return PagedServingEngine(cfg, params, slots=SLOTS, max_len=MAX_LEN,
                              page_size=PAGE, device="cuda", **kw)


def tp_serve(driver, prompts) -> list:
    """``prompts`` through an engine or a router; their greedy tokens (None
    if a request did not finish)."""
    reqs = [Request(rid=i, prompt=p, max_new=TP_NEW)
            for i, p in enumerate(prompts)]
    done = driver.run_to_completion(reqs, max_steps=40 * len(reqs) * TP_NEW)
    return [r.generated for r in reqs] if len(done) == len(reqs) else None


def tp_timed(eng, prompts) -> dict:
    """A warm-up request (the decode graph's capture where there is one),
    ``reset_metrics``, then ``prompts`` with the launch counters zeroed:
    the tokens, launches (and the serve formula's), all-reduces issued,
    and the decode step's host-clock ms (the step wall over the decode
    steps, ``metrics()``) and tok/s."""
    eng.run_to_completion([Request(rid=-1, prompt=list(range(64)),
                                   max_new=2)])
    eng.reset_metrics()
    ops.reset_launch_counts()
    rules = eng._model_rules
    reduces = getattr(rules, "reduces", 0)
    t0 = time.perf_counter()
    toks = tp_serve(eng, prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m = eng.metrics()
    return {"tokens": toks, "counts": ops.launch_counts(),
            "want": serving_launches(eng.cfg, eng), "wall": wall,
            "tok_s": sum(map(len, toks or [])) / wall,
            "step_ms": m["util.step_wall_s"] / eng.decode_steps * 1e3,
            "steps": eng.decode_steps, "prefills": eng.prefills,
            "captures": m["sampling.step_traces"],
            "reduces": getattr(rules, "reduces", 0) - reduces}


def tp_rank(rank: int, prompts) -> dict:
    """One rank of a phase-13 world (spawned; every rank on cuda:0): the
    engine on this rank's part of a mesh as wide as the world, serving
    ``prompts`` after a warm-up (``tp_timed``). Returns what the parent
    checks: ``tp_timed``'s, and the rank's shard stats, plan and pool and
    query heads."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    torch.cuda.set_device(0)
    world = dist.get_world_size()
    cfg = tp_config()
    mesh = make_host_mesh(world, devices=["cuda:0"] * world)
    eng = tp_engine(cfg, tp_params(), mesh=mesh)
    torch.cuda.empty_cache()
    return dict(tp_timed(eng, prompts), shard=eng.shard_stats(),
                contract=sorted(eng._model_rules.contract_axes),
                backend=mesh.backend,
                pool_heads=int(eng.cache[0]["k"].shape[2]),
                q_heads=int(eng.params["blocks"][0]["attn"]["wq"].shape[1]))


def force_contract(eng, rules):
    """The engine's plan with ``rules`` in place of its own (before its
    first step, so every graph it captures records their sums)."""
    eng.tp = dataclasses.replace(eng.tp, rules=rules)
    eng._model_rules = rules
    return eng


def forced_rank(rank: int, prompts) -> dict:
    """The spawned world of 1 over NCCL of Queue 3 check 1 (cuda:0): the
    serving ``ManualRules`` contracts "heads" and "ffn" anyway over the
    world (a sum over one rank is a copy), so the decode, verify and
    select graphs are captured with NCCL all-reduces inside, after the
    eager one that creates the communicator. qwen2.5-3b as the rest of
    phase 13 (4 layers, fp32): greedy tokens plain-captured and spec_k 4;
    8 decode replays and 8 verify replays against their uncaptured bodies
    bit for bit. recurrentgemma-9b at 6 layers, window 64, fp32: spec_k 4
    greedy tokens against its plain engine's (the select graph). Returns
    what the parent checks."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.sharding import ManualRules
    torch.cuda.set_device(0)
    mesh = make_host_mesh(1, devices=["cuda:0"])
    rules = ManualRules(("heads", "ffn"), dist.group.WORLD)
    out = {"backend": dist.get_backend(dist.group.WORLD)}

    def mk(cls, cfg, params, **kw):
        return force_contract(cls(cfg, params, mesh=mesh, device="cuda",
                                  **kw), rules)

    cfg, params = tp_config(), tp_params()
    kw = dict(slots=SLOTS, max_len=MAX_LEN, page_size=PAGE)
    eng = mk(PagedServingEngine, cfg, params, **kw)
    out["eager"] = eng._eager()
    r0 = rules.reduces
    out["tokens"] = tp_serve(eng, prompts)
    out["captures"] = (eng.step_traces, eng.spec_traces)
    out["recorded"] = rules.reduces - r0
    del eng
    spec = mk(PagedServingEngine, cfg, params, spec_k=4, **kw)
    out["spec_tokens"] = tp_serve(spec, prompts)
    out["spec_captures"] = (spec.step_traces, spec.spec_traces)
    del spec
    # 8 decode replays and 8 verify replays against their bodies
    same = {"decode": True, "verify": True}
    for name, (a_cls, extra) in {
            "decode": (UncapturedEngine, {}),
            "verify": (UncapturedSpecEngine, {"spec_k": 4})}.items():
        engs = [mk(a_cls, cfg, params, **kw, **extra),
                mk(PagedServingEngine, cfg, params, **kw, **extra)]
        for e in engs:
            for i, pr in enumerate(prompts[:SLOTS]):
                e.submit(Request(rid=i, prompt=pr, max_new=40))
        for _ in range(8):
            for e in engs:
                e.step()
            a, b = ((engs[0].last_logits, engs[1].last_logits)
                    if name == "decode" else
                    (engs[0]._spec_out, engs[1]._spec_out))
            same[name] = same[name] and torch.equal(a, b)
        same[name + "_captures"] = (engs[1].step_traces,
                                    engs[1].spec_traces)
        del engs
    out["replays_equal"] = same
    del params
    torch.cuda.empty_cache()
    # the select graph: a hybrid stack with spec_k
    rg = dataclasses.replace(get_config("recurrentgemma-9b"), num_layers=6,
                             dtype="float32", kv_cache_dtype="float32")
    rg = dataclasses.replace(rg, hybrid=dataclasses.replace(rg.hybrid,
                                                            window=64))
    rp = api.init_params(rg, torch.Generator(device="cuda")
                         .manual_seed(SEED + 131), device="cuda")
    own = np.random.default_rng(SEED + 131)
    rprompts = [[int(t) for t in own.integers(0, rg.vocab, int(n))]
                for n in (80, 150, 97, 130)]

    def serve_rg(eng):
        reqs = [Request(rid=i, prompt=pr, max_new=24)
                for i, pr in enumerate(rprompts)]
        done = eng.run_to_completion(reqs, max_steps=2000)
        return [r.generated for r in reqs] if len(done) == len(reqs) \
            else None

    rkw = dict(slots=4, max_len=512, page_size=PAGE)
    out["rg_plain"] = serve_rg(PagedServingEngine(rg, rp, device="cuda",
                                                  **rkw))
    eng = mk(PagedServingEngine, rg, rp, spec_k=4, **rkw)
    r0 = rules.reduces
    out["rg_spec"] = serve_rg(eng)
    out["rg_captures"] = (eng.step_traces, eng.spec_traces,
                          eng.select_traces)
    out["rg_recorded"] = rules.reduces - r0
    return out


def check_forced_nccl(prompts, want) -> None:
    """Queue 3 check 1 (``forced_rank``): tokens equal the plain engine's
    (``want``), one capture a graph, all-reduces recorded in them, replays
    equal their bodies."""
    import tempfile

    from repro_torch.launch.mesh import run_world
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        res = run_world(forced_rank, 1, backend="nccl",
                        init_file=os.path.join(tmp, "rdv"),
                        args=(prompts,), timeout=600)[0]
    rep = res["replays_equal"]
    log(f"tp: a world of 1 over NCCL ({res['backend']}) contracting heads "
        f"and ffn anyway: {time.perf_counter() - t0:.1f} s with spawning; "
        f"greedy tokens equal the plain engine's {res['tokens'] == want}, "
        f"spec_k 4 {res['spec_tokens'] == want}; captures (step, verify) "
        f"{res['captures']} / {res['spec_captures']}, all-reduces recorded "
        f"or run {res['recorded']}; 8 decode replays equal the uncaptured "
        f"body {rep['decode']}, 8 verify replays {rep['verify']}; "
        f"recurrentgemma 6 layers spec_k 4 tokens equal plain "
        f"{res['rg_spec'] == res['rg_plain']}, captures (step, verify, "
        f"select) {res['rg_captures']}, all-reduces {res['rg_recorded']}")
    if res["tokens"] != want or res["spec_tokens"] != want:
        fail("tp: the forced-contract NCCL engine's tokens differ from the "
             "plain engine's")
    if res["eager"] or res["captures"] != (1, 0) \
            or res["spec_captures"] != (0, 1) \
            or res["rg_captures"] != (0, 1, 1) or not res["recorded"] \
            or not res["rg_recorded"]:
        fail(f"tp: forced-contract captures or all-reduces: {res}")
    if not (rep["decode"] and rep["verify"]) \
            or res["rg_plain"] is None or res["rg_spec"] != res["rg_plain"]:
        fail(f"tp: forced-contract replays or recurrentgemma tokens: {res}")


def check_tp_kernels(rng, lengths):
    """Paged flash-decode and mha at a rank's heads at 2 shards (H8 KV1
    D128, G 8), fp32 (the phase's path) and bf16, against their plain
    versions: the decode step's batch at these contexts, and a prefill
    bucket of 512 (causal, and a 300-token prompt's kv_valid). Returns
    (paged error, mha error)."""
    Hq, KVh, Dh = TP_HEADS
    err_paged = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        args = paged_case(rng, len(lengths), 1, Hq, KVh, Dh, PAGE, lengths,
                          MAX_LEN // PAGE, dtype)
        got = paged_kernel.paged_attention(*args)
        torch.cuda.synchronize()
        err_paged = max(err_paged, agrees(
            f"paged_attention [tp2 shard heads H{Hq} KV{KVh} D{Dh}, B="
            f"{len(lengths)}, {str(dtype)[6:]}]", got,
            ref.paged_attention_ref(*args)))
    cases = [(f"tp2 shard heads, prefill bucket 512, {name}"
              f"{'' if causal else ', kv_valid 300'}", 1, 512, 512, causal,
              valid, dt)
             for dt, name in ((torch.float32, "fp32"),
                              (torch.bfloat16, "bf16"))
             for causal, valid in ((True, None), (False, [300]))]
    return err_paged, check_mha(rng, cases, heads=TP_HEADS)


def serve_tp(prompts) -> dict:
    """The sharded engine at full width: the plain engine's tokens, then
    ``make_replicas(replicas=1)`` (no world), a world of 1 over NCCL
    (``mesh=``, the decode graph captured, nothing to contract), and two
    ranks sharing cuda:0 over gloo (KV 1 and H 8 a rank, the bodies
    uncaptured, an all-reduce at each out- and down-projection): each must
    emit the plain engine's greedy tokens, every rank alike. Returns a
    rank's kernel launches in the two-rank run."""
    import tempfile

    from repro_torch.launch.mesh import run_world
    from repro_torch.runtime.router import make_replicas
    cfg = tp_config()
    params = tp_params()
    plain = tp_engine(cfg, params)
    base = tp_timed(plain, prompts)
    want = base["tokens"]
    if want is None:
        fail("tp: the plain engine did not finish its requests")
    full_bytes = plain.shard_stats()["pool_bytes_per_shard"]
    del plain
    router = make_replicas(cfg, params, replicas=1, devices=["cuda:0"],
                           slots=SLOTS, max_len=MAX_LEN, page_size=PAGE)
    if tp_serve(router, prompts) != want:
        fail("tp: make_replicas(replicas=1) emits other tokens")
    if router.stats()["routed"] != [len(prompts)]:
        fail(f"tp: routed {router.stats()['routed']}")
    del router, params
    torch.cuda.empty_cache()
    log(f"tp: plain engine and make_replicas(replicas=1): equal greedy "
        f"tokens ({len(prompts)} requests x {TP_NEW}, qwen2.5-3b full "
        f"width, {TP_LAYERS} layers, fp32); the plain engine's decode step "
        f"{base['step_ms']:.3f} ms (host clock, graph replay + its one "
        f"copy), {base['tok_s']:.1f} tok/s")
    runs = {}
    for world, backend in ((1, "nccl"), (2, "gloo")):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            runs[world] = run_world(tp_rank, world, backend=backend,
                                    init_file=os.path.join(tmp, "rdv"),
                                    args=(prompts,), timeout=600)
        for r, res in enumerate(runs[world]):
            if res["tokens"] != want:
                fail(f"tp: world of {world} ({backend}), rank {r}: greedy "
                     f"tokens differ from the plain engine's")
            if res["counts"] != res["want"]:
                fail(f"tp: world of {world}, rank {r}: launches "
                     f"{res['counts']} != {res['want']}")
        first = runs[world][0]
        log(f"tp: world of {world} over {backend}: "
            f"{time.perf_counter() - t0:.1f} s with spawning; rank 0 served "
            f"in {first['wall']:.2f} s ({first['tok_s']:.1f} tok/s, decode "
            f"step {first['step_ms']:.3f} ms against the plain engine's "
            f"{base['step_ms']:.3f}), {first['steps']} decode steps, "
            f"{first['prefills']} prefills; launches a rank "
            f"{first['counts']}; shard {first['shard']}; "
            f"{first['reduces']} all-reduces over {first['contract']}, "
            f"{first['captures']:.0f} decode graph capture(s); equal "
            f"tokens on every rank")
    check_forced_nccl(prompts, want)
    one, two = runs[1][0], runs[2]
    if one["captures"] != 1.0 or one["reduces"] != 0 or one["contract"]:
        fail(f"tp: the world of 1 must capture its decode graph and launch "
             f"no collective: {one['captures']} captures, {one['reduces']} "
             f"all-reduces")
    for res in two:
        n_sums = 2 * TP_LAYERS * (res["steps"] + res["prefills"])
        if (res["backend"] != "gloo" or res["captures"] != 0.0
                or res["reduces"] != n_sums
                or res["contract"] != ["ffn", "heads"]
                or (res["pool_heads"], res["q_heads"]) != (KV // 2, H // 2)
                or 2 * res["shard"]["pool_bytes_per_shard"] != full_bytes
                or res["shard"]["model_shards"] != 2.0):
            fail(f"tp: a gloo rank ran another plan: {res}")
    log(f"tp: 2 ranks on one card over gloo: KV {two[0]['pool_heads']} and "
        f"H {two[0]['q_heads']} a rank, pool bytes a rank "
        f"{two[0]['shard']['pool_bytes_per_shard']:.0f} of "
        f"{full_bytes:.0f}; a correctness run, not a TP time (both ranks "
        f"share one card, their sums cross the host)")
    return two[0]["counts"]


def tp_kernel_entries(errs, times, counts) -> list:
    """The JSON entries of paged flash-decode and mha at a rank's heads in
    the two-rank run, with that run's launches (one rank's)."""
    (err_paged, err_mha), (paged_t, mha_t) = errs, times
    return [
        {"name": "paged_attention[tp2 on one card, KV 1 per shard]",
         "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:78",
         "launches": counts["paged_attention"], "max_abs_err": err_paged,
         "ms": paged_t[0], "plain_ms": paged_t[1], "bound_ms": paged_t[2],
         "bound_by": paged_t[3], "library_ms": None},
        {"name": "mha[tp2 prefill, H 8 KV 1]", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/mha.cu",
         "replaces": "src/repro/kernels/attention.py:32",
         "launches": counts["mha"], "max_abs_err": err_mha, "ms": mha_t[0],
         "plain_ms": mha_t[1], "bound_ms": mha_t[2], "bound_by": mha_t[3],
         "library_ms": mha_t[4]}]


# ---------------------------------------------------------------------------
# phase 14: single-device training
# ---------------------------------------------------------------------------

TRAIN_EXACT_ARCHS = ("qwen2.5-3b", "dbrx-132b", "recurrentgemma-9b")
TRAIN_B, TRAIN_S, TRAIN_TIMED = 8, 1024, 5    # the full-width step
SERVE_B, SERVE_S = 4, 512                     # the train -> serve check
BF16_PEAK = 989e12


def on(device, tree):
    return pytree.tree_map(lambda t: t.to(device), tree)


def batch_on(device, b):
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def launch_opt(steps, cfg):
    """The reference launcher's optimizer for a run of ``steps`` steps."""
    return adamw.AdamWConfig(lr=3e-3, warmup_steps=max(5, steps // 10),
                             total_steps=steps,
                             moment_dtype=cfg.moment_dtype)


def wrappers_refuse_grad() -> None:
    """mha, paged flash-decode and the sampler on CUDA tensors: a
    grad-requiring input under grad mode raises before the launch (the
    sampler's inputs are integers, which cannot require grad: a float
    stand-in shows the order of its checks)."""
    z = torch.zeros
    x = z(1, 4, 2, 16, device="cuda", requires_grad=True)
    i64 = z(1, dtype=torch.int64, device="cuda")
    calls = {
        "mha": lambda: mha_kernel.mha(x, z(1, 4, 2, 16, device="cuda"),
                                      z(1, 4, 2, 16, device="cuda")),
        "paged_attention": lambda: paged_kernel.paged_attention(
            x, z(2, 4, 2, 16, device="cuda"), z(2, 4, 2, 16, device="cuda"),
            z(1, 1, dtype=torch.int32, device="cuda"), [4]),
        "sampler": lambda: sampler_kernel.sampler_noise(
            x.reshape(-1)[:1], i64, i64, 8, draw=0),
    }
    before = ops.launch_counts()
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            if "has no backward" not in str(e):
                fail(f"{name} wrapper: {e}")
            continue
        fail(f"{name} wrapper took a grad-requiring input under grad mode")
    if ops.launch_counts() != before:
        fail("a wrapper launched its kernel on a grad-requiring input")
    log("train: the mha, paged and sampler wrappers refuse a grad-requiring "
        "input under grad mode")


def check_train_exact() -> None:
    """Phase 14 (a): each SMOKE config at fp32 from one state on the CPU
    and on the card. Step 1's loss and aux losses within rtol 1e-4, every
    gradient leaf present, finite, non-zero wherever the CPU's is, and
    within 1e-3 of the leaf's largest CPU value (fp32 summed in other
    orders); then 3 ``make_train_step`` steps, losses within rtol 1e-4."""
    for arch in TRAIN_EXACT_ARCHS:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        opt = launch_opt(30, cfg)
        gen = torch.Generator().manual_seed(SEED + 140)
        states = {"cpu": trainer.init_state(cfg, opt, gen, device="cpu")}
        states["cuda"] = on("cuda", states["cpu"])
        ds = SyntheticDataset(DataConfig(vocab=cfg.vocab, seq_len=64,
                                         global_batch=4, seed=SEED + 140))
        batches = [ds.next_batch() for _ in range(3)]
        ops.reset_launch_counts()
        got = {dev: trainer.loss_and_grads(cfg, st["params"],
                                           batch_on(dev, batches[0]))
               for dev, st in states.items()}
        (lc, ac, gc), (lg, ag, gg) = got["cpu"], got["cuda"]
        for name, a, b in [("loss", lg, lc)] + [(k, ag[k], ac[k])
                                                for k in ac]:
            if not abs(a.item() - b.item()) <= 1e-4 * abs(b.item()) + 1e-7:
                fail(f"train {arch}: step 1 {name} {a.item()} on the card, "
                     f"{b.item()} on the CPU")
        worst = 0.0
        for (path, g), c in zip(pytree.tree_flatten_with_path(gg)[0],
                                pytree.tree_leaves(gc)):
            key = pytree.keystr(path)
            g = g.cpu()
            if not torch.isfinite(g).all():
                fail(f"train {arch}: gradient {key} not finite on the card")
            if ((c != 0) & (g == 0)).any():
                fail(f"train {arch}: gradient {key} is zero on the card "
                     f"where the CPU's is not")
            err = ((g - c).abs().max() / c.abs().max().clamp(min=1e-30))
            worst = max(worst, err.item())
        if worst > 1e-3:
            fail(f"train {arch}: a gradient leaf on the card is "
                 f"{worst:.3g} of its scale from the CPU's")
        step = trainer.make_train_step(cfg, opt)
        losses = {"cpu": [], "cuda": []}
        for b in batches:
            for dev in states:
                states[dev], m = step(states[dev], batch_on(dev, b))
                losses[dev].append(m["loss"].item())
        for a, b in zip(losses["cuda"], losses["cpu"]):
            if not abs(a - b) <= 1e-4 * abs(b):
                fail(f"train {arch}: losses {losses['cuda']} on the card, "
                     f"{losses['cpu']} on the CPU")
        if any(ops.launch_counts().values()):
            fail(f"train {arch}: the training step launched a kernel: "
                 f"{ops.launch_counts()}")
        aux = ", ".join(f"{k} {ag[k].item():.6f} / {ac[k].item():.6f}"
                        for k in ("lb_loss", "z_loss")) \
            if cfg.moe is not None else "no MoE"
        log(f"train exact [{arch} SMOKE fp32]: step 1 loss "
            f"{lg.item():.7f} card / {lc.item():.7f} CPU ({aux}); "
            f"{len(pytree.tree_leaves(gg))} gradient leaves, worst "
            f"{worst:.3g} of their scale; 3 steps' losses card "
            f"{[round(x, 6) for x in losses['cuda']]}, CPU "
            f"{[round(x, 6) for x in losses['cpu']]}")


def train_full_width():
    """Phase 14 (b): qwen2.5-3b whole (36 layers, d 2048, 16 query heads
    over 2 KV heads, d_ff 11008, vocab 151936, untied), bf16 params, fp32
    moments, remat "full"; batches of 8 x 1024 from the synthetic stream.
    One warm-up step, 5 timed (host clock around a synchronised step),
    then 2 more split by CUDA events into ``loss_and_grads`` and
    ``adamw.apply``, and one profiled (``profile_train_step``). No kernel
    may launch. Returns the profiled step's busy ms (None unmeasured)."""
    cfg = get_config("qwen2.5-3b")
    if cfg.remat != "full" or cfg.dtype != "bfloat16" \
            or cfg.moment_dtype != "float32":
        fail(f"train: qwen2.5-3b is {cfg.remat} / {cfg.dtype} / "
             f"{cfg.moment_dtype}, not full / bfloat16 / float32")
    steps = 1 + TRAIN_TIMED
    opt = launch_opt(steps, cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()     # what earlier phases still hold
    gen = torch.Generator(device="cuda").manual_seed(SEED + 141)
    state = trainer.init_state(cfg, opt, gen, device="cuda")
    static = sum(t.nbytes for t in pytree.tree_leaves(state))
    ds = SyntheticDataset(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S,
                                     global_batch=TRAIN_B, seed=SEED + 141))
    step = trainer.make_train_step(cfg, opt)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, m = step(state, batch_on("cuda", ds.next_batch()))
    losses = [m["loss"].item()]
    warm = time.perf_counter() - t0
    times = []
    for _ in range(TRAIN_TIMED):
        b = batch_on("cuda", ds.next_batch())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(m["loss"].item())
    peak = torch.cuda.max_memory_allocated() - held
    fb, upd = [], []
    for _ in range(2):
        b = batch_on("cuda", ds.next_batch())
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        ev[0].record()
        _, _, grads = trainer.loss_and_grads(cfg, state["params"], b)
        ev[1].record()
        adamw.apply(opt, grads, state["opt"], state["params"])
        ev[2].record()
        torch.cuda.synchronize()
        fb.append(ev[0].elapsed_time(ev[1]))
        upd.append(ev[1].elapsed_time(ev[2]))
        del grads
    counts = ops.launch_counts()
    if any(counts.values()):
        fail(f"train: the training step launched a kernel: {counts}")
    if not all(np.isfinite(losses)):
        fail(f"train: losses not finite: {losses}")
    busy = profile_train_step(step, state, batch_on("cuda", ds.next_batch()))
    ms = 1e3 * float(np.mean(times))
    tokens = TRAIN_B * TRAIN_S
    flops = 6 * cfg.param_count() * tokens
    PHASE14.update(ms=[1e3 * t for t in times], peak=peak, static=static,
                   flops=flops, busy=busy)
    log(f"train full width [qwen2.5-3b, {cfg.num_layers} layers, d "
        f"{cfg.d_model}, bf16 params, fp32 moments, remat full, {TRAIN_B} x "
        f"{TRAIN_S} tokens]: warm-up step "
        f"{warm:.3f} s; {ms:.1f} ms a step over {TRAIN_TIMED} steps (each "
        f"{', '.join(f'{1e3 * t:.1f}' for t in times)}); forward + backward "
        f"{np.mean(fb):.1f} ms, optimizer {np.mean(upd):.1f} ms (CUDA "
        f"events, 2 more steps); {tokens / (ms / 1e3):.0f} tokens/s; model "
        f"FLOP/s (6 x {cfg.param_count()} x tokens, recompute not counted) "
        f"{flops / (ms / 1e3) / 1e12:.1f} TFLOP/s = "
        f"{flops / (ms / 1e3) / BF16_PEAK:.1%} of the 989 TFLOP/s bf16 "
        f"peak; memory: params + moments {static / 2**30:.2f} GiB, peak "
        f"{peak / 2**30:.2f} GiB (above the {held / 2**30:.2f} GiB held "
        f"before); losses {[round(x, 4) for x in losses]}")
    del state
    torch.cuda.empty_cache()
    return busy


def profile_train_step(step, state, b):
    """One more full-width step under torch.profiler: the card's busy
    share of the step's wall, the matmul kernels' share (names with
    "gemm", "xmma" or "cutlass") and the top kernels by device time.
    Returns the busy ms (None without device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, b)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(t for t, _, _ in rows)
    if busy <= 0:
        log("train profile: no device time in the trace (not measured)")
        return None
    mm = sum(t for t, _, k in rows
             if any(w in k.lower() for w in ("gemm", "xmma", "cutlass")))
    log(f"train profile: one step, wall {wall_us / 1e3:.1f} ms under the "
        f"profiler, device busy {busy / 1e3:.1f} ms ({busy / wall_us:.1%}; "
        f"idle {1 - busy / wall_us:.1%}); matmul kernels {mm / 1e3:.1f} ms "
        f"({mm / busy:.1%} of busy), {sum(c for _, c, _ in rows)} kernel "
        f"launches")
    for t, c, key in sorted(rows, reverse=True)[:10]:
        log(f"train profile:   {t / 1e3:8.2f} ms {t / busy:6.1%} x{c:<6d} "
            f"{key[:80]}")
    return busy / 1e3


def check_train_serve(rng) -> dict:
    """Phase 14 (c): qwen2.5-3b full width, 4 of 36 layers, fp32; 2 train
    steps on the card (batches of 4 x 512), then, under no_grad, the last
    logits of ``api.prefill`` (the mha kernel, one launch a layer) against
    ``api.forward``'s (the plain ``flash_attention``) on 4 prompts of 512
    tokens, within 1e-4 of the logit scale. Returns the prefill's launch
    counts."""
    cfg = dataclasses.replace(get_config("qwen2.5-3b"), num_layers=4,
                              dtype="float32")
    opt = launch_opt(30, cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 142)
    state = trainer.init_state(cfg, opt, gen, device="cuda")
    ds = SyntheticDataset(DataConfig(vocab=cfg.vocab, seq_len=SERVE_S,
                                     global_batch=SERVE_B, seed=SEED + 142))
    step = trainer.make_train_step(cfg, opt)
    losses = []
    for _ in range(2):
        state, m = step(state, batch_on("cuda", ds.next_batch()))
        losses.append(m["loss"].item())
    prompts = torch.tensor(rng.integers(0, cfg.vocab, (SERVE_B, SERVE_S)),
                           device="cuda")
    with torch.no_grad():
        ops.reset_launch_counts()
        got, _, _ = api.prefill(cfg, state["params"], prompts)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        logits, _ = api.forward(cfg, state["params"], {"tokens": prompts})
        want = logits[:, -1]
    err = ((got - want).abs().max() / want.abs().max()).item()
    log(f"train -> serve [qwen2.5-3b full width, 4 layers, fp32]: losses "
        f"{[round(x, 5) for x in losses]}; prefill (mha kernel, "
        f"{counts['mha']} launches) against forward (plain attention), "
        f"{SERVE_B} x {SERVE_S}: max err {err:.3g} of the logit scale "
        f"(limit 1e-4)")
    if counts["mha"] != cfg.num_layers:
        fail(f"train -> serve: prefill launched mha {counts['mha']} times, "
             f"not once a layer")
    if not err <= 1e-4 or not torch.isfinite(got).all():
        fail("train -> serve: prefill logits disagree with forward's")
    return counts


# ---------------------------------------------------------------------------
# phase 15: model-parallel training
# ---------------------------------------------------------------------------

PAIR_LAYERS, PAIR_B, PAIR_S = 2, 4, 256       # phase 15 (b)'s steps
QUAD_QWEN_STEPS = 2
QUAD_DBRX_LAYERS, QUAD_DBRX_STEPS = 1, 2       # phase 15 (b)'s dbrx-132b
# phase 15 (a)'s recurrent stacks at full width (arch, layers), bf16, and
# their batch; phase 15 (b)'s cases at (data 1, model 4), fp32
MIXER_CASES = (("recurrentgemma-9b", 3), ("mamba2-2.7b", 4))
MIXER_B, MIXER_S, MIXER_STEPS = 4, 1024, 2
QUAD4_CASES = (("qwen2.5-3b", 2), ("recurrentgemma-9b", 3),
               ("mamba2-2.7b", 2))


def leaf_items(tree):
    return [(pytree.keystr(p), t) for p, t in
            pytree.tree_flatten_with_path(tree)[0]]


def timed_steps(step, state, batches) -> tuple:
    """Each batch through ``step``: (losses, ms of each step after the
    first, host clock around a synchronised step)."""
    losses, times = [], []
    for i, b in enumerate(batches):
        b = batch_on("cuda", b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        if i:
            times.append(1e3 * (time.perf_counter() - t0))
        losses.append(m["loss"].item())
    return losses, times


def profiled_step(step, state, b) -> dict:
    """One step under torch.profiler (device activity only, which keeps
    the trace's processing short): its loss, wall ms, the card's busy
    ms, the NCCL kernels' ms and the kernel launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, m = step(state, b)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return {"loss": m["loss"].item(), "wall": wall,
            "busy": sum(t for t, _, _ in rows) / 1e3,
            "nccl": sum(t for t, _, k in rows if "nccl" in k.lower()) / 1e3,
            "launches": sum(c for _, c, _ in rows)}


def forced_layout_rules(cfg, group):
    """``TrainRules`` over ``group`` (a world of one rank) that issue every
    hook of the training layout anyway: the gathers of a (data 2, model
    4) plan (every ``wembed`` dim over ``data``; qwen2.5-3b's 16 query
    heads over ``model``, its 2 KV heads not), their backward
    reduce-scatters and parts, the heads, ffn, vocab, experts and
    recurrent mixers' contractions (RG-LRU's gate reduce-scatter, mamba2's
    ``in_proj`` gather and norm sum), and the KV heads read in part (their
    slice and their leaves' gradient sum), each a collective over one rank
    (a copy). The same function as ``tests/torch_layout_ranks.py``'s
    ``forced_rules``."""
    import warnings

    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel import tp
    from repro_torch.parallel.sharding import TrainRules
    desc = Mesh(tuple((torch.device("meta"),) * 4 for _ in range(2)),
                {"data": 2, "model": 4})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        uses = tp.train_plan(cfg, desc).rules.uses
    return TrainRules(("heads", "ffn", "vocab", "experts", "rglru", "ssm"),
                      group, data_group=group, uses=uses, whole_kv=True)


def collectives_a_step(rules, c0, steps) -> dict:
    """The collectives ``rules`` issued since the snapshot ``c0``, by
    "kind:axis", per step."""
    return {f"{k[0]}:{k[1]}": (n - c0.get(k, 0)) / steps
            for k, n in sorted(rules.collectives.items())}


def train_world1_rank(rank: int) -> dict:
    """Phase 15 (a), a spawned world of 1 over NCCL on cuda:0: qwen2.5-3b
    whole (bf16, remat full, 8 x 1024 tokens a step), one warm-up step,
    two timed ones and one profiled, first on one device
    (``make_train_step``), then from the same seed with rules that issue
    every hook of the training layout anyway (``forced_layout_rules``:
    FSDP gathers, model gathers, the heads, ffn, vocab and experts sums,
    over a world of one rank: copies). The two states do not fit
    together, so the plain run's parameters are kept as host copies and
    compared leaf by leaf."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import tp
    torch.cuda.set_device(0)
    cfg = get_config("qwen2.5-3b")
    opt = launch_opt(3, cfg)
    ds = SyntheticDataset(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S,
                                     global_batch=TRAIN_B, seed=SEED + 150))
    batches = [ds.next_batch() for _ in range(4)]    # the 4th profiled
    out = {"backend": dist.get_backend()}
    ops.reset_launch_counts()

    def run(plan):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 150)
        state = trainer.init_state(cfg, opt, gen, device="cuda", plan=plan)
        rules = plan.rules if plan is not None else NO_RULES
        step = trainer.make_train_step(cfg, opt, rules=rules)
        r0 = getattr(rules, "reduces", 0)
        c0 = dict(getattr(rules, "collectives", {}))
        torch.cuda.reset_peak_memory_stats()
        losses, times = timed_steps(step, state, batches[:3])
        reduces = getattr(rules, "reduces", 0) - r0
        if plan is not None:
            out["collectives"] = collectives_a_step(rules, c0, 3)
        peak = torch.cuda.max_memory_allocated()
        if plan is None:
            state, m = step(state, batch_on("cuda", batches[3]))
            losses.append(m["loss"].item())
            prof = None
        else:
            prof = profiled_step(step, state, batch_on("cuda", batches[3]))
            losses.append(prof.pop("loss"))
        return state, losses, times, reduces, peak, prof

    state, out["plain_losses"], out["plain_ms"], _, _, _ = run(None)
    host = [(k, t.cpu()) for k, t in leaf_items(state["params"])]
    del state
    torch.cuda.empty_cache()
    # a mesh of 1 contracts nothing: the plan's rules sum anyway, over the
    # world (a sum over one rank is a copy)
    plan = tp.train_plan(cfg, make_host_mesh(1, devices=["cuda:0"]))
    plan = dataclasses.replace(plan, rules=forced_layout_rules(
        cfg, dist.group.WORLD))
    (state, out["mp_losses"], out["mp_ms"], out["reduces"],
     out["peak"], out["mp_prof"]) = run(plan)
    out["contract"] = sorted(plan.rules.contract_axes)
    diff = []
    for (k, a), (k2, b) in zip(host, leaf_items(state["params"])):
        if k != k2 or not torch.equal(a, b.cpu()):
            diff.append((k, (a.float() - b.cpu().float()).abs().max()
                         .item()))
    out["leaves"], out["diff"] = len(host), diff
    out["launches"] = ops.launch_counts()
    del state, host
    torch.cuda.empty_cache()
    # the sums alone: 180 of the step's (8, 1024, 2048) bf16 sums back to
    # back, beside 180 clones, host clock over the loop and CUDA events
    x = torch.randn(TRAIN_B, TRAIN_S, cfg.d_model, device="cuda",
                    dtype=torch.bfloat16)
    for name, fn in (("clone", lambda: x.clone()),
                     ("sum", lambda: plan.rules.contract(x, "heads"))):
        fn()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        for _ in range(180):
            fn()
        ev[1].record()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        out[name + "_alone"] = (1e3 * host_s / 180,
                                ev[0].elapsed_time(ev[1]) / 180)
    del x
    torch.cuda.empty_cache()
    out["mixers"] = {arch: forced_mixer_steps(arch, layers, dist.group.WORLD)
                     for arch, layers in MIXER_CASES}
    return out


def forced_mixer_steps(arch: str, layers: int, group) -> dict:
    """Phase 15 (a)'s recurrent stacks: ``arch`` at full width cut to
    ``layers`` layers, bf16, ``MIXER_STEPS`` steps of ``MIXER_B`` x
    ``MIXER_S`` tokens plain and then, from the same seed, through
    ``forced_layout_rules`` over ``group`` (a world of one rank): their
    losses, ms a step, the forced run's sums and collectives a step, and
    the parameter leaves that differ (the plain run's kept on the host)."""
    from repro_torch.models import transformer as tfm
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    opt = launch_opt(3, cfg)
    ds = SyntheticDataset(DataConfig(vocab=cfg.vocab, seq_len=MIXER_S,
                                     global_batch=MIXER_B, seed=SEED + 156))
    batches = [ds.next_batch() for _ in range(MIXER_STEPS)]
    out, host = {"kinds": tfm.layer_kinds(cfg)}, None
    for name, rules in (("plain", NO_RULES),
                        ("forced", forced_layout_rules(cfg, group))):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 156)
        state = trainer.init_state(cfg, opt, gen, device="cuda")
        step = trainer.make_train_step(cfg, opt, rules=rules)
        r0 = getattr(rules, "reduces", 0)
        c0 = dict(getattr(rules, "collectives", {}))
        out[name + "_losses"], out[name + "_ms"] = timed_steps(
            step, state, batches)
        if host is None:
            host = [(k, t.cpu()) for k, t in leaf_items(state["params"])]
        else:
            out["reduces"] = (rules.reduces - r0) / MIXER_STEPS
            out["collectives"] = collectives_a_step(rules, c0, MIXER_STEPS)
            out["diff"] = [k for (k, a), (k2, b) in zip(
                host, leaf_items(state["params"]))
                if k != k2 or not torch.equal(a, b.cpu())]
            out["leaves"] = len(host)
        del state, step
        torch.cuda.empty_cache()
    return out


def train_world1_nccl(plain_busy) -> float:
    """Phase 15 (a): ``train_world1_rank`` spawned, checked and logged
    beside phase 14's profiled plain step (``plain_busy`` ms, None
    unmeasured). Returns its ms a step."""
    import tempfile

    from repro_torch.launch.mesh import run_world
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        res = run_world(train_world1_rank, 1, backend="nccl",
                        init_file=os.path.join(tmp, "rdv"), timeout=900)[0]
    cfg = get_config("qwen2.5-3b")
    # a layer: 2 forward + 2 backward + 1 recompute + the KV leaves'
    # gradients (read in part)
    sums = 2 * 2 + 1 + 1
    # the vocab's: the lookup's, and each loss chunk's input gradient and
    # two sums in forward and again in its recompute
    vocab = 1 + 5 * (TRAIN_S // 512)
    ms = float(np.mean(res["mp_ms"]))
    log(f"train model-parallel [world of 1 over NCCL ({res['backend']}), "
        f"every hook of the layout forced (FSDP and model gathers, "
        f"contracting {res['contract']}); qwen2.5-3b whole, bf16, "
        f"remat full, {TRAIN_B} x {TRAIN_S} tokens]: "
        f"{time.perf_counter() - t0:.1f} s with spawning; losses "
        f"{res['mp_losses']} against the plain step's "
        f"{res['plain_losses']}; {len(res['diff'])} of {res['leaves']} "
        f"parameter leaves differ from the plain run's "
        f"{res['diff'][:4]}; {res['reduces'] / 3:.0f} sums a step "
        f"({sums} a layer x {cfg.num_layers} layers + {vocab} = "
        f"{sums * cfg.num_layers + vocab}); collectives a step "
        f"{res['collectives']}; ms a step {ms:.1f} (each "
        f"{', '.join(f'{t:.1f}' for t in res['mp_ms'])}) against the plain "
        f"step's {np.mean(res['plain_ms']):.1f} (each "
        f"{', '.join(f'{t:.1f}' for t in res['plain_ms'])}) in the same "
        f"process; peak {res['peak'] / 2**30:.2f} GiB")
    p = res["mp_prof"]
    if p["busy"] > 0:
        log(f"train model-parallel: a profiled fourth step, world of 1: "
            f"wall {p['wall']:.1f} ms, card busy {p['busy']:.1f} ms (NCCL "
            f"kernels {p['nccl']:.1f} ms), {p['launches']} launches; phase "
            f"14's profiled plain step: card busy "
            + ("not measured" if plain_busy is None
               else f"{plain_busy:.1f} ms"))
    else:
        log("train model-parallel: no device time in the trace (not "
            "measured)")
    log(f"train model-parallel: alone, 180 back to back: a sum "
        f"({TRAIN_B}, {TRAIN_S}, {cfg.d_model}) bf16 "
        f"{res['sum_alone'][0]:.3f} ms of host clock, "
        f"{res['sum_alone'][1]:.3f} ms of CUDA events; a clone "
        f"{res['clone_alone'][0]:.3f} / {res['clone_alone'][1]:.3f} ms")
    if res["mp_losses"] != res["plain_losses"] or res["diff"]:
        fail("train model-parallel: the world of 1 parts from the plain "
             "step")
    if res["reduces"] != 3 * (sums * cfg.num_layers + vocab):
        fail(f"train model-parallel: {res['reduces']} sums in 3 steps")
    if any(res["launches"].values()):
        fail(f"train model-parallel: a kernel launched: {res['launches']}")
    for arch, r in res["mixers"].items():
        moved = ("reduce-scatter:model" if arch.startswith("recurrent")
                 else "all-gather:model")
        log(f"train model-parallel [world of 1 over NCCL, every hook of the "
            f"layout forced, the mixers' too; {arch} full width, "
            f"{len(r['kinds'])} layers {r['kinds']}, bf16, {MIXER_B} x "
            f"{MIXER_S} tokens, {MIXER_STEPS} steps]: losses "
            f"{r['forced_losses']} against the plain step's "
            f"{r['plain_losses']}; {len(r['diff'])} of {r['leaves']} "
            f"parameter leaves differ {r['diff'][:4]}; {r['reduces']:.0f} "
            f"sums a step; collectives a step {r['collectives']}; ms a "
            f"step after the first {r['forced_ms']} against the plain "
            f"step's {r['plain_ms']}")
        if r["forced_losses"] != r["plain_losses"] or r["diff"]:
            fail(f"train model-parallel [{arch}]: the world of 1 parts "
                 f"from the plain step")
        if not r["collectives"].get(moved):
            fail(f"train model-parallel [{arch}]: no {moved} a step")
    return ms


def _bounded(got, want, losses_got, losses_want, lrs) -> dict:
    """Phase 15 (b)'s CPU bounds: losses within rtol 1e-4 at every step;
    every parameter within 2 lr a step, at most 1e-3 of the elements more
    than 1e-5 apart. Returns {"ok", "words"} (run on a rank: the parent
    fails)."""
    ok = all(abs(a - b) <= 1e-4 * abs(b)
             for a, b in zip(losses_got, losses_want))
    worst, over, n = 0.0, 0, 0
    for (k, a), (k2, b) in zip(got, want):
        if k != k2 or a.shape != b.shape:
            return {"ok": False, "words": f"leaf {k} against {k2}"}
        d = (a.to("cuda") - b.to("cuda")).abs()      # a leaf at a time
        worst = max(worst, d.max().item())
        over += int((d > 1e-5).sum())
        n += d.numel()
    ok = ok and worst <= 2 * sum(lrs)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses_got,
                                                       losses_want))
    pmax = max((b.to("cuda").abs().max().item() for _, b in want),
               default=0.0)
    held = (f"parameters within {worst:.3g} (bound {2 * sum(lrs):.3g}), "
            f"{over} of {n} elements past 1e-5" if n else
            "parameters not gathered")
    return {"ok": ok and over <= 1e-3 * n, "ok_but_share": ok,
            "over": over, "worst": worst, "loss_rel": loss_rel,
            "pmax": pmax, "lr_sum": sum(lrs), "words": (
        f"losses {[round(x, 6) for x in losses_got]} / "
        f"{[round(x, 6) for x in losses_want]}, {held}")}


def _quad_run(cfg, opt, batches, seed, mesh, plan, *, compress=False,
              accum=1, keep="cuda"):
    """Steps of ``cfg`` from the state drawn from ``seed``: on one device
    (``plan`` None; its final parameters kept on ``keep``) or as this
    rank's part of ``mesh`` on its replica's rows, its final parameters
    gathered on the world's first rank (None elsewhere). ``keep`` None:
    no parameters kept or gathered. (losses, ms of each step after the
    first, parameter leaves, collectives a step)."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    state = trainer.init_state(cfg, opt, gen, device="cuda",
                               compress_grads=compress, plan=plan,
                               rank=mesh.model_rank)
    torch.cuda.empty_cache()        # the whole draw, cut to the part
    torch.cuda.synchronize()
    secs = {"init": time.perf_counter() - t0}
    rules = NO_RULES if plan is None else plan.rules
    step = trainer.make_train_step(cfg, opt, rules=rules, grad_accum=accum,
                                   compress_grads=compress)
    d, r = (1, 0) if plan is None else (rules.data, mesh.data_rank)
    rows = [{k: trainer.replica_rows(v, d, r, accum) for k, v in b.items()}
            for b in batches]
    c0 = dict(getattr(rules, "collectives", {}))
    t0 = time.perf_counter()
    losses, times = timed_steps(step, state, rows)
    secs["steps"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    colls = {} if plan is None else collectives_a_step(rules, c0,
                                                       len(batches))
    if keep is None:
        return losses, times, None, colls, secs
    if plan is None:
        leaves = [(k, t.to(keep)) for k, t in leaf_items(state["params"])]
        secs["keep"] = time.perf_counter() - t0
        return losses, times, leaves, {}, secs
    from repro_torch.parallel import tp
    params = tp.gather_tree(state["params"],
                            tp.state_specs(plan, state)["params"],
                            rules.group, rules.data_group)
    secs["gather"] = time.perf_counter() - t0
    return (losses, times, None if params is None else leaf_items(params),
            colls, secs)


def train_quad_rank(rank: int) -> dict:
    """Phase 15 (b), one of four gloo ranks sharing cuda:0 at (data 2,
    model 2), every state leaf at the reference's layout (``wembed`` over
    ``data``; heads, ffn, vocab and experts over ``model``):

    * qwen2.5-3b at full width cut to ``PAIR_LAYERS`` layers, fp32,
      remat full: ``QUAD_QWEN_STEPS`` steps plain and as many with
      ``compress_grads`` (attention, MLP and the 151936-token vocab
      computed sharded);
    * dbrx-132b at full width (16 experts, 8 a rank), cut to
      ``QUAD_DBRX_LAYERS`` layer(s) with bf16 moments (its config's are
      fp32): ``QUAD_DBRX_STEPS`` plain steps, experts computed in
      parallel, the router gathered, held by its losses alone;

    each rank on its replica's rows, their parameters gathered on rank 0,
    which also runs the same steps on one device (and for qwen2.5-3b a
    control: the same step with its gradient over 2 micro-batches) and
    holds them to the bounds; then the same four re-folded at (data 1,
    model 4), ``QUAD4_CASES`` at full width, fp32, ``QUAD_QWEN_STEPS``
    steps each held to one device the same way: qwen2.5-3b (16 query heads
    over 4, its 2 KV heads whole), recurrentgemma-9b (16 heads over 4, its
    KV head whole; ``lru_dim`` 4096 over 4) and mamba2-2.7b (80 heads over
    4; ``in_proj``'s 10576 columns, 2644 a rank); ``compressed_psum`` over
    the four against the plain formula; ``gpipe`` at 4 stages on CUDA
    tensors."""
    import warnings

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import compression, pipeline, tp
    torch.cuda.set_device(0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        mesh = make_host_mesh(2, devices=["cuda:0"] * 4)
    out = {"shape": dict(mesh.shape)}
    ops.reset_launch_counts()
    cases = [("qwen", dataclasses.replace(
                  get_config("qwen2.5-3b"), num_layers=PAIR_LAYERS,
                  dtype="float32"), (False, True), QUAD_QWEN_STEPS),
             ("dbrx", dataclasses.replace(
                  get_config("dbrx-132b"), num_layers=QUAD_DBRX_LAYERS,
                  moment_dtype="bfloat16"), (False,), QUAD_DBRX_STEPS)]
    for arch, cfg, modes, n in cases:
        opt = launch_opt(30, cfg)
        ds = SyntheticDataset(DataConfig(vocab=cfg.vocab, seq_len=PAIR_S,
                                         global_batch=PAIR_B,
                                         seed=SEED + 151))
        batches = [ds.next_batch() for _ in range(n)]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            plan = tp.train_plan(cfg, mesh)
        out[arch] = {"contract": sorted(plan.rules.contract_axes)}
        lrs = [float(adamw.schedule(opt, torch.tensor(i + 1)))
               for i in range(n)]
        # dbrx-132b is held by its losses alone: gathering its 4.5e9
        # parameters through gloo and comparing them took 30-35 s
        keep = None if arch == "dbrx" else "cuda"
        with bench.fp32_exact():
            for compress in modes:
                name = "compress" if compress else "plain"
                one = ctl = None
                if rank == 0:
                    one = _quad_run(cfg, opt, batches, SEED + 151, mesh,
                                    None, compress=compress, keep=keep)
                    torch.cuda.empty_cache()
                    # the control (fp32 only: an MoE stack's micro-batch
                    # routes as a batch of its own, another function)
                    ctl = one if arch == "dbrx" else _quad_run(
                        cfg, opt, batches, SEED + 151, mesh, None,
                        compress=compress, accum=2, keep=keep)
                    torch.cuda.empty_cache()
                dist.barrier()
                torch.cuda.reset_peak_memory_stats()
                mp = _quad_run(cfg, opt, batches, SEED + 151, mesh, plan,
                               compress=compress, keep=keep)
                res = {"losses": mp[0], "ms": mp[1], "collectives": mp[3],
                       "peak": torch.cuda.max_memory_allocated(),
                       "secs": mp[4]}
                torch.cuda.empty_cache()
                if rank == 0:       # held here: the leaves stay on rank 0
                    t0 = time.perf_counter()
                    held = _bounded(mp[2] or [], one[2] or [], mp[0],
                                    one[0], lrs)
                    res.update(
                        one_losses=one[0], one_ms=one[1], one_secs=one[4],
                        held=held, control=held if ctl is one else _bounded(
                            ctl[2], one[2], ctl[0], one[0], lrs))
                    res["secs"]["compare"] = time.perf_counter() - t0
                out[arch][name] = res
                del one, ctl, mp
                dist.barrier()
    # the same four re-folded at (data 1, model 4): query heads over
    # whole KV heads, the recurrent mixers over their model dims
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        mesh4 = make_host_mesh(4, devices=["cuda:0"] * 4)
    out["shape4"] = dict(mesh4.shape)
    for arch, layers in QUAD4_CASES:
        cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                                  dtype="float32")
        opt = launch_opt(30, cfg)
        ds = SyntheticDataset(DataConfig(vocab=cfg.vocab, seq_len=PAIR_S,
                                         global_batch=PAIR_B,
                                         seed=SEED + 157))
        batches = [ds.next_batch() for _ in range(QUAD_QWEN_STEPS)]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            plan = tp.train_plan(cfg, mesh4)
        lrs = [float(adamw.schedule(opt, torch.tensor(i + 1)))
               for i in range(QUAD_QWEN_STEPS)]
        uses = pytree.tree_flatten_with_path(
            plan.rules.uses, is_leaf=lambda x: isinstance(x, tuple))[0]
        res = {"contract": sorted(plan.rules.contract_axes),
               "whole_kv": plan.rules.whole_kv,
               "gathered": [pytree.keystr(k) for k, spec in uses
                            if "model" in spec]}
        with bench.fp32_exact():
            one = None
            if rank == 0:
                one = _quad_run(cfg, opt, batches, SEED + 157, mesh4, None,
                                keep="cpu")
                torch.cuda.empty_cache()
            dist.barrier()
            torch.cuda.reset_peak_memory_stats()
            mp = _quad_run(cfg, opt, batches, SEED + 157, mesh4, plan)
            res.update(losses=mp[0], ms=mp[1], collectives=mp[3],
                       peak=torch.cuda.max_memory_allocated(), secs=mp[4])
            torch.cuda.empty_cache()
            if rank == 0:
                t0 = time.perf_counter()
                res.update(one_losses=one[0], one_ms=one[1],
                           one_secs=one[4], held=_bounded(
                               mp[2], one[2], mp[0], one[0], lrs))
                res["secs"]["compare"] = time.perf_counter() - t0
        out[arch + "_1x4"] = res
        del one, mp
        dist.barrier()
    out["launches"] = ops.launch_counts()
    # compressed_psum over the four against the plain formula
    xs = [torch.randn(1 << 20, generator=torch.Generator().manual_seed(
        SEED + 152 + r)).cuda() * (r + 1) for r in range(4)]
    got = compression.compressed_psum(xs[rank])
    s = torch.stack([x.abs().max() for x in xs]).max().clamp(
        min=1e-12) / 127.0
    want = sum(torch.clamp(torch.round(x / s), -127, 127).to(torch.int32)
               for x in xs).float() * s
    out["psum_equal"] = bool(torch.equal(got, want))
    # gpipe at 4 stages on CUDA tensors over gloo
    w = torch.randn(4, 64, 64, generator=torch.Generator().manual_seed(
        SEED + 154)).cuda() * 0.2
    xs = torch.randn(4, 2, 64, generator=torch.Generator().manual_seed(
        SEED + 155)).cuda()

    def stage_fn(p, x):
        return torch.tanh(x @ p)

    run = pipeline.gpipe(stage_fn)
    try:
        run(w[rank], xs)
        out["gpipe_cuda"] = "ran"
    except RuntimeError as e:      # the refusal, logged
        out["gpipe_cuda"] = f"refused: {e}"
    # the same pipeline on host tensors, which gloo's ring hop takes
    w, xs = w.cpu(), xs.cpu()
    seq = xs
    for i in range(4):
        seq = torch.tanh(seq @ w[i])
    out["gpipe_cpu_err"] = (run(w[rank], xs) - seq).abs().max().item()
    return out


def gloo_cuda_p2p_rank(rank: int) -> str:
    """A bare gloo send / receive of CUDA tensors between 2 ranks on cuda:0
    (what ``gpipe`` refuses before it gets there): what gloo does."""
    import torch.distributed as dist
    torch.cuda.set_device(0)
    x = torch.full((4,), float(rank + 1), device="cuda")
    y = torch.zeros(4, device="cuda")
    try:
        for w in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, x, 1 - rank),
                dist.P2POp(dist.irecv, y, 1 - rank)]):
            w.wait()
        torch.cuda.synchronize()
        return f"ran, received {y.tolist()}"
    except RuntimeError as e:
        return f"raised: {str(e)[:200]}"


def train_gloo_quad() -> None:
    """Phase 15 (b): ``train_quad_rank`` on 4 spawned gloo ranks, checked
    and logged."""
    import tempfile

    from repro_torch.launch.mesh import WorldError, run_world
    gc.collect()
    torch.cuda.empty_cache()
    held = (torch.cuda.memory_allocated() / 2**30,
            torch.cuda.memory_reserved() / 2**30)
    log(f"train quad: this process holds {held[0]:.2f} GiB allocated, "
        f"{held[1]:.2f} GiB reserved on the card before the four ranks "
        f"start")
    t0 = time.perf_counter()
    # the four share 80 GB: their allocators grow segments in place, so
    # the gathers' and reduce-scatters' GB-sized churn leaves no split
    # blocks reserved (set for the spawned ranks only)
    conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        with tempfile.TemporaryDirectory() as tmp:
            res = run_world(train_quad_rank, 4, backend="gloo",
                            init_file=os.path.join(tmp, "rdv"),
                            timeout=1000)
    finally:
        if conf is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = conf
    first = res[0]
    want = {"qwen": ["ffn", "heads", "vocab"],
            "dbrx": ["experts", "heads", "vocab"]}
    for arch, contract in want.items():
        if first[arch]["contract"] != contract:
            fail(f"train quad [{arch}]: the plan contracts "
                 f"{first[arch]['contract']}")
    for arch, name in (("qwen", "plain"), ("qwen", "compress"),
                       ("dbrx", "plain")):
        r = first[arch][name]
        held, ctl = r["held"], r["control"]
        what = (f"qwen2.5-3b full width, {PAIR_LAYERS} layers, fp32"
                if arch == "qwen" else
                f"dbrx-132b full width (16 experts, 8 a rank), "
                f"{QUAD_DBRX_LAYERS} layer(s), bf16, bf16 moments")
        log(f"train quad [{what}, 4 gloo ranks on cuda:0 at {first['shape']}"
            f", {name}] against one device on the card: {held['words']}; "
            f"the control (one device, the gradient over 2 micro-batches) "
            f"against one device: {ctl['words']}; ms a step (host clock, "
            f"correctness only) {np.mean(r['ms']):.1f} on the four, "
            f"{np.mean(r['one_ms']):.1f} on one device; collectives a step "
            f"on a rank {r['collectives']}; s on rank 0: the four "
            f"{ {k: round(v, 1) for k, v in r['secs'].items()} }, one "
            f"device { {k: round(v, 1) for k, v in r['one_secs'].items()} }; "
            f"peak allocated on the card "
            f"while the four ran, seen from each rank "
            f"{[round(x[arch][name]['peak'] / 2**30, 2) for x in res]} GiB")
        if any(x[arch][name]["losses"] != r["losses"] for x in res[1:]):
            fail(f"train quad [{arch} {name}]: the ranks' losses differ")
        # fp32: the CPU bounds; past the share of elements, only as far
        # as the control, two correct single-device runs, part from each
        # other. bf16 (dbrx): losses within one bf16 spacing (2^-8
        # relative) of one device's (its parameters are not gathered)
        if arch == "qwen":
            ok = held["ok"] or (held["ok_but_share"]
                                and held["over"] <= 2 * ctl["over"])
        else:
            ok = held["loss_rel"] <= 2.0 ** -8
        if not ok:
            fail(f"train quad [{arch} {name}]: outside the bounds")
    for arch, layers in QUAD4_CASES:
        r = first[arch + "_1x4"]
        held = r["held"]
        log(f"train quad [{arch} full width, {layers} layers, fp32, 4 gloo "
            f"ranks on cuda:0 at {first['shape4']}: contracting "
            f"{r['contract']}, KV heads whole {r['whole_kv']}, leaves "
            f"gathered over model {r['gathered']}] against one device on "
            f"the card: {held['words']}; ms a step (host clock, "
            f"correctness only) {np.mean(r['ms']):.1f} on the four, "
            f"{np.mean(r['one_ms']):.1f} on one device; collectives a step "
            f"on a rank {r['collectives']}; s on rank 0: the four "
            f"{ {k: round(v, 1) for k, v in r['secs'].items()} }, one "
            f"device { {k: round(v, 1) for k, v in r['one_secs'].items()} }; "
            f"peak allocated on the card while the four ran, seen from each "
            f"rank {[round(x[arch + '_1x4']['peak'] / 2**30, 2) for x in res]}"
            f" GiB")
        if any(x[arch + "_1x4"]["losses"] != r["losses"] for x in res[1:]):
            fail(f"train quad [{arch} (1, 4)]: the ranks' losses differ")
        if r["gathered"] or not held["ok"]:
            fail(f"train quad [{arch} (1, 4)]: leaves gathered over model "
                 f"{r['gathered']}, or outside the bounds")
    if not all(r["psum_equal"] for r in res):
        fail("train quad: compressed_psum differs from the plain formula")
    if any(any(r["launches"].values()) for r in res):
        fail(f"train quad: a kernel launched: {[r['launches'] for r in res]}")
    if not all(r["gpipe_cuda"].startswith("refused: gpipe: gloo") and
               r["gpipe_cpu_err"] <= 1e-5 for r in res):
        fail(f"train quad: gpipe: "
             f"{[(r['gpipe_cuda'], r['gpipe_cpu_err']) for r in res]}")
    with tempfile.TemporaryDirectory() as tmp:
        try:
            bare = run_world(gloo_cuda_p2p_rank, 2, backend="gloo",
                             init_file=os.path.join(tmp, "rdv"), timeout=120)
        except WorldError as e:
            bare = [f"the world failed: {str(e)[:300]}"]
    log(f"train quad: compressed_psum over the four equals the plain "
        f"formula bit for bit (4 x 2^20 fp32); gpipe at 4 stages on CUDA "
        f"tensors over gloo: {first['gpipe_cuda']}; on the same ranks' "
        f"host tensors it equals the sequential stack to "
        f"{max(r['gpipe_cpu_err'] for r in res):.3g}; a bare gloo send / "
        f"receive of CUDA tensors on a pair of its own: {bare}; "
        f"{time.perf_counter() - t0:.1f} s with spawning")


# ---------------------------------------------------------------------------
# phase 16: the dry-run (fake-tensor traces, the H100 roofline)
# ---------------------------------------------------------------------------

DRYRUN_ARCH = "qwen2.5-3b"
DRYRUN_CROSS = ("prefill_32k", "decode_32k")   # traced again in-process


def start_dryrun_cli(out: Path, arch: str = DRYRUN_ARCH, shape=None,
                     optimized: bool = False):
    """``python -m repro_torch.launch.dryrun --arch <arch> [--shape
    <shape>] [--optimized]`` (every shape by default; pod16x16, full
    width; train_4k by the period extrapolation; each cell in a process
    of its own) in a process of its own, started now: it runs on the
    host's cores while this process traces the phase's other cells."""
    shutil.rmtree(out, ignore_errors=True)
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         arch, "--out", str(out)] + (["--shape", shape] if shape else [])
        + (["--optimized"] if optimized else []),
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))


def layout_bytes(cfg, shape, table=None) -> int:
    """A rank's argument bytes on pod16x16 reckoned from the layout alone:
    each leaf of the train state (a train cell) or of the parameters, at
    the rank's part of its shape under ``tp.train_plan``'s specs (the
    reference's ``Rules(mesh)`` specs), plus the rank's rows of the
    batch and, for decode, of the dense cache lanes (KV heads over
    ``model`` where attention computes sharded). ``table`` {"seq":
    "model"} (``--optimized``): the batch's and the lanes' sequence split
    over ``model`` instead (a dim that does not divide whole)."""
    import math

    from repro_torch.configs.base import input_specs
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.parallel import tp
    from repro_torch.parallel.sharding import Rules
    mesh = make_production_mesh()
    m, d = mesh.shape["model"], tp.data_size(mesh)
    plan = tp.train_plan(cfg, mesh, table)
    seq = bool(table and table.get("seq"))
    if shape.kind == "train":
        tree = steps.state_shapes(cfg, steps.opt_config_for(cfg))
        specs = tp.state_specs(plan, tree)
    else:
        tree, specs = api.empty_params(cfg), plan.param_specs(cfg)
    leaves = pytree.tree_leaves(tree)
    spec_leaves = pytree.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, tuple))
    total = sum(math.prod(tp._local(tuple(t.shape), sp, m, d))
                * t.element_size() for t, sp in zip(leaves, spec_leaves))
    rules = Rules(mesh, table)
    ins = input_specs(cfg, shape)
    for k, v in ins.items():
        if k == "cache":
            kv = "kv_heads" in plan.sharded_axes
            for e, axes in zip(v, api.cache_axes(cfg)):
                for name, t in e.items():
                    names = axes[name].split(",")
                    local = [n // (d if ax == "batch" else m if (
                                   seq and ax == "seq" and n % m == 0) or (
                                   not seq and kv and ax == "kv_heads")
                                   else 1)
                             for n, ax in zip(t.shape, names + [""] * 4)]
                    total += math.prod(local) * t.element_size()
            continue
        local = steps.local_shape(v.shape, rules.spec(
            tuple(v.shape), steps.BATCH_AXES[k]), mesh)
        total += math.prod(local) * v.element_size()
    return total


def dryrun_smoke_flops() -> None:
    """qwen2.5-3b SMOKE at B 1, S 1024 on one device, traced as the CPU
    tests trace it (every kernel seam through its plain version, as XLA's
    attention stands in for the Pallas kernels in the JAX dry-run on a
    CPU host): each step's matmul FLOPs must equal the JAX dry-run's
    (``SMOKE_DOT_FLOPS``) on this machine's torch."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    for key, want in SMOKE_DOT_FLOPS.items():
        arch, kind = key.split("/")
        tr, _ = dryrun.trace_cell(get_smoke_config(arch),
                                  ShapeConfig("smoke", 1024, 1, kind),
                                  make_host_mesh(1, devices=["cpu"]),
                                  seams="plain")
        if tr.cost.dot_flops != want:
            fail(f"dryrun {key}: dot FLOPs {tr.cost.dot_flops:.0f}, the JAX "
                 f"dry-run's {want}")
    log(f"dryrun: SMOKE {', '.join(SMOKE_DOT_FLOPS)} dot FLOPs equal the "
        f"JAX dry-run's")


def dense_decode_ms(cfg) -> tuple:
    """The dry-run's decode cell as the card runs it: ``api.decode_step``
    (qwen2.5-3b whole, bf16, random weights) at phase 6's batch on dense
    ``cache_init`` lanes of its length, every lane full (pos MAX_LEN - 1,
    so the mha kernel reads each slot's whole lane, as the dry-run counts
    a decode cell). (CUDA-event ms an eager call, ms a replay of the step
    captured as a CUDA graph: the device's time without the host's launch
    gaps, peak bytes allocated during the replays)."""
    params = api.init_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(SEED), device="cuda")
    cache = api.cache_init(cfg, SLOTS, MAX_LEN, device="cuda")
    tokens = torch.ones((SLOTS, 1), dtype=torch.int64, device="cuda")
    pos = torch.full((SLOTS,), MAX_LEN - 1, dtype=torch.int32,
                     device="cuda")

    def step():
        api.decode_step(cfg, params, cache, tokens, pos)
    with torch.no_grad():
        eager = cuda_ms(step, iters=5)
        torch.cuda.reset_peak_memory_stats()
        graph = graph_ms(step)
    peak = torch.cuda.max_memory_allocated()
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()
    return eager, graph, peak


def dryrun_beside_measured() -> None:
    """The dry-run of phase 14's own step (qwen2.5-3b whole, bf16, remat
    full, 8 x 1024 tokens, one device) beside what phase 14 measured, and
    of a dense decode cell at phase 6's batch and lane length beside that
    step timed here (``dense_decode_ms``). Phase 6's own decode step
    reads pages through the paged kernel, other work: it is not
    compared."""
    from repro_torch.analysis import roofline as rl
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    cfg = get_config(DRYRUN_ARCH)
    one = make_host_mesh(1, devices=["cpu"])
    eager, graph, peak = dense_decode_ms(cfg)
    for shape in (ShapeConfig("phase14", TRAIN_S, TRAIN_B, "train"),
                  ShapeConfig("phase6", MAX_LEN, SLOTS, "decode")):
        t0 = time.perf_counter()
        tr, depths = dryrun.trace_cell(cfg, shape, one)
        r = rl.analyze(tr.cost, chips=1,
                       model_flops=rl.model_flops_for(cfg, shape))
        mem = tr.memory["total_bytes_per_device"]
        head = (f"dryrun beside phase {shape.name[5:]} [{DRYRUN_ARCH}, "
                f"{shape.kind} B{shape.global_batch} S{shape.seq_len}, one "
                f"device, depths traced {depths}, "
                f"{time.perf_counter() - t0:.1f} s]: predicted t_bound "
                f"{1e3 * r.t_bound:.2f} ms ({r.bottleneck}; compute "
                f"{1e3 * r.t_compute:.2f}, memory {1e3 * r.t_memory:.2f} ms), "
                f"memory {mem / 2**30:.2f} GiB (arguments "
                f"{tr.memory['argument_bytes'] / 2**30:.2f}, temp "
                f"{tr.memory['temp_bytes'] / 2**30:.2f}), model FLOPs "
                f"{r.model_flops:.4e}, op FLOPs {r.flops:.4e}, dot FLOPs "
                f"{tr.cost.dot_flops:.4e}, bytes {r.bytes_hbm:.4e}")
        if shape.kind == "train":
            ms = PHASE14["ms"]
            log(f"{head}; measured {min(ms):.1f}-{max(ms):.1f} ms a step "
                f"(t_bound / step {1e3 * r.t_bound / max(ms):.1%}-"
                f"{1e3 * r.t_bound / min(ms):.1%}), peak "
                f"{PHASE14['peak'] / 2**30:.2f} GiB (predicted / measured "
                f"{mem / PHASE14['peak']:.3f}), 6 N T {PHASE14['flops']:.4e} "
                f"(model FLOPs / 6 N T {r.model_flops / PHASE14['flops']:.4f})")
        else:
            log(f"{head}; measured (the dense decode step, lanes full): "
                f"{graph:.3f} ms a graph replay (t_bound / replay "
                f"{1e3 * r.t_bound / graph:.1%}), {eager:.3f} ms an eager "
                f"call, peak allocated {peak / 2**30:.2f} GiB (predicted / "
                f"measured {mem / peak:.3f})")


def finish_dryrun_cli(proc, out: Path, arch: str = DRYRUN_ARCH,
                      shapes=None, cross=DRYRUN_CROSS,
                      optimized: bool = False) -> list:
    """Wait for the CLI; fail on its exit code, on any cell that is not
    ok or skipped (of ``shapes``: every runnable shape by default), if
    ``cross``'s cells' dot FLOPs differ from the same cells traced here
    (the CPU tests' code path), and if a cell's argument bytes differ
    from ``layout_bytes``' reckoning (the sequence split with
    ``optimized``, whose records must carry the reference's
    ``optimized_kwargs``). Returns the ok records."""
    from repro_torch.analysis import report
    from repro_torch.configs.base import SHAPES, cell_runnable
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    t0 = time.perf_counter()
    flops = {}
    for name in cross:
        tr, _ = dryrun.trace_cell(get_config(arch), SHAPES[name],
                                  make_production_mesh())
        flops[name] = tr.cost.dot_flops
    t_cross = time.perf_counter() - t0
    stdout, stderr = proc.communicate(timeout=600)
    print(stdout, end="", flush=True)
    if proc.returncode != 0:
        fail(f"dryrun CLI exited {proc.returncode}:\n{stderr[-3000:]}")
    rows = report.load_cells(str(out))
    bad = [r["cell"] for r in rows if r["status"] != "ok"]
    runnable = [name for name, shape in SHAPES.items()
                if (shapes is None or name in shapes)
                and cell_runnable(get_config(arch), shape)[0]]
    if bad or sorted(r["shape"] for r in rows) != sorted(runnable):
        fail(f"dryrun: cells {bad} failed; records "
             f"{[r['cell'] for r in rows]} for the runnable {runnable}")
    for r in rows:
        if r["shape"] in flops and r["cost"]["dot_flops"] != flops[
                r["shape"]]:
            fail(f"dryrun {r['cell']}: the CLI's dot FLOPs "
                 f"{r['cost']['dot_flops']:.0f}, traced here "
                 f"{flops[r['shape']]:.0f}")
    traced = ", ".join(f"{r['shape']} {r['trace_s']}" for r in rows
                       if r["status"] == "ok")
    log(f"dryrun CLI ({arch}, {'every shape' if shapes is None else shapes}"
        f", pod16x16{', --optimized' if optimized else ''}, H100 constants; "
        f"trace s {traced})"
        + (f"; {', '.join(cross)} traced again here in {t_cross:.1f} s, "
           f"equal dot FLOPs" if cross else "") + ":\n"
        + report.roofline_table(rows) + f"\n{report.summary(rows)}")
    for r in rows:
        if r["status"] != "ok":
            continue
        kw = dryrun.optimized_kwargs(r["shape"]) if optimized else {}
        if optimized and any(r.get(k) != v for k, v in kw.items()):
            fail(f"dryrun {r['cell']}: the record does not carry the "
                 f"reference's optimized options {kw}")
        want = layout_bytes(dataclasses.replace(
            get_config(arch), **kw.get("cfg_patch", {})),
            SHAPES[r["shape"]], kw.get("rules_table"))
        got = r["memory"]["argument_bytes"]
        log(f"dryrun {r['cell']}: argument bytes {got:.0f} "
            f"({got / 2**30:.3f} GiB), the layout's reckoning {want:.0f}; "
            f"memory {r['memory']}, dot FLOPs "
            f"{r['cost']['dot_flops']:.4e}, collective bytes "
            f"{r['cost']['coll_bytes']}, t_collective "
            f"{r['roofline']['t_collective_s']:.4g} s, sums {r['reduces']}, "
            f"ops {r['ops']:.0f}, depths {r['depths']}")
        if got != want:
            fail(f"dryrun {r['cell']}: argument bytes {got} against the "
                 f"layout's {want}")
    return [r for r in rows if r["status"] == "ok"]


def start_dryrun_clis() -> list:
    """Phase 16's six CLI processes, started early: qwen2.5-3b every shape
    and dbrx-132b train_4k, each plain and ``--optimized`` (phase 17 (c)),
    and recurrentgemma-9b and mamba2-2.7b train_4k plain (their mixers
    over ``model``): (process, out directory, arch, shapes, cells traced
    again here, optimized) each."""
    out = []
    for opt in (False, True):
        tag = "_opt" if opt else ""
        qwen = ROOT / "build" / f"dryrun_torch{tag}"
        moe = ROOT / "build" / f"dryrun_torch_moe{tag}"
        out += [(start_dryrun_cli(qwen, optimized=opt), qwen, DRYRUN_ARCH,
                 None, () if opt else DRYRUN_CROSS, opt),
                (start_dryrun_cli(moe, "dbrx-132b", "train_4k", opt), moe,
                 "dbrx-132b", ("train_4k",), (), opt)]
    for arch in ("recurrentgemma-9b", "mamba2-2.7b"):
        where = ROOT / "build" / f"dryrun_torch_{arch}"
        out.append((start_dryrun_cli(where, arch, "train_4k"), where, arch,
                    ("train_4k",), (), False))
    return out


def stop(clis) -> None:
    for proc, *_ in clis:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def dryrun_phase(clis) -> None:
    dryrun_smoke_flops()
    dryrun_beside_measured()
    recs = {}
    for proc, out, arch, shapes, cross, opt in clis:
        for r in finish_dryrun_cli(proc, out, arch, shapes, cross, opt):
            recs[r["arch"], r["shape"], opt] = r
    for (arch, shape, opt), r in sorted(recs.items()):
        rl = r["roofline"]
        log(f"dryrun {r['cell']}{' --optimized' if opt else ''}: memory a "
            f"device {r['memory']['total_bytes_per_device'] / 2**30:.2f} "
            f"GiB, t_comp {rl['t_compute_s']:.4g} s, t_mem "
            f"{rl['t_memory_s']:.4g} s, t_coll {rl['t_collective_s']:.4g} "
            f"s ({rl['bottleneck']}), useful_flops "
            f"{rl['useful_flops_frac']:.3f}, dot FLOPs a rank "
            f"{r['cost']['dot_flops']:.4e}, sums {r['reduces']}")
    for (arch, shape, opt), r in sorted(recs.items()):
        if not opt or (arch, shape, False) not in recs:
            continue
        lines = []
        for name, x in (("plain", recs[arch, shape, False]),
                        ("--optimized", r)):
            rl = x["roofline"]
            t_bound = max(rl["t_compute_s"], rl["t_memory_s"],
                          rl["t_collective_s"])
            lines.append(
                f"{name}: memory a device "
                f"{x['memory']['total_bytes_per_device'] / 2**30:.2f} GiB "
                f"(arguments {x['memory']['argument_bytes'] / 2**30:.3f}), "
                f"t_bound {t_bound:.4g} s ({rl['bottleneck']}; "
                f"compute {rl['t_compute_s']:.4g}, memory "
                f"{rl['t_memory_s']:.4g}, collective "
                f"{rl['t_collective_s']:.4g}), collective bytes "
                f"{ {k: f'{v:.4g}' for k, v in x['cost']['coll_bytes'].items()} }")
        log(f"dryrun {arch} {shape} pod16x16 (phase 17 (c)): "
            + "; ".join(lines))


# ---------------------------------------------------------------------------
# phase 17: context parallelism (the sequence over ``model``)
# ---------------------------------------------------------------------------

CP = {"seq": "model"}
CP_LAYERS, CP_S, CP_STEPS = 4, 2048, 8         # (b)'s prefill and decode
CP_TRAIN_B, CP_TRAIN_S = 2, 1024                # (a)'s train step
CP_PAIR_TRAIN_B, CP_PAIR_TRAIN_S = 2, 512       # (b)'s train step
CP_MHA = (1, 1024, 1024, 2048)                  # B, Sq, q_offset, Sk


def cp_forced_rules(cfg, group):
    """``TrainRules`` over ``group`` (a world of one rank) with the
    sequence over ``model`` and every context-parallel hook taken at M =
    1 (the sequence's gathers, the owner's lane write, the merge, the
    loss's sums, the train step's sums of the leaves ``model`` does not
    split), and the gathers of a (data 2, model 4) context-parallel plan
    (every ``wembed`` dim over ``data``, every ``model`` dim but the
    experts' over ``model``), each collective over one rank: a copy."""
    import warnings

    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel import tp
    from repro_torch.parallel.sharding import TrainRules
    desc = Mesh(tuple((torch.device("meta"),) * 4 for _ in range(2)),
                {"data": 2, "model": 4})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        r = tp.train_plan(cfg, desc, CP).rules
    return TrainRules(r.contract_axes, group, data_group=group, uses=r.uses,
                      seq="model")


def check_mha_cp(rng) -> float:
    """mha at a context-parallel rank's block (B1, Sq 1024 at q_offset
    1024 against Sk 2048, H16 KV2 D128, no prefix), bf16 and fp32, against
    its plain version; bf16 also on inputs peaked on the diagonal, where
    the plain version at the offset one short must miss. Returns the max
    abs error."""
    B, Sq, off, Sk = CP_MHA
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        def t(*shape):
            return torch.tensor(rng.standard_normal(shape), dtype=dtype,
                                device="cuda")
        q, k, v = t(B, Sq, H, D), t(B, Sk, KV, D), t(B, Sk, KV, D)
        got = mha_kernel.mha(q, k, v, causal=True, q_offset=off)
        torch.cuda.synchronize()
        want = ref.mha_ref(q, k, v, causal=True, q_offset=off)
        worst = max(worst, agrees(
            f"mha [context-parallel rank block: Sq {Sq} at q_offset {off}, "
            f"Sk {Sk}, H{H} KV{KV} D{D}, {str(dtype)[6:]}]", got, want))
    q, k, v = (torch.tensor(a, dtype=torch.bfloat16, device="cuda")
               for a in ref.peaked_mha_inputs(rng, B, Sk, H, KV, D))
    q = q[:, off:].contiguous()
    got = mha_kernel.mha(q, k, v, causal=True, q_offset=off)
    torch.cuda.synchronize()
    want = ref.mha_ref(q, k, v, causal=True, q_offset=off)
    name = f"mha [context-parallel rank block, peaked, q_offset {off}]"
    worst = max(worst, agrees(name, got, want))
    mask_shift_caught(name, ref.mha_ref(q, k, v, causal=True,
                                        q_offset=off - 1), want)
    return worst


def time_mha_cp(rng) -> tuple:
    """mha at a context-parallel rank's block (``CP_MHA``, bf16): CUDA-event
    and device ms, the plain version's ms, SDPA with the offset-causal band
    as a boolean attn_mask (its event and device ms), and the bound: the
    band's FLOPs (4 D a visible pair and head) against q, k, v and the
    output's bytes. (ms, plain ms, bound ms, bound by, SDPA ms)."""
    B, Sq, off, Sk = CP_MHA

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.bfloat16,
                            device="cuda")
    q, k, v = t(B, Sq, H, D), t(B, Sk, KV, D), t(B, Sk, KV, D)

    def kernel():
        mha_kernel.mha(q, k, v, causal=True, q_offset=off)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = (torch.arange(Sk, device="cuda")[None, :]
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
    n_bytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    flops = 4 * B * H * D * band_pairs(Sq, off, Sk + 1, Sk)
    bms, by = bench.bound_ms(n_bytes, flops, torch.bfloat16)
    log(f"mha time [context-parallel rank block: B{B} Sq {Sq} at q_offset "
        f"{off}, Sk {Sk}, H{H} KV{KV} D{D}, bf16]: {ms:.4f} ms/launch "
        f"(device {dev:.4f} ms), plain {plain:.4f} ms, SDPA with the band "
        f"as a mask {lib:.4f} ms (device {lib_dev:.4f} ms), bound "
        f"{bms:.4f} ms ({by}), {bms / ms:.1%} of bound ({bms / dev:.1%} on "
        f"the device)")
    return ms, plain, bms, by, lib


def cp_world1_rank(rank: int) -> dict:
    """Phase 17 (a), a spawned world of 1 over NCCL on cuda:0: qwen2.5-3b
    at full width cut to ``CP_LAYERS`` layers, bf16, from one seed: a
    train step (``CP_TRAIN_B`` x ``CP_TRAIN_S`` tokens), a prefill of 4
    prompts of 512 tokens into dense lanes of 512 + ``CP_STEPS`` rows and
    ``CP_STEPS`` greedy decode steps (those two at fp32 with an fp32
    cache), each plain and with ``cp_forced_rules`` (every context-parallel
    hook over one rank)."""
    import torch.distributed as dist
    torch.cuda.set_device(0)
    cfg = dataclasses.replace(get_config("qwen2.5-3b"), num_layers=CP_LAYERS)
    opt = launch_opt(3, cfg)
    rules = cp_forced_rules(cfg, dist.group.WORLD)
    ds = SyntheticDataset(DataConfig(vocab=cfg.vocab, seq_len=CP_TRAIN_S,
                                     global_batch=CP_TRAIN_B,
                                     seed=SEED + 170))
    b = batch_on("cuda", ds.next_batch())
    out = {"backend": dist.get_backend()}
    t0 = time.perf_counter()
    states, losses = [], []
    for r in (NO_RULES, rules):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 170)
        state = trainer.init_state(cfg, opt, gen, device="cuda")
        state, m = trainer.make_train_step(cfg, opt, rules=r)(state, b)
        losses.append(m["loss"].item())
        states.append([t.cpu() for _, t in leaf_items(state["params"])])
        del state
        torch.cuda.empty_cache()
    out["train_losses"] = losses
    out["train_equal"] = all(torch.equal(a, c) for a, c in zip(*states))
    out["train_leaves"] = len(states[0])
    out["secs"] = {"train": round(time.perf_counter() - t0, 1)}
    t0 = time.perf_counter()
    del states
    # the prefill and decode at fp32 with an fp32 cache: the decode's
    # plain attention is held to the kernel's by a bound
    cfg = dataclasses.replace(cfg, dtype="float32", kv_cache_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 171)
    params = api.init_params(cfg, gen, device="cuda")
    prompts = torch.randint(0, cfg.vocab, (4, 512), device="cuda",
                            generator=torch.Generator(device="cuda")
                            .manual_seed(SEED + 172))
    runs = []
    for r in (NO_RULES, rules):
        ops.reset_launch_counts()
        with torch.no_grad():
            logits, caches, pos = api.prefill(cfg, params, prompts,
                                              max_len=512 + CP_STEPS,
                                              rules=r)
            first = logits.clone()
            pre = ops.launch_counts()
            ops.reset_launch_counts()
            toks, steps = [], []
            for _ in range(CP_STEPS):
                tok = logits.argmax(-1)
                toks.append(tok.tolist())
                logits, caches = api.decode_step(cfg, params, caches,
                                                 tok[:, None], pos, rules=r)
                steps.append(logits.clone())
                pos = pos + 1
        runs.append({"first": first, "caches": caches, "toks": toks,
                     "steps": steps, "prefill_launches": pre,
                     "decode_launches": ops.launch_counts()})
    a, c = runs
    out["prefill_equal"] = torch.equal(a["first"], c["first"])
    out["toks_equal"] = a["toks"] == c["toks"]
    scale = max(s.abs().max().item() for s in a["steps"])
    out["decode_err"] = max((x - y).abs().max().item()
                            for x, y in zip(a["steps"], c["steps"])) / scale
    out["launches"] = [(r["prefill_launches"], r["decode_launches"])
                       for r in runs]
    out["collectives"] = {f"{k[0]}:{k[1]}": n
                          for k, n in sorted(rules.collectives.items())}
    out["secs"]["serve"] = round(time.perf_counter() - t0, 1)
    return out


def cp_world1_nccl() -> None:
    """Phase 17 (a): ``cp_world1_rank`` spawned, checked and logged. The
    train step and the prefill must equal the plain path bit for bit; the
    decode steps attend in plain PyTorch under context parallelism (a
    partial softmax a rank, merged), where the plain path runs the mha
    kernel: their greedy tokens must be equal, their logits within 1e-4
    of the logit scale (fp32)."""
    import tempfile

    from repro_torch.launch.mesh import run_world
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        res = run_world(cp_world1_rank, 1, backend="nccl",
                        init_file=os.path.join(tmp, "rdv"), timeout=600)[0]
    log(f"context parallelism [world of 1 over NCCL ({res['backend']}), "
        f"the sequence over model with every hook forced; qwen2.5-3b full "
        f"width, {CP_LAYERS} layers; the train step bf16, the prefill and "
        f"decode fp32]: "
        f"{time.perf_counter() - t0:.1f} s with spawning; train step losses "
        f"{res['train_losses']} (plain, forced), all {res['train_leaves']} "
        f"parameter leaves equal bit for bit: {res['train_equal']}; prefill "
        f"logits (4 x 512) equal bit for bit: {res['prefill_equal']}; "
        f"{CP_STEPS} decode steps: greedy tokens equal {res['toks_equal']}, "
        f"logits within {res['decode_err']:.3g} of the logit scale; launches "
        f"(prefill, decode) plain {res['launches'][0]}, forced "
        f"{res['launches'][1]}; collectives {res['collectives']}; s in the "
        f"rank {res['secs']}")
    if not (res["train_equal"] and res["prefill_equal"]
            and res["train_losses"][0] == res["train_losses"][1]):
        fail("context parallelism: the forced world of 1 parts from the "
             "plain path")
    if not res["toks_equal"] or res["decode_err"] > 1e-4:
        fail("context parallelism: the forced decode parts from the plain "
             "decode")
    forced_pre, forced_dec = res["launches"][1]
    if forced_pre.get("mha") != CP_LAYERS or forced_dec.get("mha"):
        fail(f"context parallelism: mha launches {res['launches'][1]}")


def cp_pair_rank(rank: int) -> dict:
    """Phase 17 (b), one of two gloo ranks sharing cuda:0 at (data 1,
    model 2), the sequence over ``model``; qwen2.5-3b at full width cut to
    ``CP_LAYERS`` layers, fp32 with an fp32 cache:

    * a ``CP_S``-token prefill, each rank's half of the prompt (its
      queries through the mha kernel at q_offset 0 and ``CP_S`` / 2 against
      the gathered keys) into its half of the dense lanes, then
      ``CP_STEPS`` greedy decode steps on those halves (the owner writes,
      the partial softmaxes merged), whole weights on every rank;
    * one train step (``CP_PAIR_TRAIN_B`` x ``CP_PAIR_TRAIN_S``) at the
      reference's layout (``tp.train_plan(table=CP)``), its parameters
      gathered on rank 0;

    rank 0 also runs the same prefill, decode and step on one device."""
    import warnings

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import tp
    from repro_torch.parallel.sharding import ManualRules
    torch.cuda.set_device(0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        mesh = make_host_mesh(2, devices=["cuda:0"] * 2)
    cfg = dataclasses.replace(get_config("qwen2.5-3b"), num_layers=CP_LAYERS,
                              dtype="float32", kv_cache_dtype="float32")
    out = {"rank": mesh.model_rank}
    rules = ManualRules((), mesh.group, model=2, model_rank=mesh.model_rank,
                        seq="model")
    params = api.init_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(SEED + 173), device="cuda")
    prompt = torch.randint(0, cfg.vocab, (1, CP_S), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(SEED + 174))
    max_len = CP_S + CP_STEPS

    def prefill_decode(r, tokens):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with torch.no_grad(), bench.fp32_exact():
            logits, caches, pos = api.prefill(cfg, params, tokens,
                                              max_len=max_len, rules=r)
            torch.cuda.synchronize()
            t_pre = time.perf_counter() - t0
            first, pre = logits.clone(), ops.launch_counts()
            toks = []
            for _ in range(CP_STEPS):
                tok = logits.argmax(-1)
                toks.append(int(tok[0]))
                logits, caches = api.decode_step(cfg, params, caches,
                                                 tok[:, None], pos, rules=r)
                pos = pos + 1
            torch.cuda.synchronize()
        # numpy: a tensor would go back through shared memory, which
        # needs this process alive after it returns
        return {"first": first.cpu().numpy(), "toks": toks, "launches": pre,
                "lane_rows": caches[0]["k"].shape[1],
                "s": (t_pre, time.perf_counter() - t0 - t_pre)}

    out["cp"] = prefill_decode(rules, rules.cp_own(prompt).contiguous())
    out["cp"]["collectives"] = {f"{k[0]}:{k[1]}": n for k, n in
                                sorted(rules.collectives.items())}
    if rank == 0:
        out["one"] = prefill_decode(NO_RULES, prompt)
    dist.barrier()
    # one train step at the layout, and on one device on rank 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        plan = tp.train_plan(cfg, mesh, CP)
    opt = launch_opt(30, cfg)
    ds = SyntheticDataset(DataConfig(vocab=cfg.vocab, seq_len=CP_PAIR_TRAIN_S,
                                     global_batch=CP_PAIR_TRAIN_B,
                                     seed=SEED + 175))
    batches = [ds.next_batch()]
    del params
    torch.cuda.empty_cache()
    with bench.fp32_exact():
        one = None
        if rank == 0:
            one = _quad_run(cfg, opt, batches, SEED + 175, mesh, None)
            torch.cuda.empty_cache()
        dist.barrier()
        cp_batches = [{k: np.ascontiguousarray(trainer.seq_rows(
            v, 2, mesh.model_rank)) for k, v in b.items()} for b in batches]
        mp = _quad_run(cfg, opt, cp_batches, SEED + 175, mesh, plan)
    out["train"] = {"losses": mp[0], "collectives": mp[3],
                    "contract": sorted(plan.rules.contract_axes),
                    "seq": plan.rules.seq,
                    "secs": {k: round(v, 1) for k, v in mp[4].items()}}
    if rank == 0:
        out["train"]["one_secs"] = {k: round(v, 1)
                                    for k, v in one[4].items()}
    if rank == 0:
        lrs = [float(adamw.schedule(opt, torch.tensor(1)))]
        out["train"]["held"] = _bounded(mp[2], one[2], mp[0], one[0], lrs)
    return out


def cp_gloo_pair() -> dict:
    """Phase 17 (b): ``cp_pair_rank`` on 2 spawned gloo ranks sharing the
    card, checked and logged. Returns the ranks' mha launches in the
    prefill (each rank's ``CP_LAYERS``)."""
    import tempfile

    from repro_torch.launch.mesh import run_world
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        res = run_world(cp_pair_rank, 2, backend="gloo",
                        init_file=os.path.join(tmp, "rdv"), timeout=900)
    one = res[0]["one"]
    want = one["first"]
    worst = max(float(np.abs(r["cp"]["first"] - want).max()) for r in res)
    close = all(np.allclose(r["cp"]["first"], want, atol=2e-5, rtol=2e-5)
                for r in res)
    scale = float(np.abs(want).max())
    train = res[0]["train"]
    log(f"context parallelism [2 gloo ranks on cuda:0, the sequence over "
        f"model; qwen2.5-3b full width, {CP_LAYERS} layers, fp32]: a "
        f"{CP_S}-token prefill, each rank's {CP_S // 2} queries at q_offset "
        f"{[r['rank'] * CP_S // 2 for r in res]}: last-position logits "
        f"within {worst:.3g} of one device's (scale {scale:.3g}; CPU bound "
        f"atol = rtol = 2e-5: {close}); mha launches a rank "
        f"{[r['cp']['launches'].get('mha') for r in res]}, one device "
        f"{one['launches'].get('mha')}; lanes of {res[0]['cp']['lane_rows']} "
        f"rows a rank; {CP_STEPS} greedy decode steps: "
        f"{[r['cp']['toks'] for r in res]}, one device {one['toks']}; s "
        f"(prefill, decode) a rank {[r['cp']['s'] for r in res]}, one "
        f"device {one['s']}; collectives a rank {res[0]['cp']['collectives']}"
        f"; train step at the layout (contract {train['contract']}, seq "
        f"{train['seq']}): {train['held']['words']}, collectives "
        f"{train['collectives']}, s on rank 0 {train['secs']}, one device "
        f"{train['one_secs']}; {time.perf_counter() - t0:.1f} s with "
        f"spawning")
    if not close:
        fail("context parallelism: the two ranks' prefill logits part from "
             "one device's")
    if any(r["cp"]["toks"] != one["toks"] for r in res):
        fail("context parallelism: the decode tokens part from one device's")
    if any(r["cp"]["launches"].get("mha") != CP_LAYERS for r in res):
        fail("context parallelism: a rank's prefill did not launch mha "
             "once a layer")
    if any(r["train"]["losses"] != train["losses"] for r in res) \
            or not train["held"]["ok"]:
        fail("context parallelism: the train step is outside the bounds")
    return {"mha": res[0]["cp"]["launches"].get("mha", 0)}


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
    # phase 9, from generators of its own
    t9 = time.perf_counter()
    own = np.random.default_rng(SEED + 50)
    err_mha_win = check_mha_window(own)
    err_paged_win = check_paged_window(own)
    mha_win_t = time_mha_window(own, torch.bfloat16)
    time_mha_window(own, torch.float32)
    paged_win_t = time_paged_window(own, 1)
    time_paged_window(own, 5)
    check_hybrid_exact()
    hybrid_counts = serve_hybrid("recurrentgemma-9b")
    serve_hybrid("mamba2-2.7b")
    run_serve_bench_hybrid()
    log(f"phase 9 in {time.perf_counter() - t9:.1f} s")
    # phase 10: the host tier
    t10 = time.perf_counter()
    check_tier_exact()
    check_swap_race()
    cfg = get_config("qwen2.5-3b")
    params = api.init_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(SEED), device="cuda")
    check_bf16_swap_stream(cfg, params)
    check_spec_gap(cfg, params)
    del params
    tier_counts = serve_tier("qwen2.5-3b", prompts)
    for k in ("paged_attention", "mha", "sampler_noise"):
        if not tier_counts.get(k):
            fail(f"host tier: the tiered run launched no {k}")
    serve_tier("recurrentgemma-9b", prompts)
    serve_tier("mamba2-2.7b", prompts)
    run_serve_bench_oversubscribe()
    log(f"phase 10 in {time.perf_counter() - t10:.1f} s")
    # phase 11: MoE and vlm stacks, from generators of their own
    t11 = time.perf_counter()
    own = np.random.default_rng(SEED + 80)
    moe_errs = check_moe_kernels(own)
    moe_times = time_moe_kernels(own)
    check_moe_exact()
    check_vlm_prefill()
    moe_counts = {arch: serve_moe(arch, prompts) for arch in NEW_ARCHS}
    for arch, c in moe_counts.items():
        for k in ("paged_attention", "mha", "sampler_noise"):
            if not c.get(k):
                fail(f"serve {arch}: the run launched no {k}")
    log(f"phase 11 in {time.perf_counter() - t11:.1f} s")
    # phase 12: the dense-slot engine and seamless, generators of their own
    t12 = time.perf_counter()
    own = np.random.default_rng(SEED + 90)
    err_dense = check_dense_mha(own)
    dense_times = time_dense_mha(own)
    check_dense_exact()
    dense_counts = serve_dense(prompts)
    check_seamless_fp32()
    seamless_counts = run_seamless()
    for name, c in (("dense serve", dense_counts),
                    ("seamless", seamless_counts)):
        for k in ("mha", "sampler_noise") if name == "dense serve" \
                else ("mha",):
            if not c.get(k):
                fail(f"{name}: the run launched no {k}")
    log(f"phase 12 in {time.perf_counter() - t12:.1f} s")
    # phase 13: tensor parallelism and the router, generators of their own
    t13 = time.perf_counter()
    own = np.random.default_rng(SEED + 130)
    tp_prompts = prompts[:TP_REQ]
    tp_lengths = [len(p) for p in tp_prompts]
    tp_errs = check_tp_kernels(own, tp_lengths)
    tp_times = (
        time_paged(own, len(tp_lengths), tp_lengths,
                   f"tp2 shard heads H8 KV1 D128, B={len(tp_lengths)}, "
                   f"contexts {min(tp_lengths)}-{max(tp_lengths)}, fp32",
                   heads=TP_HEADS, dtype=torch.float32),
        time_mha(own, 512, "tp2 shard heads H8 KV1 D128, prefill bucket "
                 "512, fp32", heads=TP_HEADS, dtype=torch.float32))
    tp_counts = serve_tp(tp_prompts)
    for k in ("paged_attention", "mha", "sampler_noise"):
        if not tp_counts.get(k):
            fail(f"tp: the two-rank run launched no {k}")
    log(f"phase 13 in {time.perf_counter() - t13:.1f} s")
    # phase 14: single-device training, generators of their own
    t14 = time.perf_counter()
    own = np.random.default_rng(SEED + 140)
    wrappers_refuse_grad()
    with bench.fp32_exact():
        check_train_exact()
    plain_busy = train_full_width()
    serve_case = [(f"train -> serve prefill B{SERVE_B} S{SERVE_S}, causal, "
                   f"fp32", SERVE_B, SERVE_S, SERVE_S, True, None,
                   torch.float32)]
    err_train_mha = check_mha(own, serve_case)
    train_mha_t = time_mha(own, SERVE_S, f"train -> serve prefill, B="
                           f"{SERVE_B}, Sq=Sk={SERVE_S}, fp32",
                           dtype=torch.float32, B=SERVE_B)
    with bench.fp32_exact():
        train_counts = check_train_serve(own)
    log(f"phase 14 in {time.perf_counter() - t14:.1f} s")
    # phase 16's CLIs trace on the host's cores while phase 15 runs
    clis = start_dryrun_clis()
    try:
        # phase 15: model- and data-parallel training
        t15 = time.perf_counter()
        train_world1_nccl(plain_busy)
        train_gloo_quad()
        log(f"phase 15 in {time.perf_counter() - t15:.1f} s")
        # phase 16: the dry-run, plain and --optimized (phase 17 (c))
        t16 = time.perf_counter()
        dryrun_phase(clis)
        log(f"phase 16 in {time.perf_counter() - t16:.1f} s (its CLIs "
            f"started with phase 15)")
    finally:
        stop(clis)
    # phase 17: context parallelism, generators of their own
    t17 = time.perf_counter()
    own = np.random.default_rng(SEED + 170)
    err_cp = check_mha_cp(own)
    cp_t = time_mha_cp(own)
    cp_world1_nccl()
    cp_counts = cp_gloo_pair()
    log(f"phase 17 in {time.perf_counter() - t17:.1f} s")
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
        {"name": "mha[window 2048, D 256, recurrentgemma-9b prefill]",
         "route": "cuda", "source": "src/repro_torch/kernels/csrc/mha.cu",
         "replaces": "src/repro/kernels/attention.py:32",
         "launches": hybrid_counts["mha"], "max_abs_err": err_mha_win,
         "ms": mha_win_t[0], "plain_ms": mha_win_t[1],
         "bound_ms": mha_win_t[2], "bound_by": mha_win_t[3],
         "library_ms": mha_win_t[4]},
        {"name": "paged_attention[window 2048, G 16, D 256, "
                 "recurrentgemma-9b decode]", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:78",
         "launches": hybrid_counts["paged_attention"],
         "max_abs_err": err_paged_win, "ms": paged_win_t[0],
         "plain_ms": paged_win_t[1], "bound_ms": paged_win_t[2],
         "bound_by": paged_win_t[3], "library_ms": None},
        {"name": "paged_attention[host tier, qwen2.5-3b tiered@cap]",
         "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:78",
         "launches": tier_counts["paged_attention"],
         "max_abs_err": err_paged, "ms": paged_t[0],
         "plain_ms": paged_t[1], "bound_ms": paged_t[2],
         "bound_by": paged_t[3], "library_ms": None},
        {"name": "mha[host tier, qwen2.5-3b tiered@cap]", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/mha.cu",
         "replaces": "src/repro/kernels/attention.py:32",
         "launches": tier_counts["mha"], "max_abs_err": err_mha,
         "ms": mha_t[0], "plain_ms": mha_t[1], "bound_ms": mha_t[2],
         "bound_by": mha_t[3], "library_ms": mha_t[4]},
    ] + moe_kernel_entries(moe_errs, moe_times, moe_counts)
        + dense_kernel_entries(err_dense, dense_times, dense_counts,
                               seamless_counts)
        + tp_kernel_entries(tp_errs, tp_times, tp_counts)
        + [{"name": f"mha[train -> serve prefill, qwen2.5-3b 4 layers, "
                    f"B{SERVE_B} S{SERVE_S} fp32]", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/mha.cu",
            "replaces": "src/repro/kernels/attention.py:32",
            "launches": train_counts["mha"], "max_abs_err": err_train_mha,
            "ms": train_mha_t[0], "plain_ms": train_mha_t[1],
            "bound_ms": train_mha_t[2], "bound_by": train_mha_t[3],
            "library_ms": train_mha_t[4]},
           {"name": f"mha[context-parallel rank block, qwen2.5-3b "
                    f"{CP_LAYERS} layers, Sq {CP_MHA[1]} at q_offset "
                    f"{CP_MHA[2]}, Sk {CP_MHA[3]}]", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/mha.cu",
            "replaces": "src/repro/kernels/attention.py:32",
            "launches": cp_counts["mha"], "max_abs_err": err_cp,
            "ms": cp_t[0], "plain_ms": cp_t[1], "bound_ms": cp_t[2],
            "bound_by": cp_t[3], "library_ms": cp_t[4]}] + layer}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
