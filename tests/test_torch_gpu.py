"""The port's CUDA kernels and engine on the card, against their plain
PyTorch versions (run there: ``PYTHONPATH=src python -m pytest -m gpu
tests/test_torch_*.py``). Every test is marked ``gpu`` and skips, inside
its fixture, when no CUDA device is present. Imports no jax: the card's
machine runs the port alone."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import attention as mha_kernel  # noqa: E402
from repro_torch.kernels import conv_im2col as conv_kernel  # noqa: E402
from repro_torch.kernels import gemm_os as gemm_kernel  # noqa: E402
from repro_torch.kernels import maxpool as pool_kernel  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import paged_attention as paged_kernel  # noqa: E402
from repro_torch.kernels import reshuffle as reshuffle_kernel  # noqa: E402
from repro_torch.kernels import sampler as sampler_kernel  # noqa: E402
from repro_torch.launch import kernel_bench  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import sampling, trainer  # noqa: E402
from repro_torch.data.synthetic import DataConfig, SyntheticDataset  # noqa
from repro_torch.runtime.drafter import DraftModelDrafter  # noqa: E402
from repro_torch.runtime.scheduler import Scheduler  # noqa: E402
from repro_torch.runtime.serving import (DenseServingEngine,  # noqa: E402
                                         PagedServingEngine, Request)
from torch_cases import (BLOCKED_CASES, CONV_SPECS,  # noqa: E402
                         EPILOGUE_EDGES, F32, GEMM_SHAPES, MASK_PROBES,
                         dying_traffic,
                         MHA_CASES, OP_NAMES, PAGED_CASES, POOL_SPECS,
                         QUANT_SCALES, op_calls_on,
                         STEM_SPEC, TC_GEMM_SHAPES, TRANSPOSE_SHAPES,
                         epilogue_inputs, gemm_inputs, int8_extremes,
                         int8, mha_inputs, normal, paged_case,
                         paged_inputs, pool_input)


# gemm_os's fp32 path with its depth split over CTAs (the launcher's plan on
# an H100's 132 SMs): the kernel bench's 128 x 4096 x 128 (4 output tiles),
# M = N = 1, and a depth that is no multiple of a range or a stage.
SPLIT_GEMM_SHAPES = [(128, 4096, 128), (1, 4096, 1), (100, 4099, 72)]
# ResNet-50 stage 3 and the kernel bench's conv row, batch 2: fp32 splits
# each tile's taps over CTAs there. (H, W, C, K, R, stride).
CONV_PAPER_SPECS = [(28, 28, 128, 128, 3, 1), (28, 28, 64, 128, 3, 1)]


def assert_agrees(got, want):
    """fp32: summation order only. bf16: on every query row, within
    ref.ROW_TOL of the row's largest reference output (rounding of the bf16
    output, and of P in mha)."""
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, **F32)
    else:
        worst = ref.row_error(got, want).max().item()
        assert worst <= ref.ROW_TOL[got.dtype], worst


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def fp32_exact(cuda):
    """The card's fp32 plain versions in full fp32: TF32 off for cuBLAS
    and cuDNN (cuDNN's default is on)."""
    with kernel_bench.fp32_exact():
        yield cuda


def launched_once(counter, fn):
    """fn()'s result, asserting that it launched its kernel exactly once:
    ``counter()`` reads the launch count."""
    before = counter()
    out = fn()
    torch.cuda.synchronize()
    assert counter() == before + 1
    return out


# ---------------------------------------------------------------------------
# On the card: the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(PAGED_CASES))
def test_cuda_paged_matches_plain(cuda, name, dtype):
    (q, kp, vp, table, lens), kw = paged_inputs(name)
    dt = getattr(torch, dtype)
    q = torch.from_numpy(q).to(cuda, dt)
    kp, vp = (torch.from_numpy(x).to(cuda) for x in (kp, vp))
    if kp.is_floating_point():
        kp, vp = kp.to(dt), vp.to(dt)
    table, lens = torch.from_numpy(table).to(cuda), \
        torch.from_numpy(lens).to(cuda)
    before = paged_kernel.paged_attention.launches
    got = ops.paged_attention(q, kp, vp, table, lens, **kw)
    torch.cuda.synchronize()
    assert paged_kernel.paged_attention.launches == before + 1
    want = ref.paged_attention_ref(q, kp, vp, table, lens, **kw)
    assert_agrees(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("types", [("bfloat16", "float32"),
                                   ("float32", "bfloat16")])
@pytest.mark.parametrize("name", sorted(n for n, c in PAGED_CASES.items()
                                        if "kv_scale" not in c[-1]))
def test_cuda_paged_mixed_dtype_pairs_match_plain(cuda, name, types):
    """q in one float type over pools in the other: pairs the JAX kernel
    takes (both run on the FMA body)."""
    qt, pt = (getattr(torch, t) for t in types)
    (q, kp, vp, table, lens), kw = paged_inputs(name)
    q = torch.from_numpy(q).to(cuda, qt)
    kp, vp = (torch.from_numpy(x).to(cuda, pt) for x in (kp, vp))
    table, lens = (torch.from_numpy(x).to(cuda) for x in (table, lens))
    got = launched_once(lambda: paged_kernel.paged_attention.launches,
                        lambda: ops.paged_attention(q, kp, vp, table, lens,
                                                    **kw))
    assert got.dtype == qt
    assert_agrees(got, ref.paged_attention_ref(q, kp, vp, table, lens, **kw))


# Shapes at serving widths (16 query heads over 2 KV heads, head dim 128,
# pages of 16) where the split plan on an H100's 132 SMs takes S = 1 (B *
# KV = 132), an intermediate S (5) and the largest (8); ragged lengths,
# the short ones leaving ranges empty. (B, n_blocks, lengths, S).
PAGED_SPLIT_SHAPES = [
    (66, 8, [1 + 127 * b // 65 for b in range(66)], 1),
    (16, 32, [1, 17, 100, 230, 333, 400, 511, 512] * 2, 5),
    (1, 64, [1000], 8),
    (2, 64, [3, 1000], 8),
]


def split_case(B, n_blocks, lengths, dtype, dev):
    q, kp, vp, table, lens = paged_case(B + n_blocks, B, 1, 16, 2, 128, 16,
                                        n_blocks, lengths, poison=True)
    q, kp, vp = (torch.from_numpy(x).to(dev, dtype) for x in (q, kp, vp))
    return q, kp, vp, torch.from_numpy(table).to(dev), \
        torch.from_numpy(lens).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", PAGED_SPLIT_SHAPES)
def test_cuda_paged_split_matches_split_ref(cuda, shape, dtype):
    """At the plan's S the kernel agrees with its summation structure
    (``ref.paged_attention_split_ref``): fp32 within 1e-5 of each row's
    largest output; and with the dense oracle within ref.ROW_TOL."""
    B, n_blocks, lengths, S = shape
    dt = getattr(torch, dtype)
    args = split_case(B, n_blocks, lengths, dt, cuda)
    assert paged_kernel.split_plan(B, 2, n_blocks, 16, 8, build.
                                   sm_count(cuda.index or 0)) == S
    got = launched_once(lambda: paged_kernel.paged_attention.launches,
                        lambda: ops.paged_attention(*args))
    split = ref.paged_attention_split_ref(*args, splits=S)
    tol = 1e-5 if dt == torch.float32 else ref.ROW_TOL[dt]
    assert ref.row_error(got, split).max().item() <= tol
    assert_agrees(got, ref.paged_attention_ref(*args))


# The batch at which the plan on an H100's 132 SMs takes each S from 2 to 7
# at serving heads (2 KV heads, 8 query rows): S = ceil(132 / (2 B)).
PLAN_BATCHES = {2: 33, 3: 22, 4: 17, 5: 14, 6: 11, 7: 10}


@pytest.mark.gpu
@pytest.mark.parametrize("splits", sorted(PLAN_BATCHES))
def test_cuda_paged_every_split_matches_split_ref(cuda, splits):
    """Each S from 2 to 7, reached through the plan by the batch, on ragged
    fp32 inputs whose short requests leave ranges empty."""
    B = PLAN_BATCHES[splits]
    lengths = [(1, 15, 16, 17, 200, 333, 600, 1000)[b % 8] for b in range(B)]
    args = split_case(B, 64, lengths, torch.float32, cuda)
    assert paged_kernel.split_plan(B, 2, 64, 16, 8, build.sm_count(
        cuda.index or 0)) == splits
    got = launched_once(lambda: paged_kernel.paged_attention.launches,
                        lambda: paged_kernel.paged_attention(*args))
    split = ref.paged_attention_split_ref(*args, splits=splits)
    assert ref.row_error(got, split).max().item() <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("B", [2, 66])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_paged_long_table_matches_split_ref(cuda, dtype, B):
    """Pages of 4 keys (a 16-key tile spans four) in a table of 600: the
    kernel stages 256 table entries at a time and moves the window along
    the range; at B = 2 the plan splits the sweep 8 ways, at B = 66 not."""
    dt = getattr(torch, dtype)
    lengths = [(2397, 1000)[b % 2] for b in range(B)]
    q, kp, vp, table, lens = paged_case(3, B, 1, 16, 2, 128, 4, 600,
                                        lengths, poison=True)
    args = (torch.from_numpy(q).to(cuda, dt),
            *(torch.from_numpy(x).to(cuda, dt) for x in (kp, vp)),
            torch.from_numpy(table).to(cuda), torch.from_numpy(lens).to(cuda))
    got = launched_once(lambda: paged_kernel.paged_attention.launches,
                        lambda: paged_kernel.paged_attention(*args))
    S = paged_kernel.split_plan(B, 2, 600, 4, 8, build.sm_count(
        cuda.index or 0))
    assert S == (8 if B == 2 else 1)
    tol = 1e-5 if dt == torch.float32 else ref.ROW_TOL[dt]
    split = ref.paged_attention_split_ref(*args, splits=S)
    assert ref.row_error(got, split).max().item() <= tol
    assert_agrees(got, ref.paged_attention_ref(*args))


# Head dims past 256 (the wide body, every pair): (D, T, q dtype, pool
# dtype, kwargs); 1432 is the largest that bf16 pools take.
WIDE_HEAD_CASES = [
    (272, 1, "float32", "float32", {}),
    (512, 2, "bfloat16", "bfloat16", {"window": 20}),
    (1024, 1, "float32", "int8", {"kv_scale": 8.0}),
    (1432, 3, "bfloat16", "float32", {}),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", WIDE_HEAD_CASES)
def test_cuda_paged_wide_head_dims_match_plain(cuda, case):
    """Head dims up to MAX_HEAD_DIM, ragged lengths and empty ranges (the
    plan splits the sweep 4 ways), against the dense oracle."""
    D, T, qt, pt, kw = case
    q, kp, vp, table, lens = paged_case(D, 3, T, 4, 2, D, 16, 8,
                                        [T, 40, 120], poison=True)
    q = torch.from_numpy(q).to(cuda, getattr(torch, qt))
    if pt == "int8":
        kp, vp = (torch.from_numpy(int8(x, kw["kv_scale"])).to(cuda)
                  for x in (kp, vp))
    else:
        kp, vp = (torch.from_numpy(x).to(cuda, getattr(torch, pt))
                  for x in (kp, vp))
    table, lens = (torch.from_numpy(x).to(cuda) for x in (table, lens))
    got = launched_once(lambda: paged_kernel.paged_attention.launches,
                        lambda: ops.paged_attention(q, kp, vp, table, lens,
                                                    **kw))
    assert_agrees(got, ref.paged_attention_ref(q, kp, vp, table, lens, **kw))


@pytest.mark.gpu
def test_cuda_paged_refuses_head_dims_past_its_limit(cuda):
    D = paged_kernel.MAX_HEAD_DIM + 2
    q = torch.zeros((1, 2, D), device=cuda)
    kp = torch.zeros((2, 16, 1, D), device=cuda)
    with pytest.raises(ValueError, match="D >"):
        paged_kernel.paged_attention(q, kp, kp, torch.zeros(
            (1, 1), dtype=torch.int32, device=cuda), 1)


@pytest.mark.gpu
def test_cuda_paged_takes_lengths_in_any_form(cuda):
    """lengths as an int32 tensor on the card, on the host, as int64 and as
    a list: the same bits."""
    args = split_case(8, 64, [1, 17, 100, 230, 333, 400, 511, 512],
                      torch.bfloat16, cuda)
    want = paged_kernel.paged_attention(*args)
    lens = args[-1]
    for other in (lens.cpu(), lens.long(), lens.tolist()):
        got = paged_kernel.paged_attention(*args[:-1], other)
        torch.cuda.synchronize()
        assert ref.bitwise_equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_paged_two_runs_give_the_same_bits(cuda, dtype):
    """The ranks' partials merge in rank order, the warps' in warp order,
    with no atomics: the same inputs give the same bits."""
    args = split_case(8, 64, [237, 300, 350, 400, 450, 500, 550, 584],
                      getattr(torch, dtype), cuda)
    first = paged_kernel.paged_attention(*args)
    second = paged_kernel.paged_attention(*args)
    torch.cuda.synchronize()
    assert ref.bitwise_equal(first, second)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", MHA_CASES)
def test_cuda_mha_matches_plain(cuda, shape, causal, dtype):
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to(cuda, dt)
               for x in mha_inputs(sum(shape), *shape))
    valid = torch.tensor([shape[2] - 3] * shape[0], dtype=torch.int32,
                         device=cuda)
    for kv_valid in (None, valid):
        before = mha_kernel.mha.launches
        got = ops.attention(q, k, v, causal=causal, kv_valid=kv_valid)
        torch.cuda.synchronize()
        assert mha_kernel.mha.launches == before + 1
        want = ref.mha_ref(q, k, v, causal=causal, kv_valid=kv_valid)
        assert_agrees(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("probe", MASK_PROBES)
def test_cuda_mha_bf16_agrees_where_a_mask_shift_shows(cuda, probe):
    """On inputs whose scores peak on one key, the bf16 kernel agrees with
    its plain version per row, and the plain version with its mask shifted
    by one key misses ref.ROW_TOL on every row: an off-by-one mask in the
    kernel could not pass."""
    kind, B, S, H, KV, D, valid = probe
    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16)
               for x in ref.peaked_mha_inputs(
                   np.random.default_rng(S + D), B, S, H, KV, D,
                   last_key=None if valid is None
                   else [n - 1 for n in valid]))
    causal = kind == "causal"
    kv_valid = None if valid is None else torch.tensor(
        valid, dtype=torch.int32, device=cuda)
    got = launched_once(lambda: mha_kernel.mha.launches,
                        lambda: ops.attention(q, k, v, causal=causal,
                                              kv_valid=kv_valid))
    want = ref.mha_ref(q, k, v, causal=causal, kv_valid=kv_valid)
    assert_agrees(got, want)
    if causal:
        shifted = ref.mha_ref(q[:, 1:], k[:, :-1], v[:, :-1], causal=True)
        want = want[:, 1:]
    else:
        shifted = ref.mha_ref(q, k, v, causal=False, kv_valid=kv_valid - 1)
    assert ref.row_error(shifted, want).min().item() > \
        ref.ROW_TOL[torch.bfloat16]


# fp32 mha: (B, Sq, Sk) with per-batch kv_valid (0 and 1 among them), at
# (H, KV) = (4, 2); Sq != Sk both ways, Sq = 1, and a q block cut by Sq
F32_MHA_SHAPES = [(3, 130, 300, [0, 1, 257]), (3, 1, 77, [1, 0, 77]),
                  (2, 150, 70, [70, 1]), (2, 257, 257, [0, 200])]


def assert_rows_agree(got, want):
    worst = ref.row_error(got, want).max().item()
    assert worst <= ref.ROW_TOL[got.dtype], worst


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("shape", F32_MHA_SHAPES)
def test_cuda_mha_f32_matches_plain_per_row(cuda, shape, D, causal):
    """The fp32 kernel at every head dim it builds, within ref.ROW_TOL of
    its plain version on every query row, with kv_valid None, an int and
    a (B,) tensor holding 0 and 1: a fully masked row is 0."""
    B, Sq, Sk, valid = shape
    q, k, v = (torch.from_numpy(x).to(cuda)
               for x in mha_inputs(Sq + Sk + D, B, Sq, Sk, 4, 2, D))
    for kv_valid in (None, 1, torch.tensor(valid, dtype=torch.int32,
                                            device=cuda)):
        got = launched_once(lambda: mha_kernel.mha.launches,
                            lambda: ops.attention(q, k, v, causal=causal,
                                                  kv_valid=kv_valid))
        want = ref.mha_ref(q, k, v, causal=causal, kv_valid=kv_valid)
        assert_rows_agree(got, want)
        if isinstance(kv_valid, torch.Tensor) and 0 in valid:
            assert not got[valid.index(0)].any()   # kv_valid 0: rows are 0


@pytest.mark.gpu
@pytest.mark.parametrize("rg", [2, 4])
@pytest.mark.parametrize("D", [16, 32, 64])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_mha_f32_every_plan_matches_plain(cuda, rg, D, causal):
    """Both layouts the fp32 plan picks from (64-row blocks in 2 key splits,
    32-row blocks in 4), launched through the C entry point whatever the
    plan would take, agree with the plain version per row."""
    B, Sq, Sk, H, KV = 2, 200, 230, 4, 2
    q, k, v = (torch.from_numpy(x).to(cuda)
               for x in mha_inputs(rg + D, B, Sq, Sk, H, KV, D))
    valid = torch.tensor([230, 97], dtype=torch.int32, device=cuda)
    out = torch.empty_like(q)
    err = build.launch_on(q.device, mha_kernel._lib().mha_fwd_launch,
                          q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          valid.data_ptr(), out.data_ptr(), B, Sq, Sk, H, KV,
                          D, 0, int(causal), D ** -0.5, rg)
    assert err == 0
    torch.cuda.synchronize()
    assert_rows_agree(out, ref.mha_ref(q, k, v, causal=causal,
                                       kv_valid=valid))


@pytest.mark.gpu
@pytest.mark.parametrize("heads", [(8, 2, 64), (16, 2, 128)],
                         ids=["bench", "serve"])
def test_cuda_mha_f32_two_runs_give_the_same_bits(cuda, heads):
    """Each output sums its keys in one order (tiles ascending within a key
    split, the splits merged in ascending order), so the same inputs give
    the same bits: the kernel bench's row and the serving heads, 1024
    causal."""
    H, KV, D = heads
    q, k, v = (torch.from_numpy(x).to(cuda)
               for x in mha_inputs(H + D, 1, 1024, 1024, H, KV, D))
    first = mha_kernel.mha(q, k, v, causal=True)
    second = mha_kernel.mha(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert ref.bitwise_equal(first, second)


@pytest.mark.gpu
@pytest.mark.parametrize("heads", [(8, 2, 64), (16, 2, 128)],
                         ids=["bench", "serve"])
def test_cuda_mha_f32_agrees_where_a_mask_shift_shows(cuda, heads):
    """At 1024 causal the fp32 kernel agrees per row, and its plain version
    with the causal mask shifted by one key misses ref.ROW_TOL[float32] on
    every row: an off-by-one mask in the kernel could not pass."""
    H, KV, D = heads
    q, k, v = (torch.from_numpy(x).to(cuda)
               for x in mha_inputs(H * D, 1, 1024, 1024, H, KV, D))
    got = launched_once(lambda: mha_kernel.mha.launches,
                        lambda: ops.attention(q, k, v, causal=True))
    want = ref.mha_ref(q, k, v, causal=True)
    assert_rows_agree(got, want)
    shifted = ref.mha_ref(q[:, 1:], k[:, :-1], v[:, :-1], causal=True)
    assert ref.row_error(shifted, want[:, 1:]).min().item() > \
        ref.ROW_TOL[torch.float32]


def tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, dev) for v in tree]
    return tree.to(dev)


class UncapturedEngine(PagedServingEngine):
    """The engine with its step body run as it is on the card, uncaptured:
    what the CUDA graph must reproduce."""

    def _dispatch(self):
        self._step_body()


def smoke_fp32(arch="qwen2.5-3b"):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    return cfg, api.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")


def preempting_traffic():
    return [Request(rid=0, prompt=[5, 4, 3, 2, 1, 6, 7], max_new=8),
            Request(rid=1, prompt=[1, 2, 3, 4, 5, 6], max_new=8)]


def serve_on(cls, cfg, params, dev, reqs, **kw):
    """(tokens, engine, launches over the run) of ``reqs`` through a
    ``cls`` engine on ``dev``."""
    kw = dict(dict(slots=2, max_len=32, page_size=4, num_pages=4), **kw)
    eng = cls(cfg, tree_to(params, dev), device=dev, **kw)
    before = ops.launch_counts()
    eng.run_to_completion(reqs, max_steps=400)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    eng.alloc.check_no_aliasing()
    return ([r.generated for r in reqs], eng,
            {k: after[k] - before[k] for k in after})


@pytest.mark.gpu
@pytest.mark.parametrize("attn_impl", ["kernel", "gather"])
@pytest.mark.parametrize("arch", ["yi-6b", "qwen1.5-4b", "qwen2.5-3b",
                                  "granite-3-2b", "dbrx-132b",
                                  "llama4-maverick-400b-a17b",
                                  "internvl2-2b"])
def test_cuda_engine_tokens_equal_cpu_engine(cuda, arch, attn_impl):
    """fp32 smoke model: the engine on the card (its decode step a replayed
    CUDA graph) emits the CPU engine's greedy tokens (plain versions),
    through a preemption, and launches each kernel once per layer per
    decode step / prefill (the gather baseline: no paged kernel)."""
    cfg, params = smoke_fp32(arch)
    want, _, _ = serve_on(PagedServingEngine, cfg, params, "cpu",
                          preempting_traffic(), attn_impl=attn_impl)
    got, eng, launched = serve_on(PagedServingEngine, cfg, params, cuda,
                                  preempting_traffic(), attn_impl=attn_impl)
    paged = cfg.num_layers * eng.decode_steps if attn_impl == "kernel" \
        else 0
    assert launched["paged_attention"] == paged
    assert launched["mha"] == cfg.num_layers * eng.prefills
    assert eng.step_traces == 1
    assert got == want


@pytest.mark.gpu
@pytest.mark.parametrize("attn_impl", ["kernel", "gather"])
@pytest.mark.parametrize("max_len,page", [(32, 4), (256, 16)])
def test_cuda_graph_replay_equals_uncaptured_body(cuda, attn_impl, max_len,
                                                  page):
    """The replayed graph emits the tokens of the same step body run
    uncaptured on the card, through admissions between steps, finishes and
    a preemption. At max_len 256, page 16 the paged kernel's plan cuts each
    request's pages over a cluster of CTAs (splits > 1), so the cluster
    launch is captured and replayed."""
    cfg, params = smoke_fp32()
    kw = dict(attn_impl=attn_impl, max_len=max_len, page_size=page,
              num_pages=4 if max_len == 32 else 24)

    def traffic():
        n = 7 if max_len == 32 else 150
        return [Request(rid=i, prompt=[(3 * i + 5 * j) % cfg.vocab
                                       for j in range(n - i)], max_new=8 + i)
                for i in range(3)]

    if attn_impl == "kernel" and max_len == 256:
        assert paged_kernel.split_plan(
            2, cfg.kv_heads, max_len // page, page,
            cfg.num_heads // cfg.kv_heads,
            build.sm_count(torch.cuda.current_device())) > 1
    want, ref_eng, _ = serve_on(UncapturedEngine, cfg, params, cuda,
                                traffic(), **kw)
    got, eng, _ = serve_on(PagedServingEngine, cfg, params, cuda, traffic(),
                           **kw)
    assert ref_eng.step_traces == 0 and eng.step_traces == 1
    assert got == want


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["dbrx-132b", "llama4-maverick-400b-a17b",
                                  "internvl2-2b"])
def test_cuda_moe_vlm_graph_replay_equals_uncaptured_body(cuda, arch):
    """The MoE and vlm stacks' replayed graph (routing, dispatch, experts
    and combine captured with the step) emits the tokens of the same step
    body run uncaptured on the card, through admissions, finishes and a
    preemption, with one capture."""
    cfg, params = smoke_fp32(arch)

    def traffic():
        return [Request(rid=i, prompt=[(3 * i + 5 * j) % cfg.vocab
                                       for j in range(7 - i)], max_new=8 + i)
                for i in range(3)]

    want, ref_eng, _ = serve_on(UncapturedEngine, cfg, params, cuda,
                                traffic())
    got, eng, _ = serve_on(PagedServingEngine, cfg, params, cuda, traffic())
    assert ref_eng.step_traces == 0 and eng.step_traces == 1
    assert got == want


def dying_requests(slots, vocab):
    return [Request(rid=i, prompt=p, max_new=b)
            for i, (p, b) in enumerate(dying_traffic(slots, vocab))]


@pytest.mark.gpu
def test_cuda_dbrx_dying_slots_equal_cpu_and_repeat(cuda):
    """dbrx SMOKE at 8 slots, where decode capacity binds with dead rows
    in the step: the card's graph emits the CPU engine's tokens (which
    tests/test_torch_moe.py holds against the JAX engine's), and a second
    run on the card emits them again: dead rows write the scratch page
    through the last-writer write, so nothing depends on the order the
    card applies duplicate writes in."""
    cfg, params = smoke_fp32("dbrx-132b")
    kw = dict(slots=8, num_pages=None)
    want, _, _ = serve_on(PagedServingEngine, cfg, params, "cpu",
                          dying_requests(8, cfg.vocab), **kw)
    runs = [serve_on(PagedServingEngine, cfg, params, cuda,
                     dying_requests(8, cfg.vocab), **kw)[0]
            for _ in range(2)]
    assert runs[0] == runs[1] == want


@pytest.mark.gpu
def test_cuda_last_writer_write_leaves_the_last_rows_value(cuda):
    """Three dead rows at one position write one scratch row in the same
    step on the card: it holds the last row's k/v (the row alone, written
    to a fresh pool), whatever order the card applies the writes in."""
    from repro_torch.models import layers
    cfg, params = smoke_fp32("dbrx-132b")
    attn = tree_to(params["blocks"][0]["attn"], cuda)
    x = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (3, 1, cfg.d_model)).astype(np.float32)).to(cuda)
    table = torch.zeros((3, 2), dtype=torch.int32, device=cuda)
    pos = torch.full((3,), 5, dtype=torch.int32, device=cuda)
    rows = layers.paged_rows(table, pos, 1, 4)
    rows_alone = layers.paged_rows(table[2:], pos[2:], 1, 4)
    for _ in range(3):
        pool = api.paged_cache_init(cfg, 3, 4, device=cuda)[0]
        layers.attention_decode(cfg, attn, x, pool, pos, table, rows)
        alone = api.paged_cache_init(cfg, 3, 4, device=cuda)[0]
        layers.attention_decode(cfg, attn, x[2:], alone, pos[2:], table[2:],
                                rows_alone)
        assert torch.equal(pool["k"][0, 1], alone["k"][0, 1])
        assert torch.equal(pool["v"][0, 1], alone["v"][0, 1])


@pytest.mark.gpu
def test_cuda_one_capture_through_admissions_finishes_and_preemption(cuda):
    """One capture serves the engine's life: requests admitted between
    steps, finished and preempted leave ``sampling.step_traces`` at 1, and
    ``reset_metrics`` keeps it (a lifetime fact)."""
    cfg, params = smoke_fp32()
    eng = PagedServingEngine(cfg, tree_to(params, cuda), slots=2,
                             max_len=32, page_size=4, num_pages=4,
                             device=cuda)
    sched = Scheduler(eng)
    reqs = preempting_traffic() + [Request(rid=2, prompt=[9, 8, 7],
                                           max_new=3)]
    for r in reqs:
        sched.add(r)
    sched.drain(max_steps=400)
    assert sched.preempted >= 1 and all(r.done for r in reqs)
    assert eng.metrics()["sampling.step_traces"] == 1.0
    eng.reset_metrics()
    eng.run_to_completion([Request(rid=3, prompt=[1, 2], max_new=4)])
    assert eng.metrics()["sampling.step_traces"] == 1.0


@pytest.mark.gpu
def test_cuda_graph_launches_are_counted_per_replay(cuda):
    """The wrappers count a launch only when called; the graph holds one
    paged launch per layer, which each replay adds, so the counters read
    layers x decode steps whatever the warm-up and capture did."""
    cfg, params = smoke_fp32()
    _, eng, launched = serve_on(PagedServingEngine, cfg, params, cuda,
                                preempting_traffic())
    assert eng._graph_launches == {"paged_attention": cfg.num_layers,
                                   "sampler_noise": 1}
    assert launched["paged_attention"] == cfg.num_layers * eng.decode_steps
    steps = eng.decode_steps
    before = ops.launch_counts()["paged_attention"]
    eng.run_to_completion([Request(rid=5, prompt=[3, 1, 4], max_new=4)])
    assert ops.launch_counts()["paged_attention"] - before == \
        cfg.num_layers * (eng.decode_steps - steps)


@pytest.mark.gpu
def test_cuda_gather_tokens_equal_kernel_tokens(cuda):
    """fp32 on the card: the dense-gather baseline and the flash-decode
    kernel, each inside the captured step, emit the same greedy tokens."""
    cfg, params = smoke_fp32()
    out = {impl: serve_on(PagedServingEngine, cfg, params, cuda,
                          preempting_traffic(), attn_impl=impl)[0]
           for impl in ("gather", "kernel")}
    assert out["gather"] == out["kernel"]


# ---------------------------------------------------------------------------
# On the card: the kernel layer against its plain versions
# ---------------------------------------------------------------------------


def assert_gemm_agrees(got, want, x, w):
    """int8 inputs: bitwise. Float: within ref.sum_order_error."""
    if x.dtype == torch.int8:
        assert ref.bitwise_equal(got, want)
    else:
        worst = ref.sum_order_error(got, want, ref.gemm_ref(
            x.abs().float(), w.abs().float()), x.shape[1]).item()
        assert worst <= 1, worst


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("mkn", GEMM_SHAPES + TC_GEMM_SHAPES +
                         SPLIT_GEMM_SHAPES)
def test_cuda_gemm_matches_plain(fp32_exact, mkn, dtype):
    M, K, N = mkn
    dt = getattr(torch, dtype)
    x, w = (torch.from_numpy(a).to(fp32_exact, dt) for a in gemm_inputs(
        sum(mkn), M, K, N, integer=dtype == "int8"))
    attr = "int8_launches" if dtype == "int8" else "launches"
    got = launched_once(lambda: getattr(gemm_kernel.gemm_os, attr),
                        lambda: ops.matmul(x, w))
    assert_gemm_agrees(got, ref.gemm_ref(x, w), x, w)


def offset_view(a: np.ndarray, dev, dtype, offset: bool):
    """``a`` on the card as a contiguous view whose data pointer is one
    element past a 16-byte boundary (offset=True), or as is."""
    if not offset:
        return torch.from_numpy(a).to(dev, dtype)
    buf = torch.empty(a.size + 1, dtype=dtype, device=dev)
    view = buf[1:].view(a.shape)
    view.copy_(torch.from_numpy(a).to(dtype))
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("which", ["x", "w", "both"])
def test_cuda_gemm_unaligned_view_matches_plain(cuda, which, dtype):
    """A contiguous view that starts off a 16-byte boundary takes the scalar
    loader though its shape (K, N multiples of 16) admits 16-byte copies:
    the launcher decides from the pointers."""
    dt = getattr(torch, dtype)
    xa, wa = gemm_inputs(7, 96, 256, 160, integer=dtype == "int8")
    x = offset_view(xa, cuda, dt, which in ("x", "both"))
    w = offset_view(wa, cuda, dt, which in ("w", "both"))
    got = ops.matmul(x, w)
    torch.cuda.synchronize()
    assert_gemm_agrees(got, ref.gemm_ref(x, w), x, w)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, scale, mkn", [
    pytest.param("bfloat16", None, (512, 768, 3072), id="bfloat16-None"),
    pytest.param("int8", None, (512, 3072, 768), id="int8-None"),
    pytest.param("int8", 0.002, (512, 3072, 768), id="int8-0.002"),
    pytest.param("float32", None, (512, 768, 3072), id="float32-ffn"),
    pytest.param("float32", None, (128, 4096, 128), id="float32-split")])
def test_cuda_gemm_two_runs_give_the_same_bits(cuda, dtype, scale, mkn):
    """Each output's sum has one order: one thread per output and depth
    range, and where the fp32 path splits the depth (128 x 4096 x 128) the
    partials are added in rank order by a second pass; no atomics. So the
    same inputs give the same bits (the FFN's shapes, and a split one)."""
    M, K, N = mkn
    x, w = (torch.from_numpy(a).to(cuda, getattr(torch, dtype))
            for a in gemm_inputs(11, M, K, N, integer=dtype == "int8"))
    first = gemm_kernel.gemm_os(x, w, quant_scale=scale)
    second = gemm_kernel.gemm_os(x, w, quant_scale=scale)
    torch.cuda.synchronize()
    assert ref.bitwise_equal(first, second)


@pytest.mark.gpu
def test_cuda_f32_plans_fill_the_card(cuda):
    """The fp32 launcher's plans (``f32_plan``): whole 16-deep stages per
    range, and enough CTAs for the 132 SMs where the tiles alone are few:
    128 x 4096 x 128 (4 tiles of 64 x 64) from 4 CTAs to at least 128,
    ResNet-50 stage 3 (26 tiles) to at least 130, its ranges whole taps or
    whole fractions of one."""
    sms = build.sm_count(cuda.index or 0)
    for M, K, N in [(128, 4096, 128), (1, 4096, 1), (100, 4099, 72),
                    (512, 768, 3072)]:
        bm, bn, chunk, splits = gemm_kernel.f32_plan(M, N, K, sms)
        assert chunk % 16 == 0 and splits == -(-K // chunk)
        if (M, K, N) == (128, 4096, 128):
            assert -(-M // bm) * -(-N // bn) * splits >= 128
    for H, W, C, K, R, _ in CONV_PAPER_SPECS:
        bm, bn, chunk, splits = conv_kernel.f32_plan(H * W, K, C, R, R, sms)
        assert chunk % C == 0 or C % chunk == 0
        assert -(-H * W // bm) * -(-K // bn) * splits >= 130


@pytest.mark.gpu
def test_cuda_f32_split_agrees_where_a_dropped_chunk_shows(fp32_exact):
    """128 x 4096 x 128 fp32, the depth split over CTAs: the kernel agrees
    with its plain version, which without 16 depth values from the middle
    of one range falls outside the same limit."""
    M, K, N = 128, 4096, 128
    xa, wa = gemm_inputs(13, M, K, N)
    x, w = (torch.from_numpy(a).to(fp32_exact) for a in (xa, wa))
    chunk = gemm_kernel.f32_plan(M, N, K, build.sm_count(
        fp32_exact.index or 0))[2]
    got = launched_once(lambda: gemm_kernel.gemm_os.launches,
                        lambda: ops.matmul(x, w))
    want = ref.gemm_ref(x, w)
    absp = ref.gemm_ref(x.abs(), w.abs())
    assert ref.sum_order_error(got, want, absp, K).item() <= 1
    mid = K // chunk // 2 * chunk + chunk // 2 - 8
    dropped = x.clone()
    dropped[:, mid:mid + 16] = 0
    assert ref.sum_order_error(ref.gemm_ref(dropped, w), want, absp,
                               K).item() > 1


@pytest.mark.gpu
def test_cuda_int8_extremes_accumulate_exactly(cuda):
    """K = 3072 with every input at +-127: sums up to 3072 * 127^2, exact
    in int32 through the tensor cores."""
    x, w = (torch.from_numpy(a).to(cuda)
            for a in int8_extremes(5, 64, 3072, 96))
    got = ops.matmul(x, w)
    torch.cuda.synchronize()
    assert int(got[0, 0]) == 3072 * 127 * 127
    assert ref.bitwise_equal(got, ref.gemm_ref(x, w))


@pytest.mark.gpu
def test_cuda_quant_epilogue_ties_and_saturation_exactly(cuda):
    """The epilogue's ties (acc * scale on .5, rounded to even) and its
    clipping beyond +-127, at a depth that takes the 16-byte copies."""
    (M, K, N), scale = EPILOGUE_EDGES
    x, w = (torch.from_numpy(a).to(cuda)
            for a in epilogue_inputs(6, M, K, N))
    got = launched_once(lambda: gemm_kernel.gemm_os.int8_launches,
                        lambda: ops.quant_matmul(x, w, scale))
    assert ref.bitwise_equal(got, ref.gemm_ref(x, w, quant_scale=scale))
    assert {-128, 127} <= set(got.unique().tolist())


@pytest.mark.gpu
@pytest.mark.parametrize("types", [("float32", "bfloat16"),
                                   ("bfloat16", "float32")])
@pytest.mark.parametrize("mkn", [(1, 512, 96), (257, 129, 65),
                                 (1000, 256, 1024), (512, 768, 3072)])
def test_cuda_gemm_out_dtype_matches_plain(fp32_exact, mkn, types):
    """An output type other than the inputs' (``out_dtype``), both ways."""
    M, K, N = mkn
    dt, out = (getattr(torch, t) for t in types)
    x, w = (torch.from_numpy(a).to(fp32_exact, dt)
            for a in gemm_inputs(sum(mkn), M, K, N))
    got = launched_once(lambda: gemm_kernel.gemm_os.launches,
                        lambda: ops.matmul(x, w, out_dtype=out))
    assert got.dtype == out
    want = ref.gemm_ref(x, w, out_dtype=out)
    worst = ref.sum_order_error(got, want, ref.gemm_ref(
        x.abs().float(), w.abs().float()), K).item()
    assert worst <= 1, worst


@pytest.mark.gpu
@pytest.mark.parametrize("scale", QUANT_SCALES)
def test_cuda_quant_epilogue_matches_plain_exactly(cuda, scale):
    x, w = (torch.from_numpy(a).to(cuda) for a in gemm_inputs(
        4, 64, 256, 96, integer=True))
    got = launched_once(lambda: gemm_kernel.gemm_os.int8_launches,
                        lambda: ops.quant_matmul(x, w, scale))
    assert ref.bitwise_equal(got, ref.gemm_ref(x, w, quant_scale=scale))


@pytest.mark.gpu
def test_cuda_int8_accumulates_in_int32(cuda):
    x = torch.full((8, 512), 127, dtype=torch.int8, device=cuda)
    got = ops.matmul(x, x.t().contiguous())
    assert torch.equal(got, torch.full_like(got, 512 * 127 * 127))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("spec", CONV_SPECS + CONV_PAPER_SPECS)
def test_cuda_conv_matches_plain(fp32_exact, spec, dtype):
    H, W, C, K, R, stride = spec
    dt = getattr(torch, dtype)
    x = torch.from_numpy(normal(H + W, 2, H, W, C)).to(fp32_exact, dt)
    w = torch.from_numpy(normal(C + K, R, R, C, K)).to(fp32_exact, dt)
    got = launched_once(lambda: conv_kernel.conv2d.launches,
                        lambda: ops.conv2d(x, w, stride=stride))
    want = ref.conv2d_ref(x, w, stride=stride)
    worst = ref.sum_order_error(got, want, ref.conv2d_ref(
        x.abs().float(), w.abs().float(), stride=stride), R * R * C).item()
    assert worst <= 1, worst


@pytest.mark.gpu
def test_cuda_conv_f32_two_runs_give_the_same_bits(cuda):
    """ResNet-50 stage 3 in fp32, its taps split over CTAs: the partials
    are added in rank order, so two runs give the same bits."""
    H, W, C, K, R, stride = CONV_PAPER_SPECS[0]
    x = torch.from_numpy(normal(H + W, 2, H, W, C)).to(cuda)
    w = torch.from_numpy(normal(C + K, R, R, C, K)).to(cuda)
    first = conv_kernel.conv2d(x, w, stride=stride)
    second = conv_kernel.conv2d(x, w, stride=stride)
    torch.cuda.synchronize()
    assert ref.bitwise_equal(first, second)


@pytest.mark.gpu
def test_cuda_conv_bf16_stem_agrees_where_a_dropped_tap_shows(fp32_exact):
    """The bf16 kernel on a stem-like conv (C = 3, 7x7/2: the scalar
    gather, depth 147 padded to 160) agrees with its plain version, which
    with its last tap dropped falls outside the same limit."""
    H, W, C, K, R, stride = STEM_SPEC
    x = torch.from_numpy(normal(H + W, 2, H, W, C)).to(fp32_exact,
                                                       torch.bfloat16)
    w = torch.from_numpy(normal(C + K, R, R, C, K)).to(fp32_exact,
                                                       torch.bfloat16)
    got = launched_once(lambda: conv_kernel.conv2d.launches,
                        lambda: ops.conv2d(x, w, stride=stride))
    want = ref.conv2d_ref(x, w, stride=stride)
    absp = ref.conv2d_ref(x.abs().float(), w.abs().float(), stride=stride)
    assert ref.sum_order_error(got, want, absp, R * R * C).item() <= 1
    dropped = w.clone()
    dropped[-1, -1] = 0
    wrong = ref.conv2d_ref(x, dropped, stride=stride)
    assert ref.sum_order_error(wrong, want, absp, R * R * C).item() > 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("spec", POOL_SPECS)
def test_cuda_maxpool_matches_plain(cuda, spec, nan, dtype):
    H, W, C, win, stride = spec
    x = torch.from_numpy(pool_input(H * C, H, W, C, nan=nan)).to(
        cuda, getattr(torch, dtype))
    got = launched_once(lambda: pool_kernel.maxpool2d.launches,
                        lambda: ops.maxpool2d(x, window=win, stride=stride))
    assert bool(got.isnan().any()) == nan
    assert ref.bitwise_equal(got, ref.maxpool2d_ref(x, window=win,
                                                    stride=stride))


def pooled(x, window, stride):
    """The kernel's max-pool of x (one launch), checked bitwise against the
    plain version."""
    got = launched_once(lambda: pool_kernel.maxpool2d.launches,
                        lambda: ops.maxpool2d(x, window=window,
                                              stride=stride))
    assert ref.bitwise_equal(got, ref.maxpool2d_ref(x, window=window,
                                                    stride=stride))
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [3, 6, 13, 8, 64])
@pytest.mark.parametrize("win_stride", [(1, 1), (2, 3), (3, 2), (3, 3),
                                        (5, 1), (2, 2)])
def test_cuda_maxpool_channels_and_windows_bitwise(cuda, win_stride, C,
                                                   dtype):
    """Channel counts of no whole 16-byte vector (C = 3, 6, 13) and of
    whole ones (C = 8, 64), at windows the kernel fixes (2/2, 3/2, 3/3) and
    others (1/1, 2/3 with stride past the window, 5/1), on 11 x 13 images
    whose last columns no window reaches."""
    win, stride = win_stride
    x = torch.from_numpy(normal(C * win + stride, 2, 11, 13, C)).to(
        cuda, getattr(torch, dtype))
    pooled(x, win, stride)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("win_stride", [(3, 2), (2, 2), (5, 1)])
def test_cuda_maxpool_unaligned_view_bitwise(cuda, win_stride, dtype):
    """A contiguous view one element past a 16-byte boundary, at C = 64."""
    x = offset_view(normal(5, 2, 12, 12, 64), cuda, getattr(torch, dtype),
                    True)
    assert x.data_ptr() % 16
    pooled(x, *win_stride)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [8, 13])
def test_cuda_maxpool_nan_in_a_shared_column(cuda, C, dtype):
    """3x3/2 windows overlap in every other column and row: a NaN at
    (4, 4) lies in four windows, which all give NaN, the other outputs
    none; a NaN in a column two windows share only along the row, too."""
    x = torch.from_numpy(normal(C, 2, 11, 11, C)).to(cuda,
                                                      getattr(torch, dtype))
    x[0, 4, 4, 1] = float("nan")      # rows 1-2 x columns 1-2 of outputs
    x[1, 3, 6, C - 1] = float("nan")  # row 1 x columns 2-3 of outputs
    got = pooled(x, 3, 2)
    nan = got.isnan()
    assert nan[0, 1:3, 1:3, 1].all() and int(nan[0].sum()) == 4
    assert nan[1, 1, 2:4, C - 1].all() and int(nan[1].sum()) == 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("win_stride", [(3, 2), (2, 2), (2, 3)])
def test_cuda_maxpool_windows_of_minus_inf_or_negatives(cuda, win_stride,
                                                        dtype):
    """A window of only -inf gives -inf (the kernel's start value is no
    stand-in for an input); a window of negatives gives its largest."""
    win, stride = win_stride
    dt = getattr(torch, dtype)
    neg = -1.0 - torch.from_numpy(normal(3, 2, 9, 9, 8)).abs().to(cuda, dt)
    got = pooled(neg, win, stride)
    assert (got < 0).all()
    x = torch.full((2, 9, 9, 8), float("-inf"), device=cuda, dtype=dt)
    x[1] = neg[1]
    got = pooled(x, win, stride)
    assert torch.isneginf(got[0]).all() and (got[1] > float("-inf")).all()


@pytest.mark.gpu
def test_cuda_maxpool_row_of_2_31_elements(cuda):
    """An input row of W * C = 2^31 + 2 elements (bf16 1 x 2 x (2^30 + 1) x
    2, 2x2 windows at stride 1: 8 GiB in) takes the kernel's 64-bit index:
    each output is its window's largest, up to a NaN in the last column."""
    W = 2 ** 30 + 1
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((1, 2, W, 2), generator=gen, device=cuda,
                    dtype=torch.bfloat16)
    x[0, 1, W - 1, 1] = float("nan")
    got = launched_once(lambda: pool_kernel.maxpool2d.launches,
                        lambda: ops.maxpool2d(x, window=2, stride=1))
    rows = torch.maximum(x[:, 0], x[:, 1])
    del x
    want = torch.maximum(rows[:, :-1], rows[:, 1:]).unsqueeze(1)
    del rows
    assert got.shape == want.shape == (1, 1, 2 ** 30, 2)
    nan = got.isnan()
    assert bool(nan[0, 0, -1, 1]) and int(nan.sum()) == 1
    assert bool(want[0, 0, -1, 1].isnan())
    del nan
    got[0, 0, -1, 1] = want[0, 0, -1, 1] = 0     # bits compared, NaN aside
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", BLOCKED_CASES)
def test_cuda_blocked_layout_matches_plain(cuda, case, dtype):
    H, W, C, cb = case
    x = torch.from_numpy(normal(C + cb, H, W, C)).to(cuda,
                                                     getattr(torch, dtype))
    got = launched_once(lambda: reshuffle_kernel.blocked_layout.launches,
                        lambda: ops.blocked_layout(x, cb))
    assert ref.bitwise_equal(got, ref.blocked_layout_ref(x, cb))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [(5, 6, 256, 8), (4, 4, 104, 64)])
def test_cuda_blocked_layout_unaligned_view_matches_plain(cuda, case, dtype):
    """A contiguous view one element past a 16-byte boundary: shapes that
    admit 16-byte vectors take the element path (the launcher decides from
    the pointer), bitwise equal all the same."""
    H, W, C, cb = case
    x = offset_view(normal(C + cb, H, W, C), cuda, getattr(torch, dtype),
                    True)
    got = launched_once(lambda: reshuffle_kernel.blocked_layout.launches,
                        lambda: ops.blocked_layout(x, cb))
    assert ref.bitwise_equal(got, ref.blocked_layout_ref(x, cb))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [(1, 2, 70001, 1), (1, 2, 280000, 4),
                                  (2, 1, 560008, 8)])
def test_cuda_blocked_layout_many_channel_blocks_matches_plain(cuda, case,
                                                               dtype):
    """More than 65535 channel blocks, past the grid's y limit: the CTAs
    step on over the blocks (elements, fp32 vectors, vectors in both)."""
    H, W, C, cb = case
    x = (torch.arange(1, H * W * C + 1, device=cuda, dtype=torch.float32)
         .reshape(H, W, C).to(getattr(torch, dtype)))
    got = launched_once(lambda: reshuffle_kernel.blocked_layout.launches,
                        lambda: ops.blocked_layout(x, cb))
    assert got.shape[0] > 65535
    assert ref.bitwise_equal(got, ref.blocked_layout_ref(x, cb))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mn", TRANSPOSE_SHAPES)
def test_cuda_transpose_matches_plain(cuda, mn, dtype):
    x = torch.from_numpy(normal(sum(mn), *mn)).to(cuda,
                                                  getattr(torch, dtype))
    got = launched_once(lambda: reshuffle_kernel.tiled_transpose.launches,
                        lambda: ops.transpose(x))
    assert ref.bitwise_equal(got, ref.transpose_ref(x))


@pytest.mark.gpu
def test_cuda_kernel_bench_smoke_launches_every_kernel(cuda):
    """The kernel bench launches every kernel of the kernel layer and the
    serving kernels (the sampler's noise kernel serves the decode step
    only and is not a row of the bench)."""
    ops.reset_launch_counts()
    rows = kernel_bench.run(smoke=True, device=cuda)
    counts = ops.launch_counts()
    assert counts.pop("sampler_noise") == 0
    assert all(n > 0 for n in counts.values()), counts
    assert all(isinstance(r["ms"], float) and r["ms"] > 0 for r in rows)
    assert all(r["err_of_limit"] == "" or r["err_of_limit"] <= 1
               for r in rows)


# ---------------------------------------------------------------------------
# Decode policies, the prefix cache, speculative decode
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", [(8, 2, 64), (16, 2, 128)],
                         ids=["bench", "serve"])
@pytest.mark.parametrize("offset,Sq", [(0, 77), (1, 128), (15, 1), (16, 300),
                                       (37, 64), (512, 200)])
def test_cuda_mha_q_offset_matches_plain(cuda, offset, Sq, heads, dtype):
    """mha with a query offset (a suffix prefill against a cached prefix),
    keys running past the last query: per row against its plain version;
    the plain version with the offset one short misses on some row."""
    H, KV, D = heads
    Sk = offset + Sq + 29
    q, k, v = (torch.from_numpy(x).to(cuda, getattr(torch, dtype))
               for x in mha_inputs(offset + Sq, 2, Sq, Sk, H, KV, D))
    got = launched_once(lambda: mha_kernel.mha.launches,
                        lambda: ops.attention(q, k, v, causal=True,
                                              q_offset=offset))
    want = ref.mha_ref(q, k, v, causal=True, q_offset=offset)
    if dtype == "bfloat16":
        assert_agrees(got, want)
    else:
        assert_rows_agree(got, want)
    if offset and dtype == "float32":
        shifted = ref.mha_ref(q, k, v, causal=True, q_offset=offset - 1)
        assert ref.row_error(shifted, want).max().item() > \
            ref.ROW_TOL[torch.float32]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,lengths", [(8, 5, [5, 17, 64, 200, 333, 512,
                                                 600, 1000]),
                                         (2, 32, [32, 700])])
def test_cuda_paged_verify_and_ingest_blocks_match_plain(cuda, B, T, lengths,
                                                         dtype):
    """Paged flash-decode at the verify step's T = 5 and a draft model's
    ingest block of T = 32, at the serving heads."""
    q, kp, vp, table, lens = paged_case(B + T, B, T, 16, 2, 128, 16, 64,
                                        lengths)
    args = [torch.from_numpy(x).to(cuda) for x in (q, kp, vp, table, lens)]
    args[:3] = [x.to(getattr(torch, dtype)) for x in args[:3]]
    got = launched_once(lambda: paged_kernel.paged_attention.launches,
                        lambda: ops.paged_attention(*args))
    assert_agrees(got, ref.paged_attention_ref(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 1000, 151936])
def test_cuda_threefry_equals_cpu(cuda, n):
    """The sampler's keys and bits on the card equal the CPU's bit for bit
    (integer arithmetic); the noise kernel's bits too, and its Gumbel noise
    is within 1e-6 of its plain version on the card."""
    rng = np.random.default_rng(n)
    cpu = [torch.from_numpy(rng.integers(0, 2**31, 5)) for _ in range(3)]
    dev = [x.to(cuda) for x in cpu]
    assert torch.equal(ref.row_keys(*cpu, 1), ref.row_keys(*dev, 1).cpu())
    want = ref.sampler_noise_ref(*cpu, n, draw=1, bits=True)
    assert torch.equal(ops.sampler_noise(*dev, n, draw=1, bits=True).cpu(),
                       want)
    got = launched_once(lambda: ops.launch_counts()["sampler_noise"],
                        lambda: ops.sampler_noise(*dev, n, draw=1))
    torch.testing.assert_close(got, ref.sampler_noise_ref(*dev, n, draw=1),
                               atol=1e-6, rtol=0)


class UncapturedSpecEngine(PagedServingEngine):
    """The engine with its verify body run as it is, uncaptured."""

    def _dispatch_spec(self):
        self._spec_body()


MIXED = [None, sampling.SamplingParams(0.9, 0, 0.95),
         sampling.SamplingParams(1.0, 5, 1.0, 7)]


def mixed_traffic(max_new=8):
    return [Request(rid=i, prompt=[(5 * i + 3 * j) % 97 + 1
                                   for j in range(7 + i)],
                    max_new=max_new, params=MIXED[i % 3]) for i in range(5)]


@pytest.mark.gpu
def test_cuda_verify_graph_equals_uncaptured_body(cuda):
    """fp32: the replayed verify graph's (2, slots, T) accept bits and
    tokens equal its uncaptured body's at every step of a mixed greedy /
    sampled run, and their streams are the same."""
    cfg, params = smoke_fp32()
    engs = [cls(cfg, tree_to(params, cuda), slots=3, max_len=64,
                page_size=4, spec_k=3, device=cuda)
            for cls in (UncapturedSpecEngine, PagedServingEngine)]
    reqs = [mixed_traffic(), mixed_traffic()]
    for eng, rs in zip(engs, reqs):
        for r in rs[:3]:
            assert eng.submit(r)
    for _ in range(6):
        for eng in engs:
            eng.step()
        assert torch.equal(engs[0]._spec_out, engs[1]._spec_out)
    assert [r.generated for r in reqs[0]] == [r.generated for r in reqs[1]]
    assert (engs[0].spec_traces, engs[1].spec_traces) == (0, 1)


ENGINE_KW = {
    "sampled": dict(),
    "prefix_cache": dict(prefix_cache=True),
    "spec_ngram": dict(spec_k=3),
    "spec_model": dict(spec_k=3, drafter=True),
    "spec_prefix": dict(spec_k=2, prefix_cache=True, num_pages=10),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(ENGINE_KW))
def test_cuda_policy_engines_equal_cpu_engine(cuda, case):
    """fp32 smoke model, mixed greedy / sampled requests on 2 slots: the
    engine on the card (its steps replayed graphs) emits the CPU engine's
    tokens with the prefix cache, n-gram and self-drafting speculation,
    and both together under a small pool; one capture of the graph it
    uses through the whole run, the launches counted per replay."""
    cfg, params = smoke_fp32()

    def run(dev):
        kw = dict(ENGINE_KW[case])
        if kw.pop("drafter", False):
            kw["drafter"] = DraftModelDrafter(
                cfg, tree_to(params, dev), page_size=4, num_pages=64,
                max_len=64, device=dev)
        return serve_on(PagedServingEngine, cfg, params, dev,
                        mixed_traffic(10), **dict(dict(
                            max_len=64, num_pages=24), **kw))

    want, _, _ = run("cpu")
    got, eng, launched = run(cuda)
    assert got == want
    spec = bool(eng.spec_k)
    assert (eng.step_traces, eng.spec_traces) == ((0, 1) if spec else (1, 0))
    assert launched["sampler_noise"] == eng.decode_steps + eng.prefills
    # the draft model runs the gather baseline (its default): no paged
    # launch of its own
    assert launched["paged_attention"] == cfg.num_layers * eng.decode_steps
    assert eng.sampling_stats()["sampled_requests"] == 3


# ---------------------------------------------------------------------------
# The hybrid stacks: mha with a band and head dim 256, paged at recurrent-
# gemma's shapes, the hybrid engines
# ---------------------------------------------------------------------------

# (B, Sq, Sk, H, KV, D, window, q_offset, kv_valid): recurrentgemma's heads
# (16 over 1, D 256) and the serving heads at D 128; bands of 1, 16, 100
# and 2048 keys, a query offset that is no tile multiple, Sk past Sq
WINDOW_MHA_CASES = [
    (1, 1024, 1024, 16, 1, 256, 16, 0, None),
    (1, 1024, 1024, 16, 1, 256, 2048, 0, None),
    (1, 640, 640, 16, 1, 256, 100, 0, 577),
    (1, 300, 637, 16, 1, 256, 100, 337, None),
    (2, 200, 200, 16, 2, 128, 37, 0, None),
    (1, 129, 400, 8, 2, 64, 1, 271, None),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", WINDOW_MHA_CASES, ids=str)
def test_cuda_mha_window_matches_plain(cuda, case, dtype):
    """mha with a band (and head dim 256) against its plain version per
    row, in both dtypes, on inputs whose rows peak on the oldest key of
    their band: the plain version with a band one key narrower misses the
    row tolerance on every row that has such a key, so a kernel whose band
    is off by one could not pass (a band wider than every row's keys has
    no such row)."""
    B, Sq, Sk, H, KV, D, window, off, valid = case
    dt = getattr(torch, dtype)
    q, k, v = ref.peaked_mha_inputs(np.random.default_rng(Sq + window), B,
                                    Sk, H, KV, D, edge=window)
    q, k, v = (torch.from_numpy(x).to(cuda, dt)
               for x in (q[:, off:off + Sq], k, v))
    got = launched_once(lambda: mha_kernel.mha.launches,
                        lambda: ops.attention(q, k, v, causal=True,
                                              q_offset=off, window=window,
                                              kv_valid=valid))
    want = ref.mha_ref(q, k, v, causal=True, q_offset=off, window=window,
                       kv_valid=valid)
    assert_rows_agree(got, want)
    if 1 < window <= Sk:
        rows = slice(max(window - 1 - off, 0),
                     None if valid is None else valid - off - window)
        narrower = ref.mha_ref(q, k, v, causal=True, q_offset=off,
                               window=window - 1, kv_valid=valid)
        assert ref.row_error(narrower, want)[:, rows].min().item() > \
            ref.ROW_TOL[dt]


@pytest.mark.gpu
def test_cuda_mha_refuses_what_it_cannot_take(cuda):
    """No fallback: a head dim the kernel lacks and a band without causal
    masking raise."""
    q = torch.zeros(1, 8, 2, 96, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        mha_kernel.mha(q, q, q)
    q = torch.zeros(1, 8, 2, 256, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="window"):
        mha_kernel.mha(q, q, q, causal=False, window=4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("T", [1, 5])
def test_cuda_paged_window_d256_never_reads_recycled_entries(cuda, T, dtype):
    """Paged flash-decode at recurrentgemma's shapes (16 query heads over
    1 KV head, D 256, window 2048, page 16) with contexts 2100-3500 whose
    entries below the earliest row's window point at scratch page 0,
    filled with 1e4: any read of a recycled entry would move the output
    past the tolerance."""
    B, page, H, KV, D, window = 4, 16, 16, 1, 256, 2048
    lengths = [2100, 2777, 3000, 3500]
    nb = -(-max(lengths) // page)
    q, kp, vp, table, lens = paged_case(T, B, T, H, KV, D, page, nb, lengths,
                                        poison=True)
    for b, n in enumerate(lengths):
        table[b, : max(0, n - T - window + 1) // page] = 0
    dt = getattr(torch, dtype)
    q, kp, vp = (torch.from_numpy(x).to(cuda, dt) for x in (q, kp, vp))
    table, lens = (torch.from_numpy(x).to(cuda) for x in (table, lens))
    got = launched_once(lambda: paged_kernel.paged_attention.launches,
                        lambda: ops.paged_attention(q, kp, vp, table, lens,
                                                    window=window))
    assert torch.isfinite(got).all()
    assert_agrees(got, ref.paged_attention_ref(q, kp, vp, table, lens,
                                               window=window))


def smoke_hybrid(arch):
    over = dict(dtype="float32", kv_cache_dtype="float32")
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    return cfg, api.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")


def hybrid_traffic():
    return [Request(rid=0, prompt=[5, 4, 3, 2, 1, 6, 7] * 4, max_new=20),
            Request(rid=1, prompt=[1, 2, 3, 4, 5, 6], max_new=20),
            Request(rid=2, prompt=[9, 8] * 12, max_new=20)]


@pytest.mark.gpu
@pytest.mark.parametrize("spec_k", [0, 3])
@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mamba2-2.7b"])
def test_cuda_hybrid_engine_kernel_tokens_equal_gather(cuda, arch, spec_k):
    """fp32 SMOKE hybrid stacks (window 16) on the card, prompts past the
    window, a pool that forces preemption: the kernel engine (replayed
    graphs, the paged kernel through the window table) emits the gather
    engine's and the CPU engine's greedy tokens, launches the paged kernel
    once per local_attn layer a step and mha once per local_attn layer a
    prefill, and captures each graph once."""
    cfg, params = smoke_hybrid(arch)
    kw = dict(slots=2, max_len=64, page_size=4, num_pages=8, spec_k=spec_k)
    want, _, _ = serve_on(PagedServingEngine, cfg, params, "cpu",
                          hybrid_traffic(), **kw)
    gather, _, _ = serve_on(PagedServingEngine, cfg, params, cuda,
                            hybrid_traffic(), attn_impl="gather", **kw)
    got, eng, launched = serve_on(PagedServingEngine, cfg, params, cuda,
                                  hybrid_traffic(), **kw)
    assert got == gather == want
    n_win = sum(k == "local_attn" for k in
                api.tfm.layer_kinds(cfg))
    assert launched["paged_attention"] == n_win * eng.decode_steps
    assert launched["mha"] == n_win * eng.prefills
    assert (eng.step_traces, eng.spec_traces) == \
        ((0, 1) if spec_k else (1, 0))
    assert eng.select_traces == (1 if spec_k else 0)


# ---------------------------------------------------------------------------
# The host tier on the card: pinned round trips, the copy stream's ordering,
# the tiered kernel engine against the uncapped one
# ---------------------------------------------------------------------------


def tier_traffic(n=3, max_new=8):
    # prompt + max_new <= 16 tokens = 4 pages: a 4-page pool holds one
    # request at a time, so decode must swap
    return [Request(rid=i, prompt=[(7 * i + 3 * j) % 256
                                   for j in range(3 + 2 * i)],
                    max_new=max_new)
            for i in range(n)]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "recurrentgemma-9b"])
def test_cuda_tiered_kernel_engine_equals_uncapped(cuda, arch):
    """fp32 SMOKE: a pool capped below the working set with the tier on
    (pinned host blobs, side-stream copies, scatters between replays)
    emits the uncapped kernel engine's tokens and the CPU tiered engine's,
    swaps out and back in as often, prefills nothing again, ends with an
    empty store, and still captures its decode graph once."""
    if arch == "qwen2.5-3b":
        cfg, params = smoke_fp32(arch)
        pages, traffic = 4, tier_traffic
    else:
        # prompts on both sides of half the window: 6 pages hold one
        # request's window pages at a time, not two
        cfg, params = smoke_hybrid(arch)
        w = cfg.hybrid.window
        pages = 6

        def traffic():
            return [Request(rid=i, prompt=[(5 * i + j) % cfg.vocab
                                           for j in range(w // 2 + 5 * i)],
                            max_new=8) for i in range(3)]
    base, beng, _ = serve_on(PagedServingEngine, cfg, params, cuda,
                             traffic(), num_pages=32)
    cpu, ceng, _ = serve_on(PagedServingEngine, cfg, params, "cpu",
                            traffic(), num_pages=pages, host_tier=True)
    got, eng, launched = serve_on(PagedServingEngine, cfg, params, cuda,
                                  traffic(), num_pages=pages,
                                  host_tier=True)
    assert got == base == cpu
    t = eng.tier
    assert t.swap_outs == t.swap_ins == ceng.tier.swap_outs > 0
    assert eng.prefilled_tokens == beng.prefilled_tokens
    assert len(t.store) == sum(len(v) for v in t._win_archive.values())
    assert eng.step_traces == 1
    assert launched["paged_attention"] > 0
    eng.check()


def swap_race(cfg, params, dev, prefetch, steps=6, after=8, **kw):
    """The copy-stream race: request A decodes ``steps`` tokens, is swapped
    out (its D2H copies left pending), request B is prefilled at once into
    the pages A just freed (the free list is LIFO), then A is swapped back
    in — through a prefetch (the hit path) or a demand fetch — and both
    decode ``after`` more steps. Returns (A's and B's tokens, the engine);
    ``prefetch=None`` runs the same schedule without the swap."""
    kw = dict(dict(slots=2, max_len=64, page_size=4, num_pages=24), **kw)
    eng = PagedServingEngine(cfg, tree_to(params, dev), device=dev,
                             host_tier=prefetch is not None, **kw)
    a = Request(rid=0, prompt=[5, 4, 3, 2, 1, 6, 7, 9, 9, 2, 8],
                max_new=steps + after + 1)
    b = Request(rid=1, prompt=[3, 1, 4, 1, 5, 9, 2, 6, 5, 3],
                max_new=after + 1)
    assert eng.submit(a)
    for _ in range(steps):
        eng.step()
    if prefetch is not None:
        freed = eng.alloc.block_table(a.rid)
        assert eng._swap_out_slot(0) is a
        assert eng.tier.store.pending > 0      # D2H not yet finalized
        assert eng.submit(b)
        assert set(eng.alloc.block_table(b.rid)) & set(freed)
        if prefetch:
            eng.prefetch_pending([a])
        assert eng.submit(a)
    else:
        assert eng.submit(b)
    for _ in range(after):
        eng.step()
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    return [list(a.generated), list(b.generated)], eng


@pytest.mark.gpu
@pytest.mark.parametrize("prefetch", [True, False])
def test_cuda_swap_race_resumes_exactly(cuda, prefetch):
    """Swap out, prefill another request into the freed pages at once,
    swap back in: the resumed request's next 8 tokens (and the other's)
    equal the run without the swap, through the prefetch hit path and
    through a demand fetch."""
    cfg, params = smoke_fp32()
    want, _ = swap_race(cfg, params, cuda, None)
    got, eng = swap_race(cfg, params, cuda, prefetch)
    assert got == want
    assert eng.tier.stream.prefetch_hits == int(prefetch)
    assert eng.tier.stream.demand_fetches == int(not prefetch)
    assert eng.tier.swap_ins == 1 and len(eng.tier.store) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "float32"])
@pytest.mark.parametrize("prefetch", [True, False])
def test_cuda_store_round_trips_pinned(cuda, dtype, prefetch):
    """A device blob through the pinned store and back to the card, bit
    for bit: the host copy is pinned, finalized by ``drain``, and the
    device copy comes back through a prefetch or a demand fetch."""
    from repro_torch.runtime.host_tier import HostTier
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(64, 16, 2, 32, generator=g, device=cuda) * 40
    x = x.to(getattr(torch, dtype))
    tier = HostTier()
    h = tier.store.put({"0": {"k": x[torch.arange(0, 64, 3,
                                                  device=cuda)]}})
    want = x[torch.arange(0, 64, 3, device=cuda)].clone()
    x.zero_()                                # a later write to the source
    assert tier.drain() == 1
    host = tier.store.get(h)["0"]["k"]
    assert host.device.type == "cpu" and host.is_pinned()
    assert torch.equal(host.view(torch.uint8), want.cpu().view(torch.uint8))
    if prefetch:
        tier.stream.prefetch(h)
    back = tier.stream.take(h)["0"]["k"]
    assert back.device.type == "cuda"
    assert torch.equal(back.view(torch.uint8), want.view(torch.uint8))
    assert tier.stream.prefetch_hits == int(prefetch)


@pytest.mark.gpu
def test_cuda_drain_waits_only_when_a_copy_is_pending(cuda):
    """``drain()`` with nothing pending returns at once while the card is
    busy (no sync); with a copy pending behind busy work it waits for
    it."""
    import time
    from repro_torch.runtime.host_tier import HostTier
    tier = HostTier()
    busy = torch.cuda.Event()
    torch.cuda._sleep(1 << 28)                # ~0.1 s of device time
    busy.record()
    t0 = time.perf_counter()
    assert tier.drain() == 0
    assert time.perf_counter() - t0 < 0.01
    assert not busy.query()                   # the device is still busy
    torch.cuda.synchronize()
    x = torch.ones(1024, device=cuda)
    torch.cuda._sleep(1 << 28)
    h = tier.store.put({"k": x})              # behind the sleep
    assert tier.store.pending == 1
    assert tier.drain() == 1                  # waited for the copy
    assert tier.store.get(h)["k"].sum().item() == 1024


# ---------------------------------------------------------------------------
# The dense-slot engine and the encoder-decoder stack: mha at their shapes
# ---------------------------------------------------------------------------

# (query heads, KV heads, head dim): qwen2.5-3b's and seamless-m4t's
DENSE_HEADS = [(16, 2, 128), (16, 16, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("heads", DENSE_HEADS, ids=["qwen", "seamless"])
def test_cuda_mha_decode_row_with_device_kv_valid(cuda, heads, dtype):
    """The dense lanes' decode attention: one query row a slot (B 8) against
    a 256-row lane, non-causal, with a (B,) int32 kv_valid on the device
    running from 1 to the lane length (a ring's min(pos + 1, W) among
    them), per row within the plain version's tolerance; then the same
    call captured in a CUDA graph and replayed after kv_valid's contents
    change in place: the replay reads the new counts."""
    Hq, KVh, Dh = heads
    dt = getattr(torch, dtype)
    B, S = 8, 256
    q, k, v = (torch.from_numpy(x).to(cuda, dt)
               for x in mha_inputs(Hq + Dh, B, 1, S, Hq, KVh, Dh))
    valid = torch.tensor([1, 2, 17, 64, 129, 255, 256, 100],
                         dtype=torch.int32, device=cuda)
    got = launched_once(lambda: mha_kernel.mha.launches,
                        lambda: ops.attention(q, k, v, causal=False,
                                              kv_valid=valid))
    assert_rows_agree(got, ref.mha_ref(q, k, v, causal=False,
                                       kv_valid=valid))
    ops.attention(q, k, v, causal=False, kv_valid=valid)     # warm
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.attention(q, k, v, causal=False, kv_valid=valid)
    valid.copy_(torch.tensor([256, 3, 1, 200, 32, 5, 77, 256],
                             dtype=torch.int32))
    graph.replay()
    torch.cuda.synchronize()
    assert_rows_agree(out, ref.mha_ref(q, k, v, causal=False,
                                       kv_valid=valid))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("Sq,Sk", [(128, 1024), (1024, 1024), (77, 300)])
def test_cuda_mha_non_causal_at_seamless_heads(cuda, Sq, Sk, dtype):
    """seamless-m4t's attention shapes (H16 KV16 D64, G = 1), non-causal:
    the encoder (Sq = Sk), the cross-attention prefill (prompt rows
    against encoder frames, Sq != Sk), per row within tolerance."""
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to(cuda, dt)
               for x in mha_inputs(Sq + Sk, 2, Sq, Sk, 16, 16, 64))
    got = launched_once(lambda: mha_kernel.mha.launches,
                        lambda: ops.attention(q, k, v, causal=False))
    assert_rows_agree(got, ref.mha_ref(q, k, v, causal=False))


class UncapturedDenseEngine(DenseServingEngine):
    """The dense engine with its step body run as it is, uncaptured."""

    def _dispatch(self):
        self._step_body()


def dense_traffic(vocab):
    """Budgets of 3-9 tokens on 3 slots, more requests than slots: slots
    die while others decode and are refilled."""
    rng = np.random.default_rng(11)
    return [([int(t) for t in rng.integers(1, vocab, int(n))], int(b))
            for n, b in zip(rng.integers(3, 14, 6), rng.integers(3, 10, 6))]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "recurrentgemma-9b",
                                  "dbrx-132b"])
def test_cuda_dense_graph_replays_equal_uncaptured_body(cuda, arch):
    """fp32 smoke model with an fp32 KV cache on 3 slots: every replay of
    the dense engine's decode graph gives the uncaptured body's logits bit
    for bit, dead rows too, while slots die and are refilled; one
    capture."""
    cfg, params = smoke_fp32(arch)
    cfg = dataclasses.replace(cfg, kv_cache_dtype="float32")
    params = tree_to(params, cuda)
    engs = [cls(cfg, params, slots=3, max_len=48, device=cuda)
            for cls in (UncapturedDenseEngine, DenseServingEngine)]
    queues = [[Request(rid=i, prompt=p, max_new=b)
               for i, (p, b) in enumerate(dense_traffic(cfg.vocab))]
              for _ in engs]
    for _ in range(12):
        for eng, q in zip(engs, queues):
            while q and eng.submit(q[0]):
                q.pop(0)
            eng.step()
        assert torch.equal(engs[0].last_logits, engs[1].last_logits)
        assert torch.equal(engs[0].cur_tok, engs[1].cur_tok)
    assert (engs[0].step_traces, engs[1].step_traces) == (0, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "recurrentgemma-9b",
                                  "mamba2-2.7b"])
def test_cuda_dense_tokens_equal_paged_tokens(cuda, arch):
    """fp32 smoke model, fp32 KV cache: the dense engine on the card (its
    steps graph replays, its attention flash-MHA with a device kv_valid)
    emits the paged kernel engine's greedy tokens and the CPU dense
    engine's, with prompts and generations past recurrentgemma's window of
    16; the dense run launches mha once an attention layer a step and a
    prefill, and no paged kernel."""
    from repro_torch.models import transformer as tfm
    cfg, params = smoke_fp32(arch)
    cfg = dataclasses.replace(cfg, kv_cache_dtype="float32")
    traffic = [(p + p + p, b + 12) for p, b in dense_traffic(cfg.vocab)]

    def run(cls, dev, **kw):
        eng = cls(cfg, tree_to(params, dev), slots=3, max_len=64,
                  device=dev, **kw)
        reqs = [Request(rid=i, prompt=p, max_new=b)
                for i, (p, b) in enumerate(traffic)]
        ops.reset_launch_counts()
        eng.run_to_completion(reqs, max_steps=500)
        return [r.generated for r in reqs], eng, ops.launch_counts()
    dense, eng, counts = run(DenseServingEngine, cuda)
    assert dense == run(PagedServingEngine, cuda, page_size=4)[0]
    assert dense == run(DenseServingEngine, torch.device("cpu"))[0]
    n_attn = sum(k not in api.STATE_KINDS for k in tfm.layer_kinds(cfg))
    assert counts["mha"] == n_attn * (eng.decode_steps + eng.prefills)
    assert counts["paged_attention"] == 0
    assert counts["sampler_noise"] == eng.decode_steps + eng.prefills


@pytest.mark.gpu
def test_cuda_seamless_prefill_and_decode_equal_cpu(cuda):
    """seamless-m4t SMOKE in fp32: the encoder, the cross prefill and 6
    greedy decode steps on the dense lanes, on the card against the CPU
    plain path: logits within 1e-4 of the largest, equal tokens, one mha
    launch a self- or cross-attention layer a call (plus the encoder's at
    prefill)."""
    cfg, params = smoke_fp32("seamless-m4t-large-v2")
    cfg = dataclasses.replace(cfg, kv_cache_dtype="float32")
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 9)))
    enc = torch.from_numpy(rng.standard_normal(
        (2, 13, cfg.d_model)).astype(np.float32))
    out = {}
    for dev in (torch.device("cpu"), cuda):
        p = tree_to(params, dev)
        before = mha_kernel.mha.launches
        logits, cache, pos = api.prefill(cfg, p, toks.to(dev),
                                         enc_embeds=enc.to(dev), max_len=32)
        seq, ts = [logits.cpu()], []
        for _ in range(6):
            t = logits[:, : cfg.vocab].argmax(-1)[:, None]
            ts.append(t.cpu())
            logits, cache = api.decode_step(cfg, p, cache, t, pos)
            pos = pos + 1
            seq.append(logits.cpu())
        out[dev.type] = (torch.stack(seq), torch.cat(ts, 1),
                         mha_kernel.mha.launches - before)
    (want, wt, _), (got, gt, n) = out["cpu"], out["cuda"]
    assert torch.equal(gt, wt)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    assert n == cfg.enc_layers + 2 * cfg.num_layers * 7


# ---------------------------------------------------------------------------
# training (chip_smoke.py phase 14 (a)): the card against the CPU
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "dbrx-132b",
                                  "recurrentgemma-9b"])
def test_cuda_train_step_equals_cpu(fp32_exact, arch):
    """fp32 SMOKE config from one state on both devices: step 1's loss and
    aux losses within rtol 1e-4, every gradient leaf present, finite,
    non-zero wherever the CPU's is and within 1e-3 of the leaf's largest
    CPU value (fp32 in other summation orders), then 3 steps' losses
    within rtol 1e-4; no kernel launches (the training forward attends
    through the plain flash_attention)."""
    tree = torch.utils._pytree
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    opt = adamw.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=30,
                            moment_dtype=cfg.moment_dtype)
    cpu = trainer.init_state(cfg, opt, torch.Generator().manual_seed(0),
                             device="cpu")
    card = tree.tree_map(lambda t: t.cuda(), cpu)
    ds = SyntheticDataset(DataConfig(vocab=cfg.vocab, seq_len=64,
                                     global_batch=4))
    batches = [ds.next_batch() for _ in range(3)]

    def on(dev, b):
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    ops.reset_launch_counts()
    lc, ac, gc = trainer.loss_and_grads(cfg, cpu["params"],
                                        on("cpu", batches[0]))
    lg, ag, gg = trainer.loss_and_grads(cfg, card["params"],
                                        on("cuda", batches[0]))
    for a, b in [(lg, lc)] + [(ag[k], ac[k]) for k in ac]:
        assert abs(a.item() - b.item()) <= 1e-4 * abs(b.item()) + 1e-7
    for g, c in zip(tree.tree_leaves(gg), tree.tree_leaves(gc)):
        g = g.cpu()
        assert torch.isfinite(g).all()
        assert not ((c != 0) & (g == 0)).any()
        assert (g - c).abs().max() <= 1e-3 * c.abs().max()
    if cfg.moe is not None:
        assert ag["lb_loss"].item() > 0 and ag["z_loss"].item() > 0
    step = trainer.make_train_step(cfg, opt)
    for b in batches:
        cpu, mc = step(cpu, on("cpu", b))
        card, mg = step(card, on("cuda", b))
        assert abs(mg["loss"].item() - mc["loss"].item()) <= \
            1e-4 * abs(mc["loss"].item())
    assert not any(ops.launch_counts().values())


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["mha", "paged_attention", "sampler",
                                  "gemm_os", "conv_im2col", "maxpool",
                                  "blocked_layout", "tiled_transpose"])
def test_cuda_wrappers_refuse_grad(cuda, name):
    """A grad-requiring CUDA input under grad mode raises before the launch
    (the sampler's inputs are integers, which cannot require grad: a float
    stand-in shows the order of its checks); under no_grad the same call
    launches."""
    z = torch.zeros
    f = dict(device=cuda)
    i64 = z(1, dtype=torch.int64, **f)
    calls = {
        "mha": lambda x: mha_kernel.mha(x, z(1, 4, 2, 16, **f),
                                        z(1, 4, 2, 16, **f)),
        "paged_attention": lambda x: paged_kernel.paged_attention(
            x, z(2, 4, 2, 16, **f), z(2, 4, 2, 16, **f),
            z(1, 1, dtype=torch.int32, **f), [4]),
        "sampler": lambda x: sampler_kernel.sampler_noise(
            x.reshape(-1)[:1] if torch.is_grad_enabled() else i64, i64, i64,
            8,
            draw=0),
        "gemm_os": lambda x: gemm_kernel.gemm_os(x.reshape(8, 16),
                                                 z(16, 8, **f)),
        "conv_im2col": lambda x: conv_kernel.conv2d(
            x.reshape(1, 2, 4, 16), z(3, 3, 16, 8, **f)),
        "maxpool": lambda x: pool_kernel.maxpool2d(x.reshape(1, 2, 4, 16)),
        "blocked_layout": lambda x: reshuffle_kernel.blocked_layout(
            x.reshape(2, 4, 16)),
        "tiled_transpose": lambda x: reshuffle_kernel.tiled_transpose(
            x.reshape(8, 16)),
    }
    x = z(1, 4, 2, 16, requires_grad=True, **f)
    before = ops.launch_counts()
    with pytest.raises(RuntimeError, match="has no backward"):
        calls[name](x)
    assert ops.launch_counts() == before
    with torch.no_grad():
        calls[name](x)
    torch.cuda.synchronize()
    assert ops.launch_counts() != before



@pytest.mark.gpu
def test_cuda_seam_refuses_fake_inputs(cuda):
    """On the card too, every ``kernels.ops`` entry refuses fake CUDA
    tensors (null pointers) and meta tensors before it builds or launches;
    the same calls on real CUDA tensors launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    before = ops.launch_counts()
    for name in OP_NAMES:
        with FakeTensorMode():
            with pytest.raises(RuntimeError, match="fake or meta tensor"):
                op_calls_on("cuda")[name]()
        with pytest.raises(RuntimeError, match="fake or meta tensor"):
            op_calls_on("meta")[name]()
    assert ops.launch_counts() == before
    for name in OP_NAMES:
        op_calls_on("cuda")[name]()
    torch.cuda.synchronize()
    assert all(ops.launch_counts()[k] > before[k] for k in (
        "paged_attention", "mha", "gemm_os", "gemm_os_int8", "conv_im2col",
        "maxpool", "blocked_layout", "tiled_transpose", "sampler_noise"))


# ---------------------------------------------------------------------------
# a world of 1 over NCCL whose plan contracts anyway (chip_smoke.py phases
# 13 and 15): a sum over one rank is a copy, so the collectives run and
# the numbers must not move
# ---------------------------------------------------------------------------


@pytest.fixture
def nccl_world(cuda, tmp_path):
    """This process as a world of 1 (``cpu:gloo,cuda:nccl``, as
    ``launch.mesh.run_world`` makes it), torn down after the test."""
    import torch.distributed as dist
    dist.init_process_group("cpu:gloo,cuda:nccl",
                            init_method=f"file://{tmp_path / 'rdv'}",
                            rank=0, world_size=1)
    try:
        yield dist
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_cuda_mesh_serving_nccl_contract_equals_plain(nccl_world):
    """The paged engine on a mesh of 1 whose serving ``ManualRules`` sums
    "heads" and "ffn" over the world: its decode graph is captured with
    the NCCL all-reduces inside (after an eager one), and its greedy
    tokens equal the plain engine's (fp32 SMOKE, fp32 KV cache)."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.sharding import ManualRules
    cfg = dataclasses.replace(get_smoke_config("qwen2.5-3b"),
                              dtype="float32", kv_cache_dtype="float32")
    params = api.init_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(0), device="cuda")
    kw = dict(slots=3, max_len=64, page_size=8, device="cuda")

    def serve(eng):
        reqs = [Request(rid=i, prompt=[1 + i, 7, 3 + i, 9, 2], max_new=8)
                for i in range(4)]
        eng.run_to_completion(reqs)
        return [r.generated for r in reqs]

    want = serve(PagedServingEngine(cfg, params, **kw))
    rules = ManualRules(("heads", "ffn"), nccl_world.group.WORLD)
    eng = PagedServingEngine(cfg, params,
                             mesh=make_host_mesh(1, devices=["cuda:0"]),
                             **kw)
    eng.tp = dataclasses.replace(eng.tp, rules=rules)
    eng._model_rules = rules
    assert not eng._eager()
    assert serve(eng) == want
    assert eng.step_traces == 1 and rules.reduces > 0


@pytest.mark.gpu
@pytest.mark.parametrize("compress", [False, True])
def test_cuda_model_parallel_step_world_of_one_equals_plain(nccl_world,
                                                            compress):
    """``make_train_step(rules=)`` with ``TrainRules`` that sum "heads" and
    "ffn" over a world of 1 over NCCL: 2 fp32 SMOKE steps from the plain
    step's state give its losses and parameters bit for bit, with 5
    all-reduces a layer a step (2 forward, 2 backward, the attention's in
    the recompute)."""
    from repro_torch.parallel.sharding import TrainRules
    tree = torch.utils._pytree
    cfg = dataclasses.replace(get_smoke_config("qwen2.5-3b"),
                              dtype="float32")
    opt = adamw.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=30)
    plain = trainer.init_state(cfg, opt, torch.Generator(device="cuda")
                               .manual_seed(0), device="cuda",
                               compress_grads=compress)
    state = tree.tree_map(torch.clone, plain)
    rules = TrainRules(("heads", "ffn"), nccl_world.group.WORLD)
    ds = SyntheticDataset(DataConfig(vocab=cfg.vocab, seq_len=32,
                                     global_batch=4))
    steps = [trainer.make_train_step(cfg, opt, compress_grads=compress),
             trainer.make_train_step(cfg, opt, rules=rules,
                                     compress_grads=compress)]
    for _ in range(2):
        b = {k: torch.from_numpy(v).cuda()
             for k, v in ds.next_batch().items()}
        plain, mp = steps[0](plain, b)
        state, mm = steps[1](state, b)
        assert mm["loss"].item() == mp["loss"].item()
    for a, c in zip(tree.tree_leaves(state), tree.tree_leaves(plain)):
        assert torch.equal(a, c)
    assert rules.reduces == 2 * cfg.num_layers * 5


@pytest.mark.gpu
def test_cuda_layout_hooks_world_of_one_equal_plain(nccl_world):
    """``torch_layout_ranks.forced_rules`` over a world of 1 over NCCL: the
    FSDP gathers and their reduce-scatters, the model gathers (dbrx's
    router), the heads, ffn, vocab and experts contractions, and the KV
    heads read in part (their slice and their leaves' gradient sum), each
    a collective over one rank. 2 fp32 SMOKE steps of qwen2.5-3b and of
    dbrx-132b (expert-parallel), plain and compressed, equal the plain
    step's losses and state bit for bit."""
    from torch_layout_ranks import forced_steps
    for arch in ("qwen2.5-3b", "dbrx-132b"):
        for compress in (False, True):
            losses, equal, reduces, colls = forced_steps(
                arch, nccl_world.group.WORLD, "cuda", compress)
            assert all(a == b for a, b in losses) and equal, (arch, compress)
            assert reduces > 0 and colls["reduce-scatter:data"] > 0
            assert (colls.get("all-gather:model", 0) > 0) == (
                arch == "dbrx-132b")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mamba2-2.7b"])
def test_cuda_mixer_hooks_world_of_one_equal_plain(nccl_world, arch):
    """``torch_layout_ranks.forced_rules`` over a world of 1 over NCCL on
    the recurrent stacks: RG-LRU's reduce-scatter of its gates (an
    all-gather in backward) and its whole leaves' gradient sum, the local
    attention's KV heads read in part; mamba2's ``in_proj`` product
    gathered (a reduce-scatter in backward), its norm's sum both ways and
    its whole leaves' gradient sum. 2 fp32 SMOKE steps equal the plain
    step's losses and state bit for bit."""
    from torch_layout_ranks import forced_steps
    losses, equal, reduces, colls = forced_steps(
        arch, nccl_world.group.WORLD, "cuda", False)
    assert all(a == b for a, b in losses) and equal
    assert reduces > 0
    assert colls["all-gather:model"] > 0 and colls["reduce-scatter:model"] > 0


# ---------------------------------------------------------------------------
# context parallelism (chip_smoke.py phase 17)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_mha_at_a_cp_rank_block_matches_plain(cuda, dtype):
    """mha at a context-parallel rank's block: B1, 1024 queries at
    q_offset 1024 against the 2048 gathered keys, H16 KV2 D128, no
    prefix; per row against its plain version, and the plain version
    with the offset one short misses on some row (fp32)."""
    Sq, off, Sk, Hq, KVh, Dh = 1024, 1024, 2048, 16, 2, 128
    q, k, v = (torch.from_numpy(x).to(cuda, getattr(torch, dtype))
               for x in mha_inputs(off + Sq, 1, Sq, Sk, Hq, KVh, Dh))
    got = launched_once(lambda: mha_kernel.mha.launches,
                        lambda: ops.attention(q, k, v, causal=True,
                                              q_offset=off))
    want = ref.mha_ref(q, k, v, causal=True, q_offset=off)
    if dtype == "bfloat16":
        assert_agrees(got, want)
    else:
        assert_rows_agree(got, want)
        shifted = ref.mha_ref(q, k, v, causal=True, q_offset=off - 1)
        assert ref.row_error(shifted, want).max().item() > \
            ref.ROW_TOL[torch.float32]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mamba2-2.7b"])
def test_cuda_cp_hooks_world_of_one_equal_plain(nccl_world, arch):
    """``torch_cp_ranks.forced_cp_rules`` over a world of 1 over NCCL: the
    sequence over ``model`` with every context-parallel hook taken over
    one rank (a copy). 2 fp32 SMOKE steps equal the plain step's losses
    and state bit for bit, and the prefill's logits bit for bit; 4 greedy
    decode steps (plain attention a rank, merged, where the plain path
    runs the mha kernel) give the plain path's tokens, logits within 1e-5
    of their scale."""
    from torch_cp_ranks import forced_cp_steps
    losses, equal, prefill_equal, (ta, tc), err, colls = forced_cp_steps(
        arch, nccl_world.group.WORLD, "cuda")
    assert all(a == b for a, b in losses) and equal
    assert prefill_equal and ta == tc and err <= 1e-5
    assert colls["all-reduce:model"] > 0
    assert colls["all-gather:model"] > 0
