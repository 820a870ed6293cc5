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
from repro_torch.launch import kernel_bench  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.runtime import sampling  # noqa: E402
from repro_torch.runtime.drafter import DraftModelDrafter  # noqa: E402
from repro_torch.runtime.scheduler import Scheduler  # noqa: E402
from repro_torch.runtime.serving import PagedServingEngine, Request  # noqa
from torch_cases import (BLOCKED_CASES, CONV_SPECS,  # noqa: E402
                         EPILOGUE_EDGES, F32, GEMM_SHAPES, MASK_PROBES,
                         MHA_CASES, PAGED_CASES, POOL_SPECS, QUANT_SCALES,
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
                                  "granite-3-2b"])
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
