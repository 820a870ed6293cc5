"""The port's CUDA kernels and engine on the card, against their plain
PyTorch versions (run there: ``PYTHONPATH=src python -m pytest -m gpu
tests/test_torch_*.py``). Every test is marked ``gpu`` and skips, inside
its fixture, when no CUDA device is present. Imports no jax: the card's
machine runs the port alone."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import attention as mha_kernel  # noqa: E402
from repro_torch.kernels import conv_im2col as conv_kernel  # noqa: E402
from repro_torch.kernels import gemm_os as gemm_kernel  # noqa: E402
from repro_torch.kernels import maxpool as pool_kernel  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import paged_attention as paged_kernel  # noqa: E402
from repro_torch.kernels import reshuffle as reshuffle_kernel  # noqa: E402
from repro_torch.launch import kernel_bench  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.runtime.serving import PagedServingEngine, Request  # noqa
from torch_cases import (BLOCKED_CASES, CONV_SPECS, F32,  # noqa: E402
                         GEMM_SHAPES, MHA_CASES, PAGED_CASES, POOL_SPECS,
                         QUANT_SCALES, TRANSPOSE_SHAPES, gemm_inputs,
                         mha_inputs, normal, paged_inputs, pool_input)


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
def test_cuda_engine_tokens_equal_cpu_engine(cuda):
    """fp32 smoke model: the engine on the card (both kernels) emits the
    CPU engine's greedy tokens (plain versions), through a preemption, and
    launches each kernel once per layer per decode step / prefill."""
    cfg = dataclasses.replace(get_smoke_config("qwen2.5-3b"),
                              dtype="float32")
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, dev) for v in tree]
        return tree.to(dev)

    out = {}
    for dev in ("cpu", cuda):
        eng = PagedServingEngine(cfg, to(params, dev), slots=2, max_len=32,
                                 page_size=4, num_pages=4, device=dev)
        reqs = [Request(rid=0, prompt=[5, 4, 3, 2, 1, 6, 7], max_new=8),
                Request(rid=1, prompt=[1, 2, 3, 4, 5, 6], max_new=8)]
        before = ops.launch_counts()
        eng.run_to_completion(reqs, max_steps=400)
        after = ops.launch_counts()
        out[str(dev)] = [r.generated for r in reqs]
        eng.alloc.check_no_aliasing()
    assert after["paged_attention"] - before["paged_attention"] == \
        cfg.num_layers * eng.decode_steps
    assert after["mha"] - before["mha"] == cfg.num_layers * eng.prefills
    assert out["cuda"] == out["cpu"]


# ---------------------------------------------------------------------------
# On the card: the kernel layer against its plain versions
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("mkn", GEMM_SHAPES)
def test_cuda_gemm_matches_plain(fp32_exact, mkn, dtype):
    M, K, N = mkn
    dt = getattr(torch, dtype)
    x, w = (torch.from_numpy(a).to(fp32_exact, dt) for a in gemm_inputs(
        sum(mkn), M, K, N, integer=dtype == "int8"))
    attr = "int8_launches" if dtype == "int8" else "launches"
    got = launched_once(lambda: getattr(gemm_kernel.gemm_os, attr),
                        lambda: ops.matmul(x, w))
    want = ref.gemm_ref(x, w)
    if dtype == "int8":
        assert ref.bitwise_equal(got, want)
    else:
        worst = ref.sum_order_error(got, want, ref.gemm_ref(
            x.abs().float(), w.abs().float()), K).item()
        assert worst <= 1, worst


@pytest.mark.gpu
@pytest.mark.parametrize("types", [("float32", "bfloat16"),
                                   ("bfloat16", "float32")])
@pytest.mark.parametrize("mkn", [(1, 512, 96), (257, 129, 65)])
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
@pytest.mark.parametrize("spec", CONV_SPECS)
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
@pytest.mark.parametrize("mn", TRANSPOSE_SHAPES)
def test_cuda_transpose_matches_plain(cuda, mn, dtype):
    x = torch.from_numpy(normal(sum(mn), *mn)).to(cuda,
                                                  getattr(torch, dtype))
    got = launched_once(lambda: reshuffle_kernel.tiled_transpose.launches,
                        lambda: ops.transpose(x))
    assert ref.bitwise_equal(got, ref.transpose_ref(x))


@pytest.mark.gpu
def test_cuda_kernel_bench_smoke_launches_every_kernel(cuda):
    ops.reset_launch_counts()
    rows = kernel_bench.run(smoke=True, device=cuda)
    assert all(n > 0 for n in ops.launch_counts().values()), \
        ops.launch_counts()
    assert all(isinstance(r["ms"], float) and r["ms"] > 0 for r in rows)
    assert all(r["err_of_limit"] == "" or r["err_of_limit"] <= 1
               for r in rows)
