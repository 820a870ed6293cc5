"""The port's kernel layer (output-stationary GEMM with the int8 quant
epilogue, implicit-im2col conv, maxpool, the reshuffler) against the JAX
package's, on the cases of tests/test_kernels.py, and the kernel benchmark
port against benchmarks/kernel_bench.py.

On the CPU the port's ``kernels.ops`` runs the plain PyTorch versions
(``repro_torch.kernels.ref``); they are held against the JAX Pallas kernels
in interpret mode (``repro.kernels.ops``, ``repro.kernels.maxpool``) and the
JAX oracles (``repro.kernels.ref``, ``maxpool2d_ref``) on the same numpy
inputs. The CUDA kernels are held against the plain versions on the same
cases by tests/test_torch_gpu.py.

Tolerances: exact where the JAX test is exact (int8 GEMM and its epilogue,
maxpool, blocked layout, transpose). Float GEMM and conv: within
``ref.sum_order_error`` — both sides sum the same fp32 products in another
order, so each element stays within depth * 2^-24 * (|x| @ |w|), plus one
bf16 step of the output for bf16.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")     # held against the JAX package

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.gemm_os import \
    spatial_utilization as jax_spatial_utilization  # noqa: E402
from repro.kernels.maxpool import maxpool2d as jmaxpool2d  # noqa: E402
from repro.kernels.maxpool import maxpool2d_ref as jmaxpool2d_ref  # noqa: E402
from repro_torch.kernels import conv_im2col as conv_kernel  # noqa: E402
from repro_torch.kernels import gemm_os as gemm_kernel  # noqa: E402
from repro_torch.kernels import maxpool as pool_kernel  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import reshuffle as reshuffle_kernel  # noqa: E402
from repro_torch.launch import kernel_bench  # noqa: E402
from torch_cases import (BLOCKED_CASES, CONV_SPECS, GEMM_SHAPES,  # noqa: E402
                         POOL_SPECS, QUANT_SCALES, TRANSPOSE_SHAPES,
                         gemm_inputs, normal, pool_input)

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "int8": (torch.int8, jnp.int8)}


def both(x: np.ndarray, dtype: str):
    """The same numbers as a torch tensor and a jax array of ``dtype``
    (float32 values round to bf16 alike on both sides)."""
    t, j = DTYPES[dtype]
    return torch.from_numpy(x).to(t), jnp.asarray(x, j)


def to_torch(a) -> torch.Tensor:
    """A jax array as a torch tensor, bf16 included (through float32:
    exact)."""
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def assert_sum_order(got, want, abs_product, depth):
    worst = ref.sum_order_error(got, want, abs_product, depth).item()
    assert worst <= 1, worst


# ---------------------------------------------------------------------------
# gemm_os
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("mkn", GEMM_SHAPES)
def test_plain_gemm_matches_jax_kernel_and_oracle(mkn, dtype):
    M, K, N = mkn
    (xt, xj), (wt, wj) = (both(a, dtype) for a in gemm_inputs(
        sum(mkn), M, K, N, integer=dtype == "int8"))
    got = ops.matmul(xt, wt)
    for want in (jops.matmul(xj, wj), jref.gemm_ref(xj, wj)):
        want = to_torch(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        if dtype == "int8":
            assert torch.equal(got, want)
        else:
            assert_sum_order(got, want, ref.gemm_ref(xt.abs().float(),
                                                     wt.abs().float()), K)


@pytest.mark.parametrize("scale", QUANT_SCALES)
def test_plain_quant_epilogue_matches_jax_exactly(scale):
    (xt, xj), (wt, wj) = (both(a, "int8") for a in gemm_inputs(
        4, 64, 256, 96, integer=True))
    got = ops.quant_matmul(xt, wt, scale)
    assert got.dtype == torch.int8
    assert torch.equal(got, to_torch(jops.quant_matmul(xj, wj, scale)))
    assert torch.equal(got, to_torch(jref.gemm_ref(xj, wj,
                                                   quant_scale=scale)))


def test_plain_quant_epilogue_rounds_half_to_even():
    """acc * scale landing on .5 rounds to the even neighbour, as jnp.round
    does: 1 * 0.5 -> 0, 3 * 0.5 -> 2, -5 * 0.5 -> -2; and clips to int8."""
    x = torch.tensor([[1], [3], [-5], [127]], dtype=torch.int8)
    w = torch.tensor([[1, 127]], dtype=torch.int8)
    got = ops.quant_matmul(x, w, 0.5)
    assert got.tolist() == [[0, 64], [2, 127], [-2, -128], [64, 127]]
    want = jref.gemm_ref(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                         quant_scale=0.5)
    assert torch.equal(got, to_torch(want))


def test_plain_int8_accumulates_in_int32():
    # 512 * 127 * 127 overflows int16 by far; int32 must hold it exactly
    x = torch.full((8, 512), 127, dtype=torch.int8)
    got = ops.matmul(x, x.t().contiguous())
    assert got.dtype == torch.int32
    assert int(got[0, 0]) == 512 * 127 * 127
    j = jnp.full((8, 512), 127, jnp.int8)
    assert torch.equal(got, to_torch(jops.matmul(j, j.T)))


def test_spatial_utilization_equals_jax():
    dims = [1, 7, 64, 100, 128, 129, 256, 1000]
    for block in [(128, 128, 128), (64, 64, 16), (8, 16, 32)]:
        for M in dims:
            for K in dims:
                for N in dims:
                    assert gemm_kernel.spatial_utilization(M, K, N, block) \
                        == jax_spatial_utilization(M, K, N, block)
    assert gemm_kernel.spatial_utilization(129, 128, 128) == \
        pytest.approx(129 / 256)


# ---------------------------------------------------------------------------
# conv_im2col
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", CONV_SPECS)
def test_plain_conv_matches_jax_kernel_and_oracle(spec):
    H, W, C, K, R, stride = spec
    xt, xj = both(normal(H + W, 2, H, W, C), "float32")
    wt, wj = both(normal(C + K, R, R, C, K), "float32")
    got = ops.conv2d(xt, wt, stride=stride)
    absp = ref.conv2d_ref(xt.abs(), wt.abs(), stride=stride)
    for want in (jops.conv2d(xj, wj, stride=stride),
                 jref.conv2d_ref(xj, wj, stride=stride)):
        want = to_torch(want)
        assert got.shape == want.shape
        assert_sum_order(got, want, absp, R * R * C)


def test_plain_conv_bf16_matches_jax_oracle():
    xt, xj = both(normal(1, 2, 9, 9, 16), "bfloat16")
    wt, wj = both(normal(2, 3, 3, 16, 8), "bfloat16")
    got = ops.conv2d(xt, wt, stride=2)
    assert got.dtype == torch.bfloat16
    assert_sum_order(got, to_torch(jref.conv2d_ref(xj, wj, stride=2)),
                     ref.conv2d_ref(xt.abs().float(), wt.abs().float(),
                                    stride=2), 3 * 3 * 16)


def test_same_padding_splits_like_lax():
    """(p//2, p - p//2), OH = ceil(H / stride): the 7x7/2 stem on 224 pads
    2 above and 3 below; a padding shifted by one row is caught."""
    assert ref.same_padding(224, 224, 7, 7, 2) == (112, 112, (2, 3), (2, 3))
    xt, xj = both(normal(5, 1, 14, 14, 3), "float32")
    wt, wj = both(normal(6, 7, 7, 3, 4), "float32")
    want = to_torch(jref.conv2d_ref(xj, wj, stride=2))
    absp = ref.conv2d_ref(xt.abs(), wt.abs(), stride=2)
    assert_sum_order(ops.conv2d(xt, wt, stride=2), want, absp, 7 * 7 * 3)
    shifted = torch.nn.functional.pad(xt, (0, 0, 0, 0, 1, 0))[:, :-1]
    assert ref.sum_order_error(ops.conv2d(shifted, wt, stride=2), want,
                               absp, 7 * 7 * 3) > 1


# ---------------------------------------------------------------------------
# maxpool
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("spec", POOL_SPECS)
def test_plain_maxpool_matches_jax_kernel_and_oracle(spec, nan):
    H, W, C, win, stride = spec
    x = pool_input(H * C, H, W, C, nan=nan)
    got = ops.maxpool2d(torch.from_numpy(x), window=win, stride=stride)
    assert got.isnan().any() == nan
    xj = jnp.asarray(x)
    for want in (jmaxpool2d(xj, window=win, stride=stride),
                 jmaxpool2d_ref(xj, window=win, stride=stride)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_plain_maxpool_bf16_matches_jax():
    xt, xj = both(pool_input(3, 9, 9, 8), "bfloat16")
    got = ops.maxpool2d(xt, window=3, stride=2)
    assert torch.equal(got, to_torch(jmaxpool2d(xj, window=3, stride=2)))


# ---------------------------------------------------------------------------
# reshuffle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", BLOCKED_CASES)
def test_plain_blocked_layout_matches_jax_kernel_and_oracle(case):
    H, W, C, cb = case
    x = normal(C + cb, H, W, C)
    got = ops.blocked_layout(torch.from_numpy(x), cb)
    Cp = -(-C // cb) * cb
    assert got.shape == (Cp // cb, H, W, cb)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jops.blocked_layout(jnp.asarray(x), cb)))
    # the JAX oracle takes C % cb == 0 only: hold it to the padded input
    xp = np.pad(x, ((0, 0), (0, 0), (0, Cp - C)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jref.blocked_layout_ref(jnp.asarray(xp), cb)))
    assert not got.numpy()[-1, :, :, cb - (Cp - C):].any()


@pytest.mark.parametrize("mn", TRANSPOSE_SHAPES)
def test_plain_transpose_matches_jax_kernel_and_oracle(mn):
    x = normal(sum(mn), *mn)
    got = ops.transpose(torch.from_numpy(x))
    assert got.is_contiguous()
    for want in (jops.transpose(jnp.asarray(x)),
                 jref.transpose_ref(jnp.asarray(x))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bitwise_equal_ignores_nan_payload_only():
    a = torch.tensor([1.0, float("nan"), 0.0])
    other_nan = a.clone()
    other_nan.view(torch.int32)[1] = 0x7FFFFFFF      # another NaN payload
    assert ref.bitwise_equal(a, other_nan)
    assert ref.bitwise_equal(a.bfloat16(), other_nan.bfloat16())
    assert not ref.bitwise_equal(a, torch.tensor([1.0, 1.0, 0.0]))
    assert not ref.bitwise_equal(a, torch.tensor([1.0, float("nan"), -0.0]))
    assert not ref.bitwise_equal(a, a.bfloat16())
    assert ref.bitwise_equal(torch.arange(3), torch.arange(3))


# ---------------------------------------------------------------------------
# The CUDA wrappers, and the benchmark port
# ---------------------------------------------------------------------------


WRAPPERS = {
    "gemm_os": lambda: gemm_kernel.gemm_os(torch.ones(4, 4),
                                           torch.ones(4, 4)),
    "gemm_os_int8": lambda: gemm_kernel.gemm_os(
        torch.ones(4, 4, dtype=torch.int8), torch.ones(4, 4, dtype=torch.int8),
        quant_scale=0.5),
    "conv_im2col": lambda: conv_kernel.conv2d(torch.ones(1, 4, 4, 2),
                                              torch.ones(3, 3, 2, 2)),
    "maxpool": lambda: pool_kernel.maxpool2d(torch.ones(1, 4, 4, 2)),
    "blocked_layout": lambda: reshuffle_kernel.blocked_layout(
        torch.ones(4, 4, 8), 8),
    "tiled_transpose": lambda: reshuffle_kernel.tiled_transpose(
        torch.ones(4, 3)),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_kernel_wrappers_refuse_cpu_tensors(name):
    """A CUDA wrapper never falls back: a CPU tensor is an error there, and
    nothing is launched or counted (kernels.ops routes CPU tensors to the
    plain versions instead)."""
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        WRAPPERS[name]()
    assert ops.launch_counts() == before


@pytest.mark.slow               # ~6 s: the port's rows run their plain versions
@pytest.mark.parametrize("smoke", [True, False])
def test_kernel_bench_rows_match_jax_kernel_bench(smoke, monkeypatch,
                                                  capsys):
    """The port's benchmark on the CPU: the JAX benchmark's (bench, shape)
    rows in its order, then the three kernels it never timed; no time on
    the CPU, only the card's bound."""
    from benchmarks import kernel_bench as jax_bench
    # the JAX rows' labels come from shapes alone: skip its interpret runs
    monkeypatch.setattr(jax_bench, "time_call",
                        lambda fn, *a, reps=3, warmup=1: 0.0)
    want = [(r["bench"], r["shape"]) for r in jax_bench.run(smoke=smoke)]
    kernel_bench.main(["--device", "cpu"] + (["--smoke"] if smoke else []))
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == ",".join(kernel_bench.COLUMNS)
    rows = [dict(zip(kernel_bench.COLUMNS, ln.split(","))) for ln in lines[1:]]
    got = [(r["bench"], r["shape"]) for r in rows]
    assert got[:len(want)] == want
    assert [b for b, _ in got[len(want):]] == [
        "kernel_maxpool", "kernel_blocked_layout", "kernel_transpose"]
    for r in rows:
        assert r["ms"] == r["plain_ms"] == r["library_ms"] == "not measured"
        assert float(r["bound_us"]) > 0 and r["bound"] in ("bytes",
                                                           "operations")
        # on the CPU the row's call is its plain version: no error at all
        assert r["err_of_limit"] == (
            "" if r["bench"] == "kernel_paged_attn_gather" else "0")


FAULTS = {
    # a row whose call has a known fault, by the rule that must catch it
    "float gemm, last K value dropped": lambda: dict(
        kernel_bench.gemm_case(33, 40, 17, torch.float32, "cpu"),
        fn=lambda x, w: ref.gemm_ref(x[:, :-1], w[:-1])),
    "bf16 conv, input shifted a row": lambda: dict(
        kernel_bench.conv_case("cpu", 1, 9, 9, 4, 8, 3, 2, torch.bfloat16),
        fn=lambda x, w: ref.conv2d_ref(
            torch.nn.functional.pad(x, (0, 0, 0, 0, 1, 0))[:, :-1], w,
            stride=2)),
    "int8 epilogue, scale off by 1%": lambda: dict(
        kernel_bench.gemm_case(16, 64, 16, torch.int8, "cpu",
                               quant_scale=0.01),
        fn=lambda x, w: ref.gemm_ref(x, w, quant_scale=0.0101)),
    "mha, one key masked out": lambda: dict(
        kernel_bench.mha_case(True, "cpu"),
        fn=lambda q, k, v: ref.mha_ref(q, k, v, causal=True,
                                       kv_valid=k.shape[1] - 1)),
    "transpose, one element off": lambda: dict(
        kernel_bench.transpose_case(8, 6, torch.float32, "cpu"),
        fn=lambda x: ref.transpose_ref(x).index_put_(
            (torch.tensor(0), torch.tensor(0)), torch.tensor(7.0))),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_kernel_bench_rejects_a_row_that_disagrees_with_its_plain_version(
        fault, monkeypatch):
    """Every row's output is held against its kernel's plain version on the
    same inputs; a known fault stops the benchmark."""
    monkeypatch.setattr(kernel_bench, "cases",
                        lambda smoke, dev: [FAULTS[fault]()])
    with pytest.raises(RuntimeError, match="disagrees with its plain"):
        kernel_bench.run(smoke=True, device="cpu")


def test_bound_counts_each_byte_once_at_h100_peaks():
    ms, by = kernel_bench.bound_ms(3.35e9, 0.0, torch.float32)
    assert (ms, by) == (pytest.approx(1.0), "bytes")
    ms, by = kernel_bench.bound_ms(0.0, 989e9, torch.bfloat16)
    assert (ms, by) == (pytest.approx(1.0), "operations")
    assert kernel_bench.bound_ms(0.0, 1979e9, torch.int8)[0] == \
        pytest.approx(1.0)
    assert kernel_bench.bound_ms(0.0, 67e9, torch.float32)[0] == \
        pytest.approx(1.0)
    # stride 1, 3x3 on 3x3: 4 + 6 + 4 + 6 + 9 + 6 + 4 + 6 + 4 in-image taps
    assert kernel_bench.conv_taps(3, 3, 3, 3, 1) == 49
