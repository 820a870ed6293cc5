"""Kernel benchmark of the PyTorch port: the rows of the JAX package's
``benchmarks/kernel_bench.py``, run through ``repro_torch.kernels.ops``.

    PYTHONPATH=src python -m repro_torch.launch.kernel_bench \\
        [--smoke] [--device cuda|cpu]

Prints CSV, one row per case, with the JAX benchmark's ``bench`` and
``shape`` values and its full (default) or ``--smoke`` shapes, plus three
rows for the kernels that benchmark never timed (``kernel_maxpool``,
``kernel_blocked_layout``, ``kernel_transpose``, at ResNet-50 and BERT-Base
shapes), so that every kernel of the port's kernel layer runs. Inputs are
drawn from a seeded numpy generator.

On CUDA (the default; raises without a device) each row gives the card's
own numbers, where the JAX benchmark gave an interpret-mode CPU time and a
derived TPU roofline:

- ``ms``: CUDA-event milliseconds per call of the kernel (the gather row:
  of the dense-gather path it measures), cycling through copies of the
  inputs that together exceed the 50 MB L2 cache three times, so that each
  call reads its inputs from device memory;
- ``plain_ms``: the same for the kernel's plain PyTorch version (``ref``);
- ``library_ms``: one PyTorch call computing the same function, where there
  is one (``torch.matmul``, ``torch._int_mm`` without the epilogue,
  ``F.conv2d`` on the padded input, SDPA, ``F.max_pool2d``, a
  ``contiguous()`` copy), else empty;
- ``bound_us`` and ``bound``: the least time the card could take, the
  larger of the bytes the function must move (each input read once, each
  output written once) over 3.35 TB/s and its operations over the H100 SXM
  peak for their type (67 TFLOP/s fp32 outside the tensor cores, 989
  TFLOP/s bf16, 1,979 TOP/s int8; NVIDIA's data sheet);
- ``spatial_util``: the tile-edge efficiency of the kernel's own blocking
  for the GEMM rows (fp32: 64 x 64 outputs, 16 deep per stage, the depth
  split into ranges of whole stages where the launcher's plan splits it,
  which adds no padding; int8: the 32 x 32 tiles, 128 deep, that the
  launcher takes at the int8 row's shape);
- ``err_of_limit``: the row's output against its plain version on the same
  inputs, as the worst element's (or query row's) error over its limit: 0
  where it must be bitwise equal (int8 GEMM, maxpool, reshuffler) and is;
  ``ref.sum_order_error`` for float GEMM and conv; ``ref.row_error`` over
  ``ref.ROW_TOL`` for attention. Above 1 the benchmark raises. Empty for
  the gather row, which is a plain version itself.

fp32 products run in full fp32 throughout (TF32 off for cuBLAS and cuDNN
while the benchmark runs), as the kernels compute. ``--device cpu`` runs the
plain versions once per row and reports no time: every time column reads
"not measured".
"""
from __future__ import annotations

import argparse
import contextlib
import csv
import math
import sys
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.kernels import ops, ref
from repro_torch.kernels.gemm_os import spatial_utilization

HBM_BYTES_S = 3.35e12           # H100 SXM device memory rate (data sheet)
PEAK_OPS_S = {                  # H100 SXM dense peaks (data sheet)
    torch.float32: 67e12,       # fp32, outside the tensor cores
    torch.bfloat16: 989e12,     # bf16 tensor cores
    torch.int8: 1979e12,        # int8 tensor cores
}
L2_BYTES = 50e6
NOT_MEASURED = "not measured"
COLUMNS = ("bench", "shape", "ms", "plain_ms", "library_ms", "bound_us",
           "bound", "spatial_util", "err_of_limit")
FLOAT_TILE = (64, 64, 16)       # os_tile.cuh's fp32 blocking (bm, bn, bk)
INT8_TILE = (32, 32, 128)       # its int8 blocking at the int8 row's shape
                                # (256x1024x256) on an H100's 132 SMs


def bound_ms(n_bytes: float, n_ops: float, dtype: torch.dtype
             ) -> Tuple[float, str]:
    """(least milliseconds, "bytes" or "operations"): the larger of the
    bytes over the device memory rate and the operations over the peak
    rate of ``dtype``."""
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = n_ops / PEAK_OPS_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn: Callable[[], object], iters: int = 20,
            warmup: int = 3) -> float:
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


def cold_copies(args: Sequence, n_bytes: float) -> List[tuple]:
    """``args`` and clones of its tensors, enough that one pass over them
    reads more than three times the L2 cache."""
    n = max(1, math.ceil(3 * L2_BYTES / max(n_bytes, 1.0)))
    return [tuple(args)] + [
        tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
        for _ in range(n - 1)]


def cold_ms(fn: Callable, copies: List[tuple], min_iters: int = 20) -> float:
    """CUDA-event ms per call of ``fn(*args)``, cycling through ``copies``
    (see ``cold_copies``)."""
    state = {"i": 0}

    def call():
        fn(*copies[state["i"] % len(copies)])
        state["i"] += 1
    return cuda_ms(call, iters=max(min_iters, len(copies)),
                   warmup=min(3, len(copies)))


@contextlib.contextmanager
def fp32_exact():
    """fp32 products in full fp32 inside: TF32 off for cuBLAS and for cuDNN
    (whose default is on), restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def conv_taps(H: int, W: int, R: int, S: int, stride: int) -> int:
    """Taps that land inside the image, summed over the output pixels of
    one image and channel pair (SAME padding): the MACs per (n, c, k)."""
    OH, OW, (pt, _), (pl, _) = ref.same_padding(H, W, R, S, stride)
    rows = sum(1 for oh in range(OH) for kh in range(R)
               if 0 <= oh * stride + kh - pt < H)
    cols = sum(1 for ow in range(OW) for kw in range(S)
               if 0 <= ow * stride + kw - pl < W)
    return rows * cols


# ---------------------------------------------------------------------------
# Agreement with the plain version: the worst error over its limit (<= 1)
# ---------------------------------------------------------------------------


def exact(got, want, args) -> float:
    """0 if ``got`` is bitwise ``want`` (``ref.bitwise_equal``), else inf."""
    return 0.0 if ref.bitwise_equal(got, want) else math.inf


def per_row(got, want, args) -> float:
    """Attention: the worst query row's error over the row's largest
    reference output (``ref.row_error``), over ``ref.ROW_TOL``."""
    # repro-lint: disable=host-sync — a correctness check, outside any timing
    return ref.row_error(got, want).max().item() / ref.ROW_TOL[got.dtype]


def sum_order(abs_fn: Callable, depth: int) -> Callable:
    """Float GEMM or conv: ``ref.sum_order_error`` at ``depth`` products,
    ``abs_fn`` being the plain version that takes |x| and |w| in fp32."""
    def agree(got, want, args) -> float:
        absp = abs_fn(*(a.abs().float() for a in args))
        # repro-lint: disable=host-sync — a correctness check, outside timing
        return ref.sum_order_error(got, want, absp, depth).item()
    return agree


# ---------------------------------------------------------------------------
# Cases: one dict per row
# ---------------------------------------------------------------------------


def _case(bench, shape, fn, args, plain, library, n_bytes, n_ops, dtype,
          util="", lib_args=None, agree=None) -> Dict:
    """``fn(*args)`` is the row's call, ``plain(*args)`` the kernel's plain
    version (or None), ``agree(fn's out, plain's out, args)`` the error over
    its limit between the two, ``library(*lib_args)`` the one-call
    yardstick (or None; ``lib_args`` default to ``args``); ``n_bytes`` and
    ``n_ops`` the work its bound counts, ``dtype`` the type of the
    operations."""
    assert (plain is None) == (agree is None), bench
    return dict(bench=bench, shape=shape, fn=fn, args=args, plain=plain,
                agree=agree, library=library, lib_args=args if lib_args is
                None else lib_args, n_bytes=n_bytes, n_ops=n_ops, dtype=dtype,
                util=util)


def _normal(rng, shape, dtype, dev):
    return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                        device=dev).to(dtype)


def _int8(rng, shape, dev):
    return torch.tensor(rng.integers(-128, 127, shape), dtype=torch.int8,
                        device=dev)


def int_mm_or_none(x: torch.Tensor, w: torch.Tensor) -> Optional[Callable]:
    """``torch._int_mm`` (int8 -> int32, no epilogue) where its shape rules
    allow (M > 16, K and N multiples of 8), else None."""
    M, K = x.shape
    N = w.shape[1]
    if M > 16 and K % 8 == 0 and N % 8 == 0:
        return torch._int_mm
    return None


def gemm_case(M: int, K: int, N: int, dtype, dev, *,
              quant_scale: Optional[float] = None, bench="kernel_gemm_os",
              shape: Optional[str] = None, seed: int = 0) -> Dict:
    """x (M, K) @ w (K, N): float inputs (yardstick torch.matmul), or int8
    inputs with the quant epilogue (yardstick torch._int_mm where its shape
    rules allow, int32 out without the epilogue)."""
    rng = np.random.default_rng(seed)
    shape = shape or f"{M}x{K}x{N}"
    if dtype == torch.int8:
        x, w = _int8(rng, (M, K), dev), _int8(rng, (K, N), dev)
        return _case(
            bench, shape, lambda x, w: ops.quant_matmul(x, w, quant_scale),
            (x, w), lambda x, w: ref.gemm_ref(x, w, quant_scale=quant_scale),
            int_mm_or_none(x, w), nbytes(x, w) + M * N, 2.0 * M * K * N,
            torch.int8, spatial_utilization(M, K, N, INT8_TILE), agree=exact)
    x, w = _normal(rng, (M, K), dtype, dev), _normal(rng, (K, N), dtype, dev)
    return _case(bench, shape, ops.matmul, (x, w), ref.gemm_ref, torch.matmul,
                 nbytes(x, w) + M * N * x.element_size(), 2.0 * M * K * N,
                 dtype, spatial_utilization(M, K, N, FLOAT_TILE),
                 agree=sum_order(ref.gemm_ref, K))


def gemm_cases(smoke: bool, dev) -> List[Dict]:
    shapes = [(256, 256, 256)] if smoke else \
        [(512, 512, 512), (1024, 1024, 1024), (128, 4096, 128)]
    return [gemm_case(M, K, N, torch.float32, dev, seed=i)
            for i, (M, K, N) in enumerate(shapes)] + [
        gemm_case(256, 1024, 256, torch.int8, dev, quant_scale=0.01,
                  bench="kernel_quant_gemm", shape="256x1024x256-int8",
                  seed=3)]


def mha_case(smoke: bool, dev, heads=(8, 2, 64)) -> Dict:
    """fp32 causal flash-MHA at B 1, S 1024 (256 smoke); ``heads`` = (query
    heads, KV heads, head dim), the bench row's by default."""
    rng = np.random.default_rng(4)
    H, KV, D = heads
    B, S = (1, 256) if smoke else (1, 1024)
    q = _normal(rng, (B, S, H, D), torch.float32, dev)
    k = _normal(rng, (B, S, KV, D), torch.float32, dev)
    v = _normal(rng, (B, S, KV, D), torch.float32, dev)

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)
    return _case("kernel_mha", f"B{B}S{S}H{H}kv{KV}D{D}", ops.attention,
                 (q, k, v), ref.mha_ref, sdpa, 2 * nbytes(q) + nbytes(k, v),
                 4.0 * B * H * D * S * (S + 1) / 2, torch.float32,
                 lib_args=tuple(t.transpose(1, 2).contiguous()
                                for t in (q, k, v)), agree=per_row)


def conv_case(dev, N=1, H=28, W=28, C=64, K=128, R=3, stride=1,
              dtype=torch.float32, bench="kernel_conv_im2col",
              shape="28x28x64->128 3x3", seed=7) -> Dict:
    rng = np.random.default_rng(seed)
    x = _normal(rng, (N, H, W, C), dtype, dev)
    w = _normal(rng, (R, R, C, K), dtype, dev)
    OH, OW, (pt, pb), (pl, pr) = ref.same_padding(H, W, R, R, stride)
    # the yardstick convolves the padded input (PyTorch has no uneven SAME
    # split): NCHW views of channels_last tensors
    xp = F.pad(x, (0, 0, pl, pr, pt, pb)).permute(0, 3, 1, 2)
    wl = w.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    def plain(x, w):
        return ref.conv2d_ref(x, w, stride=stride)
    return _case(bench, shape, lambda x, w: ops.conv2d(x, w, stride=stride),
                 (x, w), plain, lambda x, w: F.conv2d(x, w, stride=stride),
                 nbytes(x, w) + N * OH * OW * K * x.element_size(),
                 2.0 * N * conv_taps(H, W, R, R, stride) * C * K, dtype,
                 lib_args=(xp, wl), agree=sum_order(plain, R * R * C))


def paged_cases(smoke: bool, dev) -> List[Dict]:
    """The JAX benchmark's decode shapes: B requests at 1/4, 1/2, 3/4 and
    all of the table's span, pages in order after scratch page 0, fp32."""
    B, KV, G, D = (2, 2, 4, 64) if smoke else (4, 2, 4, 64)
    page, n_blocks = (16, 4) if smoke else (16, 16)
    H, S = KV * G, page * n_blocks
    P = 1 + B * n_blocks
    rng = np.random.default_rng(9)
    q = _normal(rng, (B, H, D), torch.float32, dev)
    kp = _normal(rng, (P, page, KV, D), torch.float32, dev)
    vp = _normal(rng, (P, page, KV, D), torch.float32, dev)
    bt = torch.arange(1, P, dtype=torch.int32, device=dev).reshape(
        B, n_blocks)
    lens = [S // 4, S // 2, 3 * S // 4, S][:B]
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    shape = f"B{B}H{H}kv{KV}D{D}p{page}x{n_blocks}"
    args = (q, kp, vp, bt, lengths)
    n_bytes = (2 * sum(lens) * KV * D * 4 + 2 * nbytes(q) + nbytes(bt)
               + nbytes(lengths))
    n_ops = 4.0 * H * D * sum(lens)
    return [
        _case("kernel_paged_attn", shape, ops.paged_attention, args,
              ref.paged_attention_ref, None, n_bytes, n_ops, torch.float32,
              agree=per_row),
        # the dense pool gather the kernel exists to avoid, as its own row
        _case("kernel_paged_attn_gather", shape, ref.paged_attention_ref,
              args, None, None, n_bytes, n_ops, torch.float32),
    ]


def pool_case(N: int, H: int, W: int, C: int, window: int, stride: int,
              dtype, dev, *, seed: int = 10) -> Dict:
    """VALID max-pool of (N, H, W, C); yardstick F.max_pool2d on the NCHW
    view (channels_last)."""
    rng = np.random.default_rng(seed)
    x = _normal(rng, (N, H, W, C), dtype, dev)
    OH, OW = (H - window) // stride + 1, (W - window) // stride + 1
    return _case(
        "kernel_maxpool", f"{N}x{H}x{W}x{C} {window}x{window}/{stride}",
        lambda x: ops.maxpool2d(x, window=window, stride=stride), (x,),
        lambda x: ref.maxpool2d_ref(x, window=window, stride=stride),
        lambda x: F.max_pool2d(x.permute(0, 3, 1, 2), window, stride),
        nbytes(x) + N * OH * OW * C * x.element_size(),
        float(N * OH * OW * C * (window * window - 1)), torch.float32,
        agree=exact)


def blocked_case(H: int, W: int, C: int, cb: int, dtype, dev, *,
                 seed: int = 11) -> Dict:
    """(H, W, C) -> (Cp/cb, H, W, cb); yardstick one contiguous() copy of
    the permuted view, where C % cb == 0 (padding would take a second
    call)."""
    rng = np.random.default_rng(seed)
    x = _normal(rng, (H, W, C), dtype, dev)
    Cp = -(-C // cb) * cb

    def library(x):
        return x.reshape(H, W, C // cb, cb).permute(2, 0, 1, 3).contiguous()
    return _case("kernel_blocked_layout", f"{H}x{W}x{C} cb{cb}",
                 lambda x: ops.blocked_layout(x, cb), (x,),
                 lambda x: ref.blocked_layout_ref(x, cb),
                 library if C % cb == 0 else None,
                 nbytes(x) + H * W * Cp * x.element_size(), 0.0,
                 torch.float32, agree=exact)


def transpose_case(M: int, N: int, dtype, dev, *, seed: int = 12) -> Dict:
    """(M, N) -> (N, M); yardstick x.t().contiguous()."""
    x = _normal(np.random.default_rng(seed), (M, N), dtype, dev)
    return _case("kernel_transpose", f"{M}x{N}", ops.transpose, (x,),
                 ref.transpose_ref, lambda x: x.t().contiguous(),
                 2 * nbytes(x), 0.0, torch.float32, agree=exact)


def layout_cases(smoke: bool, dev) -> List[Dict]:
    """The kernels the JAX benchmark never timed, at the paper's workload
    shapes: the ResNet-50 stem pool, its C/8HWC8 blocking, a BERT-Base FFN
    weight transpose."""
    f32 = torch.float32
    if smoke:
        return [pool_case(1, 16, 16, 8, 3, 2, f32, dev),
                blocked_case(8, 8, 32, 8, f32, dev),
                transpose_case(64, 48, f32, dev)]
    return [pool_case(1, 112, 112, 64, 3, 2, f32, dev),
            blocked_case(56, 56, 256, 8, f32, dev),
            transpose_case(3072, 768, f32, dev)]


def cases(smoke: bool, dev) -> List[Dict]:
    """Every row's case, in the JAX benchmark's row order, then the three
    rows it lacks."""
    return (gemm_cases(smoke, dev) + [mha_case(smoke, dev), conv_case(dev)]
            + paged_cases(smoke, dev) + layout_cases(smoke, dev))


def _finite(out) -> bool:
    return bool(torch.isfinite(out.float()).all())


def measure(c: Dict) -> Dict:
    """On the card: ms per call of the case's kernel, its plain version and
    its yardstick (None where there is none), each cycling through cold
    copies of its inputs, and the bound."""
    copies = cold_copies(c["args"], c["n_bytes"])
    out = {"ms": cold_ms(c["fn"], copies),
           "plain_ms": None if c["plain"] is None else
           cold_ms(c["plain"], copies, min_iters=5),
           "library_ms": None if c["library"] is None else
           cold_ms(c["library"], cold_copies(c["lib_args"], c["n_bytes"]))}
    out["bound_ms"], out["bound_by"] = bound_ms(c["n_bytes"], c["n_ops"],
                                                c["dtype"])
    return out


def run(smoke: bool = False, device="cuda") -> List[Dict]:
    """The benchmark's rows. Raises if any output is not finite or
    disagrees with the kernel's plain version on the same inputs."""
    dev = resolve_device(device)
    rows = []
    with fp32_exact():
        for c in cases(smoke, dev):
            label = f"{c['bench']} {c['shape']}"
            out = c["fn"](*c["args"])
            if not _finite(out):
                raise RuntimeError(f"{label}: output not finite")
            err = ""
            if c["plain"] is not None:
                err = c["agree"](out, c["plain"](*c["args"]), c["args"])
                if not err <= 1:
                    raise RuntimeError(
                        f"{label}: disagrees with its plain version, worst "
                        f"error at {err:.3g} of its limit")
            bms, by = bound_ms(c["n_bytes"], c["n_ops"], c["dtype"])
            row = {"bench": c["bench"], "shape": c["shape"],
                   "ms": NOT_MEASURED, "plain_ms": NOT_MEASURED,
                   "library_ms": NOT_MEASURED, "bound_us": bms * 1e3,
                   "bound": by, "spatial_util": c["util"],
                   "err_of_limit": err}
            if dev.type == "cuda":
                m = measure(c)
                row.update({k: "" if m[k] is None else m[k]
                            for k in ("ms", "plain_ms", "library_ms")})
            rows.append(row)
    return rows


def write_csv(rows: List[Dict], out=None) -> None:
    w = csv.DictWriter(out or sys.stdout, fieldnames=COLUMNS,
                       lineterminator="\n")
    w.writeheader()
    for r in rows:
        w.writerow({k: (f"{v:.6g}" if isinstance(v, float) else v)
                    for k, v in r.items()})


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="the JAX benchmark's smoke shapes")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a CUDA device) or "
                         "cpu (plain versions, no times)")
    args = ap.parse_args(argv)
    write_csv(run(smoke=args.smoke, device=args.device))


if __name__ == "__main__":
    main()
