"""Wrapper of the output-stationary GEMM CUDA kernel (``csrc/gemm_os.cu``).

The Hopper counterpart of ``repro.kernels.gemm_os``: ``x (M, K) @ w (K, N)``
with the accumulator held for the whole K sweep, float inputs accumulated
in fp32, int8 inputs in int32, and the fused int8 quantisation epilogue
(Voltra C1 + C4). Same public signature and layouts as the JAX ``gemm_os``
(the TPU ``block`` sizes have no counterpart: the CUDA launcher picks its
tiles, on the tensor cores 64 x 64 or 32 x 32, whichever leaves the busiest
of the card's SMs fewer bytes to load, and masks ragged edges instead of
padding). bf16 and int8 inputs run on the tensor cores, fp32 inputs on the
FMA units in 64 x 64 tiles, 16 deep per ``cp.async`` stage, with the depth
split over CTAs where the tiles alone leave the SMs short of warps
(``f32_plan``; the partials are added in a fixed order, so two runs give the
same bits). CUDA tensors only: ``kernels.ops.matmul`` / ``quant_matmul`` route
CPU tensors to ``ref.gemm_ref``.

``spatial_utilization`` is the JAX module's tile-edge formula, copied (it is
pure Python and the port imports nothing of ``repro``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.int32: 3}
_FLOAT = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("gemm_os")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gemm_os_launch.argtypes = [p, p, p, i, i, i, i, i, i, f, p]
    lib.gemm_os_launch.restype = ctypes.c_int
    lib.gemm_os_f32_plan.argtypes = [i, i, i, i, p]
    lib.gemm_os_f32_plan.restype = None
    lib.gemm_os_f32_launch.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.gemm_os_f32_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=4096)
def f32_plan(M: int, N: int, K: int, sms: int) -> Tuple[int, int, int, int]:
    """The fp32 path's plan for x (M, K) @ w (K, N) on ``sms`` SMs, from
    the launcher (``gemm_os_f32_plan``): (tile rows, tile columns, depth
    values per range, ranges). More than one range: the depth is split,
    the partials go to a workspace and a second pass adds them in rank
    order."""
    plan = (ctypes.c_int * 4)()
    _lib().gemm_os_f32_plan(M, N, K, sms, plan)
    return tuple(plan)


def workspace_numel(M: int, N: int, plan: Tuple[int, int, int, int]) -> int:
    """fp32 elements of the workspace a plan needs (0 without a split):
    one (M, N) slice per range, rounded up to whole tiles."""
    bm, bn, _, splits = plan
    return 0 if splits == 1 else splits * -(-M // bm) * bm * -(-N // bn) * bn


def _require(ok: bool, msg: str, *args) -> None:
    """Raise with ``msg.format(*args)`` unless ``ok``; the message is built
    only on failure (its formatting would cost every call microseconds)."""
    if not ok:
        raise ValueError("gemm_os kernel: " + msg.format(*args))


# the smallest row tile the launcher can pick: row tiles go on grid.y,
# which holds at most 65535
_MIN_ROW_TILE = 32


def gemm_os(x: torch.Tensor, w: torch.Tensor, *, out_dtype=None,
            quant_scale: Optional[float] = None) -> torch.Tensor:
    """out (M, N) = x (M, K) @ w (K, N), both contiguous, one dtype.

    float32 / bfloat16 inputs: fp32 accumulation, output ``out_dtype``
    (float32 or bfloat16; default x's dtype). int8 inputs: int32
    accumulation, int32 output; with ``quant_scale`` the fused epilogue
    ``clip(round_half_even(float32(acc) * scale), -128, 127)`` gives int8.
    """
    build.refuse_fake("gemm_os", x, w)
    build.refuse_grad("gemm_os", x, w)
    _require(x.is_cuda, "needs CUDA tensors (CPU tensors go through "
             "repro_torch.kernels.ops)")
    _require(x.dim() == 2 and w.dim() == 2 and x.shape[1] == w.shape[0],
             "x (M, K) and w (K, N), got {}, {}", x.shape, w.shape)
    M, K = x.shape
    N = w.shape[1]
    _require(min(M, K, N) >= 1, "empty product {}x{}x{}", M, K, N)
    _require(w.dtype == x.dtype, "dtypes {}/{} differ", x.dtype, w.dtype)
    _require(w.device == x.device, "w on {}, x on {}", w.device, x.device)
    _require(x.is_contiguous() and w.is_contiguous(),
             "x and w must be contiguous")
    integer = x.dtype == torch.int8
    if quant_scale is not None:
        _require(integer, "the quant epilogue takes int8 inputs, got {}",
                 x.dtype)
        _require(out_dtype in (None, torch.int8),
                 "the quant epilogue stores int8, not {}", out_dtype)
        out_dtype = torch.int8
    elif integer:
        _require(out_dtype in (None, torch.int32),
                 "int8 inputs give int32, not {}", out_dtype)
        out_dtype = torch.int32
    else:
        _require(x.dtype in _FLOAT, "dtype {} (float32, bfloat16 or int8)",
                 x.dtype)
        out_dtype = x.dtype if out_dtype is None else out_dtype
        _require(out_dtype in _FLOAT,
                 "float inputs give float32 or bfloat16, not {}", out_dtype)
    _require(-(-M // _MIN_ROW_TILE) < 65536,
             "M = {} needs more than 65535 row tiles", M)

    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if x.dtype == torch.float32:
        plan = f32_plan(M, N, K, build.sm_count(x.device.index))
        ws = workspace_numel(M, N, plan)
        ws = torch.empty(ws, dtype=torch.float32, device=x.device) \
            if ws else None
        err = build.launch_on(
            x.device, _lib().gemm_os_f32_launch, x.data_ptr(), w.data_ptr(),
            out.data_ptr(), None if ws is None else ws.data_ptr(), M, N, K,
            _CODES[out_dtype], plan[2])
    else:
        err = build.launch_on(
            x.device, _lib().gemm_os_launch, x.data_ptr(), w.data_ptr(),
            out.data_ptr(), M, N, K, _CODES[x.dtype], _CODES[out_dtype],
            int(quant_scale is not None),
            0.0 if quant_scale is None else quant_scale)
    if err:
        raise RuntimeError(f"gemm_os kernel launch failed: CUDA error {err}")
    if integer:
        gemm_os.int8_launches += 1
    else:
        gemm_os.launches += 1
    return out


gemm_os.launches = 0        # float datapath
gemm_os.int8_launches = 0   # int8 datapath (with or without the epilogue)


def spatial_utilization(M: int, K: int, N: int,
                        block: Tuple[int, int, int] = (128, 128, 128)
                        ) -> float:
    """Tile-edge efficiency of the 3D blocking — the same formula as the
    chip's spatial utilization (core/spatial.py), at MXU granularity."""
    bm, bn, bk = block

    def eff(d, b):
        return d / (b * -(-d // b))

    return eff(M, bm) * eff(N, bn) * eff(K, bk)
