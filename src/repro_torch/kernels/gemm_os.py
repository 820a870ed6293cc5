"""Wrapper of the output-stationary GEMM CUDA kernel (``csrc/gemm_os.cu``).

The Hopper counterpart of ``repro.kernels.gemm_os``: ``x (M, K) @ w (K, N)``
with the accumulator held for the whole K sweep, float inputs accumulated
in fp32, int8 inputs in int32, and the fused int8 quantisation epilogue
(Voltra C1 + C4). Same public signature and layouts as the JAX ``gemm_os``
(the TPU ``block`` sizes have no counterpart: the CUDA kernel's tiles are
fixed at 64 x 64, and it masks ragged edges instead of padding). CUDA
tensors only: ``kernels.ops.matmul`` / ``quant_matmul`` route CPU tensors to
``ref.gemm_ref``.

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
    return lib


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(f"gemm_os kernel: {msg}")


def gemm_os(x: torch.Tensor, w: torch.Tensor, *, out_dtype=None,
            quant_scale: Optional[float] = None) -> torch.Tensor:
    """out (M, N) = x (M, K) @ w (K, N), both contiguous, one dtype.

    float32 / bfloat16 inputs: fp32 accumulation, output ``out_dtype``
    (float32 or bfloat16; default x's dtype). int8 inputs: int32
    accumulation, int32 output; with ``quant_scale`` the fused epilogue
    ``clip(round_half_even(float32(acc) * scale), -128, 127)`` gives int8.
    """
    _require(x.is_cuda, "needs CUDA tensors (CPU tensors go through "
             "repro_torch.kernels.ops)")
    _require(x.dim() == 2 and w.dim() == 2 and x.shape[1] == w.shape[0],
             f"x (M, K) and w (K, N), got {tuple(x.shape)}, "
             f"{tuple(w.shape)}")
    M, K = x.shape
    N = w.shape[1]
    _require(min(M, K, N) >= 1, f"empty product {M}x{K}x{N}")
    _require(w.dtype == x.dtype, f"dtypes {x.dtype}/{w.dtype} differ")
    _require(w.device == x.device, f"w on {w.device}, x on {x.device}")
    _require(x.is_contiguous() and w.is_contiguous(),
             "x and w must be contiguous")
    integer = x.dtype == torch.int8
    if quant_scale is not None:
        _require(integer, f"the quant epilogue takes int8 inputs, got "
                 f"{x.dtype}")
        _require(out_dtype in (None, torch.int8),
                 f"the quant epilogue stores int8, not {out_dtype}")
        out_dtype = torch.int8
    elif integer:
        _require(out_dtype in (None, torch.int32),
                 f"int8 inputs give int32, not {out_dtype}")
        out_dtype = torch.int32
    else:
        _require(x.dtype in _FLOAT, f"dtype {x.dtype} (float32, bfloat16 "
                 f"or int8)")
        out_dtype = x.dtype if out_dtype is None else out_dtype
        _require(out_dtype in _FLOAT, f"float inputs give float32 or "
                 f"bfloat16, not {out_dtype}")
    _require(-(-M // 64) < 65536, f"M = {M} needs more than 65535 row tiles")

    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().gemm_os_launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K,
            _CODES[x.dtype], _CODES[out_dtype], int(quant_scale is not None),
            0.0 if quant_scale is None else quant_scale, stream)
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
