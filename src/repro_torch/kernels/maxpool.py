"""Wrapper of the max-pool CUDA kernel (``csrc/maxpool.cu``).

The Hopper counterpart of ``repro.kernels.maxpool``: VALID max-pool over
NHWC with a square window and stride, compared in fp32, NaN propagating.
CUDA tensors only: ``kernels.ops.maxpool2d`` routes CPU tensors to
``ref.maxpool2d_ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("maxpool")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.maxpool_launch.argtypes = [p, p] + [i] * 9 + [p]
    lib.maxpool_launch.restype = ctypes.c_int
    return lib


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(f"maxpool kernel: {msg}")


def maxpool2d(x: torch.Tensor, *, window: int = 2, stride: int = 2
              ) -> torch.Tensor:
    """x: (N, H, W, C) float32 or bfloat16, contiguous; VALID padding ->
    (N, OH, OW, C), OH = (H - window) // stride + 1."""
    _require(x.is_cuda, "needs CUDA tensors (CPU tensors go through "
             "repro_torch.kernels.ops)")
    _require(x.dim() == 4 and x.numel() > 0,
             f"x must be a non-empty (N, H, W, C), got {tuple(x.shape)}")
    N, H, W, C = x.shape
    _require(window >= 1 and stride >= 1 and window <= min(H, W),
             f"window {window}, stride {stride} on {H}x{W}")
    _require(x.dtype in _DTYPES, f"dtype {x.dtype} (float32 or bfloat16)")
    _require(x.is_contiguous(), "x must be contiguous")
    OH = (H - window) // stride + 1
    OW = (W - window) // stride + 1
    _require(-(-N * OH * OW * C // 256) < 2 ** 31, "output too large")

    out = torch.empty((N, OH, OW, C), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().maxpool_launch(x.data_ptr(), out.data_ptr(), N, H, W, C,
                                    OH, OW, window, stride, _DTYPES[x.dtype],
                                    stream)
    if err:
        raise RuntimeError(f"maxpool kernel launch failed: CUDA error {err}")
    maxpool2d.launches += 1
    return out


maxpool2d.launches = 0
