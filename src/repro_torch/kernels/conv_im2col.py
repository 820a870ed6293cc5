"""Wrapper of the implicit-im2col Conv2D CUDA kernel
(``csrc/conv_im2col.cu``).

The Hopper counterpart of ``repro.kernels.conv_im2col``: x (N, H, W, C)
NHWC against w (R, S, C, K) RSCK, SAME padding, a stride, fp32
accumulation, output in x's dtype. The kernel computes every input address
itself (the AGU's role): no padded copy of x is made, unlike the JAX
wrapper's jnp.pad, and there is no output-channel block ``bn`` to pad to.
CUDA tensors only: ``kernels.ops.conv2d`` routes CPU tensors to
``ref.conv2d_ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import same_padding

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("conv_im2col")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.conv_im2col_launch.argtypes = [p, p, p] + [i] * 13 + [p]
    lib.conv_im2col_launch.restype = ctypes.c_int
    return lib


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(f"conv_im2col kernel: {msg}")


def conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1
           ) -> torch.Tensor:
    """x: (N, H, W, C); w: (R, S, C, K), one dtype (float32 or bfloat16),
    contiguous. SAME padding split (p//2, p - p//2). -> (N, OH, OW, K),
    OH = ceil(H / stride)."""
    _require(x.is_cuda, "needs CUDA tensors (CPU tensors go through "
             "repro_torch.kernels.ops)")
    _require(x.dim() == 4 and w.dim() == 4 and w.shape[2] == x.shape[3],
             f"x (N, H, W, C) and w (R, S, C, K), got {tuple(x.shape)}, "
             f"{tuple(w.shape)}")
    N, H, W, C = x.shape
    R, S, _, K = w.shape
    _require(x.numel() > 0 and w.numel() > 0, "empty x or w")
    _require(stride >= 1, f"stride {stride}")
    _require(x.dtype in _DTYPES and w.dtype == x.dtype,
             f"dtypes {x.dtype}/{w.dtype} (one of float32, bfloat16)")
    _require(w.device == x.device, f"w on {w.device}, x on {x.device}")
    _require(x.is_contiguous() and w.is_contiguous(),
             "x and w must be contiguous")
    OH, OW, (pad_t, _), (pad_l, _) = same_padding(H, W, R, S, stride)
    _require(-(-N * OH * OW // 64) < 65536,
             f"{N * OH * OW} output pixels need more than 65535 row tiles")

    out = torch.empty((N, OH, OW, K), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().conv_im2col_launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), N, H, W, C, R, S, K,
            OH, OW, stride, pad_t, pad_l, _DTYPES[x.dtype], stream)
    if err:
        raise RuntimeError(f"conv_im2col kernel launch failed: CUDA error "
                           f"{err}")
    conv2d.launches += 1
    return out


conv2d.launches = 0
