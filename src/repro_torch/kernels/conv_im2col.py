"""Wrapper of the implicit-im2col Conv2D CUDA kernel
(``csrc/conv_im2col.cu``).

The Hopper counterpart of ``repro.kernels.conv_im2col``: x (N, H, W, C)
NHWC against w (R, S, C, K) RSCK, SAME padding, a stride, fp32
accumulation, output in x's dtype. The kernel computes every input address
itself (the AGU's role): no padded copy of x is made, unlike the JAX
wrapper's jnp.pad, and there is no output-channel block ``bn`` to pad to.
fp32 runs on the FMA units with the depth (kh, kw, c) split over CTAs where
the tiles alone leave the SMs short of warps (``f32_plan``; partials added
in a fixed order), bf16 on the tensor cores.
CUDA tensors only: ``kernels.ops.conv2d`` routes CPU tensors to
``ref.conv2d_ref``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gemm_os import workspace_numel
from repro_torch.kernels.ref import same_padding

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("conv_im2col")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.conv_im2col_launch.argtypes = [p, p, p] + [i] * 13 + [p]
    lib.conv_im2col_launch.restype = ctypes.c_int
    lib.conv_im2col_f32_plan.argtypes = [i] * 6 + [p]
    lib.conv_im2col_f32_plan.restype = None
    lib.conv_im2col_f32_launch.argtypes = [p, p, p, p] + [i] * 13 + [p]
    lib.conv_im2col_f32_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=4096)
def f32_plan(M: int, Cout: int, C: int, R: int, S: int, sms: int
             ) -> Tuple[int, int, int, int]:
    """The fp32 path's plan for a conv of M output pixels, Cout channels
    and an R x S x C depth on ``sms`` SMs, from the launcher
    (``conv_im2col_f32_plan``): (tile rows, tile columns, depth values per
    range, ranges). Where C is a whole number of 16-deep stages a range is
    whole taps or a whole fraction of one."""
    plan = (ctypes.c_int * 4)()
    _lib().conv_im2col_f32_plan(M, Cout, C, R, S, sms, plan)
    return tuple(plan)


def _require(ok: bool, msg: str, *args) -> None:
    """Raise with ``msg.format(*args)`` unless ``ok``; the message is built
    only on failure (its formatting would cost every call microseconds)."""
    if not ok:
        raise ValueError("conv_im2col kernel: " + msg.format(*args))


def conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1
           ) -> torch.Tensor:
    """x: (N, H, W, C); w: (R, S, C, K), one dtype (float32 or bfloat16),
    contiguous. SAME padding split (p//2, p - p//2). -> (N, OH, OW, K),
    OH = ceil(H / stride)."""
    build.refuse_fake("conv_im2col", x, w)
    build.refuse_grad("conv_im2col", x, w)
    _require(x.is_cuda, "needs CUDA tensors (CPU tensors go through "
             "repro_torch.kernels.ops)")
    _require(x.dim() == 4 and w.dim() == 4 and w.shape[2] == x.shape[3],
             "x (N, H, W, C) and w (R, S, C, K), got {}, {}", x.shape,
             w.shape)
    N, H, W, C = x.shape
    R, S, _, K = w.shape
    _require(x.numel() > 0 and w.numel() > 0, "empty x or w")
    _require(stride >= 1, "stride {}", stride)
    dtype = _DTYPES.get(x.dtype)
    _require(dtype is not None and w.dtype == x.dtype,
             "dtypes {}/{} (one of float32, bfloat16)", x.dtype, w.dtype)
    _require(w.device == x.device, "w on {}, x on {}", w.device, x.device)
    _require(x.is_contiguous() and w.is_contiguous(),
             "x and w must be contiguous")
    OH, OW, (pad_t, _), (pad_l, _) = same_padding(H, W, R, S, stride)
    _require(-(-N * OH * OW // 64) < 65536,
             "{} output pixels need more than 65535 row tiles", N * OH * OW)

    out = torch.empty((N, OH, OW, K), dtype=x.dtype, device=x.device)
    if dtype == 0:
        plan = f32_plan(N * OH * OW, K, C, R, S,
                        build.sm_count(x.device.index))
        ws = workspace_numel(N * OH * OW, K, plan)
        ws = torch.empty(ws, dtype=torch.float32, device=x.device) \
            if ws else None
        err = build.launch_on(
            x.device, _lib().conv_im2col_f32_launch, x.data_ptr(),
            w.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), N, H, W, C, R, S, K, OH,
            OW, stride, pad_t, pad_l, plan[2])
    else:
        err = build.launch_on(
            x.device, _lib().conv_im2col_launch, x.data_ptr(), w.data_ptr(),
            out.data_ptr(), N, H, W, C, R, S, K, OH, OW, stride, pad_t,
            pad_l, dtype)
    if err:
        raise RuntimeError(f"conv_im2col kernel launch failed: CUDA error "
                           f"{err}")
    conv2d.launches += 1
    return out


conv2d.launches = 0
