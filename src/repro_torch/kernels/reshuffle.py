"""Wrappers of the reshuffler's CUDA kernels (``csrc/reshuffle.cu``).

The Hopper counterparts of ``repro.kernels.reshuffle``:
``blocked_layout`` (H, W, C) -> (Cp/cb, H, W, cb), C zero-padded to a
multiple of cb inside the kernel (16-byte vectors where cb and C are whole
vectors and x is 16-byte aligned, else single elements), and
``tiled_transpose`` (M, N) -> (N, M) through shared-memory tiles, ragged
edges masked (no pad, no crop; the TPU ``block`` size has no counterpart).
Both copy bits, for float32 and bfloat16. CUDA tensors only:
``kernels.ops.blocked_layout`` / ``transpose`` route CPU tensors to
``ref.blocked_layout_ref`` / ``ref.transpose_ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("reshuffle")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.blocked_layout_launch.argtypes = [p, p, i, i, i, i, i, p]
    lib.blocked_layout_launch.restype = ctypes.c_int
    lib.tiled_transpose_launch.argtypes = [p, p, i, i, i, p]
    lib.tiled_transpose_launch.restype = ctypes.c_int
    return lib


def _check(name: str, x: torch.Tensor, dims: int) -> None:
    build.refuse_fake(name, x)
    build.refuse_grad(name, x)

    def require(ok, msg):
        if not ok:
            raise ValueError(f"{name} kernel: {msg}")
    require(x.is_cuda, "needs CUDA tensors (CPU tensors go through "
            "repro_torch.kernels.ops)")
    require(x.dim() == dims and x.numel() > 0,
            f"x must be non-empty with {dims} dims, got {tuple(x.shape)}")
    require(x.dtype in _DTYPES, f"dtype {x.dtype} (float32 or bfloat16)")
    require(x.is_contiguous(), "x must be contiguous")
    require(x.numel() < 2 ** 31, "x too large")


def _launched(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def blocked_layout(x: torch.Tensor, cb: int = 128) -> torch.Tensor:
    """(H, W, C) -> (Cp // cb, H, W, cb), Cp = C rounded up to a multiple
    of cb, channels C..Cp-1 zero."""
    _check("blocked_layout", x, 3)
    H, W, C = x.shape
    if cb < 1:
        raise ValueError(f"blocked_layout kernel: cb {cb}")
    Cp = -(-C // cb) * cb
    if H * W * cb >= 2 ** 31:
        raise ValueError(f"blocked_layout kernel: channel blocks of "
                         f"{H * W * cb} elements (fewer than 2^31 each)")
    out = torch.empty((Cp // cb, H, W, cb), dtype=x.dtype, device=x.device)
    err = build.launch_on(x.device, _lib().blocked_layout_launch,
                          x.data_ptr(), out.data_ptr(), H, W, C, cb,
                          x.element_size())
    _launched("blocked_layout", err)
    blocked_layout.launches += 1
    return out


blocked_layout.launches = 0


def tiled_transpose(x: torch.Tensor) -> torch.Tensor:
    """(M, N) -> (N, M)."""
    _check("tiled_transpose", x, 2)
    M, N = x.shape
    if -(-M // 32) >= 65536:
        raise ValueError(f"tiled_transpose kernel: M = {M} needs more than "
                         f"65535 row tiles")
    out = torch.empty((N, M), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().tiled_transpose_launch(x.data_ptr(), out.data_ptr(), M,
                                            N, x.element_size(), stream)
    _launched("tiled_transpose", err)
    tiled_transpose.launches += 1
    return out


tiled_transpose.launches = 0
