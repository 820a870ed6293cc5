"""Wrapper of the flash-MHA forward CUDA kernel (``csrc/mha.cu``).

The Hopper counterpart of ``repro.kernels.attention``: fused flash attention
with K in its natural layout, GQA, causal masking by absolute row, a traced
(B,) ``kv_valid``, fully masked rows -> 0. Same public signature and layouts
as the JAX ``mha`` (the TPU block sizes ``bq``/``bk`` have no counterpart:
the CUDA kernels' tiles are fixed at 64 x 64). bfloat16 runs on the tensor
cores (wgmma fed by TMA), float32 on the FMA units (``csrc/mha.cu`` says
why). CUDA tensors only: ``kernels.ops.attention`` routes CPU tensors to
``ref.mha_ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("mha")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mha_fwd_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, f,
                                   p]
    lib.mha_fwd_launch.restype = ctypes.c_int
    return lib


def _require(ok: bool, msg: str, *args) -> None:
    """Raise with ``msg.format(*args)`` unless ``ok``; the message is built
    only on failure (its formatting would cost every call microseconds)."""
    if not ok:
        raise ValueError("mha kernel: " + msg.format(*args))


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, kv_valid=None) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, KV, D), one dtype (float32 or
    bfloat16), contiguous, H % KV == 0, D in (16, 32, 64, 128).
    kv_valid: None (all Sk keys), an int, or a (B,) int32 tensor — only the
    first kv_valid[b] keys of sequence b attend. Returns (B, Sq, H, D)."""
    _require(q.is_cuda, "needs CUDA tensors (CPU tensors go through "
             "repro_torch.kernels.ops)")
    _require(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape,
             "q (B,Sq,H,D) and k, v (B,Sk,KV,D) of one shape, got {}, {}, "
             "{}", q.shape, k.shape, v.shape)
    B, Sq, H, D = q.shape
    _, Sk, KV, Dk = k.shape
    _require(k.shape[0] == B and Dk == D and H % KV == 0,
             "q {} does not fit k {}", q.shape, k.shape)
    _require(D in _HEAD_DIMS, "head dim {} not in {}", D, _HEAD_DIMS)
    dtype = _DTYPES.get(q.dtype)
    _require(dtype is not None and k.dtype == q.dtype and v.dtype == q.dtype,
             "dtypes {}/{}/{} (one of float32, bfloat16)", q.dtype, k.dtype,
             v.dtype)
    dev = q.device
    _require(k.device == dev and v.device == dev, "q, k, v on {}, {}, {}",
             dev, k.device, v.device)
    _require(q.is_contiguous() and k.is_contiguous() and v.is_contiguous(),
             "q, k and v must be contiguous")
    _require((q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16 == 0,
             "q, k and v must be 16-byte aligned")
    if kv_valid is None:
        valid_ptr = 0           # the kernel reads all Sk keys: no fill launch
    else:
        if isinstance(kv_valid, int):
            # filled on the device: no host copy, no sync
            valid = torch.full((B,), kv_valid, dtype=torch.int32, device=dev)
        else:
            valid = torch.as_tensor(kv_valid, dtype=torch.int32,
                                    device=dev).expand(B).contiguous()
        valid_ptr = valid.data_ptr()

    out = torch.empty_like(q)
    err = build.launch_on(dev, _lib().mha_fwd_launch, q.data_ptr(),
                          k.data_ptr(), v.data_ptr(), valid_ptr,
                          out.data_ptr(), B, Sq, Sk, H, KV, D, dtype,
                          int(causal), D ** -0.5)
    if err:
        raise RuntimeError(f"mha kernel launch failed: CUDA error {err}")
    mha.launches += 1
    return out


mha.launches = 0
