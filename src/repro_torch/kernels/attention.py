"""Wrapper of the flash-MHA forward CUDA kernel (``csrc/mha.cu``).

The Hopper counterpart of ``repro.kernels.attention``: fused flash attention
with K in its natural layout, GQA, causal masking by absolute row, a traced
(B,) ``kv_valid``, fully masked rows -> 0. Same public signature and layouts
as the JAX ``mha`` (the TPU block sizes ``bq``/``bk`` have no counterpart:
the CUDA kernel's tiles are fixed at 64 x 64). CUDA tensors only:
``kernels.ops.attention`` routes CPU tensors to ``ref.mha_ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 128)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("mha")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mha_fwd_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, f,
                                   p]
    lib.mha_fwd_launch.restype = ctypes.c_int
    return lib


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(f"mha kernel: {msg}")


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, kv_valid=None) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, KV, D), one dtype (float32 or
    bfloat16), contiguous, H % KV == 0, D in (16, 32, 128).
    kv_valid: None (all Sk keys), an int, or a (B,) int32 tensor — only the
    first kv_valid[b] keys of sequence b attend. Returns (B, Sq, H, D)."""
    _require(q.is_cuda, "needs CUDA tensors (CPU tensors go through "
             "repro_torch.kernels.ops)")
    _require(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape,
             f"q (B,Sq,H,D) and k, v (B,Sk,KV,D) of one shape, got "
             f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    _, Sk, KV, Dk = k.shape
    _require(k.shape[0] == B and Dk == D and H % KV == 0,
             f"q {tuple(q.shape)} does not fit k {tuple(k.shape)}")
    _require(D in _HEAD_DIMS, f"head dim {D} not in {_HEAD_DIMS}")
    _require(q.dtype in _DTYPES and k.dtype == q.dtype
             and v.dtype == q.dtype, f"dtypes {q.dtype}/{k.dtype}/{v.dtype}"
             f" (one of float32, bfloat16)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _require(t.device == q.device, f"{name} on {t.device}, q on "
                 f"{q.device}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
        _require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    if kv_valid is None or isinstance(kv_valid, int):
        # filled on the device: no host copy, no sync
        valid = torch.full((B,), Sk if kv_valid is None else kv_valid,
                           dtype=torch.int32, device=q.device)
    else:
        valid = torch.as_tensor(kv_valid, dtype=torch.int32,
                                device=q.device).expand(B).contiguous()

    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().mha_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
            out.data_ptr(), B, Sq, Sk, H, KV, D, _DTYPES[q.dtype],
            int(causal), D ** -0.5, stream)
    if err:
        raise RuntimeError(f"mha kernel launch failed: CUDA error {err}")
    mha.launches += 1
    return out


mha.launches = 0
