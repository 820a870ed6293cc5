"""Wrapper of the paged flash-decode CUDA kernel (``csrc/paged_attention.cu``).

The Hopper counterpart of ``repro.kernels.paged_attention``: flash-decode over
a shared KV page pool with the block-table indirection inside the kernel
(one CTA per request and KV head walks its own table row), GQA and a T-row
query block folded into one tile, in-sweep causal and sliding-window masks,
int8 pools dequantized per tile. Same public signature and layouts as the
JAX wrapper. CUDA tensors only: ``kernels.ops.paged_attention`` routes CPU
tensors to ``ref.paged_attention_ref``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_SMEM_LIMIT = 232_448   # bytes of shared memory one Hopper CTA may use


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("paged_attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.paged_attention_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i,
                                           i, i, i, i, f, f, i, p]
    lib.paged_attention_launch.restype = ctypes.c_int
    lib.paged_attention_smem_bytes.argtypes = [i, i, i, i, i]
    lib.paged_attention_smem_bytes.restype = ctypes.c_long
    return lib


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(f"paged_attention kernel: {msg}")


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_table: torch.Tensor, lengths,
                    *, kv_scale: Optional[float] = None,
                    window: int = 0) -> torch.Tensor:
    """Flash-decode over a paged KV pool. Returns q's shape and dtype.

    q:           (B, H, D) or (B, T, H, D), float32 or bfloat16, contiguous.
    k/v_pool:    (P, page, KV, D) float32, bfloat16 or int8 (with
                 ``kv_scale``), contiguous; H % KV == 0; float32 pools
                 need float32 q.
    block_table: (B, n_blocks) int32 — logical block j of request b is
                 physical page block_table[b, j].
    lengths:     (B,) int32 tensor or an int — live tokens including the
                 q block; row t sees keys < lengths - T + t + 1.
    window:      > 0 limits each row to its last ``window`` keys.
    """
    squeeze = q.dim() == 3
    if squeeze:
        q = q.unsqueeze(1)
    _require(q.is_cuda, "needs CUDA tensors (CPU tensors go through "
             "repro_torch.kernels.ops)")
    _require(q.dim() == 4, f"q must be (B, H, D) or (B, T, H, D), got "
             f"{tuple(q.shape)}")
    B, T, H, D = q.shape
    _require(k_pool.dim() == 4 and k_pool.shape == v_pool.shape,
             f"pools must be (P, page, KV, D) of one shape, got "
             f"{tuple(k_pool.shape)} and {tuple(v_pool.shape)}")
    _, page, KV, Dk = k_pool.shape
    _require(Dk == D and H % KV == 0, f"q (H={H}, D={D}) does not fit pools "
             f"(KV={KV}, D={Dk})")
    _require(q.dtype in (torch.float32, torch.bfloat16),
             f"q dtype {q.dtype} (float32 or bfloat16)")
    _require(k_pool.dtype == v_pool.dtype and k_pool.dtype in _DTYPES,
             f"pool dtypes {k_pool.dtype}/{v_pool.dtype}")
    _require(not (q.dtype == torch.bfloat16
                  and k_pool.dtype == torch.float32),
             "bfloat16 q over float32 pools is not built")
    int8 = k_pool.dtype == torch.int8
    _require(not int8 or kv_scale is not None, "int8 pools need kv_scale")
    _require(block_table.dim() == 2 and block_table.shape[0] == B
             and block_table.dtype == torch.int32,
             f"block_table must be ({B}, n_blocks) int32")
    _require(page <= 32 or page % 32 == 0,
             f"page {page}: pages above 32 rows must be a multiple of 32")
    _require(window >= 0, f"window {window}")
    if isinstance(lengths, int):
        lengths = torch.full((B,), lengths, dtype=torch.int32,
                             device=q.device)
    lengths = torch.as_tensor(lengths, dtype=torch.int32,
                              device=q.device).expand(B).contiguous()
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_table", block_table)):
        _require(t.device == q.device, f"{name} on {t.device}, q on "
                 f"{q.device}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    for t in (q, k_pool):
        vec = 16 // t.element_size()
        _require(D % vec == 0, f"head dim {D} must be a multiple of {vec} "
                 f"for {t.dtype} (16-byte loads)")
    for t in (q, k_pool, v_pool):
        _require(t.data_ptr() % 16 == 0, "tensors must be 16-byte aligned")
    lib = _lib()
    smem = lib.paged_attention_smem_bytes(T, H, KV, D, page)
    _require(smem <= _SMEM_LIMIT, f"T*G={T * (H // KV)} rows at D={D} need "
             f"{smem} bytes of shared memory (limit {_SMEM_LIMIT})")

    out = torch.empty_like(q)
    dequant = kv_scale / 127.0 if int8 else 1.0
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_attention_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            B, T, H, KV, D, page, block_table.shape[1], _DTYPES[q.dtype],
            _DTYPES[k_pool.dtype], D ** -0.5, dequant, window, stream)
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    paged_attention.launches += 1
    return out[:, 0] if squeeze else out


paged_attention.launches = 0
