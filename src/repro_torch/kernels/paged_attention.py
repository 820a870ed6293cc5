"""Wrapper of the paged flash-decode CUDA kernel (``csrc/paged_attention.cu``).

The Hopper counterpart of ``repro.kernels.paged_attention``: flash-decode over
a shared KV page pool with the block-table indirection inside the kernel,
GQA and a T-row query block folded into 8-row tiles, in-sweep causal and
sliding-window masks, int8 pools dequantized as they are read. Each
request's live pages are cut into ``split_plan`` ranges, one CTA each, whose
partials merge in rank order inside a thread-block cluster: the same inputs
give the same bits. Same public signature and layouts as the JAX wrapper.
CUDA tensors only: ``kernels.ops.paged_attention`` routes CPU tensors to
``ref.paged_attention_ref``; ``ref.paged_attention_split_ref`` is the
kernel's summation structure as a plain function.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
MAX_SPLITS = 8      # CTAs of a cluster (the portable size)
ROWS_PER_CTA = 8    # query rows (T * G) one CTA takes
KEYS_PER_TILE = 16  # keys per stage of the kernel's ring
# The largest head dim (csrc/paged_attention.cu, kMaxHeadDim): above 256 the
# query rows and the warps' accumulators live in 160 D + 2272 bytes of
# shared memory, of a CTA's 232448.
MAX_HEAD_DIM = 1438


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("paged_attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.paged_attention_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i,
                                           i, i, i, i, f, f, i, i, p]
    lib.paged_attention_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=4096)
def split_plan(B: int, KV: int, n_blocks: int, page: int, rows: int,
               sms: int) -> int:
    """Ranges S that each (request, KV head, row tile)'s live pages are cut
    into, one CTA each, from shapes alone (never the lengths, which live on
    the device): enough CTAs for ``sms`` SMs, between 1 and 2 a SM; S = 1
    once the (request, KV head, row tile) CTAs alone are that many; at most
    ``MAX_SPLITS`` (one cluster); at least 2 pages and 2 tiles of 16 keys a
    range at the longest table (``n_blocks`` pages of ``page`` keys).
    ``rows`` is T * G, the query rows of one (request, KV head)."""
    ctas = B * KV * -(-rows // ROWS_PER_CTA)
    if ctas >= sms:
        return 1
    return max(1, min(-(-sms // ctas), MAX_SPLITS, n_blocks // 2,
                      n_blocks * page // (2 * KEYS_PER_TILE)))


def _require(ok: bool, msg: str, *args) -> None:
    """Raise with ``msg.format(*args)`` unless ``ok``; the message is built
    only on failure."""
    if not ok:
        raise ValueError("paged_attention kernel: " + msg.format(*args))


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_table: torch.Tensor, lengths,
                    *, kv_scale: Optional[float] = None,
                    window: int = 0) -> torch.Tensor:
    """Flash-decode over a paged KV pool. Returns q's shape and dtype.

    q:           (B, H, D) or (B, T, H, D), float32 or bfloat16, contiguous.
    k/v_pool:    (P, page, KV, D) float32, bfloat16 or int8 (with
                 ``kv_scale``), contiguous; H % KV == 0; D <= 1438.
    block_table: (B, n_blocks) int32 — logical block j of request b is
                 physical page block_table[b, j].
    lengths:     (B,) integers (a tensor on any device, a list) or an int —
                 live tokens including the q block; row t sees keys <
                 lengths - T + t + 1.
    window:      > 0 limits each row to its last ``window`` keys.
    """
    build.refuse_fake("paged_attention", q, k_pool, v_pool, block_table,
                      lengths)
    build.refuse_grad("paged_attention", q, k_pool, v_pool, block_table,
                      lengths)
    squeeze = q.dim() == 3
    if squeeze:
        q = q.unsqueeze(1)
    _require(q.is_cuda, "needs CUDA tensors (CPU tensors go through "
             "repro_torch.kernels.ops)")
    _require(q.dim() == 4, "q must be (B, H, D) or (B, T, H, D), got {}",
             tuple(q.shape))
    B, T, H, D = q.shape
    _require(k_pool.dim() == 4 and k_pool.shape == v_pool.shape,
             "pools must be (P, page, KV, D) of one shape, got {} and {}",
             tuple(k_pool.shape), tuple(v_pool.shape))
    _, page, KV, Dk = k_pool.shape
    _require(Dk == D and H % KV == 0 and D <= MAX_HEAD_DIM,
             "q (H={}, D={}) does not fit pools (KV={}, D={}), or D > {}", H,
             D, KV, Dk, MAX_HEAD_DIM)
    _require(q.dtype in (torch.float32, torch.bfloat16),
             "q dtype {} (float32 or bfloat16)", q.dtype)
    _require(k_pool.dtype == v_pool.dtype and k_pool.dtype in _DTYPES,
             "pool dtypes {}/{}", k_pool.dtype, v_pool.dtype)
    int8 = k_pool.dtype == torch.int8
    _require(not int8 or kv_scale is not None, "int8 pools need kv_scale")
    _require(block_table.dim() == 2 and block_table.shape[0] == B
             and block_table.dtype == torch.int32,
             "block_table must be ({}, n_blocks) int32", B)
    _require(window >= 0, "window {}", window)
    n_blocks = block_table.shape[1]
    splits = split_plan(B, KV, n_blocks, page, T * (H // KV),
                        build.sm_count(q.device.index))
    if isinstance(lengths, int):
        lengths = torch.full((B,), lengths, dtype=torch.int32,
                             device=q.device)
    elif not (isinstance(lengths, torch.Tensor)
              and lengths.dtype == torch.int32 and lengths.shape == (B,)
              and lengths.device == q.device and lengths.is_contiguous()):
        lengths = torch.as_tensor(lengths, dtype=torch.int32,
                                  device=q.device).expand(B).contiguous()
    for t in (k_pool, v_pool, block_table):
        _require(t.device == q.device, "tensors on {} and {}", t.device,
                 q.device)
    _require(q.is_contiguous() and k_pool.is_contiguous()
             and v_pool.is_contiguous() and block_table.is_contiguous(),
             "q, pools and block_table must be contiguous")
    _require(D * k_pool.element_size() % 16 == 0,
             "head dim {} must be a multiple of {} for {} pools (16-byte "
             "copies)", D, 16 // k_pool.element_size(), k_pool.dtype)
    _require(k_pool.data_ptr() % 16 == 0 and v_pool.data_ptr() % 16 == 0,
             "pools must be 16-byte aligned")

    out = torch.empty_like(q)
    err = build.launch_on(
        q.device, _lib().paged_attention_launch, q.data_ptr(),
        k_pool.data_ptr(), v_pool.data_ptr(), block_table.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), B, T, H, KV, D, page, n_blocks,
        _DTYPES[q.dtype], _DTYPES[k_pool.dtype], D ** -0.5,
        kv_scale / 127.0 if int8 else 1.0, window, splits)
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    paged_attention.launches += 1
    return out[:, 0] if squeeze else out


paged_attention.launches = 0
