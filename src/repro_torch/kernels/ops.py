"""The kernel seam: dispatch on the tensor's device, nothing else.

A CPU tensor goes to the plain PyTorch version in ``ref``; a CUDA tensor goes
to the hand-written CUDA kernel, whose wrapper launches it or raises. There
is no fallback: a kernel that fails to build or launch is an error, never a
silent detour through the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import attention as _attention
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import ref


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, kv_valid=None) -> torch.Tensor:
    """Fused flash-MHA (q (B,Sq,H,D), k/v (B,Sk,KV,D)); see
    ``kernels.attention.mha``."""
    if q.device.type == "cpu":
        return ref.mha_ref(q, k, v, causal=causal, kv_valid=kv_valid)
    return _attention.mha(q, k, v, causal=causal, kv_valid=kv_valid)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_table: torch.Tensor, lengths,
                    *, kv_scale: Optional[float] = None,
                    window: int = 0) -> torch.Tensor:
    """Flash-decode over a paged KV pool; see
    ``kernels.paged_attention.paged_attention``."""
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_pool, v_pool, block_table,
                                       lengths, kv_scale=kv_scale,
                                       window=window)
    return _paged.paged_attention(q, k_pool, v_pool, block_table, lengths,
                                  kv_scale=kv_scale, window=window)


def launch_counts() -> dict:
    """Each CUDA kernel's launches so far in this process."""
    return {"paged_attention": _paged.paged_attention.launches,
            "mha": _attention.mha.launches}


def reset_launch_counts() -> None:
    _paged.paged_attention.launches = 0
    _attention.mha.launches = 0
