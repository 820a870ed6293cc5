"""Plain PyTorch versions of the port's kernels (the correctness contract).

Each function computes what its CUDA kernel computes, in fp32, the obvious
way: ``mha_ref`` is a dense masked softmax, ``paged_attention_ref`` first
gathers every request's pages into a dense buffer (the data movement the
kernel exists to avoid). ``kernels.ops`` runs them for CPU tensors; the
tests and ``chip_smoke.py`` hold the kernels against them.

Both zero rows that see no key at all, as the kernels do (their denominator
is floored at 1e-30); where every row sees a key they equal the JAX
package's ``repro.kernels.ref`` oracles.
"""
from __future__ import annotations

from typing import Optional

import torch

_NEG = -1e30


def _lengths(x, B: int, device) -> torch.Tensor:
    """An int, or a (B,) tensor of per-batch counts, as a (B,) int32 tensor."""
    return torch.as_tensor(x, dtype=torch.int32, device=device).expand(B)


def _masked_softmax(s: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    s = torch.where(mask, s, torch.full_like(s, _NEG))
    return torch.where(mask, torch.softmax(s, dim=-1), torch.zeros_like(s))


# How far a kernel's output may stray from its plain version, as a share of
# the largest reference output of the same query row (``row_error``). fp32:
# the order of the sums only. bf16: both compute in fp32 from the same bf16
# inputs and differ in the rounding of the bf16 output (one bf16 step is up
# to 2^-7 of the row's largest value) and, in mha, of P cast to bf16 (2^-9 of
# each term); two steps. A key masked in or out by one position moves a row
# of 1000 keys by more than 1e-2 of it, far past the fp32 limit.
ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def row_error(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per query row of (..., H, D) outputs: the largest absolute error over
    the row's heads and dims, over the row's largest reference magnitude (a
    row that is all zeros in the reference must be zeros)."""
    g, w = got.float(), want.float()
    scale = w.abs().amax(dim=(-2, -1)).clamp_min(1e-6)
    return (g - w).abs().amax(dim=(-2, -1)) / scale


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, kv_valid=None) -> torch.Tensor:
    """Exact softmax attention with GQA. q: (B, Sq, H, D); k, v: (B, Sk, KV,
    D); kv_valid: None (all Sk keys), an int, or a (B,) tensor — only the
    first kv_valid[b] keys of sequence b are visible. Causal masking compares
    absolute row and key indices (row i sees keys <= i)."""
    B, Sq, H, D = q.shape
    _, Sk, KV, _ = k.shape
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, D).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * (D ** -0.5)
    valid = _lengths(Sk if kv_valid is None else kv_valid, B, q.device)
    kpos = torch.arange(Sk, device=q.device)
    mask = kpos[None, None, :] < valid[:, None, None]            # (B, 1, Sk)
    if causal:
        qpos = torch.arange(Sq, device=q.device)
        mask = mask & (qpos[:, None] >= kpos[None, :])[None]      # (B, Sq, Sk)
    p = _masked_softmax(s, mask[:, None, None])
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)


def paged_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, block_table: torch.Tensor,
                        lengths, *, kv_scale: Optional[float] = None,
                        window: int = 0) -> torch.Tensor:
    """Dense-gather version of the paged flash-decode kernel. q: (B, H, D)
    or (B, T, H, D); pools: (P, page, KV, D) float or int8; block_table:
    (B, n_blocks) int; lengths: (B,) live tokens INCLUDING the q block —
    query row t attends to keys at positions < lengths - T + t + 1, and with
    window > 0 only to the last ``window`` of those."""
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    B, T, H, D = q.shape
    _, page, KV, _ = k_pool.shape
    G = H // KV
    n_blocks = block_table.shape[1]
    lengths = _lengths(lengths, B, q.device)

    def dq(x):
        if x.is_floating_point():
            return x.float()
        return x.float() * (kv_scale / 127.0)

    idx = block_table.long()
    kg = dq(k_pool[idx]).reshape(B, n_blocks * page, KV, D)
    vg = dq(v_pool[idx]).reshape(B, n_blocks * page, KV, D)
    qg = q.reshape(B, T, KV, G, D).float()
    s = torch.einsum("btkgd,bskd->btkgs", qg, kg) * (D ** -0.5)
    kpos = torch.arange(n_blocks * page, device=q.device)[None, None, :]
    qlen = (lengths[:, None] - T
            + torch.arange(T, device=q.device)[None, :] + 1)[..., None]
    mask = kpos < qlen                                          # (B, T, S)
    if window > 0:
        mask = mask & (kpos >= qlen - window)
    p = _masked_softmax(s, mask[:, :, None, None, :])
    o = torch.einsum("btkgs,bskd->btkgd", p, vg)
    o = o.reshape(B, T, H, D).to(q.dtype)
    return o[:, 0] if squeeze else o
