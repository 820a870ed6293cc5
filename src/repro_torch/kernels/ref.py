"""Plain PyTorch versions of the port's kernels (the correctness contract).

Each function computes what its CUDA kernel computes, in fp32, the obvious
way: ``mha_ref`` is a dense masked softmax, ``paged_attention_ref`` first
gathers every request's pages into a dense buffer (the data movement the
kernel exists to avoid), ``conv2d_ref`` pads x and runs a VALID convolution,
``maxpool2d_ref`` takes the largest of strided slices, ``blocked_layout_ref``
and ``transpose_ref`` copy through a padded, permuted view. ``kernels.ops``
runs them for CPU tensors; the tests and ``chip_smoke.py`` hold the kernels
against them.

The attention versions zero rows that see no key at all, as the kernels do
(their denominator is floored at 1e-30); where every row sees a key they
equal the JAX package's ``repro.kernels.ref`` oracles. ``blocked_layout_ref``
zero-pads C to a multiple of cb, as the kernel does (the JAX oracle asserts
``C % cb == 0``).

On the card, fp32 products must not run in TF32: ``gemm_ref`` relies on
``torch.backends.cuda.matmul.allow_tf32`` (False by default) and
``conv2d_ref`` on ``torch.backends.cudnn.allow_tf32`` (True by default!);
whoever compares on the card sets both to False.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

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


# ---------------------------------------------------------------------------
# The Voltra kernel layer: GEMM, conv, maxpool, reshuffler
# ---------------------------------------------------------------------------


def gemm_ref(x: torch.Tensor, w: torch.Tensor, *, out_dtype=None,
             quant_scale: Optional[float] = None) -> torch.Tensor:
    """x (M, K) @ w (K, N): float inputs in fp32, int8 inputs exactly, then
    the optional quant epilogue clip(round(float32(acc) * scale), -128,
    127) -> int8 (round half to even, as jnp.round), else ``out_dtype``
    (default x's dtype, int32 for integers)."""
    integer = not x.is_floating_point()
    if integer:
        # an int8 @ in PyTorch accumulates (and wraps) in int8, and CUDA has
        # no integer matmul; float64 holds every sum exactly, |acc| <= K *
        # 2^14 being far below 2^53
        acc = (x.double() @ w.double()).to(torch.int32)
    else:
        acc = x.float() @ w.float()
    if quant_scale is not None:
        # the scale as float32, as JAX's weakly typed Python float is
        q = torch.round(acc.float() * float(np.float32(quant_scale)))
        return q.clamp(-128, 127).to(torch.int8)
    if out_dtype is None:
        out_dtype = torch.int32 if integer else x.dtype
    return acc.to(out_dtype)


def same_padding(H: int, W: int, R: int, S: int, stride: int
                 ) -> Tuple[int, int, Tuple[int, int], Tuple[int, int]]:
    """SAME padding as lax.conv computes it: (OH, OW, (top, bottom),
    (left, right)), OH = ceil(H / stride), each total p split (p//2,
    p - p//2)."""
    OH, OW = -(-H // stride), -(-W // stride)
    ph = max((OH - 1) * stride + R - H, 0)
    pw = max((OW - 1) * stride + S - W, 0)
    return OH, OW, (ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2)


def conv2d_ref(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1
               ) -> torch.Tensor:
    """x: (N, H, W, C); w: (R, S, C, K) -> (N, OH, OW, K), SAME padding,
    in fp32, output in x's dtype. PyTorch's padding='same' takes no
    stride above 1 and splits no padding unevenly, so x is padded first
    and the convolution is VALID."""
    _, H, W, _ = x.shape
    R, S, _, _ = w.shape
    _, _, (pt, pb), (pl, pr) = same_padding(H, W, R, S, stride)
    xp = F.pad(x.float(), (0, 0, pl, pr, pt, pb))
    out = F.conv2d(xp.permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1),
                   stride=stride)
    return out.permute(0, 2, 3, 1).contiguous().to(x.dtype)


def maxpool2d_ref(x: torch.Tensor, *, window: int = 2, stride: int = 2
                  ) -> torch.Tensor:
    """VALID max-pool of x (N, H, W, C) -> (N, OH, OW, C), compared in fp32;
    a NaN in a window gives NaN (torch.maximum propagates it)."""
    _, H, W, _ = x.shape
    OH = (H - window) // stride + 1
    OW = (W - window) // stride + 1
    xf = x.float()
    out = None
    for kh in range(window):
        for kw in range(window):
            tap = xf[:, kh:kh + stride * (OH - 1) + 1:stride,
                     kw:kw + stride * (OW - 1) + 1:stride]
            out = tap if out is None else torch.maximum(out, tap)
    return out.contiguous().to(x.dtype)


def blocked_layout_ref(x: torch.Tensor, cb: int) -> torch.Tensor:
    """(H, W, C) -> (Cp // cb, H, W, cb), C zero-padded up to Cp, the next
    multiple of cb."""
    H, W, C = x.shape
    xp = F.pad(x, (0, (-C) % cb))
    return xp.reshape(H, W, -1, cb).permute(2, 0, 1, 3).contiguous()


def transpose_ref(x: torch.Tensor) -> torch.Tensor:
    """(M, N) -> (N, M)."""
    return x.t().contiguous()


def bitwise_equal(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Same shape, dtype and bits; NaN where the other has NaN, whatever
    the NaN's payload (CUDA's bf16 NaN and PyTorch's differ)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    if not got.is_floating_point():
        return torch.equal(got, want)
    nan = got.isnan()
    if not torch.equal(nan, want.isnan()):
        return False
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[got.dtype]
    return torch.equal(got.view(bits)[~nan], want.view(bits)[~nan])


def sum_order_ratio(got: torch.Tensor, want: torch.Tensor,
                    abs_product: torch.Tensor, depth: int) -> torch.Tensor:
    """Elementwise ratio of |got - want| to the limit that two fp32 sums of
    the same ``depth`` products in different orders respect: depth * 2^-24
    * (|x| @ |w|), ``abs_product`` being that product of absolute values
    (for a conv, the conv of |x| with |w|). A bfloat16 output also gets one
    bf16 step of |want|, 2^-7 of it: both sides round a slightly different
    fp32 sum, and the two roundings can land one step apart. An element is
    within its limit iff its ratio is <= 1."""
    g, w = got.double(), want.double()
    limit = depth * 2.0 ** -24 * abs_product.double()
    if want.dtype == torch.bfloat16:
        limit = limit + 2.0 ** -7 * w.abs()
    err = (g - w).abs()
    # an element both sides compute exactly (limit 0) must agree exactly
    return torch.where(err > 0, err / limit.clamp_min(1e-300),
                       torch.zeros_like(err))


def sum_order_error(got: torch.Tensor, want: torch.Tensor,
                    abs_product: torch.Tensor, depth: int) -> torch.Tensor:
    """The largest ``sum_order_ratio`` over the elements: within the limit
    iff <= 1."""
    return sum_order_ratio(got, want, abs_product, depth).max()
