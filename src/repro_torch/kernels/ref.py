"""Plain PyTorch versions of the port's kernels (the correctness contract).

Each function computes what its CUDA kernel computes, in fp32, the obvious
way: ``mha_ref`` is a dense masked softmax, ``paged_attention_ref`` first
gathers every request's pages into a dense buffer (the data movement the
kernel exists to avoid; ``paged_attention_split_ref`` also follows the
kernel's split of the pages into ranges and its merge), ``conv2d_ref`` pads
x and runs a VALID convolution, ``maxpool2d_ref`` takes the largest of
strided slices, ``blocked_layout_ref`` and ``transpose_ref`` copy through a
padded, permuted view, ``sampler_noise_ref`` runs Threefry-2x32 in int64
arithmetic (32-bit words masked after every add and shift). ``kernels.ops``
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


def peaked_mha_inputs(rng: np.random.Generator, B: int, S: int, H: int,
                      KV: int, D: int, last_key=None, peak: float = 30.0,
                      edge: int = 0):
    """numpy float32 (q, k, v), (B, S, H, D) and (B, S, KV, D), on which
    every query row's scores peak on one key, ~``peak`` above the rest, so
    that the row's output is nearly that key's value row and a mask off by
    one key moves every row by far more than ``ROW_TOL[bfloat16]`` (a random
    input spreads the weight over many keys, and the same shift moves a row
    by less than that tolerance). Each GQA group's query rows are a shared
    direction u plus 10% noise. last_key None: key i is c * u_i, so causal
    row i peaks on its own (diagonal) key, which a causal mask shifted by
    one drops. last_key (B,) ints: key last_key[b] is c * u for a direction
    u shared by all of batch b's rows, so every row peaks on that key,
    which a kv_valid of last_key[b] (one short) drops. 1 < edge <= S (with
    last_key None): key j is c * u_{j + edge - 1}, so row i peaks on key i
    - edge + 1, the oldest key of a band of ``edge`` keys, which a band one
    key narrower drops (rows i < edge - 1 peak on no key)."""
    G = H // KV
    c = peak / np.sqrt(D)        # |u|^2 ~ D: the peak's score ~ peak
    k = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    if last_key is None:
        u = rng.standard_normal((B, S, KV, D))
        k = (c * u).astype(np.float32)
        if 1 < edge <= S:
            k[:, : S - edge + 1] = k[:, edge - 1:].copy()
            k[:, S - edge + 1:] = rng.standard_normal((B, edge - 1, KV, D))
    else:
        u = rng.standard_normal((B, 1, KV, D)) * np.ones((1, S, 1, 1))
        for b, L in enumerate(last_key):
            k[b, L] = c * u[b, 0]
    q = np.repeat(u, G, axis=2) + 0.1 * rng.standard_normal((B, S, H, D))
    return q.astype(np.float32), k, v


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, kv_valid=None, q_offset: int = 0,
            window: int = 0) -> torch.Tensor:
    """Exact softmax attention with GQA. q: (B, Sq, H, D); k, v: (B, Sk, KV,
    D); kv_valid: None (all Sk keys), an int, or a (B,) tensor — only the
    first kv_valid[b] keys of sequence b are visible. Causal masking compares
    absolute row and key indices: row i sits at q_offset + i and sees keys
    <= q_offset + i, and with ``window`` > 0 only keys > q_offset + i -
    window (the band of ``layers.flash_attention(window=)``, causal only)."""
    B, Sq, H, D = q.shape
    _, Sk, KV, _ = k.shape
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, D).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * (D ** -0.5)
    valid = _lengths(Sk if kv_valid is None else kv_valid, B, q.device)
    kpos = torch.arange(Sk, device=q.device)
    mask = kpos[None, None, :] < valid[:, None, None]            # (B, 1, Sk)
    if causal:
        qpos = q_offset + torch.arange(Sq, device=q.device)
        band = qpos[:, None] >= kpos[None, :]
        if window:
            band = band & (qpos[:, None] - kpos[None, :] < window)
        mask = mask & band[None]                                  # (B, Sq, Sk)
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


def live_pages(lengths: torch.Tensor, T: int, page: int, n_blocks: int,
               window: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The paged kernel's live pages [first, last) of each request, (B,)
    each: pages at or past lengths hold no live key, and with a window the
    pages wholly below the earliest query row's window are skipped."""
    lengths = lengths.long()
    base = lengths - T
    lo = base - window + 1
    first = torch.where((lo > 0) & (window > 0), lo.clamp_min(0) // page,
                        torch.zeros_like(lo))
    last = torch.clamp(-(-lengths // page), max=n_blocks)
    return first, torch.maximum(last, first)


def split_ranges(first: torch.Tensor, last: torch.Tensor, splits: int
                 ) -> torch.Tensor:
    """(B, splits, 2) page ranges [start, end): rank r of ``splits`` takes
    the live pages [first + n*r // splits, first + n*(r+1) // splits),
    n = last - first, the paged kernel's cut (a range may be empty)."""
    n = (last - first)[:, None]
    r = torch.arange(splits + 1, device=first.device)[None, :]
    edges = first[:, None] + n * r // splits
    return torch.stack([edges[:, :-1], edges[:, 1:]], dim=-1)


def paged_attention_split_ref(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor, block_table: torch.Tensor,
                              lengths, *, kv_scale: Optional[float] = None,
                              window: int = 0, splits: int = 1,
                              drop: Optional[int] = None) -> torch.Tensor:
    """The paged kernel's summation structure as a plain function: each
    request's live pages cut into ``splits`` ranges (``split_ranges``),
    each range's partial (m, l, acc) a softmax over the keys it holds, in
    fp32 (m = -1e30, l = 0, acc = 0 for a range a row sees no key of), and
    the partials merged with the log-sum-exp rule in rank order, rank 0
    first: out = sum_r acc_r e^(m_r - M) / max(sum_r l_r e^(m_r - M),
    1e-30), M = max_r m_r. ``drop``: the rank whose partial is left out of
    the merge (a known fault, for checks that must reject it). Arguments
    as ``paged_attention_ref``."""
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
    seen = kpos < qlen                                          # (B, T, S)
    if window > 0:
        seen = seen & (kpos >= qlen - window)
    ranges = split_ranges(*live_pages(lengths, T, page, n_blocks, window),
                          splits)                        # (B, splits, 2)
    kpage = kpos[:, 0] // page                           # (1, S)
    parts = []
    for r in range(splits):
        held = (kpage >= ranges[:, r, :1]) & (kpage < ranges[:, r, 1:])
        mask = (seen & held[:, None])[:, :, None, None, :]
        sr = torch.where(mask, s, torch.full_like(s, _NEG))
        m = sr.amax(dim=-1)
        p = torch.where(mask, torch.exp(sr - m[..., None]),
                        torch.zeros_like(s))
        parts.append((m, p.sum(-1), torch.einsum("btkgs,bskd->btkgd", p,
                                                 vg)))
    keep = [part for r, part in enumerate(parts) if r != drop]
    M = torch.stack([m for m, _, _ in keep]).amax(dim=0)
    num = torch.zeros_like(keep[0][2])
    den = torch.zeros_like(keep[0][1])
    for m, l, acc in keep:                               # rank order
        w = torch.exp(m - M)
        num = num + acc * w[..., None]
        den = den + l * w
    o = num / den.clamp_min(1e-30)[..., None]
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


def gemm_split_ref(x: torch.Tensor, w: torch.Tensor, chunk: int, *,
                   out_dtype=None) -> torch.Tensor:
    """The summation order of gemm_os's fp32 path as a plain version: the
    depth K cut into ranges of ``chunk`` values, each range's products
    summed in fp32, the partials added in rank order (rank 0 first) in fp32
    and rounded once to ``out_dtype`` (default x's dtype)."""
    acc = None
    for k0 in range(0, x.shape[1], chunk):
        part = x[:, k0:k0 + chunk].float() @ w[k0:k0 + chunk].float()
        acc = part if acc is None else acc + part
    return acc.to(x.dtype if out_dtype is None else out_dtype)


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


# -- the sampler's noise: Threefry-2x32, as jax.random computes it ----------
#
# jax's threefry PRNG with ``jax_threefry_partitionable`` on (the default
# from jax 0.5): a key is two uint32 words; ``random_bits(key, (n,))`` hashes
# the counters (0, i) and xors the two output words. The words live here in
# int64 tensors, masked to 32 bits after every add and shift (torch has no
# uint32 shifts on the CPU), so every result is bit-exact on either device.

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
TINY_F32 = float(np.finfo(np.float32).tiny)


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of counter words (x1, x2) under
    key words (k1, k2): int64 tensors of uint32 values, broadcast together.
    Returns the two output words, likewise."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & _M32
    b = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _M32
            b = (((b << r) & _M32) | (b >> (32 - r))) ^ a
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _M32
    return a, b


def fold_in(key: Tuple[torch.Tensor, torch.Tensor], data: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.fold_in``: threefry2x32(key, (0, data)), data taken as
    uint32."""
    data = data & _M32
    return threefry2x32(key[0], key[1], torch.zeros_like(data), data)


def row_keys(seed: torch.Tensor, rid: torch.Tensor, idx: torch.Tensor,
             draw: Optional[int] = None) -> torch.Tensor:
    """The sampler's key of each row, ``fold_in(fold_in(fold_in(key(seed),
    rid), idx), draw)`` (the last fold only when ``draw`` is given),
    ``key(seed)`` being the words (0, seed). (R,) int tensors -> (R, 2)
    int64 key words."""
    seed = seed.to(torch.int64) & _M32
    k = fold_in((torch.zeros_like(seed), seed), rid.to(torch.int64))
    k = fold_in(k, idx.to(torch.int64))
    if draw is not None:
        k = fold_in(k, torch.full_like(seed, draw))
    return torch.stack(k, -1)


def random_bits_ref(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` for each row of ``keys`` ((R, 2)
    int64 key words): (R, n) int64 holding the uint32 values."""
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    a, b = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(i), i)
    return a ^ b


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits (int64) -> float32 in [0, 1): 23 mantissa bits under the
    exponent of 1.0, minus 1 (``jax.random.uniform``'s construction)."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low") from its uint32 bits:
    -log(-log(u)), u uniform on [tiny, 1) in float32."""
    u = bits_to_unit(bits) * np.float32(np.float32(1.0) - np.float32(TINY_F32)) \
        + np.float32(TINY_F32)
    u = torch.clamp(u, min=TINY_F32)
    return -torch.log(-torch.log(u))


def sampler_noise_ref(seed: torch.Tensor, rid: torch.Tensor,
                      idx: torch.Tensor, n: int, *, draw: int,
                      bits: bool = False) -> torch.Tensor:
    """Plain version of the sampler's noise kernel: for row r,
    ``jax.random.gumbel(row_keys(seed, rid, idx, draw)[r], (n,), float32)``
    as (R, n) float32, or with ``bits`` its raw uint32 bits as (R, n)
    int64."""
    raw = random_bits_ref(row_keys(seed, rid, idx, draw), n)
    return raw if bits else gumbel_from_bits(raw)
