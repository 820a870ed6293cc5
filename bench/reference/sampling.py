"""Plain PyTorch of the sampling rule the benchmark's requests ask for,
written from its statement: a draw at temperature t with nucleus p is
``argmax(z / t + G)`` over the smallest prefix of the sorted distribution
``softmax(z / t)`` whose mass reaches p (the token crossing it kept), G
being ``jax.random.gumbel`` noise under the key ``fold_in(fold_in(
fold_in(key(seed), rid), j), 1)`` for generated token j of request rid
(Threefry-2x32, the counters (0, i) of vocabulary index i, the two output
words xor'd). Greedy is t = 0: the plain argmax.

It imports nothing of the port. The words are uint32 values held in
int64 tensors, masked after every add and shift."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

M32 = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
TINY = float(np.finfo(np.float32).tiny)
SAMPLE_DRAW = 1        # the fold that separates a position's token draw
ROWS = 64              # positions a block of noise


def threefry2x32(k1, k2, x1, x2) -> Tuple[torch.Tensor, torch.Tensor]:
    """20 rounds of Threefry-2x32 of the counter words (x1, x2) under the
    key words (k1, k2), broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & M32
    b = (x2 + ks[1]) & M32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            a = (a + b) & M32
            b = (((b << r) & M32) | (b >> (32 - r))) ^ a
        a = (a + ks[(i + 1) % 3]) & M32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & M32
    return a, b


def fold_in(key, data: torch.Tensor):
    data = data & M32
    return threefry2x32(key[0], key[1], torch.zeros_like(data), data)


def keys(seed: int, rid: int, idx: torch.Tensor) -> torch.Tensor:
    """(n,) token indices -> (n, 2) key words of their draws."""
    idx = idx.to(torch.int64)
    k = (torch.zeros_like(idx), torch.full_like(idx, int(seed) & M32))
    k = fold_in(k, torch.full_like(idx, int(rid) & M32))
    k = fold_in(k, idx)
    k = fold_in(k, torch.full_like(idx, SAMPLE_DRAW))
    return torch.stack(k, -1)


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """(R, 2) key words -> (R, n) float32 Gumbel noise (mode "low":
    -log(-log(u)), u uniform on [tiny, 1))."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    a, b = threefry2x32(key[:, :1], key[:, 1:], torch.zeros_like(i), i)
    bits = a ^ b
    u = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    u = u * np.float32(np.float32(1.0) - np.float32(TINY)) + np.float32(TINY)
    return -torch.log(-torch.log(torch.clamp(u, min=TINY)))


def nucleus_floor(z: torch.Tensor, temp: float, top_p: float) -> torch.Tensor:
    """(R,) the lowest logit of each row's nucleus at ``top_p``: the tokens
    at or above it are the smallest sorted prefix of softmax(z / temp)
    whose mass reaches top_p."""
    if top_p >= 1.0:
        return torch.full(z.shape[:1], -float("inf"), device=z.device)
    srt = torch.sort(z, dim=-1, descending=True).values
    p = torch.softmax(srt / temp, -1)
    n_keep = ((torch.cumsum(p, -1) - p) < top_p).sum(-1).clamp(min=1)
    return srt.gather(-1, (n_keep - 1)[:, None])[:, 0]


def _scores(zb: torch.Tensor, seed: int, rid: int, lo: int,
            temp: float) -> torch.Tensor:
    """z / t + G of the block of positions lo, lo + 1, ..."""
    r = torch.arange(zb.shape[0], device=zb.device)
    return zb / temp + gumbel(keys(seed, rid, r + lo), zb.shape[1])


def gaps(z: torch.Tensor, picks: torch.Tensor, seed: int, rid: int,
         temp: float, top_p: float, slack: float) -> torch.Tensor:
    """How far each of ``picks`` (n,) lies from the rule's draw under the
    logits ``z`` (n, V), in logit units, for tokens j = 0 .. n-1 of request
    ``rid``. Greedy (temp 0): the best logit less the pick's. Sampled: the
    best score z / t + G over the nucleus at top_p - slack, less the
    pick's, times t; and where the pick lies below the nucleus at top_p +
    slack, how far its logit lies below that nucleus's floor. ``slack``
    is the mass by which the nucleus may differ under rounding of z."""
    rows = torch.arange(z.shape[0], device=z.device)
    if temp <= 0:
        return z.max(-1).values - z[rows, picks]
    out = []
    for lo in range(0, z.shape[0], ROWS):
        zb, pb = z[lo:lo + ROWS], picks[lo:lo + ROWS]
        r = torch.arange(zb.shape[0], device=z.device)
        s = _scores(zb, seed, rid, lo, temp)
        inner = nucleus_floor(zb, temp, max(top_p - slack, 1e-6))
        outer = nucleus_floor(zb, temp, min(top_p + slack, 1.0))
        best = torch.where(zb >= inner[:, None], s,
                           torch.full_like(s, -float("inf"))).max(-1).values
        drawn = temp * (best - s[r, pb])
        below = outer - zb[r, pb]
        out.append(torch.clamp(torch.maximum(drawn, below), min=0.0))
    return torch.cat(out)


def draw(z: torch.Tensor, seed: int, rid: int, temp: float,
         top_p: float) -> torch.Tensor:
    """The rule's tokens under the logits ``z`` (n, V): what a sampler
    that reads these logits picks (the control's picks)."""
    if temp <= 0:
        return z.argmax(-1)
    out = []
    for lo in range(0, z.shape[0], ROWS):
        zb = z[lo:lo + ROWS]
        s = _scores(zb, seed, rid, lo, temp)
        floor = nucleus_floor(zb, temp, top_p)
        s = torch.where(zb >= floor[:, None], s,
                        torch.full_like(s, -float("inf")))
        out.append(s.argmax(-1))
    return torch.cat(out)
