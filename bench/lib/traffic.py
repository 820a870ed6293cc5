"""The one traffic generator: a mix file's parameters -> the requests of a
closed loop, drawn from ``--seed``.

Lengths are integers: ``L = floor(X)``, X uniform or log-uniform on
``[min, max + 1)``. They are drawn stratified, so that every seed serves
the same sizes in another order: the requests come in blocks of
``block``, and each block holds the ``block`` quantiles (k + 1/2) / block
of the prompt and of the output distribution, each list shuffled by the
seed on its own. A block's greedy requests are ``greedy_share`` of it, at
shuffled places. Each client's first request is already running when the
window opens, so its output length is drawn from the residual-life
distribution, P(R = r) proportional to P(L >= r) (the remaining length of
a request met at a random moment), stratified over the clients in the
same way. Prompt tokens are uniform over the vocabulary, drawn from
(seed, request id)."""
from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np


@dataclasses.dataclass
class Card:
    """One request's draw: its id, prompt and output lengths, and whether
    it decodes greedily."""
    rid: int
    prompt_len: int
    output_len: int
    greedy: bool


def cdf(dist: dict, x: np.ndarray) -> np.ndarray:
    """P(X <= x) of the continuous X behind ``dist``, on its support
    [min, max + 1)."""
    lo, hi = float(dist["min"]), float(dist["max"]) + 1.0
    x = np.clip(np.asarray(x, np.float64), lo, hi)
    if dist["dist"] == "uniform":
        return (x - lo) / (hi - lo)
    if dist["dist"] == "loguniform":
        return np.log(x / lo) / math.log(hi / lo)
    raise ValueError(f"unknown length distribution {dist['dist']!r}")


def quantile(dist: dict, q: np.ndarray) -> np.ndarray:
    """Integer lengths floor(F^-1(q))."""
    lo, hi = float(dist["min"]), float(dist["max"]) + 1.0
    q = np.asarray(q, np.float64)
    if dist["dist"] == "uniform":
        x = lo + q * (hi - lo)
    elif dist["dist"] == "loguniform":
        x = lo * np.exp(q * math.log(hi / lo))
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return np.minimum(np.floor(x), dist["max"]).astype(np.int64)


def grid(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def residual_quantile(dist: dict, q: np.ndarray) -> np.ndarray:
    """Quantiles of the residual life R >= 1 of the integer length L:
    P(R = r) = P(L >= r) / E[L]."""
    r = np.arange(1, int(dist["max"]) + 1)
    tail = 1.0 - cdf(dist, r.astype(np.float64))      # P(X >= r) = P(L >= r)
    c = np.cumsum(tail)
    c /= c[-1]
    return r[np.minimum(np.searchsorted(c, q, side="left"), len(r) - 1)]


def _flags(n: int, share: float, rng: np.random.Generator) -> np.ndarray:
    k = int(round(n * share))
    flags = np.zeros(n, bool)
    flags[:k] = True
    return rng.permutation(flags)


class Deck:
    """The requests of one run, dealt in send order: the clients' first
    requests (``first``), then the block-stratified stream (``next``)."""

    def __init__(self, mix: dict, seed: int):
        self.mix = mix
        self.rng = np.random.default_rng([_key(seed), 0x5EED])
        self._rid = 0
        self._pending: List[Card] = []

    def _card(self, p: int, o: int, greedy: bool) -> Card:
        card = Card(self._rid, int(p), int(o), bool(greedy))
        self._rid += 1
        return card

    def first(self) -> List[Card]:
        """One card a client: prompts from the prompt grid, outputs from
        the residual-life grid, both shuffled."""
        n = self.mix["clients"]
        g = grid(n)
        prompts = self.rng.permutation(quantile(self.mix["prompt"], g))
        outs = self.rng.permutation(
            residual_quantile(self.mix["output"], g))
        flags = _flags(n, self.mix["greedy_share"], self.rng)
        return [self._card(p, o, f) for p, o, f in zip(prompts, outs, flags)]

    def next(self) -> Card:
        if not self._pending:
            n = self.mix["block"]
            g = grid(n)
            prompts = self.rng.permutation(quantile(self.mix["prompt"], g))
            outs = self.rng.permutation(quantile(self.mix["output"], g))
            flags = _flags(n, self.mix["greedy_share"], self.rng)
            self._pending = [self._card(p, o, f)
                             for p, o, f in zip(prompts, outs, flags)]
            self._pending.reverse()
        return self._pending.pop()


def prompt_tokens(seed: int, rid: int, n: int, vocab: int) -> List[int]:
    """Request ``rid``'s prompt: ``n`` ids uniform over [0, vocab)."""
    rng = np.random.default_rng([_key(seed), 0x70C, rid])
    return rng.integers(0, vocab, n).tolist()


def buckets(mix: dict) -> List[int]:
    """The prefill buckets the mix's prompts fill: powers of two from the
    shortest prompt's to the longest's, at least a page, at most
    ``max_len`` rounded up to pages (the port's bucket rule)."""
    page = mix["page_size"]
    max_len = -(-mix["max_len"] // page) * page
    out = []
    b = bucket(mix["prompt"]["min"], page, max_len)
    while True:
        out.append(b)
        if b >= bucket(mix["prompt"]["max"], page, max_len):
            return out
        b = min(b * 2, max_len)


def bucket(n: int, page: int, max_len: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return min(max(page, p), max_len)


def sampled_seed(seed: int, rid: int) -> int:
    """A sampled request's own sampler seed, from (seed, rid)."""
    return int(np.random.default_rng([_key(seed), 0x5A3, rid])
               .integers(0, 2**31))


def _key(seed: int) -> int:
    """Any whole number as a numpy seed word (negative ones too)."""
    return int(seed) % 2**64
