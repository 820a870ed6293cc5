"""Per-request decode policies: ``SamplingParams`` and the batched sampler
the paged engine emits every token through.

Counterpart of ``repro.runtime.sampling``, name for name, and bit for bit
where the reference is integer arithmetic:

* **Policies are operands.** A request's (temperature, top_k, top_p, seed)
  and its PRNG fold (rid, next generated-token index) live in fixed
  per-slot device buffers (``PolicyBuffers``), allocated once by the
  engine and written in place at admission and release. A captured decode
  graph reads them, so one graph serves any mix of greedy and sampled
  requests.
* **Greedy is the temperature-0 row of the sampled program.** A draw at
  temperature t is ``argmax(z + G)``, z the masked, scaled logits and G
  Gumbel noise; rows with t <= 0 multiply the noise by zero and reduce to
  the exact argmax (the top-k/top-p masks keep the top-1 token).
* **Per-request PRNG, position-indexed.** The key deciding generated token
  ``idx`` of request ``rid`` is ``fold_in(fold_in(fold_in(key(seed), rid),
  idx), draw)``, a pure function of (seed, rid, idx), so a request replays
  the same stream alone, in any batch, and after preemption. Keys and bits
  are jax's Threefry-2x32 with ``jax_threefry_partitionable`` on (the
  default from jax 0.5), computed in int64 tensors (``kernels.ref``) and,
  for the (rows, vocab) noise with its key folded in, by the sampler's
  CUDA kernel (``kernels.ops.sampler_noise``); both equal ``jax.random``
  bit for bit.
  ``ACCEPT_DRAW`` and ``SAMPLE_DRAW`` separate a position's two uses.

Speculative verification (``runtime/serving.py``'s verify step): both
drafters propose deterministically, so a draft x is accepted iff ``u <
p(x)``; on the first rejection the engine emits a sample of p with x's
mass removed (a gumbel-argmax with x masked). At temperature 0 this is
exact greedy matching.

Nothing here syncs the host: every op has a fixed shape (sort, gather,
softmax, cumsum, where), so the sampler captures into a CUDA graph.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import (bits_to_unit, fold_in, row_keys,
                                     threefry2x32)

# Filtered-out logits get a large finite penalty rather than -inf: an
# all-masked row still argmaxes deterministically instead of giving NaN.
NEG_FILTER = -1e30

# fold_in tags separating the independent draws of one generated position
ACCEPT_DRAW = 0
SAMPLE_DRAW = 1

_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode policy, carried on ``Request.params``. Defaults
    are exact greedy.

    temperature: 0 = greedy (argmax); > 0 scales logits by 1/t.
    top_k: keep only the k highest logits (0 = no cut).
    top_p: nucleus — keep the smallest prefix of the sorted distribution
        with cumulative mass >= top_p (1.0 = no cut).
    seed: per-request PRNG seed; None uses the engine's seed.
    """
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None

    def validate(self) -> "SamplingParams":
        if not self.temperature >= 0.0:
            raise ValueError(
                f"temperature must be >= 0 (0 = greedy): {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 = off): {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(
                f"top_p must be in (0, 1] (1 = off): {self.top_p}")
        return self

    @property
    def is_greedy(self) -> bool:
        return self.temperature <= 0.0


GREEDY = SamplingParams()


class PolicyBuffers:
    """The per-slot policy operands (the reference's ``policy_operands``)
    as fixed device buffers: ``temp``, ``top_k``, ``top_p``, ``seed``,
    ``rid`` and ``idx`` (the slot's next generated-token index), allocated
    once. ``set_slot``/``clear_slot`` write one slot's row in place (on
    the device's current stream, between graph replays); the decode step
    advances ``idx`` of live slots in place."""

    def __init__(self, slots: int, device):
        def z(dtype, fill=0):
            return torch.full((slots,), fill, dtype=dtype, device=device)

        self.temp = z(torch.float32)
        self.top_k = z(torch.int32)
        self.top_p = z(torch.float32, 1.0)
        self.seed = z(torch.int64)
        self.rid = z(torch.int64)
        self.idx = z(torch.int64)

    def set_slot(self, slot: int, p: SamplingParams, rid: int, idx: int,
                 default_seed: int) -> None:
        s = p.seed if p.seed is not None else default_seed
        self.temp[slot] = float(p.temperature)
        self.top_k[slot] = int(p.top_k)
        self.top_p[slot] = float(p.top_p)
        self.seed[slot] = int(s) & 0x7FFFFFFF
        self.rid[slot] = int(rid) & _M32
        self.idx[slot] = int(idx)

    def clear_slot(self, slot: int) -> None:
        """A dead slot's row: greedy, whose output the live mask drops."""
        self.set_slot(slot, GREEDY, 0, 0, 0)


def policy_operands(policies: Sequence[Optional[SamplingParams]],
                    rids: Sequence[int], idxs: Sequence[int],
                    default_seed: int, device="cpu") -> PolicyBuffers:
    """Stack per-row policies into a fresh ``PolicyBuffers`` (None = greedy
    row): the reference's ``policy_operands``, for one-off calls such as a
    prefill's first token and the tests."""
    pol = PolicyBuffers(len(policies), device)
    for i, p in enumerate(policies):
        pol.set_slot(i, p if p is not None else GREEDY, rids[i], idxs[i],
                     default_seed)
    return pol


def fold_keys(seed: torch.Tensor, rid: torch.Tensor,
              idx: torch.Tensor) -> torch.Tensor:
    """(B,) int operands -> (B, 2) int64 key words:
    ``fold_in(fold_in(key(seed), rid), idx)``, ``key(seed)`` being the
    words (0, seed)."""
    return row_keys(seed, rid, idx)


def draw_keys(keys: torch.Tensor, draw: int) -> torch.Tensor:
    """Split each row's key into its independent draws (ACCEPT_DRAW /
    SAMPLE_DRAW)."""
    k = fold_in((keys[:, 0], keys[:, 1]), torch.full_like(keys[:, 0], draw))
    return torch.stack(k, -1)


def uniform(keys: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(key)`` (a float32 scalar on [0, 1)) per row."""
    a, b = threefry2x32(keys[:, 0], keys[:, 1], torch.zeros_like(keys[:, 0]),
                        torch.zeros_like(keys[:, 0]))
    return torch.clamp(bits_to_unit(a ^ b), min=0.0)


def scale_mask(logits: torch.Tensor, temp: torch.Tensor, top_k: torch.Tensor,
               top_p: torch.Tensor) -> torch.Tensor:
    """Temperature-scale then top-k/top-p-filter a (B, V) logit batch,
    rowwise. Returns fp32 ``z`` with filtered entries at ``NEG_FILTER``;
    ``softmax(z)`` is the policy's distribution and ``argmax(z)`` its
    greedy token. Rows with temp <= 0 skip the scale.

    One sort where the reference sorts twice: the top-k cut keeps every
    value >= the k-th largest and sets the rest to NEG_FILTER, below all
    of them, so the sorted survivors are the first sort's values with the
    same cut applied — the very values a second sort would return."""
    V = logits.shape[-1]
    z = logits.float()
    z = z / torch.where(temp > 0, temp, torch.ones_like(temp))[:, None]
    # top-k: value threshold at the k-th largest, rows with k <= 0 exempt
    srt = torch.sort(z, dim=-1, descending=True).values
    kth = torch.gather(srt, -1, (top_k.long() - 1).clamp(0, V - 1)[:, None])
    no_k = (top_k <= 0)[:, None]
    neg = torch.full_like(z, NEG_FILTER)
    z = torch.where((z >= kth) | no_k, z, neg)
    # top-p on the top-k survivors: keep the smallest sorted prefix whose
    # cumulative mass reaches p (the token crossing the boundary is kept)
    srt = torch.where((srt >= kth) | no_k, srt, neg)
    probs = torch.softmax(srt, dim=-1)
    keep_sorted = (torch.cumsum(probs, dim=-1) - probs) < top_p[:, None]
    n_keep = keep_sorted.sum(-1).clamp(min=1)
    pth = torch.gather(srt, -1, (n_keep - 1)[:, None])
    return torch.where((z >= pth) | (top_p >= 1.0)[:, None], z, neg)


def gumbel_noise(seed: torch.Tensor, rid: torch.Tensor, idx: torch.Tensor,
                 n: int, draw: int = SAMPLE_DRAW) -> torch.Tensor:
    """(R, n) Gumbel noise of each row's key ``fold_in(fold_keys(seed, rid,
    idx), draw)``: the sampler's CUDA kernel on the card, which folds the
    key itself, the plain version on the CPU."""
    return ops.sampler_noise(seed, rid, idx, n, draw=draw)


def gumbel_argmax(z: torch.Tensor, temp: torch.Tensor, seed: torch.Tensor,
                  rid: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The fused categorical-or-greedy draw with each row's SAMPLE_DRAW
    key (of (seed, rid, idx)): noise zeroed where temp <= 0, so
    ``argmax(z + noise)`` samples softmax(z) on sampled rows and is the
    exact argmax on greedy rows. First index on ties, as ``jnp.argmax``."""
    g = gumbel_noise(seed, rid, idx, z.shape[-1])
    return torch.argmax(z + (temp > 0).float()[:, None] * g, dim=-1)


def sample_rows(logits: torch.Tensor, pol, offset=0) -> torch.Tensor:
    """One token per row of a (B, V) logit batch under the stacked
    policies ``pol`` (a ``PolicyBuffers``). ``offset`` shifts the
    generated-token index (an int or a (B,) tensor). Callers slice the
    logits to the real vocabulary first. Returns (B,) int64."""
    z = scale_mask(logits, pol.temp, pol.top_k, pol.top_p)
    return gumbel_argmax(z, pol.temp, pol.seed, pol.rid, pol.idx + offset)


def request_params(req, default: SamplingParams) -> SamplingParams:
    """A request's effective policy: its own ``params`` if set, else the
    engine default — validated either way."""
    p = getattr(req, "params", None)
    return (p if p is not None else default).validate()


def summarize(policies: List[Optional[SamplingParams]]) -> str:
    """Human-readable policy mix for logs."""
    live = [p for p in policies if p is not None]
    n_greedy = sum(1 for p in live if p.is_greedy)
    return f"{n_greedy} greedy / {len(live) - n_greedy} sampled"
