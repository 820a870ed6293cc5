"""GPipe-style pipeline parallelism over ``torch.distributed``: the port's
counterpart of ``repro.parallel.pipeline``.

One stage a rank of a process group: each rank runs its stage's params on a
stream of microbatches and hands the activations to the next rank over a
ring (``dist.batch_isend_irecv``, the reference's ``lax.ppermute``). The
classic GPipe schedule: with M microbatches and S stages the loop runs
M + S - 1 ticks, and the bubble fraction is (S - 1) / (M + S - 1). Bubble
ticks run the stage on don't-care data, as the reference's do; only the
last stage's valid outputs are kept, and its buffer is summed over the
group (the reference's ``psum``), so every rank returns the outputs.
Forward only, as the reference is tested.

The ring hop is point-to-point, which a backend must support for the
tensors' device: NCCL for CUDA tensors (one GPU a rank), gloo for CPU
tensors. Nothing stages a tensor through another device. gloo does not
check: handed a CUDA tensor, its TCP transport writes from the device
pointer, fails ("Bad address") and closes the pair, which leaves the group
unusable. So ``gpipe`` raises first for a CUDA tensor over gloo.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist


def gpipe(stage_fn: Callable, group=None) -> Callable:
    """A pipelined apply over the ranks of ``group`` (default: the world),
    stage s on the group's rank s: run(params, xs) -> outputs.

    stage_fn(params, x) -> y must keep x's shape (a transformer block's
    contract). params: this rank's stage's parameters (the reference's
    stacked params at this stage's index). xs: (n_micro, mb, ...), the
    whole microbatch stream, read at stage 0 only. Returns (n_micro, mb,
    ...), the last stage's outputs, the same on every rank."""
    n_stages = dist.get_world_size(group)
    idx = dist.get_rank(group)

    def peer(i):
        r = i % n_stages
        return r if group is None else dist.get_global_rank(group, r)

    def run(params, xs: torch.Tensor) -> torch.Tensor:
        if n_stages > 1 and xs.is_cuda \
                and dist.get_backend(group) == "gloo":
            raise RuntimeError(
                "gpipe: gloo's point-to-point takes CPU tensors only; a "
                "CUDA tensor's ring hop needs NCCL, one GPU a rank")
        n_micro = xs.shape[0]
        state = torch.zeros_like(xs[0])
        buf = torch.zeros_like(xs)
        for t in range(n_micro + n_stages - 1):
            x_in = xs[min(t, n_micro - 1)] if idx == 0 else state
            y = stage_fn(params, x_in)
            if n_stages == 1:
                state = y
            else:
                state = torch.empty_like(y)
                for w in dist.batch_isend_irecv([
                        dist.P2POp(dist.isend, y.contiguous(), peer(idx + 1),
                                   group),
                        dist.P2POp(dist.irecv, state, peer(idx - 1),
                                   group)]):
                    w.wait()
            out_t = t - (n_stages - 1)
            if idx == n_stages - 1 and out_t >= 0:
                buf[out_t] = y
        dist.all_reduce(buf, group=group)
        return buf

    return run


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
