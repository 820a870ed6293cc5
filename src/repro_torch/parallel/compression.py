"""Gradient compression, int8 with error feedback: the port's counterpart
of ``repro.parallel.compression``.

``compress_tree`` quantizes each gradient leaf (plus its error-feedback
residual, carried in the train state) to int8 with a max-abs scale and
hands the optimizer the dequantized values; the residual keeps the
long-run bias at zero (EF-SGD). The scale is one per reference leaf: the
reference stacks a pattern position's layers into one leaf, so the port's
per-layer leaves of one stack share a scale (``group``; the trainer's
``stack_group``). ``torch.round`` rounds half to even, as
``jnp.round`` does, so the port's int8 values are the reference's bit for
bit. On a sharded rank a group that holds a split leaf takes the max over
every rank's part (a MAX all-reduce over each axis its leaves are split
on: ``data``, then ``model``), so its scale is the whole reference leaf's,
as on one device.

``compressed_psum`` is the int8 all-reduce of a data-parallel sync (the
reference's ``shard_map`` one): one scale for all ranks (a MAX
all-reduce), int8 values summed in int32, then dequantized.
"""
from __future__ import annotations

from typing import Callable, Dict, Hashable, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree


def _qparams(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x.abs().max(), min=1e-12) / 127.0


def _quantize(xf: torch.Tensor, s: torch.Tensor):
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return q, xf - q.float() * s


def compress(x: torch.Tensor, err: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x + error feedback -> (int8 q, fp32 scale, new fp32 error)."""
    xf = x.float() + err
    s = _qparams(xf)
    q, new_err = _quantize(xf, s)
    return q, s, new_err


def compress_tree(grads, err_tree,
                  group: Optional[Callable[[tuple], Hashable]] = None, *,
                  split: Optional[Callable[[tuple], frozenset]] = None,
                  all_reduce: Optional[Callable] = None):
    """(dequantized grads, each leaf in its gradient's dtype; the new error
    tree, fp32, like ``grads``). ``err_tree`` pairs with ``grads`` by key
    path. ``group`` maps a leaf's key path to the name of its scale group:
    leaves of one name share one scale, the max-abs over all of them;
    default one a leaf. ``split`` (a leaf's key path -> the mesh axes,
    "model" and / or "data", over which the tree holds a rank's part of
    it): a group holding such leaves takes its max over those axes'
    groups too, by ``all_reduce`` (a rank's ``ManualRules.all_reduce``;
    one MAX reduction an axis for all the groups)."""
    flat, spec = pytree.tree_flatten_with_path(grads)
    err_of = dict(pytree.tree_flatten_with_path(err_tree)[0])
    groups: Dict[Hashable, List[int]] = {}
    for i, (path, _) in enumerate(flat):
        groups.setdefault(i if group is None else group(path), []).append(i)

    def xf(i):
        return flat[i][1].float() + err_of[flat[i][0]]

    grps = list(groups.values())
    peak = [torch.stack([xf(i).abs().max() for i in g]).max() for g in grps]
    for axis in ("data", "model"):
        over = [j for j, g in enumerate(grps) if split is not None
                and any(axis in split(flat[i][0]) for i in g)]
        if over:
            across = torch.stack([peak[j] for j in over])
            all_reduce(across, axis, op=dist.ReduceOp.MAX)
            for j, v in zip(over, across):
                peak[j] = v
    out_g, out_e = [None] * len(flat), [None] * len(flat)
    for grp, mx in zip(grps, peak):
        s = torch.clamp(mx, min=1e-12) / 127.0
        for i in grp:
            q, out_e[i] = _quantize(xf(i), s)
            out_g[i] = (q.float() * s).to(flat[i][1].dtype)
    return (pytree.tree_unflatten(out_g, spec),
            pytree.tree_unflatten(out_e, spec))


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (default: the world)
    in int8: the scale is the MAX over the ranks of each one's max|x| /
    127, ``x`` is rounded (half to even, as ``jnp.round``) to int8 at it,
    the int8 values are summed in int32, and the sum is dequantized to
    ``x``'s dtype. The integer sum is exact, so every order of the
    reduction gives the same bits."""
    xf = x.float()
    s = _qparams(xf)
    dist.all_reduce(s, op=dist.ReduceOp.MAX, group=group)
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    total = q.to(torch.int32)
    dist.all_reduce(total, group=group)
    return (total.float() * s).to(x.dtype)


def init_error_tree(params):
    """fp32 zeros like ``params``."""
    return pytree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)
