"""Gradient compression, int8 with error feedback: the port's counterpart
of ``repro.parallel.compression`` for the single-device trainer.

``compress_tree`` quantizes each gradient leaf (plus its error-feedback
residual, carried in the train state) to int8 with a max-abs scale and
hands the optimizer the dequantized values; the residual keeps the
long-run bias at zero (EF-SGD). The scale is one per reference leaf: the
reference stacks a pattern position's layers into one leaf, so the port's
per-layer leaves of one stack share a scale (``group``; the trainer's
``stack_group``). ``torch.round`` rounds half to even, as
``jnp.round`` does, so the port's int8 values are the reference's bit for
bit. The reference's ``compressed_psum`` (the int8 all-reduce of a
shard_map data-parallel sync) belongs to model-parallel training and is not
here.
"""
from __future__ import annotations

from typing import Callable, Dict, Hashable, List, Optional, Tuple

import torch
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
                  group: Optional[Callable[[tuple], Hashable]] = None):
    """(dequantized grads, each leaf in its gradient's dtype; the new error
    tree, fp32, like ``grads``). ``err_tree`` pairs with ``grads`` by key
    path. ``group`` maps a leaf's key path to the name of its scale group:
    leaves of one name share one scale, the max-abs over all of them;
    default one a leaf."""
    flat, spec = pytree.tree_flatten_with_path(grads)
    err_of = dict(pytree.tree_flatten_with_path(err_tree)[0])
    groups: Dict[Hashable, List[int]] = {}
    for i, (path, _) in enumerate(flat):
        groups.setdefault(i if group is None else group(path), []).append(i)
    out_g, out_e = [None] * len(flat), [None] * len(flat)
    for grp in groups.values():
        xf = [flat[i][1].float() + err_of[flat[i][0]] for i in grp]
        s = _qparams(torch.stack([x.abs().max() for x in xf]))
        for i, x in zip(grp, xf):
            q, out_e[i] = _quantize(x, s)
            out_g[i] = (q.float() * s).to(flat[i][1].dtype)
    return (pytree.tree_unflatten(out_g, spec),
            pytree.tree_unflatten(out_e, spec))


def init_error_tree(params):
    """fp32 zeros like ``params``."""
    return pytree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)
