"""Weight bridge: a JAX package parameter tree (as numpy) -> port parameters.

    tree = jax.tree.map(np.asarray, repro.models.api.init_params(cfg, key))
    params = params_from_jax(cfg, tree)                 # on the card
    params = params_from_jax(cfg, tree, device="cpu")   # plain CPU path

The caller converts the JAX arrays to numpy; the port never sees a JAX
array. The JAX tree stacks each pattern position's block parameters along a
leading layer axis (``blocks.scan["<j>"]``) plus a list of tail blocks; the
port wants one dict per layer in layer order, so the bridge unstacks them.
Both packages then compute the same function.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import transformer as tfm


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: no numpy interop
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(cfg, tree: Dict[str, Any], *,
                    device="cuda") -> Dict[str, Any]:
    """The port's parameters on ``device`` (CUDA unless the caller asks for
    the CPU; raises when CUDA is asked for and absent)."""
    device = resolve_device(device)
    kinds = tfm.pattern_for(cfg)
    n_super, tail = tfm.layer_plan(cfg)
    tfm.layer_kinds(cfg)                       # raises on unported kinds
    scan = tree["blocks"]["scan"]
    blocks = [_map(scan[str(j)], lambda a, s=s: _tensor(a[s], device))
              for s in range(n_super) for j in range(len(kinds))]
    blocks += [_map(t, lambda a: _tensor(a, device))
               for t in tree["blocks"]["tail"][:len(tail)]]
    out = {k: _map(v, lambda a: _tensor(a, device))
           for k, v in tree.items() if k != "blocks"}
    out["blocks"] = blocks
    return out
