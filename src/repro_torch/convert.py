"""Weight bridge: a JAX package parameter tree (as numpy) -> port parameters.

    tree = jax.tree.map(np.asarray, repro.models.api.init_params(cfg, key))
    params = params_from_jax(cfg, tree)                 # on the card
    params = params_from_jax(cfg, tree, device="cpu")   # plain CPU path

The caller converts the JAX arrays to numpy; the port never sees a JAX
array. The JAX tree stacks each pattern position's block parameters along a
leading layer axis (``blocks.scan["<j>"]``) plus a list of tail blocks; the
port wants one dict per layer in layer order, so the bridge unstacks them
(a two-kind period such as llama4's ``attn_mlp`` / ``attn_moe`` pair
interleaves its positions back into layer order; an MoE block's ``moe``
leaves unstack like any other, its fp32 router staying fp32). An
encoder-decoder's ``enc`` subtree stacks its ``enc`` blocks the same way
(``enc.blocks.scan["0"]``) beside the encoder's ``final_norm``. Both
packages then compute the same function.
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


def _unstack(stack: Dict[str, Any], n_super: int, n_kinds: int,
             n_tail: int, device):
    """A JAX ``{"scan": {"<j>": stacked}, "tail": [...]}`` block tree ->
    one dict per layer, in layer order."""
    blocks = [_map(stack["scan"][str(j)], lambda a, s=s: _tensor(a[s], device))
              for s in range(n_super) for j in range(n_kinds)]
    return blocks + [_map(t, lambda a: _tensor(a, device))
                     for t in stack["tail"][:n_tail]]


def params_from_jax(cfg, tree: Dict[str, Any], *,
                    device="cuda") -> Dict[str, Any]:
    """The port's parameters on ``device`` (CUDA unless the caller asks for
    the CPU; raises when CUDA is asked for and absent)."""
    device = resolve_device(device)
    n_super, tail = tfm.layer_plan(cfg)
    out = {k: _map(v, lambda a: _tensor(a, device))
           for k, v in tree.items() if k not in ("blocks", "enc")}
    out["blocks"] = _unstack(tree["blocks"], n_super,
                             len(tfm.pattern_for(cfg)), len(tail), device)
    if cfg.is_encdec:
        enc = tree["enc"]
        out["enc"] = {
            "blocks": _unstack(enc["blocks"], cfg.enc_layers, 1, 0, device),
            "final_norm": _map(enc["final_norm"],
                               lambda a: _tensor(a, device))}
    return out


def state_from_jax(cfg, state: Dict[str, Any], *,
                   device="cuda") -> Dict[str, Any]:
    """A JAX train state (``repro.runtime.trainer.init_state``'s tree, as
    numpy: params, ``opt`` {"m", "v", "step"} and, with compression,
    ``err``) as the port's (``repro_torch.runtime.trainer``'s): the moments
    and the error tree are shaped like the params and unstack as they do;
    the step is a 0-dim int32 tensor."""
    opt = state["opt"]
    out = {"params": params_from_jax(cfg, state["params"], device=device),
           "opt": {"m": params_from_jax(cfg, opt["m"], device=device),
                   "v": params_from_jax(cfg, opt["v"], device=device),
                   "step": _tensor(opt["step"], resolve_device(device))}}
    if "err" in state:
        out["err"] = params_from_jax(cfg, state["err"], device=device)
    return out
