"""AdamW with a configurable moment dtype, global-norm clipping and a
warm-up + cosine schedule: the port's counterpart of ``repro.optim.adamw``.

Written out by hand, not ``torch.optim.AdamW``, whose decay and rounding
differ: the arithmetic is the reference's, in fp32 (bias corrections
``1 - b ** step``, ``delta = m̂ / (sqrt(v̂) + eps) + weight_decay · p``,
``p - lr · delta``), the moments stored in ``moment_dtype`` (llama4's SMOKE
config keeps bf16 moments) and the parameter cast back to its own dtype.
Where the reference returns new trees, ``apply`` updates the parameters and
moments in place, one leaf at a time, so the card holds one leaf's fp32
temporaries at a time. Trees are nested dicts and lists of tensors (the
port's parameter layout); the step count is a 0-dim int32 tensor on the
parameters' device, so nothing syncs with the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils import _pytree as pytree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    moment_dtype: str = "float32"


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_frac`` of ``lr``; fp32
    like the step it is read at."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def init(cfg: AdamWConfig, params) -> Dict[str, Any]:
    """{"m", "v": zeros like ``params`` in ``moment_dtype``, "step": 0}."""
    mdt = getattr(torch, cfg.moment_dtype)

    def z(p):
        return torch.zeros(p.shape, dtype=mdt, device=p.device)

    dev = pytree.tree_leaves(params)[0].device
    return {"m": pytree.tree_map(z, params), "v": pytree.tree_map(z, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree, *, split: Optional[Callable[[tuple], frozenset]] = None,
                all_reduce: Optional[Callable] = None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares.
    ``split`` (a leaf's key path -> the mesh axes, "model" and / or
    "data", over which ``tree`` holds a rank's part of it): each part's
    squares are summed over exactly those axes' groups by ``all_reduce``
    (a rank's ``ManualRules.all_reduce``: one call for the data axis,
    then one for the model axis), each other leaf counted once, so every
    rank gets the whole tree's norm."""
    flat = pytree.tree_flatten_with_path(tree)[0]
    zero = torch.zeros((), dtype=torch.float32, device=flat[0][1].device)
    acc = {(): zero, ("data",): zero, ("model",): zero,
           ("data", "model"): zero}
    present: set = set()
    for path, g in flat:
        key = () if split is None else tuple(sorted(split(path)))
        present.update(key)
        acc[key] = acc[key] + g.float().square().sum()
    over_data = torch.stack([acc[("data", "model")], acc[("data",)]])
    if "data" in present:
        all_reduce(over_data, "data")
    over_model = acc[("model",)] + over_data[0]
    if "model" in present:
        all_reduce(over_model, "model")
    return torch.sqrt(acc[()] + over_model + over_data[1])


@torch.no_grad()
def apply(cfg: AdamWConfig, grads, opt_state: Dict[str, Any], params, *,
          split: Optional[Callable[[tuple], frozenset]] = None,
          all_reduce: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
    """One AdamW update of ``params`` and ``opt_state`` in place, leaf by
    leaf. ``grads`` and the moments pair with ``params`` by key path (any
    float dtype for the gradients). ``split`` / ``all_reduce``: a
    sharded rank's (``global_norm``). Returns
    {"grad_norm" (before clipping), "lr"}, 0-dim fp32 tensors."""
    opt_state["step"] += 1
    step = opt_state["step"]
    gnorm = global_norm(grads, split=split, all_reduce=all_reduce)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if cfg.clip_norm > 0 else 1.0
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    g_of, m_of, v_of = (dict(pytree.tree_flatten_with_path(t)[0]) for t in
                        (grads, opt_state["m"], opt_state["v"]))
    for path, p in pytree.tree_flatten_with_path(params)[0]:
        g, m, v = g_of[path], m_of[path], v_of[path]
        g = g.float() * scale
        m2 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v2 = cfg.b2 * v.float() + (1 - cfg.b2) * g.square()
        delta = (m2 / b1c) / (torch.sqrt(v2 / b2c) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m2)
        v.copy_(v2)
    return {"grad_norm": gnorm, "lr": lr}
