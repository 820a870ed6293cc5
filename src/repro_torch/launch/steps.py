"""The dry-run's step functions, and one rank's arguments for them.

Counterpart of ``repro.launch.steps``: the dry-run traces exactly these
steps, the code the trainer and the server run (``trainer.
make_train_step``, ``api.prefill``, ``api.decode_step``), so a passing
dry-run certifies the production path. The reference hands ``jax.jit``
global shapes and shardings; the port runs one process a rank, so
``make_step`` hands back one rank's arguments:

* parameters and optimizer state cut to the rank's part at the
  reference's layout (``tp.train_plan``: every leaf's spec from
  ``Rules(mesh)`` over the whole table, so ``wembed`` splits over
  ``("pod", "data")`` and the heads, ffn, vocab and expert dims over
  ``model``), for all three step kinds, as the reference compiles them
  all under one ``Rules(mesh)``;
* the batch split over ``("pod", "data")`` (a dim that does not divide
  replicates, as ``Rules`` falls back), and its sequence over ``model``
  when ``rules.table`` maps "seq" there (context parallelism: the
  reference's ``--optimized``);
* for decode, the dense ``cache_init`` lanes at the rank's rows and KV
  heads, or under context parallelism its block of each lane (the KV
  heads then lose ``model`` to the sequence, ``Rules.spec``'s conflict
  fallback);

and the rank's rules, a ``sharding.DryRunRules`` (the train plan's
contractions and gathers) that records each collective instead of issuing
it: the sums over ``model`` (the contractions) and ``data`` (the train
step's gradient average), the all-gathers of the split leaves at their
use and the reduce-scatters of their gradients. Tensors are made on
``device`` with ``torch.empty`` / ``torch.zeros``: inside a
``FakeTensorMode`` (the dry-run) nothing is allocated.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, input_specs
from repro_torch.models import api
from repro_torch.optim import adamw
from repro_torch.parallel import tp
from repro_torch.parallel.sharding import DryRunRules, Rules
from repro_torch.runtime import trainer as trainer_mod

BATCH_AXES = {
    "tokens": "batch,seq",
    "labels": "batch,seq",
    "pos": "batch",
    "enc_embeds": "batch,seq,embed",
    "frontend_embeds": "batch,seq,embed",
}


def opt_config_for(cfg: ModelConfig) -> adamw.AdamWConfig:
    return adamw.AdamWConfig(moment_dtype=cfg.moment_dtype)


def state_shapes(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, *,
                 device="meta") -> Dict[str, Any]:
    """The whole train state as uninitialised tensors on ``device``
    (``meta``: shapes and dtypes only)."""
    p = api.empty_params(cfg, device=device)
    return {"params": p, "opt": adamw.init(opt_cfg, p)}


def state_axes(cfg: ModelConfig) -> Dict[str, Any]:
    pa = api.param_axes(cfg)
    return {"params": pa,
            "opt": {"m": pa, "v": pa, "step": ""}}


def local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """A rank's part of a dim tuple under ``spec`` (per dim a mesh axis,
    a tuple of them, or None)."""
    out = []
    for i, n in enumerate(shape):
        ax = spec[i] if i < len(spec) else None
        names = () if ax is None else (ax if isinstance(ax, tuple) else (ax,))
        out.append(n // math.prod(mesh.shape[a] for a in names))
    return tuple(out)


def make_step(cfg: ModelConfig, shape: ShapeConfig, rules: Rules, *,
              device="cpu") -> Tuple[Callable, tuple, DryRunRules]:
    """(step fn, one rank's arguments, the rank's ``DryRunRules``) for the
    cell's step kind on ``rules.mesh`` (``launch.mesh``; ``rules.table``
    decides the batch's split and whether the sequence splits over
    ``model``, ``tp.train_plan``)."""
    mesh = rules.mesh
    plan = tp.train_plan(cfg, mesh, rules.table)
    pspecs = plan.param_specs(cfg)
    r = plan.rules
    rank = DryRunRules(r.contract_axes, r.sharded, data=r.data,
                       model=r.model, uses=r.uses,
                       train=shape.kind == "train", seq=r.seq,
                       whole_kv=r.whole_kv)
    ins = input_specs(cfg, shape)

    def batch_of(names):
        return {k: torch.zeros(local_shape(v.shape, rules.spec(
                    tuple(v.shape), BATCH_AXES[k]), mesh),
                    dtype=v.dtype, device=device)
                for k, v in ins.items() if k in names}

    def part(tree, specs):
        return tp.shard_tree(tree, specs, plan.model_shards, 0, d=r.data)

    if shape.kind == "train":
        opt_cfg = opt_config_for(cfg)
        state = state_shapes(cfg, opt_cfg, device=device)
        state = part(state, tp.state_specs(plan, state))
        step = trainer_mod.make_train_step(cfg, opt_cfg, rules=rank)
        return step, (state, batch_of(BATCH_AXES)), rank

    params = part(api.empty_params(cfg, device=device), pspecs)
    if shape.kind == "prefill":
        def fn(params, batch):
            return api.prefill(cfg, params, batch["tokens"],
                               enc_embeds=batch.get("enc_embeds"),
                               frontend_embeds=batch.get("frontend_embeds"),
                               rules=rank)

        return fn, (params, batch_of(BATCH_AXES)), rank

    # decode: the dense lanes, batch over (pod, data), KV heads with
    # attention, the sequence as the table says
    table = {"batch": rules.table["batch"], "seq": r.seq,
             "kv_heads": "model" if "kv_heads" in plan.sharded_axes
             else None}
    crules = Rules(mesh, {name: table.get(name) for name in rules.table})
    cache = [{name: torch.zeros(local_shape(t.shape, crules.spec(
                  tuple(t.shape), axes[name]), mesh),
                  dtype=t.dtype, device=device)
              for name, t in e.items()}
             for e, axes in zip(ins["cache"], api.cache_axes(cfg))]

    def fn(params, cache, tokens, pos):
        return api.decode_step(cfg, params, cache, tokens, pos, rules=rank)

    b = batch_of(("tokens", "pos"))
    return fn, (params, cache, b["tokens"], b["pos"]), rank
