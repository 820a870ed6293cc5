"""Rank-side scenarios of tests/test_torch_train_heads.py and
tests/test_torch_train_mixers.py: a rank computes its share of attention
whose query heads split over ``model`` while its KV heads do not, and of
the recurrent mixers over their ``model`` dims, in spawned gloo worlds of
4 on the CPU. Imports neither jax nor the JAX package: the ranks read the
JAX package's initial states and parameters (moved over by
``repro_torch.convert``) and the batches from a ``torch.save`` file.

``run_scenarios(rank, inputs_file, names)`` runs each named scenario in
the world, each on its own ``(data, model)`` fold of the world's ranks,
and returns {name: result or {"error": traceback}}, tensors as numpy
arrays.
"""
import dataclasses
import sys
import traceback
import warnings

import torch
from torch.utils import _pytree as pytree

from repro_torch.parallel import tp
from repro_torch.parallel.sharding import TrainRules
from repro_torch.runtime import trainer
from torch_layout_ranks import mesh_of
from torch_train_ranks import QWEN, cfg_of, train_case


# name: (arch, (data, model), mamba2 ssm fields replaced). mamba2 SMOKE
# with 15 state dims: in_proj's 2 * 128 + 2 * 15 + 4 = 290 columns do not
# divide 4 ranks (the SMOKE config's 292 do)
CASES = {
    "qwen_1x4": (QWEN, (1, 4), {}),
    "rgemma_1x4": ("recurrentgemma-9b", (1, 4), {}),
    "mamba2_2x2": ("mamba2-2.7b", (2, 2), {}),
    "mamba2_1x4": ("mamba2-2.7b", (1, 4), {}),
    "mamba2_odd_1x4": ("mamba2-2.7b", (1, 4), {"state_dim": 15}),
}


def case_over(name):
    """The config fields case ``name`` replaces."""
    arch, _, ssm = CASES[name]
    if not ssm:
        return {}
    return {"ssm": dataclasses.replace(cfg_of(arch).ssm, **ssm)}


def _train(name):
    arch, (d, m), _ = CASES[name]

    def scenario(inputs):
        return train_case(mesh_of(d, m), inputs, name,
                          case=(arch, 1, False), over=case_over(name))
    scenario.__name__ = f"train_{name}"
    return scenario


class NoPartialRules(TrainRules):
    """The control: ``TrainRules`` whose ``partial`` sums nothing (each
    rank keeps its own share of a whole leaf's gradient)."""

    def partial(self, *leaves):
        return leaves


def _grads(name):
    """The gradient of the loss on ``inputs["batch"][name]`` at the JAX
    package's parameters, each rank's (its part of a split leaf, a whole
    leaf whole), under the plan's rules and under ``NoPartialRules``; the
    leaves' specs."""
    arch, (d, m), _ = CASES[name]

    def scenario(inputs):
        cfg = cfg_of(arch, **case_over(name))
        mesh = mesh_of(d, m)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            plan = tp.train_plan(cfg, mesh)
        specs = plan.param_specs(cfg)
        part = tp.shard_tree(inputs["params"][name], specs, m,
                             mesh.model_rank)
        batch = {k: torch.from_numpy(v)
                 for k, v in inputs["batch"][name].items()}
        r = plan.rules
        out = {"specs": specs, "whole_kv": r.whole_kv,
               "contract": sorted(r.contract_axes)}
        for which, rules in (("plan", r), ("control", NoPartialRules(
                r.contract_axes, r.group, r.sharded, model=r.model,
                model_rank=r.model_rank, uses=r.uses,
                whole_kv=r.whole_kv))):
            loss, aux, g = trainer.loss_and_grads(cfg, part, batch,
                                                  rules=rules)
            out[which] = {"loss": loss.item(), "grads": g}
        return out
    scenario.__name__ = f"grads_{name}"
    return scenario


# the gradients at a (1, 4) fold, one replica of the whole batch
GRADS = tuple(n for n in CASES if CASES[n][1] == (1, 4))
SCENARIOS = {f.__name__: f for f in (
    *(_train(n) for n in CASES), *(_grads(n) for n in GRADS))}


def run_scenarios(rank, inputs_file, names):
    """A rank's results, {name: result or {"error": traceback}}, plus
    "jax_loaded": whether anything imported jax or the JAX package."""
    torch.set_num_threads(1)
    inputs = torch.load(inputs_file, weights_only=False)
    out = {}
    for name in names:
        try:
            out[name] = pytree.tree_map(
                lambda t: t.numpy() if isinstance(t, torch.Tensor) else t,
                SCENARIOS[name](inputs))
        except Exception:       # reported per scenario; the test fails it
            out[name] = {"error": traceback.format_exc()}
    out["jax_loaded"] = sorted(
        m for m in sys.modules if m in ("jax", "repro")
        or m.startswith(("jax.", "repro.")))
    return out
