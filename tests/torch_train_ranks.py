"""Rank-side scenarios of tests/test_torch_train_parallel.py: model- and
data-parallel training of the port on the CPU, in spawned gloo worlds
(``repro_torch.launch.mesh.run_world``). Imports neither jax nor the JAX
package: the ranks read their inputs (the JAX package's initial states
moved over by ``repro_torch.convert``, the batches, the pipeline's
inputs) from a ``torch.save`` file.

``run_scenarios(rank, inputs_file, ckpt_dir, names)`` runs each named
scenario in the world and returns {name: result or {"error": traceback}},
tensors as numpy arrays.
A sharded leaf comes back as the rank's part with its spec, or gathered
on the group's first rank (``tp.gather_tree``), which the test process
compares with the whole.
"""
import dataclasses
import os
import sys
import traceback
import warnings

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_smoke_config
from repro_torch.data.synthetic import DataConfig, SyntheticDataset
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import api
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw
from repro_torch.parallel import compression, pipeline, tp
from repro_torch.parallel.sharding import NO_RULES, TrainRules
from repro_torch.runtime import trainer

QWEN = "qwen2.5-3b"
# the reference launcher's optimizer at --steps 30
OPT = dict(lr=3e-3, warmup_steps=5, total_steps=30)
# (arch, grad_accum, compress_grads) of each training case, by name
TRAIN_CASES = {
    "plain": (QWEN, 1, False),
    "accum4": (QWEN, 4, False),
    "compress": (QWEN, 1, True),
    "rgemma": ("recurrentgemma-9b", 1, False),
    "dbrx": ("dbrx-132b", 1, False),
    "dbrx_accum2": ("dbrx-132b", 2, False),
}
STEPS = 3
RESUME_AT, RESUME_STEPS = 4, 8        # the cross-mesh resume's schedule


def cfg_of(arch, **over):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32",
                               **over)


# ---------------------------------------------------------------------------
# one block, whole against shard by shard
# ---------------------------------------------------------------------------

# (config, block kind): attention + MLP with both sharded at worlds 2 and
# 4 (qwen2.5-3b SMOKE at 4 KV heads), and seamless's decoder block, whose
# cross-attention takes the encoder output as a second input
BLOCKS = {
    "attn_mlp": (QWEN, dict(kv_heads=4), "attn_mlp"),
    "dec": ("seamless-m4t-large-v2", {}, "dec"),
    "moe": ("dbrx-132b", {}, "attn_moe"),
}


class NaiveRules(TrainRules):
    """The contraction through ``torch.distributed.nn.functional.
    all_reduce``, no entry hook: its backward sums the gradient too."""

    def contract(self, x, axis):
        from torch.distributed.nn.functional import all_reduce
        return all_reduce(x, group=self.group) if self._check(axis) else x

    def enter(self, x, axis):
        return x


def _block_grads(cfg, kind, p, inputs, rules):
    """(output, grads of every leaf of ``p``, grads of ``inputs``) of
    ``block_train`` under a fixed linear read-out of its output."""
    leaves, spec = pytree.tree_flatten(p)
    leaves = [t.detach().requires_grad_() for t in leaves]
    ins = [t.detach().requires_grad_() for t in inputs]
    with torch.enable_grad():
        y, _ = tfm.block_train(cfg, kind, rules.use(pytree.tree_unflatten(
                                   leaves, spec), kind),
                               ins[0], ins[1] if len(ins) > 1 else None,
                               rules)
        w = torch.linspace(-1.0, 1.0, y.numel()).reshape(y.shape)
        g = torch.autograd.grad((y * w).sum(), leaves + ins)
    return (y.detach(), pytree.tree_unflatten(list(g[:len(leaves)]), spec),
            list(g[len(leaves):]))


def block(mesh, name):
    """One block whole (no rules) and as this rank's shard (``TrainRules``
    of ``tp.train_plan``, and ``NaiveRules`` for the control): outputs,
    the rank's gradients (its part of each sharded leaf) and the specs."""
    arch, over, kind = BLOCKS[name]
    cfg = cfg_of(arch, **over)
    params = api.init_params(cfg, torch.Generator().manual_seed(3),
                             device="cpu")
    j = tfm.layer_kinds(cfg).index(kind)
    p = params["blocks"][j]
    gen = torch.Generator().manual_seed(4)
    inputs = [torch.randn(2, 8, cfg.d_model, generator=gen)]
    if kind == "dec":
        inputs.append(torch.randn(2, 6, cfg.d_model, generator=gen))
    plan = tp.train_plan(cfg, mesh)
    specs = plan.param_specs(cfg)["blocks"][j]
    part = tp.shard_tree(p, specs, plan.model_shards, mesh.model_rank)
    out = {"whole": _block_grads(cfg, kind, p, inputs, NO_RULES),
           "shard": _block_grads(cfg, kind, part, inputs, plan.rules),
           "specs": specs, "contract": sorted(plan.rules.contract_axes),
           "reduces": plan.rules.reduces}
    r = plan.rules
    naive = NaiveRules(r.contract_axes, r.group, model=r.model,
                       model_rank=r.model_rank, uses=r.uses)
    out["naive"] = _block_grads(cfg, kind, part, inputs, naive)
    return out


def block_attn_mlp(mesh, inputs, ckpt_dir):
    return block(mesh, "attn_mlp")


def block_dec(mesh, inputs, ckpt_dir):
    return block(mesh, "dec")


# ---------------------------------------------------------------------------
# three train steps from the JAX package's initial state
# ---------------------------------------------------------------------------


def train_case(mesh, inputs, name, case=None, table=None, over=None):
    """``STEPS`` model-parallel steps of case ``name`` (``TRAIN_CASES[name]``
    unless ``case`` gives (arch, grad_accum, compress_grads); the SMOKE
    config with ``over`` replaced) from the moved-over JAX state, each rank
    on its data replica's rows of the global batch (and with ``table``
    {"seq": "model"} on its block of their sequences): each step's
    metrics, the all-reduces of the first step, the collectives a step by
    kind and axis, the plan, and the final parameters gathered on the
    world's first rank."""
    arch, accum, compress = case or TRAIN_CASES[name]
    cfg = cfg_of(arch, **(over or {}))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # the fallbacks warn
        plan = tp.train_plan(cfg, mesh, table)
    # a copy: AdamW updates in place, and a replicated leaf's part is the
    # leaf itself, which another scenario of this world starts from
    state = pytree.tree_map(torch.clone, inputs["states"][name])
    specs = tp.state_specs(plan, state)
    d, r = plan.rules.data, mesh.data_rank
    state = tp.shard_tree(state, specs, plan.model_shards, mesh.model_rank,
                          d=d, data_rank=r)
    step = trainer.make_train_step(cfg, adamw.AdamWConfig(**OPT),
                                   rules=plan.rules, grad_accum=accum,
                                   compress_grads=compress)
    metrics, reduces, colls = [], [], []
    for b in inputs["batches"][name]:
        r0, c0 = plan.rules.reduces, dict(plan.rules.collectives)
        rows = {k: torch.from_numpy(trainer.seq_rows(
                    trainer.replica_rows(v, d, r, accum), plan.rules.cp,
                    mesh.model_rank)) for k, v in b.items()}
        state, m = step(state, rows)
        reduces.append(plan.rules.reduces - r0)
        colls.append({f"{k[0]}:{k[1]}": n - c0.get(k, 0)
                      for k, n in plan.rules.collectives.items()})
        metrics.append({k: v.item() for k, v in m.items()})
    params = tp.gather_tree(state["params"], specs["params"],
                            plan.rules.group, plan.rules.data_group)
    replicated = {pytree.keystr(p): t for p, t in
                  pytree.tree_flatten_with_path(state["params"])[0]
                  if "data" not in plan.rules.sharded.get(tp.path_key(p),
                                                          ())}
    return {"metrics": metrics, "reduces": reduces, "collectives": colls,
            "contract": sorted(plan.rules.contract_axes),
            "whole_kv": plan.rules.whole_kv, "uses": plan.rules.uses,
            "n_sharded": len(plan.rules.sharded), "data": d,
            "rows": len(rows["tokens"]), "params": params,
            "replicated": replicated}


def _train(name):
    def scenario(mesh, inputs, ckpt_dir):
        return train_case(mesh, inputs, name)
    scenario.__name__ = f"train_{name}"
    return scenario


def dp_mesh():
    """(data 2, model world / 2): the world's ranks folded two data
    replicas deep (collective: every rank makes it, in scenario order)."""
    world = dist.get_world_size()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return make_host_mesh(world // 2, devices=["cpu"] * world)


def _dp(name):
    def scenario(mesh, inputs, ckpt_dir):
        return train_case(dp_mesh(), inputs, name)
    scenario.__name__ = f"dp_{name}"
    return scenario


DP_CASES = ("plain", "compress", "dbrx", "dbrx_accum2")


def dp_ckpt_save(mesh, inputs, ckpt_dir):
    """At (data 2, model world / 2): a trainer run of ``RESUME_AT`` steps,
    saved at its end under ``ckpt_dir/dp``, which one process restores."""
    log = []
    tr = _trainer(dp_mesh(), os.path.join(ckpt_dir, "dp"), log)
    tr.run(RESUME_AT)
    return {"losses": _losses(tr), "shape": tr.mesh.shape,
            "data": tr.plan.rules.data}


# ---------------------------------------------------------------------------
# compressed_psum, gpipe
# ---------------------------------------------------------------------------


def psum(mesh, inputs, ckpt_dir):
    """``compressed_psum`` of this rank's row of ``inputs["psum"]``."""
    return compression.compressed_psum(
        inputs["psum"][dist.get_rank()].clone())


def gpipe(mesh, inputs, ckpt_dir):
    """The pipeline of ``inputs["gpipe"]`` (a stage a rank): the outputs
    on this rank."""
    pp = inputs["gpipe"]
    r = dist.get_rank()

    def stage_fn(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    return pipeline.gpipe(stage_fn)({"w": pp["w"][r], "b": pp["b"][r]},
                                    pp["xs"])


# ---------------------------------------------------------------------------
# checkpoints across meshes
# ---------------------------------------------------------------------------


def _trainer(mesh, ckpt_dir, log):
    cfg = cfg_of(QWEN)
    ds = SyntheticDataset(DataConfig(vocab=cfg.vocab, seq_len=16,
                                     global_batch=8))
    return trainer.Trainer(cfg, adamw.AdamWConfig(**OPT), ds,
                           ckpt_dir=ckpt_dir, save_every=0, log_every=1,
                           log_fn=log.append, device="cpu", mesh=mesh)


def _losses(tr):
    return [h["loss"] for h in tr.history]


def ckpt_save(mesh, inputs, ckpt_dir):
    """At this world: a bf16 (8, 8) leaf split over its columns saved
    through ``gather_tree`` (one rank writes); a trainer run of
    ``RESUME_AT`` steps that saves at its end, and an uninterrupted run of
    ``RESUME_STEPS`` without a checkpoint directory."""
    w = torch.arange(64.0, dtype=torch.bfloat16).reshape(8, 8)
    m = mesh.shape["model"]
    spec = {"w": (None, "model")}
    full = tp.gather_tree(tp.shard_tree({"w": w}, spec, m, mesh.model_rank),
                          spec, mesh.group)
    if full is not None:
        ckpt.save(os.path.join(ckpt_dir, "elastic", "step_00000001"), full,
                  extra={"step": 1})
    dist.barrier()
    log = []
    tr = _trainer(mesh, os.path.join(ckpt_dir, "train"), log)
    tr.run(RESUME_AT)
    whole = _trainer(mesh, None, [])
    whole.run(RESUME_STEPS)
    return {"cut": _losses(tr), "whole": _losses(whole), "log": log}


def ckpt_restore(mesh, inputs, ckpt_dir):
    """At this world: the bf16 leaf restored into an fp32 ``like`` and cut
    to this rank's part; the trainer resumed from the saved run and run to
    ``RESUME_STEPS``."""
    m = mesh.shape["model"]
    spec = {"w": (None, "model")}
    full, extra = ckpt.restore(
        os.path.join(ckpt_dir, "elastic", "step_00000001"),
        {"w": torch.zeros(8, 8)})
    log = []
    tr = _trainer(mesh, os.path.join(ckpt_dir, "train"), log)
    resumed_at = tr.step
    tr.run(RESUME_STEPS - RESUME_AT)
    return {"part": tp.shard_tree(full, spec, m, mesh.model_rank)["w"],
            "extra": extra, "resumed_at": resumed_at,
            "data_step": tr.dataset.step, "losses": _losses(tr), "log": log,
            "contract": sorted(tr.plan.rules.contract_axes)}


SCENARIOS = {f.__name__: f for f in (
    block_attn_mlp, block_dec, psum, gpipe, ckpt_save, ckpt_restore,
    dp_ckpt_save, *(_train(n) for n in TRAIN_CASES),
    *(_dp(n) for n in DP_CASES))}


def run_scenarios(rank, inputs_file, ckpt_dir, names):
    """A rank's results, {name: result or {"error": traceback}}, plus
    "jax_loaded": whether anything imported jax or the JAX package."""
    inputs = torch.load(inputs_file, weights_only=False)
    world = dist.get_world_size()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        mesh = make_host_mesh(world, devices=["cpu"] * world)
    out = {}
    for name in names:
        try:
            # as numpy: a tensor would go back through shared memory, which
            # needs this process alive after it returns
            out[name] = pytree.tree_map(
                lambda t: t.numpy() if isinstance(t, torch.Tensor) else t,
                SCENARIOS[name](mesh, inputs, ckpt_dir))
        except Exception:       # reported per scenario; the test fails it
            out[name] = {"error": traceback.format_exc()}
    out["jax_loaded"] = sorted(
        m for m in sys.modules if m in ("jax", "repro")
        or m.startswith(("jax.", "repro.")))
    return out
