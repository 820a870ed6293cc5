"""Rank-side scenarios of tests/test_torch_train_fsdp.py and
tests/test_torch_train_ep.py: training at the reference's layout (every
``wembed`` dim split over ``data``, the heads, ffn, vocab and expert dims
over ``model``) in spawned gloo worlds on the CPU. Imports neither jax nor
the JAX package: the ranks read the JAX package's initial states (moved
over by ``repro_torch.convert``) and the batches from a ``torch.save``
file.

``run_scenarios(rank, inputs_file, ckpt_dir, names)`` runs each named
scenario in the world, each on a ``(data, model)`` mesh of the world's
ranks, and returns {name: result or {"error": traceback}}, tensors as
numpy arrays.
"""
import os
import shutil
import sys
import traceback
import warnings

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from repro_torch.data.synthetic import DataConfig, SyntheticDataset
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.models import api
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw
from repro_torch.parallel import tp
from repro_torch.parallel.sharding import TrainRules
from repro_torch.runtime import trainer
from torch_train_ranks import (OPT, QWEN, RESUME_AT, RESUME_STEPS, _losses,
                               _trainer, block, cfg_of, train_case)

# name: (arch, (data, model), grad_accum, compress_grads)
CASES = {
    "qwen_2x2": (QWEN, (2, 2), 1, False),
    "qwen_4x1": (QWEN, (4, 1), 1, False),
    "qwen_1x4": (QWEN, (1, 4), 1, False),
    "granite_2x2": ("granite-3-2b", (2, 2), 1, False),
    "mamba2_2x2": ("mamba2-2.7b", (2, 2), 1, False),
    "compress_2x2": (QWEN, (2, 2), 1, True),
    "dbrx_1x2": ("dbrx-132b", (1, 2), 1, False),
    "dbrx_2x2_accum2": ("dbrx-132b", (2, 2), 2, False),
}


def mesh_of(data, model):
    """A (data, model) fold of the world's CPU ranks (collective: every
    rank makes it, in scenario order)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return make_host_mesh(model, devices=["cpu"] * (data * model))


def _case(name):
    arch, (d, m), accum, compress = CASES[name]

    def scenario(inputs, ckpt_dir):
        return train_case(mesh_of(d, m), inputs, name,
                          case=(arch, accum, compress))
    scenario.__name__ = name
    return scenario


# ---------------------------------------------------------------------------
# checkpoints across layouts
# ---------------------------------------------------------------------------


def ckpt_save_2x2(inputs, ckpt_dir):
    """At (data 2, model 2): a trainer run of ``RESUME_AT`` steps saved at
    its end under ``ckpt_dir/fsdp``, and an uninterrupted run of
    ``RESUME_STEPS`` without a checkpoint directory."""
    mesh = mesh_of(2, 2)
    tr = _trainer(mesh, os.path.join(ckpt_dir, "fsdp"), [])
    tr.run(RESUME_AT)
    whole = _trainer(mesh, None, [])
    whole.run(RESUME_STEPS)
    return {"cut": _losses(tr), "whole": _losses(whole),
            "split": len(tr.plan.rules.sharded)}


def ckpt_restore_4x1(inputs, ckpt_dir):
    """At (data 4, model 1): the trainer resumed from a copy of the saved
    run, its restored parameters gathered on the first rank, then run to
    ``RESUME_STEPS``."""
    src, dst = (os.path.join(ckpt_dir, d) for d in ("fsdp", "fsdp_4x1"))
    if dist.get_rank() == 0:
        shutil.copytree(src, dst)
    dist.barrier()
    mesh = mesh_of(4, 1)
    log = []
    tr = _trainer(mesh, dst, log)
    restored = tp.gather_tree(tr.state["params"],
                              tp.state_specs(tr.plan, tr.state)["params"],
                              tr.plan.rules.group, tr.plan.rules.data_group)
    resumed_at = tr.step
    tr.run(RESUME_STEPS - RESUME_AT)
    return {"restored": restored, "resumed_at": resumed_at,
            "losses": _losses(tr), "log": log,
            "shape": dict(tr.mesh.shape)}


# ---------------------------------------------------------------------------
# the model gather's backward: the rank's part, summed with nothing
# ---------------------------------------------------------------------------


class _SummedGather(torch.autograd.Function):
    """The control: a model gather whose backward sums the gradient over
    the model group before taking the rank's part."""

    @staticmethod
    def forward(ctx, x, dim, rules):
        ctx.dim, ctx.rules = dim, rules
        return rules.all_gather(x, dim, "model")

    @staticmethod
    def backward(ctx, g):
        r = ctx.rules
        g = r.all_reduce(g.clone(memory_format=torch.contiguous_format))
        n = g.shape[ctx.dim] // r.model
        return g.narrow(ctx.dim, r.model_rank * n, n).contiguous(), None, \
            None


class SummedGatherRules(TrainRules):
    """``TrainRules`` whose model gathers sum their gradient."""

    def _gathered(self, t, spec):
        for dim, ax in enumerate(spec):
            if ax == "model":
                t = _SummedGather.apply(t, dim, self)
        return t


def model_gather_control(inputs, ckpt_dir):
    """dbrx-132b SMOKE's MoE block at (data 1, model 4): its router is
    split over ``model`` and gathered at its use (every rank routes every
    row). The block's gradient under a fixed read-out, whole and on each
    rank (its part of each split leaf), under the plan's rules and under
    ``SummedGatherRules``."""
    cfg = cfg_of("dbrx-132b")
    mesh = mesh_of(1, 4)
    kind = "attn_moe"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        plan = tp.train_plan(cfg, mesh)
    params = api.init_params(cfg, torch.Generator().manual_seed(3),
                             device="cpu")
    j = tfm.layer_kinds(cfg).index(kind)
    p = params["blocks"][j]
    specs = plan.param_specs(cfg)["blocks"][j]
    part = tp.shard_tree(p, specs, 4, mesh.model_rank)
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator()
                    .manual_seed(4))
    r = plan.rules
    summed = SummedGatherRules(r.contract_axes, r.group, r.sharded,
                               model=r.model, model_rank=r.model_rank,
                               uses=r.uses, whole_kv=r.whole_kv)

    def grads(tree, rules):
        leaves, spec = pytree.tree_flatten(tree)
        leaves = [t.detach().requires_grad_() for t in leaves]
        with torch.enable_grad():
            y, _ = tfm.block_train(cfg, kind, rules.use(
                pytree.tree_unflatten(leaves, spec), kind), x,
                None, rules)
            w = torch.linspace(-1.0, 1.0, y.numel()).reshape(y.shape)
            g = torch.autograd.grad((y * w).sum(), leaves)
        return pytree.tree_unflatten(list(g), spec)

    return {"whole": grads(p, TrainRules()), "shard": grads(part, r),
            "summed": grads(part, summed), "specs": specs,
            "uses": r.uses[kind]}


def moe_block(inputs, ckpt_dir):
    """dbrx-132b SMOKE's MoE block at (data 1, model 2), whole against
    shard by shard (``torch_train_ranks.block``): 2 of the 4 experts a
    rank, the router gathered."""
    return block(mesh_of(1, 2), "moe")


# ---------------------------------------------------------------------------
# every hook over a world of one rank
# ---------------------------------------------------------------------------


def forced_rules(cfg, group):
    """``TrainRules`` over ``group`` (a world of one rank) that issue every
    hook of the layout anyway: the gathers of a (data 2, model 4) plan
    (every ``wembed`` dim over ``data``; qwen2.5-3b's 4 query heads over
    ``model``, its 2 KV heads not), the heads, ffn, vocab, experts and
    recurrent mixers' contractions, and the KV heads read in part
    (``whole_kv``), each a collective over one rank (a copy)."""
    desc = Mesh(tuple((torch.device("meta"),) * 4 for _ in range(2)),
                {"data": 2, "model": 4})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        uses = tp.train_plan(cfg, desc).rules.uses
    return TrainRules(("heads", "ffn", "vocab", "experts", "rglru", "ssm"),
                      group, data_group=group, uses=uses, whole_kv=True)


def forced_steps(arch, group, device, compress, steps=2):
    """``steps`` fp32 SMOKE steps of ``arch`` on ``device``, plain and
    through ``forced_rules`` from the same state: (their losses, whether
    every state leaf ends equal bit for bit, the sums counted, the
    collectives by kind and axis)."""
    tree = torch.utils._pytree
    cfg = cfg_of(arch)
    opt = adamw.AdamWConfig(**OPT)
    plain = trainer.init_state(cfg, opt, torch.Generator(device=device)
                               .manual_seed(0), device=device,
                               compress_grads=compress)
    state = tree.tree_map(torch.clone, plain)
    rules = forced_rules(cfg, group)
    ds = SyntheticDataset(DataConfig(vocab=cfg.vocab, seq_len=32,
                                     global_batch=4))
    fns = [trainer.make_train_step(cfg, opt, compress_grads=compress),
           trainer.make_train_step(cfg, opt, rules=rules,
                                   compress_grads=compress)]
    losses = []
    for _ in range(steps):
        b = {k: torch.from_numpy(v).to(device)
             for k, v in ds.next_batch().items()}
        plain, mp = fns[0](plain, b)
        state, mm = fns[1](state, b)
        losses.append((mm["loss"].item(), mp["loss"].item()))
    equal = all(torch.equal(a, c) for a, c in
                zip(tree.tree_leaves(state), tree.tree_leaves(plain)))
    return losses, equal, rules.reduces, {
        f"{k[0]}:{k[1]}": n for k, n in rules.collectives.items()}


def world_of_one(rank, cases):
    """``forced_steps`` of each (arch, compress) of ``cases`` on the CPU,
    in a spawned world of one gloo rank: {(arch, compress): result}."""
    return {(arch, compress): forced_steps(arch, dist.group.WORLD, "cpu",
                                           compress)
            for arch, compress in cases}


SCENARIOS = {f.__name__: f for f in (
    ckpt_save_2x2, ckpt_restore_4x1, model_gather_control, moe_block,
    *(_case(n) for n in CASES))}


def run_scenarios(rank, inputs_file, ckpt_dir, names):
    """A rank's results, {name: result or {"error": traceback}}, plus
    "jax_loaded": whether anything imported jax or the JAX package."""
    inputs = torch.load(inputs_file, weights_only=False)
    out = {}
    for name in names:
        try:
            out[name] = pytree.tree_map(
                lambda t: t.numpy() if isinstance(t, torch.Tensor) else t,
                SCENARIOS[name](inputs, ckpt_dir))
        except Exception:       # reported per scenario; the test fails it
            out[name] = {"error": traceback.format_exc()}
    out["jax_loaded"] = sorted(
        m for m in sys.modules if m in ("jax", "repro")
        or m.startswith(("jax.", "repro.")))
    return out
