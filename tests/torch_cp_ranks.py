"""Rank-side scenarios of tests/test_torch_cp_layers.py and
tests/test_torch_train_cp.py: context parallelism (the sequence over
``model``, the reference's ``Rules(mesh, {"seq": "model"})``) in spawned
gloo worlds on the CPU. Imports neither jax nor the JAX package: the ranks
read their inputs (parameters moved over by ``repro_torch.convert``,
numpy inputs from a seed, the JAX package's initial states and batches)
from a ``torch.save`` file.

Every rank takes its block of each row's sequence and returns its rows of
the outputs; the test process joins them and holds them to the JAX
functions on the whole sequence. ``run_scenarios(rank, inputs_file,
ckpt_dir, names)`` returns {name: result or {"error": traceback}},
tensors as numpy arrays.
"""
import dataclasses
import os
import sys
import traceback
import warnings

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from repro_torch.data.synthetic import DataConfig, SyntheticDataset
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.models import api, griffin, layers, ssm
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw
from repro_torch.parallel import tp
from repro_torch.parallel.sharding import NO_RULES, TrainRules, _GatherModel
from repro_torch.runtime import trainer
from torch_train_ranks import OPT, RESUME_AT, cfg_of, train_case

CP = {"seq": "model"}


def mesh_of(data, model):
    """A (data, model) fold of the world's CPU ranks (collective: every
    rank makes it, in scenario order)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return make_host_mesh(model, devices=["cpu"] * (data * model))


def plan_of(cfg, mesh):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return tp.train_plan(cfg, mesh, CP)


def own(rules, t):
    """The rank's block of ``t``'s sequence (dim 1), a copy."""
    return rules.cp_own(t).clone()


def colls(rules):
    return {f"{k[0]}:{k[1]}": n for k, n in rules.collectives.items()}


# ---------------------------------------------------------------------------
# layers: the rank's rows of each output
# ---------------------------------------------------------------------------


def attention(inputs):
    """qwen2.5-3b SMOKE's attention: the training forward
    (``flash_attention``, chunked and one-shot) and the prefill
    (``ops.attention``'s plain version) on the rank's block, full and
    windowed: {case: (out rows, k rows, v rows)}."""
    case = inputs["attn"]
    rules = plan_of(case["cfg"], mesh_of(1, dist.get_world_size())).rules
    x = own(rules, case["x"])
    out = {}
    for name, (window, chunked, train) in case["cases"].items():
        cfg = dataclasses.replace(case["cfg"], flash_chunking=chunked)
        y, (k, v) = layers.attention_apply(cfg, case["p"], x, window=window,
                                           rules=rules, train=train)
        out[name] = (y, k, v)
    out["collectives"] = colls(rules)
    return out


def decode(inputs):
    """One dense-lane decode step on the rank's block of each lane (a
    full-attention lane and a window ring past its wrap, ``decode_kv_chunk``
    as the case says): {case: (out, the rank's lane rows after)}."""
    case = inputs["decode"]
    rules = plan_of(case["cfg"], mesh_of(1, dist.get_world_size())).rules
    out = {}
    for name, (window, chunk) in case["cases"].items():
        cfg = dataclasses.replace(case["cfg"], decode_kv_chunk=chunk)
        lanes = case["lanes"][window]
        cache = {k: own(rules, t) for k, t in lanes.items()}
        pos = case["pos"][window]
        rows = layers.dense_rows(pos, lanes["k"].shape[1], window > 0)
        y, cache = layers.attention_decode(cfg, case["p"], case["x"], cache,
                                           pos, rows=rows, window=window,
                                           rules=rules)
        out[name] = (y, cache["k"], cache["v"])
    out["collectives"] = colls(rules)
    return out


def mixers(inputs):
    """RG-LRU (recurrentgemma-9b SMOKE) and Mamba2 (mamba2-2.7b SMOKE) on
    the rank's block: {arch: (out rows, state)} with a ``length``."""
    out = {}
    for arch, fn in (("recurrentgemma-9b", griffin.rglru_apply),
                     ("mamba2-2.7b", ssm.ssm_apply)):
        case = inputs["mixers"][arch]
        rules = plan_of(case["cfg"], mesh_of(1, dist.get_world_size())).rules
        y = fn(case["cfg"], case["p"], own(rules, case["x"]), rules=rules)
        y2, state = fn(case["cfg"], case["p"], own(rules, case["x"]),
                       return_state=True, length=case["length"],
                       rules=rules)
        out[arch] = (y, y2, state)
    return out


def moe(inputs):
    """dbrx-132b SMOKE's MoE block (4 experts split over the ranks) on the
    rank's block of each shape: {shape: (out rows, lb_loss, z_loss,
    collectives)}."""
    out = {}
    for name, case in inputs["moe"].items():
        cfg = case["cfg"]
        plan = plan_of(cfg, mesh_of(1, dist.get_world_size()))
        j = tfm.layer_kinds(cfg).index("attn_moe")
        spec = plan.param_specs(cfg)["blocks"][j]
        part = tp.shard_tree(case["block"], spec, plan.model_shards,
                             plan.mesh.model_rank)
        p = plan.rules.use(part, "attn_moe")["moe"]
        y, aux = layers.moe_apply(cfg, p, own(plan.rules, case["x"]),
                                  plan.rules, aux=True)
        out[name] = (y, aux["lb_loss"], aux["z_loss"],
                     colls(plan.rules), sorted(plan.rules.contract_axes))
    return out


def serve(inputs):
    """Each arch's prefill of the rank's block of the prompts into its
    block of the dense lanes (``max_len``), then greedy decode steps on
    those blocks, whole weights on every rank: {arch: (the prefill's
    last-position logits, each step's logits, the tokens)}."""
    out = {}
    for arch, case in inputs["serve"].items():
        cfg, params = case["cfg"], case["params"]
        rules = plan_of(cfg, mesh_of(1, dist.get_world_size())).rules
        rules.uses = {}                      # whole weights on every rank
        with torch.no_grad():
            logits, caches, pos = api.prefill(
                cfg, params, own(rules, case["tokens"]),
                max_len=case["max_len"], rules=rules)
            first, steps, toks = logits, [], []
            for _ in range(case["steps"]):
                tok = logits.argmax(-1)
                toks.append(tok)
                logits, caches = api.decode_step(cfg, params, caches,
                                                 tok[:, None], pos,
                                                 rules=rules)
                steps.append(logits)
                pos = pos + 1
        out[arch] = (first, torch.stack(steps), torch.stack(toks))
    return out


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def grads(inputs):
    """Every arch's SMOKE loss and gradients at (data 1, model world) with
    the sequence over ``model``: each rank on its block of the batch, its
    gradients made the step's (``trainer.reduce_grads``) and gathered on
    the first rank. {arch: (loss, aux, grads or None)}."""
    out = {}
    mesh = mesh_of(1, dist.get_world_size())
    for arch, case in inputs["grads"].items():
        cfg = case["cfg"]
        plan = plan_of(cfg, mesh)
        r = plan.rules
        specs = plan.param_specs(cfg)
        part = tp.shard_tree(case["params"], specs, plan.model_shards,
                             mesh.model_rank)
        batch = {k: trainer.seq_rows(torch.from_numpy(v), r.cp,
                                     r.model_rank)
                 for k, v in case["batch"].items()}
        loss, aux, g = trainer.loss_and_grads(cfg, part, batch, rules=r)
        g = tp.gather_tree(trainer.reduce_grads(g, r), specs, r.group)
        out[arch] = (loss, aux, g)
    return out


def _steps(name, data, model):
    def scenario(inputs, ckpt_dir):
        arch = inputs["steps"][name]
        return train_case(mesh_of(data, model), inputs, name,
                          case=(arch, 1, False), table=CP)
    scenario.__name__ = name
    return scenario


def _trainer(mesh, ckpt_dir, log, table):
    cfg = cfg_of("qwen2.5-3b")
    ds = SyntheticDataset(DataConfig(vocab=cfg.vocab, seq_len=16,
                                     global_batch=8))
    return trainer.Trainer(cfg, adamw.AdamWConfig(**OPT), ds,
                           ckpt_dir=ckpt_dir, save_every=0, log_every=1,
                           log_fn=log.append, device="cpu", mesh=mesh,
                           rules_table=table)


def ckpt_save_cp(inputs, ckpt_dir):
    """At (data 2, model 2) with the sequence over ``model``: a trainer
    run of ``RESUME_AT`` steps saved at its end under ``ckpt_dir/cp``,
    and an uninterrupted run of twice as many without a checkpoint."""
    mesh = mesh_of(2, 2)
    tr = _trainer(mesh, os.path.join(ckpt_dir, "cp"), [], CP)
    tr.run(RESUME_AT)
    whole = _trainer(mesh, None, [], CP)
    whole.run(2 * RESUME_AT)
    return {"cut": [h["loss"] for h in tr.history],
            "whole": [h["loss"] for h in whole.history],
            "seq": tr.plan.rules.seq, "cp": tr.plan.rules.cp}


# ---------------------------------------------------------------------------
# the model gather's backward under context parallelism
# ---------------------------------------------------------------------------


class NoSumGatherRules(TrainRules):
    """``TrainRules`` whose model gathers keep ``_GatherModel``'s backward
    under context parallelism: the rank's part of its gradient, summed
    with nothing (the backward without a sequence split)."""

    def _gathered(self, t, spec):
        for dim, ax in enumerate(spec):
            if ax == "model":
                t = _GatherModel.apply(t, dim, self)
        return t


def gather_control(inputs):
    """qwen2.5-3b SMOKE's first block at (data 1, model world) with the
    sequence over ``model``, under a read-out that weighs every position
    alike, on a sequence of one repeated row (every position's output and
    gradient then equal): its gradient whole, and each rank's part of
    each leaf (the step's sums made, ``trainer.reduce_grads``) under the
    plan's rules and under ``NoSumGatherRules``."""
    cfg = cfg_of("qwen2.5-3b")
    mesh = mesh_of(1, dist.get_world_size())
    plan = plan_of(cfg, mesh)
    r = plan.rules
    p = inputs["control"]["block"]
    spec = plan.param_specs(cfg)["blocks"][0]
    part = tp.shard_tree(p, spec, plan.model_shards, mesh.model_rank)
    x = inputs["control"]["x"]
    w = inputs["control"]["w"]
    nosum = NoSumGatherRules(r.contract_axes, r.group, r.sharded,
                             model=r.model, model_rank=r.model_rank,
                             uses=r.uses, seq=r.seq)

    def block_grads(tree, rules, xs):
        leaves, s = pytree.tree_flatten(tree)
        leaves = [t.detach().requires_grad_() for t in leaves]
        with torch.enable_grad():
            y, _ = tfm.block_train(cfg, "attn_mlp", rules.use(
                pytree.tree_unflatten(leaves, s), "attn_mlp"), xs, None,
                rules)
            g = torch.autograd.grad((y * w).sum(), leaves)
        g = pytree.tree_unflatten(list(g), s)
        if rules is NO_RULES:
            return g
        return trainer.reduce_grads({"blocks": [g]}, rules)["blocks"][0]

    return {"whole": block_grads(p, NO_RULES, x),
            "shard": block_grads(part, r, own(r, x)),
            "nosum": block_grads(part, nosum, own(r, x)),
            "specs": spec, "uses": r.uses["attn_mlp"]}


# ---------------------------------------------------------------------------
# every context-parallel hook over a world of one rank
# ---------------------------------------------------------------------------


def forced_cp_rules(cfg, group):
    """``TrainRules`` over ``group`` (a world of one rank) with the sequence
    over ``model`` and the gathers of a (data 2, model 4) context-parallel
    plan (every ``wembed`` dim over ``data``, every ``model`` dim but the
    experts' over ``model``): the sequence's gathers, the loss's sums,
    the step's sums and every leaf's gathers, each a collective over one
    rank (a copy)."""
    desc = Mesh(tuple((torch.device("meta"),) * 4 for _ in range(2)),
                {"data": 2, "model": 4})
    r = plan_of(cfg, desc).rules
    return TrainRules(r.contract_axes, group, data_group=group, uses=r.uses,
                      seq="model")


def forced_cp_steps(arch, group, device, steps=2):
    """``steps`` fp32 SMOKE steps of ``arch`` on ``device``, plain and
    through ``forced_cp_rules`` from one state, then a prefill into dense
    lanes and 4 greedy decode steps each way (an fp32 cache): (the step
    losses, whether every state leaf ends equal bit for bit, whether the
    prefill logits are equal bit for bit, the decode tokens each way,
    the decode logits' largest difference over their scale, the
    collectives by kind and axis)."""
    cfg = dataclasses.replace(cfg_of(arch), kv_cache_dtype="float32")
    opt = adamw.AdamWConfig(**OPT)
    plain = trainer.init_state(cfg, opt, torch.Generator(device=device)
                               .manual_seed(0), device=device)
    state = pytree.tree_map(torch.clone, plain)
    rules = forced_cp_rules(cfg, group)
    ds = SyntheticDataset(DataConfig(vocab=cfg.vocab, seq_len=32,
                                     global_batch=4))
    fns = [trainer.make_train_step(cfg, opt),
           trainer.make_train_step(cfg, opt, rules=rules)]
    losses = []
    for _ in range(steps):
        b = {k: torch.from_numpy(v).to(device)
             for k, v in ds.next_batch().items()}
        plain, mp = fns[0](plain, b)
        state, mm = fns[1](state, b)
        losses.append((mm["loss"].item(), mp["loss"].item()))
    equal = all(torch.equal(a, c) for a, c in
                zip(pytree.tree_leaves(state), pytree.tree_leaves(plain)))
    tokens = torch.randint(0, cfg.vocab, (2, 24), device=device,
                           generator=torch.Generator(device=device)
                           .manual_seed(1))
    runs = []
    for r in (NO_RULES, rules):
        with torch.no_grad():
            logits, caches, pos = api.prefill(cfg, plain["params"], tokens,
                                              max_len=28, rules=r)
            first, toks, steps_ = logits, [], []
            for _ in range(4):
                tok = logits.argmax(-1)
                toks.append(tok.tolist())
                logits, caches = api.decode_step(cfg, plain["params"],
                                                 caches, tok[:, None], pos,
                                                 rules=r)
                steps_.append(logits)
                pos = pos + 1
        runs.append((first, toks, torch.stack(steps_)))
    (a, ta, sa), (c, tc, sc) = runs
    err = ((sa - sc).abs().max() / sa.abs().max()).item()
    return losses, equal, torch.equal(a, c), (ta, tc), err, {
        f"{k[0]}:{k[1]}": n for k, n in rules.collectives.items()}


SCENARIOS = {f.__name__: f for f in (attention, decode, mixers, moe, serve,
                                     grads, gather_control)}
TRAIN = {f.__name__: f for f in (
    ckpt_save_cp, _steps("qwen_1x2", 1, 2), _steps("dbrx_1x2", 1, 2),
    _steps("qwen_2x2", 2, 2), _steps("dbrx_2x2", 2, 2))}


def run_scenarios(rank, inputs_file, ckpt_dir, names):
    """A rank's results, {name: result or {"error": traceback}}, plus
    "jax_loaded": whether anything imported jax or the JAX package."""
    inputs = torch.load(inputs_file, weights_only=False)
    torch.manual_seed(0)
    out = {}
    for name in names:
        try:
            if name in TRAIN:
                res = TRAIN[name](inputs, ckpt_dir)
            else:
                res = SCENARIOS[name](inputs)
            out[name] = pytree.tree_map(
                lambda t: t.detach().numpy() if isinstance(t, torch.Tensor)
                else t, res)
        except Exception:       # reported per scenario; the test fails it
            out[name] = {"error": traceback.format_exc()}
    out["jax_loaded"] = sorted(
        m for m in sys.modules if m in ("jax", "repro")
        or m.startswith(("jax.", "repro.")))
    return out
