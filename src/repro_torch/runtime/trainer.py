"""Training runtime: the train step and the fault-tolerant loop, the
port's counterpart of ``repro.runtime.trainer`` on one device.

* ``loss_and_grads``: ``api.loss_fn`` and its gradients by
  ``torch.autograd.grad``, in the parameters' dtypes;
* ``make_train_step``: gradient accumulation over micro-batches (fp32
  sums), optional int8 compression with error feedback, then AdamW, which
  updates the state in place;
* ``Trainer``: async atomic checkpoints off the critical path, resume from
  the newest ``step_*`` checkpoint with the data cursor, and a straggler
  monitor (an EWMA of step time that flags slow steps: the hook a cluster
  scheduler would use to replace a slow host).

The training forward reaches no CUDA kernel: its attention is the plain
``layers.flash_attention``, as the reference trains through its jnp one
(the kernels' wrappers raise if autograd would record through them).

Model parallelism (the reference's ``rules=`` with a mesh): one process a
rank of a ``launch.mesh`` mesh. ``tp.train_plan`` stores every leaf at the
reference's layout (FSDP over ``data``, the ``model`` dims over
``model``); each rank keeps its part of the state, and ``rules`` (a
``sharding.TrainRules``) sum the sublayers that compute in parallel
(heads, ffn, vocab, experts) in forward and their inputs' gradients in
backward, and gather every other split leaf at its use. The step's
reductions cross exactly the axes a leaf is split on, once each: the
gradient norm (each leaf's squares summed over its axes, a replicated
leaf counted once) and each compression group's max-abs scale (a MAX
over the groups of its leaves' axes). On a mesh the trainer saves full
leaves in the single-device format (one rank writes) and restores at any
``(data, model)``.

Data parallelism (the reference splits the batch over ``("pod", "data")``):
each replica of a shard computes its gradient on its rows of the global
batch, and the step averages the gradients (and the loss) over the
``data`` group before the norm, the compression and AdamW, so every
replica applies the single-device step on the global batch (the mean of
the replicas' means: exact when their rows hold equal counts of labels,
as the reference's micro-batch mean assumes). A leaf split over ``data``
is averaged already: its gather's backward reduce-scatters the gradient
and divides it by D; a leaf that replicates over ``data`` (norm scales,
biases with no ``wembed`` dim) keeps the all-reduce mean. An MoE stack
routes each replica's rows as its share of the global batch's dispatch
groups, with the load-balance loss's two means taken over the global
batch (``layers.moe_aux``).

Context parallelism (``Trainer(rules_table={"seq": "model"})``, the
reference's ``Trainer(rules=Rules(mesh, table))``): each rank of a
``model`` group steps on its block of every row's sequence (``seq_rows``)
and the loss is the whole sequence's. A rank's gradient is then of its
own tokens: the gathers of the leaves split over ``model`` sum it in
their backward, and the step sums the gradients of the leaves that
``model`` does not split over the group, before the data average.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, Hashable, Optional

import torch
from torch.utils import _pytree as pytree

import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.checkpoint import ckpt
from repro_torch.models import api
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw
from repro_torch.parallel import compression, tp
from repro_torch.parallel.sharding import NO_RULES, Rules


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------


def loss_and_grads(cfg, params, batch: Dict[str, torch.Tensor], *,
                   rules: Rules = NO_RULES):
    """(loss, aux, grads): ``api.loss_fn`` at ``params`` (left as they are)
    and its gradient with respect to every leaf, a tree like ``params`` in
    their dtypes. On a rank (``rules`` a ``TrainRules``): the rank's part
    of each sharded leaf's gradient, the whole of each replicated one."""
    flat, spec = pytree.tree_flatten(params)
    leaves = [t.detach().requires_grad_() for t in flat]
    with torch.enable_grad():
        loss, aux = api.loss_fn(cfg, pytree.tree_unflatten(leaves, spec),
                                batch, rules=rules)
        grads = torch.autograd.grad(loss, leaves)
    return (loss.detach(), {k: v.detach() for k, v in aux.items()},
            pytree.tree_unflatten(list(grads), spec))


def stack_group(cfg) -> Callable[[tuple], Hashable]:
    """A leaf's key path in the port's parameter tree -> the name of the
    reference leaf it is part of. The reference stacks each pattern
    position's parameters over the super-blocks (and an encoder's blocks)
    along a layer axis, so layers j, j + P, j + 2P, ... of a period P (all
    the encoder's) are one leaf there, leaf name by leaf name; tail layers
    and the other leaves stand alone. What shares a reference leaf shares
    its compression scale."""
    n_super, _ = tfm.layer_plan(cfg)
    period = len(tfm.pattern_for(cfg))

    def name(path):
        keys = tuple(getattr(k, "key", getattr(k, "idx", None))
                     for k in path)
        if keys[0] == "blocks" and keys[1] < n_super * period:
            return ("blocks", keys[1] % period) + keys[2:]
        if keys[:2] == ("enc", "blocks"):
            return ("enc",) + keys[3:]
        return keys

    return name


def replica_rows(v, data: int, rank: int, grad_accum: int = 1):
    """Replica ``rank``'s rows of ``v`` (a global batch's leaf, an array
    or a tensor, rows first) over ``data`` replicas: of each of the
    ``grad_accum`` micro-batches (blocks of rows in order), its ``rank``-th
    of ``data`` slices. So the replica's i-th micro-batch is its share of
    the global i-th one, which an MoE stack routes as one batch
    (``layers.moe_capacity``). All rows at ``data`` 1."""
    n = v.shape[0] // (grad_accum * data)
    rest = tuple(v.shape[1:])
    return v.reshape((grad_accum, data, n) + rest)[:, rank].reshape(
        (grad_accum * n,) + rest)


def seq_rows(v, parts: int, rank: int):
    """Rank ``rank``'s block of ``parts`` along the sequence (dim 1) of
    ``v`` (an array or a tensor: tokens and labels (B, S), frontend or
    encoder embeddings (B, F, d)); ``v`` itself at ``parts`` 1."""
    if parts == 1:
        return v
    if v.shape[1] % parts:
        raise ValueError(f"a sequence of {v.shape[1]} does not split over "
                         f"{parts} context-parallel ranks")
    n = v.shape[1] // parts
    return v[:, rank * n:(rank + 1) * n]


def reduce_grads(grads, rules: Rules = NO_RULES):
    """A rank's gradients made the step's: under context parallelism
    (``rules.seq``) those of the leaves that ``model`` does not split
    summed over the ``model`` group (each rank's are of its own tokens;
    a gathered leaf's gather summed its own in backward), then over
    ``rules.data`` > 1 replicas those of the leaves that ``data`` does
    not split averaged over the ``data`` group (a split leaf's gather
    averaged its own). The identity without a mesh."""
    axes_of = _split_of(rules)

    def one(path, g: torch.Tensor) -> torch.Tensor:
        if rules.seq and "model" not in axes_of(path):
            g = rules.all_reduce(g)
        if rules.data > 1 and "data" not in axes_of(path):
            g = rules.all_reduce(g, "data").div_(rules.data)
        return g

    if not rules.seq and rules.data == 1:
        return grads
    return pytree.tree_map_with_path(one, grads)


def _split_of(rules: Rules) -> Callable[[tuple], frozenset]:
    """A leaf's key path -> the mesh axes ``rules`` split it on."""
    split = getattr(rules, "sharded", {})
    return lambda path: split.get(tp.path_key(path), frozenset())


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig, *,
                    rules: Rules = NO_RULES, grad_accum: int = 1,
                    compress_grads: bool = False):
    """Returns step(state, batch) -> (state, metrics). state: {"params",
    "opt" [, "err"]}, updated in place; batch: {"tokens", "labels", ...}
    tensors on the state's device. With ``grad_accum`` > 1 the batch splits
    into that many micro-batches (rows [i·b, (i+1)·b)), whose gradients are
    summed in fp32 and divided, and whose losses are averaged. With
    ``compress_grads`` the gradients go through int8 with error feedback
    (``state["err"]``), a scale per reference leaf (``stack_group``).
    ``rules``: a rank's ``TrainRules`` (``tp.train_plan``), its state the
    rank's part (``init_state(plan=)``); the batch is the rank's replica's
    rows (``replica_rows``; the whole batch without a ``data`` axis), and
    over ``rules.data`` > 1 replicas the gradients (but those of leaves
    split over ``data``, which their gathers averaged), loss and ce are
    averaged over the data group first. Under context parallelism
    (``rules.seq``) the rows are the rank's blocks of their sequences
    (``seq_rows``), and the gradients of the leaves that ``model`` does
    not split are summed over the group first (each rank's is of its own
    tokens). metrics: {"loss", "grad_norm", "lr" [, "ce" when
    grad_accum == 1]}, 0-dim tensors, the same on every rank; nothing
    syncs with the host."""
    group = stack_group(cfg)
    data = getattr(rules, "data", 1)

    def mean_over_data(t: torch.Tensor) -> torch.Tensor:
        return rules.all_reduce(t, "data").div_(data)

    reduce = dict(split=_split_of(rules), all_reduce=rules.all_reduce) \
        if getattr(rules, "sharded", {}) else {}

    def step(state, batch):
        params = state["params"]
        if grad_accum == 1:
            loss, aux, grads = loss_and_grads(cfg, params, batch,
                                              rules=rules)
        else:
            micro = {k: v.reshape((grad_accum, v.shape[0] // grad_accum)
                                  + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            grads = pytree.tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=micro["tokens"].device)
            for i in range(grad_accum):
                li, _, gi = loss_and_grads(
                    cfg, params, {k: v[i] for k, v in micro.items()},
                    rules=rules)
                pytree.tree_map(torch.Tensor.add_, grads, gi)
                loss = loss + li
            grads = pytree.tree_map(lambda g: g / grad_accum, grads)
            loss = loss / grad_accum
            aux = {}
        grads = reduce_grads(grads, rules)
        if data > 1:
            loss = mean_over_data(loss.clone())
            aux = {k: mean_over_data(v.clone()) for k, v in aux.items()
                   if k == "ce"}
        if compress_grads:
            grads, state["err"] = compression.compress_tree(
                grads, state["err"], group, **reduce)
        metrics = {"loss": loss, **adamw.apply(opt_cfg, grads, state["opt"],
                                               params, **reduce)}
        if "ce" in aux:
            metrics["ce"] = aux["ce"]
        return state, metrics

    return step


def init_state(cfg, opt_cfg: adamw.AdamWConfig, generator: torch.Generator,
               *, device="cuda", compress_grads: bool = False,
               plan: Optional[tp.TPPlan] = None, rank: int = 0
               ) -> Dict[str, Any]:
    """{"params": ``api.init_params`` drawn on ``device`` from
    ``generator`` (which lives there), "opt": ``adamw.init`` [, "err": the
    compression's zero error tree]}. With a ``plan``: rank ``rank``'s part
    (its place on the ``model`` axis; its place on the data axes is
    ``plan.mesh.data_rank``), cut from the whole parameters that every
    rank draws alike; the moments and error tree at the part's shapes."""
    params = api.init_params(cfg, generator, device=device)
    if plan is not None:
        params = tp.shard_params(params, plan, rank, plan.mesh.data_rank)
    state = {"params": params, "opt": adamw.init(opt_cfg, params)}
    if compress_grads:
        state["err"] = compression.init_error_tree(params)
    return state


# ---------------------------------------------------------------------------
# Fault-tolerant loop
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StragglerMonitor:
    """EWMA step-time monitor; flags steps slower than ``threshold`` x EWMA.

    On a cluster the flag feeds the controller that drains or replaces the
    slow host; here it is surfaced in the trainer's log."""
    alpha: float = 0.1
    threshold: float = 2.0
    ewma: Optional[float] = None
    slow_steps: int = 0

    def observe(self, dt: float) -> bool:
        slow = self.ewma is not None and dt > self.threshold * self.ewma
        self.ewma = dt if self.ewma is None else (
            (1 - self.alpha) * self.ewma + self.alpha * dt)
        if slow:
            self.slow_steps += 1
        return slow


class Trainer:
    """The loop: batches from ``dataset`` (``data.synthetic``), one
    ``make_train_step`` step each, a checkpoint every ``save_every`` steps
    and at the end of ``run`` (``ckpt.AsyncCheckpointer``), resuming from
    the newest one under ``ckpt_dir`` (state, step and data cursor). The
    state starts from ``init_state`` with a generator seeded ``seed`` on
    ``device`` (CUDA unless the caller asks for the CPU).

    ``mesh`` (``launch.mesh.make_host_mesh(model=M)`` over D x M devices,
    made inside the world): this rank's part of a model-parallel trainer on
    ``mesh.device`` (``tp.train_plan``), replica ``mesh.data_rank`` of D.
    Every rank reads the same batches and ``ckpt_dir`` and steps on its
    replica's rows of each batch (``replica_rows``: ``global_batch`` / D
    of them); a
    checkpoint holds the full leaves (the single-device format, written by
    the world's first rank), and a resume at any ``(data, model)`` and
    table cuts its part from them. ``rules_table``: the reference's rules
    table over the mesh (``tp.train_plan``); ``{"seq": "model"}`` is
    context parallelism, each rank on its block of every row's sequence
    (``seq_rows``)."""

    def __init__(self, cfg, opt_cfg, dataset, *,
                 ckpt_dir: Optional[str] = None, save_every: int = 50,
                 grad_accum: int = 1,
                 compress_grads: bool = False, seed: int = 0,
                 log_every: int = 10, log_fn: Callable[[str], None] = print,
                 device="cuda", mesh=None, rules_table=None):
        self.cfg, self.opt_cfg, self.dataset = cfg, opt_cfg, dataset
        self.mesh = mesh
        self.plan = None
        if mesh is None and rules_table:
            raise ValueError("a rules table needs a mesh")
        if mesh is not None:
            self.plan = tp.train_plan(cfg, mesh, rules_table)
            rows = dataset.cfg.global_batch // dataset.cfg.num_hosts
            if rows % (self.plan.rules.data * grad_accum):
                raise ValueError(
                    f"a batch of {rows} rows does not split into "
                    f"{grad_accum} micro-batches over "
                    f"{self.plan.rules.data} data replicas")
            device = mesh.device
        self.device = resolve_device(device)
        rules = NO_RULES if self.plan is None else self.plan.rules
        self.ckpt_dir, self.save_every = ckpt_dir, save_every
        self.log_every, self.log = log_every, log_fn
        self.monitor = StragglerMonitor()
        self.checkpointer = ckpt.AsyncCheckpointer()
        self.grad_accum = grad_accum
        self.step_fn = make_train_step(cfg, opt_cfg, rules=rules,
                                       grad_accum=grad_accum,
                                       compress_grads=compress_grads)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.state = init_state(
            cfg, opt_cfg, gen, device=self.device,
            compress_grads=compress_grads, plan=self.plan,
            rank=0 if mesh is None else mesh.model_rank)
        self.step = 0
        self.history: list = []
        if ckpt_dir:
            self._maybe_resume()

    def _specs(self):
        return tp.state_specs(self.plan, self.state)

    # -- fault tolerance -------------------------------------------------
    def _maybe_resume(self):
        path = ckpt.latest_step_dir(self.ckpt_dir)
        if path is None:
            return
        if self.plan is None:
            self.state, extra = ckpt.restore(path, self.state,
                                             device=self.device)
        else:
            m, specs = self.plan.model_shards, self._specs()
            d = self.plan.rules.data
            full, extra = ckpt.restore(path,
                                       tp.full_like(self.state, specs, m, d))
            self.state = pytree.tree_map(
                lambda t: t.to(self.device),
                tp.shard_tree(full, specs, m, self.mesh.model_rank, d=d,
                              data_rank=self.mesh.data_rank))
        self.step = int(extra["step"])
        self.dataset.load_state_dict(extra["data"])
        self.log(f"[trainer] resumed from {path} at step {self.step}")

    def save(self):
        if not self.ckpt_dir:
            return
        path = os.path.join(self.ckpt_dir, f"step_{self.step:08d}")
        state = self.state
        if self.plan is not None:
            state = tp.gather_tree(self.state, self._specs(),
                                   self.plan.rules.group,
                                   self.plan.rules.data_group)
            if state is None:                  # another rank writes
                return
        self.checkpointer.save(
            path, state,
            extra={"step": self.step, "data": self.dataset.state_dict()})

    # -- loop --------------------------------------------------------------
    def run(self, num_steps: int) -> Dict[str, Any]:
        it = iter(self.dataset)
        last_metrics: Dict[str, Any] = {}
        rules = NO_RULES if self.plan is None else self.plan.rules
        d, r = (1, 0) if self.mesh is None else (rules.data,
                                                 self.mesh.data_rank)
        for _ in range(num_steps):
            batch = {k: torch.from_numpy(seq_rows(
                         replica_rows(v, d, r, self.grad_accum), rules.cp,
                         rules.model_rank)).to(self.device)
                     for k, v in next(it).items()}
            t0 = time.perf_counter()
            self.state, metrics = self.step_fn(self.state, batch)
            # repro-lint: disable=host-sync — step timing needs the sync
            metrics["loss"].item()
            dt = time.perf_counter() - t0
            slow = self.monitor.observe(dt)
            self.step += 1
            if slow:
                self.log(f"[straggler] step {self.step} took {dt:.3f}s "
                         f"(ewma {self.monitor.ewma:.3f}s)")
            if self.step % self.log_every == 0:
                last_metrics = {k: float(v) for k, v in metrics.items()}
                self.history.append({"step": self.step, **last_metrics,
                                     "dt": dt})
                self.log(f"[train] step {self.step} "
                         f"loss {last_metrics['loss']:.4f} dt {dt*1e3:.1f}ms")
            if self.save_every and self.step % self.save_every == 0:
                self.save()
        if self.ckpt_dir:
            self.save()
            self.checkpointer.wait()
            if self.mesh is not None and dist.is_initialized():
                # the writer is done before any rank may read the directory
                dist.barrier()
        return last_metrics
