"""Logical-axis sharding rules with divisibility fallbacks.

A copy of ``repro.parallel.sharding`` for the port (which imports nothing
of the JAX package). Models name each tensor dim with a *logical* axis
(comma-separated strings, one name per dim, ``""``/missing = replicated);
``Rules`` maps those names onto the axes of a ``launch.mesh.Mesh``, falling
back to replication when a dim does not divide the mapped mesh axis (e.g.
llama4's 40 heads on a 16-way ``model`` axis), loudly: the first fallback
per (instance, logical axis) warns, naming the axis.

``spec`` returns, per dim, the mesh axis that dim shards over (a name, a
tuple of names for composed axes) or None, trailing Nones dropped: the
reference's ``PartitionSpec`` as a plain tuple.

``ManualRules`` is the per-rank variant (the reference's ``shard_map``
body): each rank holds its shard of the weights, so ``cons`` is the
identity, and a contraction over a logical axis that actually sharded
needs an explicit sum over the ``model`` group: ``contract`` all-reduces
there, in place, and is the identity for every other axis (an axis that
fell back to replication must NOT be summed, or the output is multiplied
by the shard count).

Every collective the rules issue goes through one of three methods, so a
subclass can change what a collective does (``DryRunRules`` records its
bytes instead of issuing it): ``all_reduce(x, axis, op)``, in place over
the ``model`` group (the contractions, the train step's norm and
compression scales) or the ``data`` group (data-parallel training's
gradient average); ``all_gather(x, dim, axis)`` and
``reduce_scatter(x, dim, axis)``, out of place (``torch.distributed``'s
list forms, which gloo and NCCL both take, on host and CUDA tensors).

``TrainRules`` is its training variant, which autograd differentiates.
A sharded sublayer's input is replicated and its output a per-rank partial
sum, so two functions over the ``model`` group bracket it, for the axes in
``contract_axes`` only: ``contract`` (the out- and down-projection, the
vocab-parallel embedding lookup and loss sums, the expert-parallel
combine) sums the partials in forward, out of place, and passes the
gradient through unchanged in backward (the gradient downstream is the
same on every rank); ``enter`` (the sublayer's input) is the identity in
forward and sums the gradient in backward (each rank's input gradient
holds only its shard's share). ``torch.distributed.nn.functional.
all_reduce`` at the contraction alone would sum the gradient in backward
too, and hand each rank M times it.

A stored leaf may also be split where its use is not: ``use(tree,
where)`` gathers it at its use, per the ``uses`` spec of its block kind.
Over ``data`` (FSDP: the reference shards every ``wembed`` dim over
``("pod", "data")``) an all-gather in forward and in backward a
reduce-scatter of the gradient divided by the group's size, which is the
data average itself (the train step must not average such a leaf
again). Over ``model``, where the rank computes the whole use
replicated (a mixer's dims, attention whose KV heads do not divide the
axis, the MoE router), an all-gather in forward and in backward the
rank's part of the gradient, summed with nothing: every rank computed the
same whole gradient, and a sum would hand each M times it (the trap of
the contraction above).

Context parallelism (the reference's ``Rules(mesh, {"seq": "model"})``,
its dry-run's ``--optimized``): a rank of ``seq`` holds its block of every
activation's sequence, rows [r S/M, (r + 1) S/M). Each activation's heads,
ffn and vocab then lose the ``model`` axis to the sequence (``Rules.spec``'s
conflict fallback), so those sublayers compute replicated: ``contract`` and
``enter`` sum nothing for them, and their leaves are gathered at their use.
Every rank's gradient is then of its own tokens only, so a leaf gathered
over ``model`` reduce-scatters its gradient with a sum in backward (the
model gather above hands each rank its part of a whole gradient that
every rank computed alike; under context parallelism that part would be
its own tokens' share, 1/M of the gradient on average), and the train
step sums the gradients of the leaves that ``model`` does not split. The
hooks, identities without a sequence split:

* ``cp_gather(x, dim)``: the ranks' blocks joined along ``dim`` (the keys
  and values of attention, a recurrent mixer's input, the MoE expert
  rows); in backward a reduce-scatter of the gradient with a sum (each
  rank's gradient is of its own queries);
* ``cp_scatter(x, dim)``: the rank's part along ``dim`` of the sum over
  the ranks (the MoE dispatch buffer, each expert's rows to its rank); in
  backward an all-gather;
* ``cp_sum(x)``: the sum over the ranks in forward, the identity in
  backward (a global loss's sums of per-rank partials);
* ``cp_merge(m, l, o)``: the partial softmaxes of a decode row over the
  ranks' slices of a lane merged: an all-reduce of the row max, then of
  the rescaled sums and outputs.

A sublayer may also compute at the rank's part of leaves that are whole
on every rank (the reference's GSPMD computes there at a split activation
of a replicated weight): attention whose query heads split over ``model``
while its KV heads do not (``whole_kv``: each rank's queries read only
their own KV heads), and the recurrent mixers over their ``model`` dims
(contract axes "rglru" and "ssm"). Each rank's gradient of such a leaf is
then a partial sum, so the hooks:

* ``partial(*leaves)``: the identity in forward; in backward one
  all-reduce over ``model`` of their gradients (one a dtype), counted in
  ``reduces``;
* ``sum_both(x)``: an all-reduce over ``model`` in forward and of the
  gradient in backward (a sum whose downstream differs per rank: the
  mamba2 norm's mean square over its channels);
* ``gather_sum(x, dim)`` / ``scatter_sum(x, dim)``: ``_GatherSum`` and
  ``_ScatterSum`` over ``model`` (an activation split over ``model``
  gathered whole with a summing backward; a partial sum reduce-scattered to
  the rank's columns, with an all-gather in backward).

``DryRunRules`` are one rank's rules on a described mesh (no world): the
contractions, gathers and the data-axis sums run as they would, but each
collective is recorded, (mesh axis, operand bytes) in ``sums`` for an
all-reduce and (kind, mesh axis, operand bytes) in ``moves`` for an
all-gather or a reduce-scatter, and not issued.
"""
from __future__ import annotations

import warnings
from collections import Counter
from typing import Dict, FrozenSet, Iterable, Optional, Tuple, Union

import torch
import torch.distributed as dist

Phys = Union[str, Tuple[str, ...], None]

# logical axis -> mesh axis (tuples compose axes)
DEFAULT_TABLE: Dict[str, Phys] = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "seq_sp": "model",          # sequence parallelism (opt-in)
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "ffn": "model",
    "vocab": "model",
    "experts": "model",
    "state": None,
    # weights (FSDP axis)
    "wembed": ("pod", "data"),
    "wff": "model",             # tensor-parallel weight dim
    "wvocab": "model",
    "wheads": "model",
    "wkv_heads": "model",
    "wexperts": "model",
    "layers": None,
}


class Rules:
    """Maps logical-axes strings to per-dim mesh axes for a concrete mesh
    (``launch.mesh.Mesh``, or None: everything replicated). ``data``: the
    data-parallel replicas of a rank's shard, 1 but on a ``ManualRules``
    of data-parallel training; ``model_rank`` and ``contract_axes``: a
    ``ManualRules``' (0 and none here)."""

    data = 1
    model = 1
    model_rank = 0
    contract_axes: FrozenSet[str] = frozenset()
    seq: Optional[str] = None       # the axis the sequence splits over
    whole_kv = False    # KV heads whole on a rank whose query heads split

    def __init__(self, mesh=None, table: Optional[Dict[str, Phys]] = None):
        self.mesh = mesh
        self.table = dict(DEFAULT_TABLE)
        if table:
            self.table.update(table)
        self._warned_axes: set = set()   # one fallback warning per axis

    def _axis_size(self, phys: Phys) -> int:
        if self.mesh is None or phys is None:
            return 1
        n = 1
        for a in (phys if isinstance(phys, tuple) else (phys,)):
            n *= self.mesh.shape[a]
        return n

    def spec(self, shape: Tuple[int, ...], axes: str) -> tuple:
        """Per dim of ``shape``, the mesh axis it shards over (None:
        replicated), given its comma-separated logical names; trailing
        Nones dropped."""
        if self.mesh is None:
            return ()
        names = [a.strip() for a in axes.split(",")] if axes else []
        names += [""] * (len(shape) - len(names))
        out, used = [], set()
        for dim, name in zip(shape, names):
            phys = self.table.get(name)
            if phys is None:
                out.append(None)
                continue
            pt = tuple(a for a in (phys if isinstance(phys, tuple)
                                   else (phys,))
                       if a in self.mesh.shape)    # drop absent axes (pod)
            if not pt or any(a in used for a in pt):
                out.append(None)            # absent-axis / conflict fallback
                continue
            if dim % self._axis_size(pt) != 0:
                # divisibility fallback: replicate, and say so once per
                # (instance, logical axis)
                if name not in self._warned_axes:
                    self._warned_axes.add(name)
                    warnings.warn(
                        f"logical axis {name!r} (dim {dim}) is not "
                        f"divisible by mesh axis {'x'.join(pt)} (size "
                        f"{self._axis_size(pt)}); replicating this dim "
                        f"instead of sharding it", stacklevel=3)
                out.append(None)
                continue
            out.append(pt if len(pt) > 1 else pt[0])
            used.update(pt)
        while out and out[-1] is None:
            out.pop()
        return tuple(out)

    def cons(self, x: torch.Tensor, axes: str) -> torch.Tensor:
        """A layout hint in the reference (GSPMD); the identity here: a
        rank's tensors are its own."""
        return x

    def contract(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Hook at a contraction over logical ``axis`` (the attention
        out-projection contracts "heads", the MLP down-projection "ffn",
        the embedding lookup and the loss's sums "vocab", the MoE combine
        "experts"). The identity; ``ManualRules`` sums over the model
        group."""
        return x

    def enter(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Hook at the input of a sublayer that contracts ``axis`` at its
        end. The identity; ``TrainRules`` sums its gradient over the model
        group."""
        return x

    def use(self, tree, where: str):
        """Hook at the use of stored leaves: ``tree``, a block's parameters
        of kind ``where`` or a top-level leaf ("embed", "head"). The
        identity; ``ManualRules`` gathers the dims its ``uses`` name."""
        return tree

    def partial(self, *leaves):
        """Hook at leaves whole on every rank that the rank uses only in
        part (the module doc): the leaves, as a tuple. The identity;
        ``TrainRules`` sums their gradients over the model group."""
        return leaves

    # context parallelism (the module doc); identities here
    @property
    def cp(self) -> int:
        """The ranks the sequence splits over (1: no split)."""
        return 1

    def cp_offset(self, n: int) -> int:
        """The first position of this rank's block of ``n`` rows."""
        return self.model_rank * n if self.seq else 0

    def cp_own(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's block along ``dim`` of a whole-sequence tensor."""
        if not self.seq:
            return x
        n = x.shape[dim] // self.cp
        return x.narrow(dim, self.model_rank * n, n)

    def cp_gather(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        return x

    def cp_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return x

    def cp_sum(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def cp_merge(self, m: torch.Tensor, l: torch.Tensor, o: torch.Tensor):
        """(l, o) of partial softmaxes (row max ``m``, sum ``l``,
        unnormalised output ``o``) merged over the ranks."""
        return l, o


def _map(fn, tree, spec):
    """``fn(leaf, spec)`` over a dict / list tree and its spec tree."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, spec[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, s) for v, s in zip(tree, spec)]
    return fn(tree, spec)


class ManualRules(Rules):
    """Per-rank rules: ``contract`` all-reduces ``x`` in place over
    ``group`` (the mesh's ``model`` group) for exactly the axes in
    ``contract_axes``, and is the identity for the rest. ``reduces``
    counts the ``model`` contractions issued (in a captured graph: the
    ones recorded); ``collectives`` counts every collective issued, by
    (kind, mesh axis). ``data_group`` holds the ``data`` replicas of this
    rank's shard (data-parallel training), ``data`` their count; ``model``
    is the ``model`` group's size and ``model_rank`` this rank's place in
    it (the offset of its vocab rows and experts). ``uses``: per block
    kind (or top-level leaf name), a tree of per-dim gather specs ("data",
    "model" or None) that ``use`` applies. ``seq``: "model" when the
    sequence splits over the model group (context parallelism, the
    module doc), else None. ``whole_kv``: attention's query heads split
    over ``model`` while its KV heads are whole on every rank (each rank
    attends the KV heads its queries read). Without a group (a mesh made
    outside a world) the rules can be read but a contraction raises."""

    def __init__(self, contract_axes: Iterable[str] = (), group=None, *,
                 data_group=None, data: int = 1, model: int = 1,
                 model_rank: int = 0, uses: Optional[Dict] = None,
                 seq: Optional[str] = None, whole_kv: bool = False):
        super().__init__(None)
        if seq not in (None, "model"):
            raise ValueError(f"seq over {seq!r}: the sequence splits over "
                             f"'model' or nothing")
        self.contract_axes: FrozenSet[str] = frozenset(contract_axes)
        self.group = group
        self.data_group, self.data = data_group, data
        self.model, self.model_rank = model, model_rank
        self.uses = dict(uses or {})
        self.seq = seq
        self.whole_kv = whole_kv
        self.reduces = 0
        self.collectives: Counter = Counter()

    def _group(self, axis: str):
        group = self.group if axis == "model" else self.data_group
        if group is None:
            raise RuntimeError(
                f"a collective over {axis!r} needs that axis's process "
                f"group: make the mesh inside a torch.distributed world")
        return group

    def _size(self, axis: str) -> int:
        return self.model if axis == "model" else self.data

    def all_reduce(self, x: torch.Tensor, axis: str = "model",
                   op=None) -> torch.Tensor:
        """Reduce ``x`` in place over mesh axis ``axis``'s group ("model"
        or "data"), a sum unless ``op`` (a ``dist.ReduceOp``)."""
        self.collectives["all-reduce", axis] += 1
        dist.all_reduce(x, op=dist.ReduceOp.SUM if op is None else op,
                        group=self._group(axis))
        return x

    def all_gather(self, x: torch.Tensor, dim: int,
                   axis: str) -> torch.Tensor:
        """The parts of ``x`` over ``axis``'s group joined along ``dim``,
        in rank order (a new tensor)."""
        self.collectives["all-gather", axis] += 1
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(self._size(axis))]
        dist.all_gather(parts, x.contiguous(), group=self._group(axis))
        return torch.cat(parts, dim)

    def reduce_scatter(self, x: torch.Tensor, dim: int,
                       axis: str) -> torch.Tensor:
        """Rank r's r-th part along ``dim`` of the sum of ``x`` over
        ``axis``'s group (a new tensor)."""
        self.collectives["reduce-scatter", axis] += 1
        parts = [t.contiguous() for t in x.chunk(self._size(axis), dim)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, group=self._group(axis))
        return out

    def _check(self, axis: str) -> bool:
        """Whether ``axis`` is summed (raises without a group)."""
        if axis not in self.contract_axes:
            return False
        self._group("model")
        return True

    def contract(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        if self._check(axis):
            self.all_reduce(x)
            self.reduces += 1
        return x

    @property
    def cp(self) -> int:
        return self.model if self.seq else 1

    def gather_sum(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' parts of ``x`` joined along ``dim``; in backward the
        rank's part of the gradient's sum over the model group."""
        return _GatherSum.apply(x, dim, self)

    def scatter_sum(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The rank's part along ``dim`` of the sum of ``x`` over the model
        group; in backward the gradient's parts gathered."""
        return _ScatterSum.apply(x, dim, self)

    def sum_both(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the model group, out of place; in training
        (``TrainRules``) its gradient summed over the group too."""
        self.reduces += 1
        return self.all_reduce(x.clone(memory_format=torch.contiguous_format))

    def cp_gather(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        return self.gather_sum(x, dim) if self.seq else x

    def cp_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return self.scatter_sum(x, dim) if self.seq else x

    def cp_sum(self, x: torch.Tensor) -> torch.Tensor:
        return _SumForward.apply(x, self) if self.seq else x

    def cp_merge(self, m: torch.Tensor, l: torch.Tensor, o: torch.Tensor):
        if not self.seq:
            return l, o
        top = self.all_reduce(m.clone(), "model", op=dist.ReduceOp.MAX)
        c = torch.exp(m - top)
        return self.all_reduce(l * c), self.all_reduce(o * c[..., None])

    def use(self, tree, where: str):
        spec = self.uses.get(where)
        return tree if spec is None else _map(self._gathered, tree, spec)

    def _gathered(self, t: torch.Tensor, spec) -> torch.Tensor:
        """``t`` gathered over every dim its spec names: the data dim
        first (the FSDP split), then the model dim (with a summing
        backward under context parallelism)."""
        model = _GatherSum if self.seq else _GatherModel
        for axis, fn in (("data", _GatherData), ("model", model)):
            for dim, ax in enumerate(spec):
                if ax == axis:
                    t = fn.apply(t, dim, self)
        return t


class _SumForward(torch.autograd.Function):
    """All-reduce over ``rules.group`` in forward (into a new tensor),
    the identity in backward."""

    @staticmethod
    def forward(ctx, x, rules):
        return rules.all_reduce(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSum(torch.autograd.Function):
    """An all-gather over the ``model`` group along ``dim`` in forward; in
    backward a reduce-scatter of the gradient with a sum: each rank's
    gradient of the whole is of its own tokens (context parallelism)."""

    @staticmethod
    def forward(ctx, x, dim, rules):
        ctx.dim, ctx.rules = dim, rules
        return rules.all_gather(x, dim, "model")

    @staticmethod
    def backward(ctx, g):
        return ctx.rules.reduce_scatter(g, ctx.dim, "model"), None, None


class _ScatterSum(torch.autograd.Function):
    """A reduce-scatter (sum) over the ``model`` group along ``dim`` in
    forward, an all-gather of the gradient in backward."""

    @staticmethod
    def forward(ctx, x, dim, rules):
        ctx.dim, ctx.rules = dim, rules
        return rules.reduce_scatter(x, dim, "model")

    @staticmethod
    def backward(ctx, g):
        return ctx.rules.all_gather(g, ctx.dim, "model"), None, None


class _SumBackward(torch.autograd.Function):
    """The identity on each of its tensors in forward; in backward their
    gradients summed over ``rules.group``, one all-reduce (into a new
    tensor) a dtype, each counted in ``rules.reduces``."""

    @staticmethod
    def forward(ctx, rules, *xs):
        ctx.rules = rules
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        r = ctx.rules
        out = list(gs)
        for dtype in dict.fromkeys(g.dtype for g in gs):
            idx = [i for i, g in enumerate(gs) if g.dtype == dtype]
            flat = r.all_reduce(torch.cat([gs[i].reshape(-1) for i in idx]))
            r.reduces += 1
            for i, part in zip(idx, flat.split([gs[i].numel()
                                                for i in idx])):
                out[i] = part.view_as(gs[i])
        return (None, *out)


class _SumBoth(torch.autograd.Function):
    """An all-reduce over ``rules.group`` in forward (into a new tensor)
    and of the gradient in backward, each counted in ``rules.reduces``."""

    @staticmethod
    def forward(ctx, x, rules):
        ctx.rules = rules
        rules.reduces += 1
        return rules.all_reduce(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        ctx.rules.reduces += 1
        return ctx.rules.all_reduce(
            g.clone(memory_format=torch.contiguous_format)), None


class _GatherData(torch.autograd.Function):
    """FSDP: an all-gather over the ``data`` group along ``dim`` in
    forward; in backward a reduce-scatter of the gradient over that group,
    divided by its size (each replica's gradient is of its own rows: the
    division is the data average)."""

    @staticmethod
    def forward(ctx, x, dim, rules):
        ctx.dim, ctx.rules = dim, rules
        return rules.all_gather(x, dim, "data")

    @staticmethod
    def backward(ctx, g):
        r = ctx.rules
        return r.reduce_scatter(g, ctx.dim, "data").div_(r.data), None, None


class _GatherModel(torch.autograd.Function):
    """A leaf split over ``model`` whose use computes replicated: an
    all-gather over the ``model`` group along ``dim`` in forward; in
    backward the rank's part of the gradient, summed with nothing (every
    rank computed the same whole gradient; a sum would give M times it).
    Under context parallelism each rank's gradient is of its own tokens:
    there ``_GatherSum`` takes its place."""

    @staticmethod
    def forward(ctx, x, dim, rules):
        ctx.dim, ctx.rules = dim, rules
        return rules.all_gather(x, dim, "model")

    @staticmethod
    def backward(ctx, g):
        r = ctx.rules
        n = g.shape[ctx.dim] // r.model
        return (g.narrow(ctx.dim, r.model_rank * n, n).contiguous(), None,
                None)


class TrainRules(ManualRules):
    """Per-rank rules of the training forward: ``contract`` and ``enter``
    as the module doc says, for exactly the axes in ``contract_axes``;
    ``use`` through the gathers autograd differentiates. ``reduces``
    counts the sums of ``contract`` and ``enter`` as they run: forward,
    recompute (remat) and backward. ``sharded``: {path (``tp.path_key``)
    of a parameter leaf split over a mesh axis: the axes it is split on,
    a frozenset of "model" and "data"}, over which the train step sums
    the leaf's gradient squares and takes its compression scale."""

    def __init__(self, contract_axes: Iterable[str] = (), group=None,
                 sharded: Optional[Dict[tuple, FrozenSet[str]]] = None, *,
                 data_group=None, data: int = 1, model: int = 1,
                 model_rank: int = 0, uses: Optional[Dict] = None,
                 seq: Optional[str] = None, whole_kv: bool = False):
        super().__init__(contract_axes, group, data_group=data_group,
                         data=data, model=model, model_rank=model_rank,
                         uses=uses, seq=seq, whole_kv=whole_kv)
        self.sharded = dict(sharded or {})

    def contract(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        if not self._check(axis):
            return x
        self.reduces += 1
        return _SumForward.apply(x, self)

    def enter(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        return _SumBackward.apply(self, x)[0] if self._check(axis) else x

    def partial(self, *leaves):
        self._group("model")
        return _SumBackward.apply(self, *leaves)

    def sum_both(self, x: torch.Tensor) -> torch.Tensor:
        self._group("model")
        return _SumBoth.apply(x, self)


class DryRunRules(TrainRules):
    """One rank's rules on a described mesh: ``TrainRules``' sums and
    gathers when ``train``, ``ManualRules``' in-place contraction
    otherwise (prefill, decode), each collective recorded, none issued;
    no group is needed. ``sums``: (mesh axis, operand bytes) of each
    all-reduce; ``moves``: (kind, mesh axis, operand bytes) of each
    all-gather (operand: the rank's part) and reduce-scatter (operand:
    the whole gradient). A gather returns the whole shape (the rank's
    part repeated), a reduce-scatter the first part."""

    def __init__(self, contract_axes: Iterable[str] = (),
                 sharded: Optional[Dict[tuple, FrozenSet[str]]] = None, *,
                 data: int = 1, model: int = 1,
                 uses: Optional[Dict] = None, train: bool = True,
                 seq: Optional[str] = None, whole_kv: bool = False):
        super().__init__(contract_axes, None, sharded, data=data,
                         model=model, uses=uses, seq=seq, whole_kv=whole_kv)
        self.train = train
        self.sums: list = []
        self.moves: list = []

    def _check(self, axis: str) -> bool:
        return axis in self.contract_axes

    def all_reduce(self, x: torch.Tensor, axis: str = "model",
                   op=None) -> torch.Tensor:
        self.collectives["all-reduce", axis] += 1
        self.sums.append((axis, x.numel() * x.element_size()))
        return x

    def all_gather(self, x: torch.Tensor, dim: int,
                   axis: str) -> torch.Tensor:
        self.collectives["all-gather", axis] += 1
        self.moves.append(("all-gather", axis, x.numel() * x.element_size()))
        return torch.cat([x] * self._size(axis), dim)

    def reduce_scatter(self, x: torch.Tensor, dim: int,
                       axis: str) -> torch.Tensor:
        self.collectives["reduce-scatter", axis] += 1
        self.moves.append(("reduce-scatter", axis,
                           x.numel() * x.element_size()))
        return x.chunk(self._size(axis), dim)[0].clone(
            memory_format=torch.contiguous_format)

    def contract(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        if self.train:
            return super().contract(x, axis)
        return ManualRules.contract(self, x, axis)

    def enter(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        return super().enter(x, axis) if self.train else x

    def _group(self, axis: str):
        return None

    def partial(self, *leaves):
        return super().partial(*leaves) if self.train else leaves

    def sum_both(self, x: torch.Tensor) -> torch.Tensor:
        if self.train:
            return super().sum_both(x)
        return ManualRules.sum_both(self, x)


NO_RULES = Rules(None)
