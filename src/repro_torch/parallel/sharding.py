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

Every collective the rules issue goes through ``ManualRules.all_reduce(x,
axis, op)``, in place over the ``model`` group (the contractions, the
train step's norm and compression scales) or the ``data`` group
(data-parallel training's gradient average, ``data_group``), so a
subclass can change what a sum does: ``DryRunRules`` records its bytes
instead of issuing it.

``TrainRules`` is its training variant, which autograd differentiates.
A sharded sublayer's input is replicated and its output a per-rank partial
sum, so two functions over the ``model`` group bracket it, for the axes in
``contract_axes`` only: ``contract`` (the out- and down-projection) sums
the partials in forward, out of place, and passes the gradient through
unchanged in backward (the gradient downstream is the same on every rank);
``enter`` (the sublayer's input) is the identity in forward and sums the
gradient in backward (each rank's input gradient holds only its shard's
share). ``torch.distributed.nn.functional.all_reduce`` at the contraction
alone would sum the gradient in backward too, and hand each rank M times
it.

``DryRunRules`` are one rank's rules on a described mesh (no world): the
contractions and the data-axis sums run as they would, but each sum is
recorded, (mesh axis, operand bytes) in ``sums``, and not issued.
"""
from __future__ import annotations

import warnings
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
    of data-parallel training."""

    data = 1

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
        out-projection contracts "heads", the MLP down-projection "ffn").
        The identity; ``ManualRules`` sums over the model group."""
        return x

    def enter(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Hook at the input of a sublayer that contracts ``axis`` at its
        end. The identity; ``TrainRules`` sums its gradient over the model
        group."""
        return x


class ManualRules(Rules):
    """Per-rank rules: ``contract`` all-reduces ``x`` in place over
    ``group`` (the mesh's ``model`` group) for exactly the axes in
    ``contract_axes``, and is the identity for the rest. ``reduces``
    counts the ``model`` all-reduces issued (in a captured graph: the ones
    recorded); ``data_group`` holds the ``data`` replicas of this rank's
    shard (data-parallel training). Without a group (a mesh made outside
    a world) the rules can be read but a contraction raises."""

    def __init__(self, contract_axes: Iterable[str] = (), group=None, *,
                 data_group=None, data: int = 1):
        super().__init__(None)
        self.contract_axes: FrozenSet[str] = frozenset(contract_axes)
        self.group = group
        self.data_group, self.data = data_group, data
        self.reduces = 0

    def all_reduce(self, x: torch.Tensor, axis: str = "model",
                   op=None) -> torch.Tensor:
        """Reduce ``x`` in place over mesh axis ``axis``'s group ("model"
        or "data"), a sum unless ``op`` (a ``dist.ReduceOp``): the one
        place these rules issue a collective."""
        dist.all_reduce(x, op=dist.ReduceOp.SUM if op is None else op,
                        group=self.group if axis == "model"
                        else self.data_group)
        return x

    def _check(self, axis: str) -> bool:
        """Whether ``axis`` is summed (raises without a group)."""
        if axis not in self.contract_axes:
            return False
        if self.group is None:
            raise RuntimeError(
                f"contracting {axis!r} needs the model axis's process "
                f"group: make the mesh inside a torch.distributed world")
        return True

    def contract(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        if self._check(axis):
            self.all_reduce(x)
            self.reduces += 1
        return x


class _SumForward(torch.autograd.Function):
    """All-reduce over ``rules.group`` in forward (into a new tensor),
    the identity in backward."""

    @staticmethod
    def forward(ctx, x, rules):
        rules.reduces += 1
        return rules.all_reduce(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBackward(torch.autograd.Function):
    """The identity in forward, an all-reduce of the gradient over
    ``rules.group`` in backward."""

    @staticmethod
    def forward(ctx, x, rules):
        ctx.rules = rules
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.rules.reduces += 1
        return ctx.rules.all_reduce(
            g.clone(memory_format=torch.contiguous_format)), None


class TrainRules(ManualRules):
    """Per-rank rules of the training forward: ``contract`` and ``enter``
    as the module doc says, for exactly the axes in ``contract_axes``.
    ``reduces`` counts both kinds as they run: forward, recompute (remat)
    and backward. ``sharded``: the paths (``tp.path_key``) of the
    parameter leaves split over ``group``, whose gradients' squares and
    compression scales the train step reduces over it."""

    def __init__(self, contract_axes: Iterable[str] = (), group=None,
                 sharded: FrozenSet = frozenset(), *, data_group=None,
                 data: int = 1):
        super().__init__(contract_axes, group, data_group=data_group,
                         data=data)
        self.sharded = frozenset(sharded)

    def contract(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        return _SumForward.apply(x, self) if self._check(axis) else x

    def enter(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        return _SumBackward.apply(x, self) if self._check(axis) else x


class DryRunRules(TrainRules):
    """One rank's rules on a described mesh: ``TrainRules``' sums when
    ``train``, ``ManualRules``' in-place contraction otherwise (serving),
    each recorded as (mesh axis, operand bytes) in ``sums``, none
    issued; no group is needed. ``data``: the replicas of a shard."""

    def __init__(self, contract_axes: Iterable[str] = (),
                 sharded: FrozenSet = frozenset(), *, data: int = 1,
                 train: bool = True):
        super().__init__(contract_axes, None, sharded, data=data)
        self.train = train
        self.sums: list = []

    def _check(self, axis: str) -> bool:
        return axis in self.contract_axes

    def all_reduce(self, x: torch.Tensor, axis: str = "model",
                   op=None) -> torch.Tensor:
        self.sums.append((axis, x.numel() * x.element_size()))
        return x

    def contract(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        if self.train:
            return super().contract(x, axis)
        return ManualRules.contract(self, x, axis)

    def enter(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        return super().enter(x, axis) if self.train else x


NO_RULES = Rules(None)
