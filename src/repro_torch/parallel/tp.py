"""Tensor-parallel plan for the paged serving engine.

Counterpart of ``repro.parallel.tp``, on ``torch.distributed``: one process
a shard, each running the engine's host logic on the same inputs. One
``TPPlan`` per (config, mesh) settles, before anything runs:

* **What shards.** KV heads are the shard axis: each rank owns its GQA
  groups' slice of every page, so every page access stays rank-local.
  Attention weights shard over heads / kv_heads, but only when BOTH divide
  the ``model`` axis: head j reads kv head ``j // G`` (kv-major), so rank
  r owns query heads [r H/m, (r+1) H/m) and KV heads [r KV/m, (r+1) KV/m)
  and the GQA fold inside a shard is unchanged. MLP weights shard over
  ``ffn`` unless the config has MoE (the MoE block replicates, and its
  shared expert's ``mlp_apply`` would then sum an already-full output).
  Everything else (embeddings, head, norms, recurrent mixers, MoE, block
  tables, positions, state slots) replicates; a dim that does not divide
  falls back to replication with a warning naming its axis.
* **Which specs.** Param specs come from ``api.param_axes`` restricted to
  the ``attn`` / ``mlp`` subtrees, cache specs from
  ``api.paged_cache_axes`` (page pools shard dim 2, state replicates):
  per dim, the mesh axis it shards over or None.
* **Where the sums go.** ``plan.rules`` is a ``ManualRules`` whose
  ``contract`` all-reduces over the mesh's ``model`` group for exactly the
  axes that sharded: the attention out-projection ("heads") and the MLP
  down-projection ("ffn"). The online softmax inside each shard's
  flash-decode never crosses shards.

The counterpart of the reference's ``put``: ``shard_params`` slices each
sharded leaf to the rank's part (a copy, so the full tensors can be
freed), and ``paged_cache_init`` allocates the pools at the rank's
KV/m heads.

Training (``train_plan``) stores every leaf at the reference's layout:
each leaf's spec is ``Rules(mesh).spec`` over the whole ``DEFAULT_TABLE``,
so every ``wembed`` dim splits over ``("pod", "data")`` (FSDP) and the
``model`` dims over ``model`` (heads, ffn, vocab, experts; a dim that
does not divide, or that loses the ``model`` axis to an earlier dim of its
leaf, replicates, as JAX's ``NamedSharding`` has it). The plan's
``sharding.TrainRules`` then say where each split is used:

* computed in parallel over ``model`` (the leaf stays the rank's part,
  and ``contract`` / ``enter`` bracket its sublayer): attention over its
  query heads when they divide the axis, an MLP's (and an MoE's shared
  expert's) ffn, the embedding and head over vocab (``api``'s
  vocab-parallel lookup and loss), MoE experts (``layers.moe_apply``: a
  rank runs its E/m experts), griffin's RG-LRU over its ``lru_dim``
  channels and mamba2's mixer over its heads (contract axes "rglru" and
  "ssm"; mamba2 with one group of B and C);
* gathered at the use, inside the layer's remat region (``use``): every
  ``data`` split, and the ``model`` splits of the rest (the router, and a
  mixer or attention whose compute axis does not divide).

Where attention's KV heads do not divide the axis while its query heads
do, ``wk`` / ``wv`` / ``bk`` / ``bv`` replicate in storage (``Rules.spec``
falls back) and are used whole: K and V are computed whole on every rank,
and each rank's queries attend only the KV heads they read
(``layers.kv_heads_of``), so each rank's gradient of those leaves is a
partial sum, summed over ``model`` in backward (``rules.partial``; the
plan's ``whole_kv``). A mixer's leaves that replicate (its conv, gate
biases, the mamba2 norm's scale, and an ``in_proj`` whose columns do not
divide) are used at the rank's part the same way (``models.griffin``,
``models.ssm``).

With the sequence over ``model`` (``train_plan(table={"seq": "model"})``,
context parallelism: the reference's ``Rules(mesh, table)``), the
activations' heads, ffn and vocab lose ``model`` to their sequence, so
attention, the MLPs, the embedding and the head are gathered at their use
and only the experts stay computed in parallel; the rules' ``seq`` then
makes every gathered leaf's backward a summing reduce-scatter (each rank's
gradient is of its own tokens). The stored layout is the same.

A train state's moments and error tree shard like the parameters
(``state_specs``); ``gather_tree`` puts the full leaves back together on
one rank, over both groups (a checkpoint in the single-device format),
and ``shard_tree`` cuts a full tree for any other ``(data, model)`` (a
restore). The serving plan (``tp_plan``) is unchanged: it replicates the
embeddings, the head and MoE blocks, as the reference's serving plan
does.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Dict, FrozenSet, Optional

import torch
import torch.distributed as dist

from repro_torch.models import api, griffin, ssm
from repro_torch.models import transformer as tfm
from repro_torch.parallel.sharding import (DEFAULT_TABLE, ManualRules, Rules,
                                           TrainRules)

# logical axes that may shard over "model" under the serving TP plan
_ATTN_AXES = ("heads", "kv_heads", "wheads", "wkv_heads")
_FFN_AXES = ("ffn", "wff")
# param subtrees whose weights take part in TP; everything outside
# (embed / head / norms, "mixer", "moe") replicates. "cross" (an
# encoder-decoder's cross-attention) contracts "heads" like "attn"
_SHARDED_SUBTREES = ("attn", "cross", "mlp")


def _tree_map(fn, *trees, path=()):
    """``fn(path, *leaves)`` over dict / list trees of one structure."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees), path=path + (k,))
                for k in t}
    if isinstance(t, list):
        return [_tree_map(fn, *(x[i] for x in trees), path=path + (str(i),))
                for i in range(len(t))]
    return fn(path, *trees)


def _divisor(ax, m: int, d: int) -> int:
    """The parts a dim of spec entry ``ax`` splits into: ``m`` over
    "model", ``d`` over a data axis ("data" or ``("pod", "data")``)."""
    return 1 if ax is None else m if ax == "model" else d


def _local(t_shape, spec, m: int, d: int = 1):
    """The shape of a rank's part of a leaf of ``t_shape`` under ``spec``
    (``m`` model shards, ``d`` data shards)."""
    spec = tuple(spec) + (None,) * (len(t_shape) - len(spec))
    return tuple(n // _divisor(ax, m, d) for n, ax in zip(t_shape, spec))


def _part(t: torch.Tensor, spec, m: int, rank: int, d: int = 1,
          data_rank: int = 0) -> torch.Tensor:
    """The part of ``t`` under ``spec`` of model rank ``rank`` and data
    rank ``data_rank``, a contiguous copy (the whole ``t`` may be freed);
    ``t`` itself where nothing splits."""
    out = t
    for dim, ax in enumerate(spec):
        k = _divisor(ax, m, d)
        if k > 1:
            n = t.shape[dim] // k
            out = out.narrow(dim, (rank if ax == "model" else data_rank) * n,
                             n)
    return out if out is t else out.clone(
        memory_format=torch.contiguous_format)


@dataclasses.dataclass(frozen=True)
class TPPlan:
    """Frozen answers: the config and mesh, and which logical axes
    actually sharded."""
    cfg: Any
    mesh: Any
    model_shards: int
    sharded_axes: FrozenSet[str]
    rules: ManualRules                 # a rank's model hooks
    specs: Any = None                  # a train plan's parameter specs

    def _spec_rules(self) -> Rules:
        table = {name: ("model" if name in self.sharded_axes else None)
                 for name in DEFAULT_TABLE}
        return Rules(self.mesh, table)

    def param_specs(self, cfg) -> Any:
        """A spec tree matching ``api.init_params(cfg, ...)``: a train
        plan's ``specs``; the serving plan's attn and mlp weights shard per
        ``sharded_axes``, everything else ``()``."""
        if self.specs is not None:
            return self.specs
        rules = self._spec_rules()

        def spec(path, shape, axes):
            if not any(k in _SHARDED_SUBTREES for k in path):
                return ()
            return rules.spec(tuple(shape), axes)

        return _tree_map(spec, api.param_shapes(cfg), api.param_axes(cfg))

    def cache_specs(self, cfg, cache) -> Any:
        """A spec tree for a full-shape paged cache list (``api.
        paged_cache_init``): page pools shard their KV-head dim,
        recurrent state slots replicate."""
        rules = self._spec_rules()
        return _tree_map(lambda _, leaf, a: rules.spec(tuple(leaf.shape), a),
                         cache, api.paged_cache_axes(cfg))


def tp_plan(cfg, mesh) -> Optional[TPPlan]:
    """Decide what shards for ``cfg`` on ``mesh`` (None mesh -> None plan).

    Heads and kv_heads shard together or not at all (GQA alignment); ffn
    never shards on a config with MoE. Either fallback warns once, naming
    the axis, and the engine keeps serving, replicated. ``model`` = 1
    shards nothing and contracts nothing."""
    if mesh is None:
        return None
    if "model" not in mesh.shape:
        raise ValueError(
            f"tp_plan needs a mesh with a 'model' axis; got axes "
            f"{tuple(mesh.shape)}")
    m = int(mesh.shape["model"])
    sharded: set = set()
    if m > 1:
        if cfg.num_heads % m == 0 and cfg.kv_heads % m == 0:
            sharded.update(_ATTN_AXES)
        else:
            warnings.warn(
                f"{cfg.name}: heads={cfg.num_heads}/kv_heads="
                f"{cfg.kv_heads} do not both divide model={m}; attention "
                f"(weights AND kv page pools) replicates per shard",
                stacklevel=2)
        has_moe = cfg.moe is not None and cfg.moe.num_experts > 0
        if has_moe:
            pass                       # MoE block replicates; see module doc
        elif cfg.d_ff % m == 0:
            sharded.update(_FFN_AXES)
        else:
            warnings.warn(
                f"{cfg.name}: d_ff={cfg.d_ff} does not divide model={m}; "
                f"MLP weights replicate per shard", stacklevel=2)
    contract = {a for a in ("heads", "ffn") if a in sharded}
    return TPPlan(cfg=cfg, mesh=mesh, model_shards=m,
                  sharded_axes=frozenset(sharded),
                  rules=ManualRules(contract, mesh.group))


def shard_params(params, plan: TPPlan, rank: int, data_rank: int = 0):
    """Rank ``rank``'s parameters (``rank``: its place on the ``model``
    axis, ``data_rank`` on the data axes): each sharded leaf sliced to its
    part, a contiguous copy on the leaf's device; replicated leaves are
    the caller's tensors."""
    return shard_tree(params, plan.param_specs(plan.cfg), plan.model_shards,
                      rank, d=data_size(plan.mesh), data_rank=data_rank)


def shard_tree(tree, specs, m: int, rank: int, *, d: int = 1,
               data_rank: int = 0):
    """``shard_params`` for any tree with a spec tree of its structure
    (``m`` model and ``d`` data shards)."""
    return _tree_map(lambda _, t, spec: _part(t, spec, m, rank, d, data_rank),
                     tree, specs)


def state_specs(plan: TPPlan, state) -> Any:
    """A spec tree for a train state ({"params", "opt": {"m", "v", "step"}
    [, "err"]}): the moments and the error tree shard like the
    parameters, the step replicates."""
    ps = plan.param_specs(plan.cfg)
    out = {"params": ps, "opt": {"m": ps, "v": ps, "step": ()}}
    if "err" in state:
        out["err"] = ps
    return out


def split_axes(specs) -> Dict[tuple, FrozenSet[str]]:
    """{path (``path_key``) of each leaf a spec tree splits: the axes it
    is split on, "model" and / or "data" (a composed ``("pod", "data")``
    dim is "data")}."""
    out: Dict[tuple, FrozenSet[str]] = {}

    def visit(path, spec):
        axes = frozenset("model" if ax == "model" else "data"
                         for ax in spec if ax is not None)
        if axes:
            out[path] = axes
    _tree_map(visit, specs)
    return out


def path_key(path) -> tuple:
    """A ``torch.utils._pytree`` key path as this module's paths spell it:
    dict keys, and list indices as strings."""
    return tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def _layout(cfg, mesh, table=None) -> Any:
    """Every parameter leaf's spec under ``Rules(mesh, table)`` over the
    whole ``DEFAULT_TABLE`` (``table`` maps activation axes only, so the
    parameters' specs are the default table's), a dim over an axis of size
    1 replicated."""
    rules = Rules(mesh, table)

    def spec(_, shape, axes):
        out = []
        for ax in rules.spec(tuple(shape), axes):
            names = () if ax is None else ax if isinstance(ax, tuple) \
                else (ax,)
            out.append(ax if math.prod(mesh.shape[a] for a in names) > 1
                       else None)
        while out and out[-1] is None:
            out.pop()
        return tuple(out)

    return _tree_map(spec, api.param_shapes(cfg), api.param_axes(cfg))


def _computed_in_parallel(path, name: str, attn: bool, cp: bool,
                          mixer: Optional[str] = None) -> Optional[str]:
    """The axis a sublayer contracts when the ``model`` split of logical
    weight axis ``name`` at ``path`` stays the rank's part at its use (its
    sublayer computes in parallel), or None where the split is gathered.
    ``attn``: attention's query heads divide the axis (its KV heads may
    not: a whole KV leaf has no ``model`` split to ask about); ``mixer``:
    the block's recurrent kind ("rglru" or "ssm") when its mixer computes
    in parallel. With the sequence over ``model`` (``cp``) only the
    experts do."""
    if cp and name != "wexperts":
        return None
    if "mixer" in path:
        return mixer
    if name in ("wheads", "wkv_heads"):
        return "heads" if attn and {"attn", "cross"} & set(path) else None
    if name == "wff":
        return "ffn" if {"mlp", "shared"} & set(path) else None
    if name == "wexperts":
        return "experts" if path[-1] in ("wi", "wg", "wo") else None
    return "vocab" if name == "wvocab" else None


def _mixer_parallel(cfg, kind: str, m: int) -> bool:
    """Whether a ``kind`` block's recurrent mixer computes in parallel
    over ``m`` ranks: griffin over its ``lru_dim`` channels, mamba2 over
    its heads (with one group of B and C, which every head reads)."""
    if kind == "rglru":
        return griffin.lru_dim(cfg) % m == 0
    if kind == "ssm":
        return ssm.dims(cfg)[1] % m == 0 and cfg.ssm.num_groups == 1
    return False


def train_plan(cfg, mesh, table=None) -> TPPlan:
    """The training plan: every leaf at the reference's layout
    (``_layout``), its rules a ``TrainRules`` over the mesh's ``model``
    and ``data`` groups that contract what computes in parallel, gather
    the rest at its use (the module doc), and name each split leaf for
    the train step's reductions. ``table``: the reference's rules table
    over ``DEFAULT_TABLE``; ``{"seq": "model"}`` splits the sequence over
    ``model`` (context parallelism; a mesh whose ``model`` is 1 splits
    nothing)."""
    seq = Rules(mesh, table).table.get("seq")
    if seq not in (None, "model"):
        raise ValueError(f"rules_table seq -> {seq!r}: the port splits the "
                         f"sequence over 'model' or not at all")
    specs = _layout(cfg, mesh, table)
    axes = api.param_axes(cfg)
    m = int(mesh.shape["model"])
    cp = seq == "model" and m > 1
    attn = m > 1 and not cp and cfg.num_heads % m == 0
    kinds = tfm.layer_kinds(cfg)
    mixers = {k for k in set(kinds)
              if m > 1 and not cp and _mixer_parallel(cfg, k, m)}
    contract: set = set(mixers)

    def use(path, spec, ax_str):
        names = [a.strip() for a in ax_str.split(",")] if ax_str else []
        kind = kinds[int(path[1])] if path[0] == "blocks" else None
        out = []
        for dim, ax in enumerate(spec):
            if ax is None:
                out.append(None)
            elif ax != "model":
                out.append("data")
            elif axis := _computed_in_parallel(
                    path, names[dim], attn, cp,
                    kind if kind in mixers else None):
                contract.add(axis)
                out.append(None)
            else:
                out.append("model")
        return tuple(out)

    uses_tree = _tree_map(use, specs, axes)
    uses = {k: uses_tree[k] for k in ("embed", "head") if k in uses_tree}
    for kind, block in zip(kinds, uses_tree["blocks"]):
        uses.setdefault(kind, block)
    if cfg.is_encdec:
        uses["enc"] = uses_tree["enc"]["blocks"][0]
    whole_kv = attn and cfg.kv_heads % m != 0
    sharded = {name for a in contract for name in _LOGICAL.get(a, ())}
    if whole_kv:                # the KV heads do not split
        sharded -= {"kv_heads", "wkv_heads"}
    rules = TrainRules(contract, mesh.group, split_axes(specs),
                       data_group=mesh.data_group, data=data_size(mesh),
                       model=m, model_rank=mesh.model_rank, uses=uses,
                       seq="model" if cp else None, whole_kv=whole_kv)
    return TPPlan(cfg=cfg, mesh=mesh, model_shards=m,
                  sharded_axes=frozenset(sharded), rules=rules, specs=specs)


# the logical axes (activation and weight) of each contracted axis
_LOGICAL = {"heads": _ATTN_AXES, "ffn": _FFN_AXES,
            "vocab": ("vocab", "wvocab"), "experts": ("experts", "wexperts")}


def data_size(mesh) -> int:
    """The replicas of a shard: the mesh's ``pod`` x ``data`` axes."""
    return mesh.shape.get("pod", 1) * mesh.shape.get("data", 1)


def _data_dim(spec):
    """The dim a spec splits over a data axis, or None."""
    return next((i for i, ax in enumerate(spec)
                 if ax is not None and ax != "model"), None)


def gather_tree(tree, specs, group, data_group=None):
    """The full leaves of a tree sharded over the ``model`` ``group`` and
    the ``data_group`` (either None: nothing is split over it) as host
    tensors on the first rank of both, which gets the tree (every other
    rank gets None): each leaf's parts gathered in rank order (host copies,
    so any backend that moves CPU tensors will do, and a step that
    updates the state in place leaves the tree as it was), first over the data
    group (each model column to its first data rank), then over the model
    group of the first data row, joined along their dims; replicated
    leaves copied. Collective: every rank of the groups calls it, with
    its own part."""
    first_d = data_group is None or dist.get_rank(data_group) == 0
    first = first_d and (group is None or dist.get_rank(group) == 0)

    def joined(host, grp, dim, mine):
        parts = [torch.empty_like(host) for _ in
                 range(dist.get_world_size(grp))] if mine else None
        dist.gather(host, parts, dst=dist.get_global_rank(grp, 0), group=grp)
        return torch.cat(parts, dim) if mine else None

    def full(_, t, spec):
        host = t.detach().to("cpu", copy=True)     # never the live leaf
        dd = _data_dim(spec)
        if dd is not None and data_group is not None:
            host = joined(host, data_group, dd, first_d)
        if not first_d:
            return None
        if "model" in spec and group is not None:
            host = joined(host, group, spec.index("model"), first)
        return host if first else None

    out = _tree_map(full, tree, specs)
    return out if first else None


def full_like(tree, specs, m: int, d: int = 1):
    """Meta tensors of the full shapes and dtypes of a tree sharded ``m``
    ways over ``model`` and ``d`` over the data axes (``ckpt.restore``'s
    ``like``)."""
    def meta(_, t, spec):
        shape = tuple(n * _divisor(spec[i] if i < len(spec) else None, m, d)
                      for i, n in enumerate(t.shape))
        return torch.empty(shape, dtype=t.dtype, device="meta")
    return _tree_map(meta, tree, specs)


def paged_cache_init(plan: TPPlan, cfg, num_pages: int, page_size: int, *,
                     slots: int, device) -> list:
    """``api.paged_cache_init`` at a rank's part: each page pool at KV/m
    heads when attention shards (zeros), state slots whole."""
    full = api.paged_cache_init(cfg, num_pages, page_size, slots=slots,
                                device="meta")
    m = plan.model_shards
    return _tree_map(
        lambda _, leaf, spec: torch.zeros(_local(leaf.shape, spec, m),
                                          dtype=leaf.dtype, device=device),
        full, plan.cache_specs(cfg, full))
