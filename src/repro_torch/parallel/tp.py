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
sharded leaf to the rank's part (``.contiguous()``, so the full tensors
can be freed), and ``paged_cache_init`` allocates the pools at the rank's
KV/m heads.

Training (``train_plan``) shards the same leaves, an encoder-decoder's
cross-attention with the rest of attention, and hooks
``sharding.TrainRules`` into the forward, whose sums autograd
differentiates. A train state's moments and error tree shard like the
parameters (``state_specs``); ``gather_tree`` puts the full leaves back
together on one rank (a checkpoint in the single-device format), and
``shard_tree`` cuts a full tree for any other model width (a restore).
Over a ``data`` axis the plan's rules also carry the mesh's ``data``
group, over which the train step averages the gradients (a shard's
replicas hold the same parameters).
The embeddings, the head and MoE blocks replicate, where the reference's
GSPMD rules shard "vocab" and "experts": the same numbers, more memory a
rank.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, FrozenSet, Optional

import torch
import torch.distributed as dist

from repro_torch.models import api
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


def _local(t_shape, spec, m: int):
    """The shape of a rank's part of a leaf of ``t_shape`` under ``spec``."""
    return tuple(n // m if i < len(spec) and spec[i] == "model" else n
                 for i, n in enumerate(t_shape))


def _part(t: torch.Tensor, spec, m: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s contiguous part of ``t`` under ``spec``."""
    for dim, ax in enumerate(spec):
        if ax == "model":
            n = t.shape[dim] // m
            return t.narrow(dim, rank * n, n).contiguous()
    return t


@dataclasses.dataclass(frozen=True)
class TPPlan:
    """Frozen answers: the config and mesh, and which logical axes
    actually sharded."""
    cfg: Any
    mesh: Any
    model_shards: int
    sharded_axes: FrozenSet[str]
    rules: ManualRules                 # a rank's model hooks

    def _spec_rules(self) -> Rules:
        table = {name: ("model" if name in self.sharded_axes else None)
                 for name in DEFAULT_TABLE}
        return Rules(self.mesh, table)

    def param_specs(self, cfg) -> Any:
        """A spec tree matching ``api.init_params(cfg, ...)``: attn and mlp
        weights shard per ``sharded_axes``, everything else ``()``."""
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


def shard_params(params, plan: TPPlan, rank: int):
    """Rank ``rank``'s parameters (``rank``: its place on the ``model``
    axis): each sharded leaf sliced to its part, a ``.contiguous()`` tensor
    on the leaf's device; replicated leaves are the caller's tensors."""
    return shard_tree(params, plan.param_specs(plan.cfg), plan.model_shards,
                      rank)


def shard_tree(tree, specs, m: int, rank: int):
    """``shard_params`` for any tree with a spec tree of its structure."""
    return _tree_map(lambda _, t, spec: _part(t, spec, m, rank), tree, specs)


def state_specs(plan: TPPlan, state) -> Any:
    """A spec tree for a train state ({"params", "opt": {"m", "v", "step"}
    [, "err"]}): the moments and the error tree shard like the
    parameters, the step replicates."""
    ps = plan.param_specs(plan.cfg)
    out = {"params": ps, "opt": {"m": ps, "v": ps, "step": ()}}
    if "err" in state:
        out["err"] = ps
    return out


def sharded_paths(specs) -> FrozenSet[tuple]:
    """The paths (``path_key``) of the leaves a spec tree splits."""
    out: set = set()

    def visit(path, spec):
        if "model" in spec:
            out.add(path)
    _tree_map(visit, specs)
    return frozenset(out)


def path_key(path) -> tuple:
    """A ``torch.utils._pytree`` key path as this module's paths spell it:
    dict keys, and list indices as strings."""
    return tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def train_plan(cfg, mesh) -> TPPlan:
    """``tp_plan``'s shards for the training forward, its rules a
    ``TrainRules`` over the mesh's ``model`` group (the sums autograd
    differentiates, and the sharded leaves the train step reduces
    over)."""
    plan = tp_plan(cfg, mesh)
    rules = TrainRules(plan.rules.contract_axes, mesh.group,
                       sharded_paths(plan.param_specs(cfg)),
                       data_group=mesh.data_group, data=data_size(mesh))
    return dataclasses.replace(plan, rules=rules)


def data_size(mesh) -> int:
    """The replicas of a shard: the mesh's ``pod`` x ``data`` axes."""
    return mesh.shape.get("pod", 1) * mesh.shape.get("data", 1)


def gather_tree(tree, specs, group):
    """The full leaves of a tree sharded over ``group`` (None: nothing is
    split) as host tensors on the group's first rank, which gets the tree
    (every other rank gets None): each sharded leaf's parts gathered in
    rank order (host copies, so any backend that moves CPU tensors will
    do) and joined along their sharded dim; replicated leaves copied.
    Collective: every rank of the group calls it, with its own part."""
    first = group is None or dist.get_rank(group) == 0
    dst = 0 if group is None else dist.get_global_rank(group, 0)
    m = 1 if group is None else dist.get_world_size(group)

    def full(_, t, spec):
        host = t.detach().cpu()
        if "model" not in spec or m == 1:
            return host if first else None
        parts = [torch.empty_like(host) for _ in range(m)] if first else None
        dist.gather(host, parts, dst=dst, group=group)
        return torch.cat(parts, spec.index("model")) if first else None

    out = _tree_map(full, tree, specs)
    return out if first else None


def full_like(tree, specs, m: int):
    """Meta tensors of the full shapes and dtypes of a tree sharded ``m``
    ways (``ckpt.restore``'s ``like``)."""
    def meta(_, t, spec):
        shape = tuple(n * m if i < len(spec) and spec[i] == "model" else n
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
