"""Attention whose query heads split over ``model`` while its KV heads do
not, computed in parallel in training (``tp.train_plan``), held to the JAX
package's single-device trainer on the CPU over gloo.

Where the query heads divide ``model`` a rank's ``wq`` / ``bq`` / ``wo``
are its heads' and the out-projection contracts "heads"; ``wk`` / ``wv`` /
``bk`` / ``bv`` are whole on every rank where the KV heads do not divide
(``whole_kv``), and a rank attends only the KV heads its queries read
(``layers.kv_heads_of``), so each rank's gradient of those leaves is its
share, summed over ``model`` in backward (``rules.partial``).

One spawned world of 4 ranks (``tests/torch_heads_ranks.py``, which
imports no jax) runs qwen2.5-3b SMOKE at (data 1, model 4) (4 query heads,
one a rank, over 2 KV heads) in a module fixture:

* three steps from ``convert.state_from_jax`` against JAX's on the whole
  batch, within ``torch_train_cases.steps_track_jax``'s bounds (the
  metrics within rtol 1e-4; parameters within 2 · lr a step, at most 1e-3
  of the elements more than 1e-5 apart); no leaf gathered over ``model``,
  and no collective over it but the sums;
* the loss's gradient at the JAX package's parameters: every leaf (a split
  leaf's parts joined) within ``torch_train_cases``' gradient bounds of
  JAX's; the control, whose ``partial`` sums nothing, parts from JAX's on
  every rank on exactly ``wk`` / ``wv`` / ``bk`` / ``bv``, whose four
  shares add up to JAX's.

Without a world: on ``pod16x16`` every reference config whose query heads
divide 16 gathers no attention leaf over ``model``, the serving plan still
shards attention only where both head counts divide, and
``kv_heads_of`` raises where a rank's heads would straddle a KV group.
"""
import dataclasses
import warnings

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")     # held against the JAX package

from torch.utils import _pytree as pytree  # noqa: E402

import torch_heads_ranks as ranks  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh, run_world  # noqa: E402,E501
from repro_torch.models import layers  # noqa: E402
from repro_torch.parallel import tp  # noqa: E402
from repro_torch.parallel.sharding import TrainRules  # noqa: E402
from torch_train_cases import (batch, grads_against_jax, jax_train,  # noqa: E402,E501
                               results, steps_track_jax)
from torch_train_ranks import OPT  # noqa: E402

NAME = "qwen_1x4"
KV_LEAVES = ("['wk']", "['wv']", "['bk']", "['bv']")


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """(directory, the JAX run, the gradient batch)."""
    d = tmp_path_factory.mktemp("train_heads")
    arch = ranks.CASES[NAME][0]
    run = jax_train(arch, 1, False, OPT)
    b = batch(ranks.cfg_of(arch), 2, 32)
    torch.save({"states": {NAME: run["state"]},
                "batches": {NAME: run["batches"]},
                "params": {NAME: run["state"]["params"]},
                "batch": {NAME: b}}, d / "inputs.pt")
    return d, run, b


@pytest.fixture(scope="module")
def world(bundle):
    d = bundle[0]
    return run_world(ranks.run_scenarios, 4, backend="gloo",
                     init_file=str(d / "rendezvous"),
                     args=(str(d / "inputs.pt"),
                           (f"train_{NAME}", f"grads_{NAME}")), timeout=300)


def test_steps_track_jax_with_the_kv_heads_whole(world, bundle):
    res = results(world, f"train_{NAME}")
    assert res[0]["contract"] == ["ffn", "heads", "vocab"]
    assert res[0]["whole_kv"]
    for r in res[1:]:                # the ranks step in lockstep
        assert r["metrics"] == res[0]["metrics"]
        assert r["params"] is None   # gathered on the first rank only
    steps_track_jax(res[0]["metrics"], res[0]["params"], bundle[1])
    assert all(w["jax_loaded"] == [] for w in world)


def test_no_leaf_is_gathered_over_model(world):
    """Every attention leaf is used as the rank holds it: the plan's
    ``uses`` gather nothing over ``model``, and a step's only collectives
    over ``model`` are its all-reduces."""
    res = results(world, f"train_{NAME}")
    specs = pytree.tree_leaves(res[0]["uses"],
                               is_leaf=lambda x: isinstance(x, tuple))
    assert specs and not any("model" in s for s in specs)
    for r in res:
        for step in r["collectives"]:
            assert {k for k in step if k.endswith(":model")} == {
                "all-reduce:model"}


def test_kv_gradients_equal_jax_and_the_control_is_a_share(world, bundle):
    res = results(world, f"grads_{NAME}")
    assert res[0]["whole_kv"]
    hit = grads_against_jax(res, ranks.CASES[NAME][0], bundle[2],
                            KV_LEAVES)
    cfg = ranks.cfg_of(ranks.CASES[NAME][0])
    assert len(hit) == cfg.num_layers * len(KV_LEAVES)


# ---------------------------------------------------------------------------
# the plans on pod16x16, and the straddle check
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_pod16x16_attention_is_never_gathered_where_heads_divide(arch):
    cfg = get_config(arch)
    mesh = make_production_mesh()
    m = mesh.shape["model"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        plan = tp.train_plan(cfg, mesh)
        serving = tp.tp_plan(cfg, mesh)
    attn = {k: v for kind, spec in plan.rules.uses.items()
            if isinstance(spec, dict)
            for k, v in (spec.get("attn", {}) | spec.get("cross", {})
                         ).items()}
    if not attn:                     # an attention-free stack
        assert cfg.family == "ssm"
        return
    gathered = {k for k, s in attn.items() if "model" in s}
    if cfg.num_heads % m == 0:
        assert gathered == set()
        assert "heads" in plan.rules.contract_axes
        assert plan.rules.whole_kv == (cfg.kv_heads % m != 0)
    else:                            # the query heads replicate
        assert "heads" not in plan.rules.contract_axes
        assert not plan.rules.whole_kv
    # the serving plan shards attention only where both counts divide
    both = cfg.num_heads % m == 0 and cfg.kv_heads % m == 0
    assert ("heads" in serving.rules.contract_axes) == both
    assert not serving.rules.whole_kv


def test_six_reference_configs_split_their_queries_over_whole_kv():
    whole = []
    for arch in ARCHS:
        cfg = get_config(arch)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            if tp.train_plan(cfg, make_production_mesh()).rules.whole_kv:
                whole.append(arch)
    assert sorted(whole) == sorted([
        "yi-6b", "qwen2.5-3b", "granite-3-2b", "internvl2-2b",
        "recurrentgemma-9b", "dbrx-132b"])


@pytest.mark.parametrize("heads,kv,m,want", [
    (16, 2, 16, [(0, 1)] * 8 + [(1, 2)] * 8),     # qwen2.5-3b: 1 | 8
    (48, 8, 16, [(r * 3 // 6, r * 3 // 6 + 1) for r in range(16)]),
    (16, 16, 1, [(0, 16)]),                       # a world of one: all
    (8, 2, 2, [(0, 1), (1, 2)]),                  # whole groups
])
def test_kv_heads_of_a_rank(heads, kv, m, want):
    cfg = _cfg(heads, kv)
    got = [layers.kv_heads_of(cfg, TrainRules(model=m, model_rank=r,
                                              whole_kv=True), heads // m)
           for r in range(m)]
    assert got == want
    assert layers.kv_heads_of(cfg, TrainRules(model=m), heads // m) is None


def test_kv_heads_of_refuses_a_straddled_group():
    """12 query heads over 4 KV heads (groups of 3) at ``model`` 6: rank 1
    holds heads 2 and 3, the end of one group and the start of the
    next."""
    cfg = _cfg(12, 4)
    with pytest.raises(ValueError, match="straddle"):
        layers.kv_heads_of(cfg, TrainRules(model=6, model_rank=1,
                                           whole_kv=True), 2)


def _cfg(heads, kv):
    return dataclasses.replace(get_config("qwen2.5-3b"), num_heads=heads,
                               kv_heads=kv)
