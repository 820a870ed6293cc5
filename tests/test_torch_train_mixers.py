"""The recurrent mixers computed in parallel over ``model`` in training
(``tp.train_plan``: griffin's RG-LRU over its ``lru_dim`` channels,
contract axis "rglru"; mamba2's mixer over its heads, "ssm"), held to the
JAX package's single-device trainer on the CPU over gloo.

A rank of griffin's RG-LRU computes its r / m channels: its parts of
``proj_x`` / ``proj_y`` / ``proj_out`` / ``lam``; ``gate_a`` / ``gate_x``'s
partial sums reduce-scattered to its columns; the conv and the gate biases
(whole) at its columns, their gradients summed (``rules.partial``). A rank
of mamba2's mixer computes its nheads / m heads: ``in_proj``'s product
gathered whole along its columns where they split (or ``in_proj`` used
whole where they do not), the whole B and C, the conv at its channels, the
norm's mean square summed over the ranks both ways.

One spawned world of 4 ranks (``tests/torch_heads_ranks.py``, which
imports no jax) runs, in a module fixture:

* three steps from ``convert.state_from_jax`` against JAX's on the whole
  batch, within ``torch_train_cases.steps_track_jax``'s bounds (the
  metrics within rtol 1e-4; parameters within 2 · lr a step, at most 1e-3
  of the elements more than 1e-5 apart): recurrentgemma SMOKE at (1, 4) (4
  query heads over 4 ranks, its one KV head whole; ``lru_dim`` 64 over 4),
  mamba2 SMOKE at (2, 2) (``in_proj``'s 292 columns split, 146 a rank) and
  at (1, 4) (73 a rank, not aligned to its 32-channel heads), and mamba2
  SMOKE with 15 state dims at (1, 4) (290 columns do not divide 4:
  ``in_proj`` whole on every rank, its heads and ``out_proj`` split);
* no leaf gathered over ``model``: a step's collectives over ``model`` are
  the sums and the mixers' own activation moves, counted;
* at each (1, 4) case the loss's gradient at the JAX package's parameters:
  every leaf within ``torch_train_cases``' gradient bounds of JAX's; the
  control, whose ``partial`` sums nothing, parts from JAX's on every rank
  on exactly the whole leaves used in part, whose four shares add up to
  JAX's.

And a world of one gloo rank whose rules force every hook (the mixers'
reduce-scatter, gathers and norm sum, the KV heads read in part): 2 fp32
SMOKE steps of each mixer stack equal the plain step's bit for bit. And
the repair of mamba2's SSD scan over long chunks, whose gradient was NaN
(as the reference's is).
"""
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")     # held against the JAX package

from torch.utils import _pytree as pytree  # noqa: E402

import torch_heads_ranks as ranks  # noqa: E402
import torch_layout_ranks  # noqa: E402
from repro_torch.launch.mesh import run_world  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from torch_train_cases import (batch, grads_against_jax, jax_train,  # noqa: E402,E501
                               results, steps_track_jax)
from torch_train_ranks import OPT  # noqa: E402

TRAIN = ("rgemma_1x4", "mamba2_2x2", "mamba2_1x4", "mamba2_odd_1x4")
GRADS = ("rgemma_1x4", "mamba2_1x4", "mamba2_odd_1x4")
CONTRACT = {"rgemma_1x4": ["ffn", "heads", "rglru", "vocab"],
            "mamba2_2x2": ["ssm", "vocab"], "mamba2_1x4": ["ssm", "vocab"],
            "mamba2_odd_1x4": ["ssm", "vocab"]}
# the whole leaves each case uses in part (keystr endings)
PARTIAL = {"rgemma_1x4": ("['conv_w']", "['conv_b']", "['gate_a_b']",
                          "['gate_x_b']", "['wk']", "['wv']"),
           "mamba2_1x4": ("['conv_w']", "['conv_b']", "['norm']['scale']"),
           "mamba2_odd_1x4": ("['conv_w']", "['conv_b']",
                              "['norm']['scale']", "['in_proj']")}


def moves(name):
    """(all-gathers, reduce-scatters) over ``model`` a step. RG-LRU: the
    gates' reduce-scatter in forward and in the recompute of the remat'd
    period's rglru layers, its all-gather in backward. mamba2 with a split
    ``in_proj``: the product's gather in forward and recompute (every layer
    is a remat'd period), its reduce-scatter in backward; none where
    ``in_proj`` is whole."""
    arch = ranks.CASES[name][0]
    cfg = ranks.cfg_of(arch, **ranks.case_over(name))
    kinds = tfm.layer_kinds(cfg)
    n_super, _ = tfm.layer_plan(cfg)
    period = len(tfm.pattern_for(cfg))
    remat = kinds[:n_super * period]
    if arch == "recurrentgemma-9b":
        return kinds.count("rglru"), kinds.count("rglru") + remat.count(
            "rglru")
    if name == "mamba2_odd_1x4":
        return 0, 0
    return len(kinds) + len(remat), len(kinds)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """(directory, JAX runs by case, gradient batches by case)."""
    d = tmp_path_factory.mktemp("train_mixers")
    runs, by_key, grads = {}, {}, {}
    for name in TRAIN:
        arch, over = ranks.CASES[name][0], ranks.case_over(name)
        key = (arch, tuple(sorted(over.items())))
        if key not in by_key:
            by_key[key] = jax_train(arch, 1, False, OPT, **over)
        runs[name] = by_key[key]
    for name in GRADS:
        grads[name] = batch(ranks.cfg_of(ranks.CASES[name][0]), 2, 32)
    torch.save({"states": {n: r["state"] for n, r in runs.items()},
                "batches": {n: r["batches"] for n, r in runs.items()},
                "params": {n: runs[n]["state"]["params"] for n in GRADS},
                "batch": grads}, d / "inputs.pt")
    return d, runs, grads


@pytest.fixture(scope="module")
def world(bundle):
    d = bundle[0]
    names = tuple(f"train_{n}" for n in TRAIN) + tuple(
        f"grads_{n}" for n in GRADS)
    return run_world(ranks.run_scenarios, 4, backend="gloo",
                     init_file=str(d / "rendezvous"),
                     args=(str(d / "inputs.pt"), names), timeout=300)


@pytest.mark.parametrize("name", TRAIN)
def test_steps_track_jax(world, bundle, name):
    res = results(world, f"train_{name}")
    assert res[0]["contract"] == CONTRACT[name]
    assert res[0]["whole_kv"] == (name == "rgemma_1x4")
    _, (d, m), _ = ranks.CASES[name]
    assert [r["data"] for r in res] == [d] * 4
    for r in res[1:]:                # the ranks step in lockstep
        assert r["metrics"] == res[0]["metrics"]
        assert r["params"] is None   # gathered on the first rank only
    steps_track_jax(res[0]["metrics"], res[0]["params"], bundle[1][name])
    assert all(w["jax_loaded"] == [] for w in world)


@pytest.mark.parametrize("name", TRAIN)
def test_no_leaf_is_gathered_over_model(world, name):
    res = results(world, f"train_{name}")
    specs = pytree.tree_leaves(res[0]["uses"],
                               is_leaf=lambda x: isinstance(x, tuple))
    assert specs and not any("model" in s for s in specs)
    gathers, scatters = moves(name)
    for r in res:
        for step in r["collectives"]:
            assert step.get("all-gather:model", 0) == gathers
            assert step.get("reduce-scatter:model", 0) == scatters
            assert step["all-reduce:model"] > 0


@pytest.mark.parametrize("name", GRADS)
def test_gradients_equal_jax_and_the_control_is_a_share(world, bundle,
                                                         name):
    res = results(world, f"grads_{name}")
    arch = ranks.CASES[name][0]
    hit = grads_against_jax(res, arch, bundle[2][name], PARTIAL[name],
                            **ranks.case_over(name))
    kinds = tfm.layer_kinds(ranks.cfg_of(arch))
    mixer = 4 if arch == "recurrentgemma-9b" else len(PARTIAL[name])
    want = mixer * sum(k in ("rglru", "ssm") for k in kinds) \
        + 2 * kinds.count("local_attn")
    assert len(hit) == want


# ---------------------------------------------------------------------------
# every hook over a world of one rank
# ---------------------------------------------------------------------------

ONE = [("recurrentgemma-9b", False), ("mamba2-2.7b", False)]


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    d = tmp_path_factory.mktemp("mixers_world_of_one")
    return run_world(torch_layout_ranks.world_of_one, 1, backend="gloo",
                     init_file=str(d / "rendezvous"), args=(ONE,),
                     timeout=120)[0]


@pytest.mark.parametrize("arch,compress", ONE)
def test_every_hook_over_a_world_of_one_equals_the_plain_step(
        world1, arch, compress):
    """The mixers' hooks forced over a world of one gloo rank (a copy):
    RG-LRU's reduce-scatter (an all-gather in backward) and its whole
    leaves' gradient sum, the local attention's KV heads read in part;
    mamba2's ``in_proj`` product gathered (a reduce-scatter in backward),
    its norm's sum both ways and its whole leaves' gradient sum: 2 fp32
    SMOKE steps equal the plain step's losses and state bit for bit."""
    losses, equal, reduces, colls = world1[arch, compress]
    assert all(a == b for a, b in losses) and equal
    assert reduces > 0
    assert colls["all-gather:model"] > 0
    assert colls["reduce-scatter:model"] > 0


# ---------------------------------------------------------------------------
# the repair: mamba2's long chunks have finite gradients
# ---------------------------------------------------------------------------


def test_mamba2_long_chunks_have_finite_gradients():
    """mamba2's configs chunk the SSD scan by 256 (SMOKE by 8). Over a
    long chunk the decays above the diagonal overflow to inf; the
    reference masks them after their exp, so its gradient is NaN from 64
    tokens on (a reference-side fact), and the port's was. The port masks
    them first: at chunk 256 and 64 tokens its loss equals JAX's, and its
    gradient, finite, equals JAX's at chunk 8 (the chunked scan is exact
    at any chunk) within the gradient bounds."""
    import dataclasses

    import jax
    import numpy as np

    from repro_torch.configs import get_smoke_config
    from repro_torch.runtime.trainer import loss_and_grads
    from torch_train_cases import (LOSS_RTOL, jax_loss_and_grads, leaves_close,
                                   pair, torch_batch)
    long = dataclasses.replace(get_smoke_config("mamba2-2.7b").ssm,
                               chunk=256)
    jc, tc, jp, tp = pair("mamba2-2.7b", ssm=long)
    b = batch(jc, 2, 64)
    jl, _, jg = jax_loss_and_grads(jc, jp, b)
    assert any(np.isnan(np.asarray(g)).any() for g in jax.tree.leaves(jg))
    loss, _, grads = loss_and_grads(tc, tp, torch_batch(b))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    assert not any(g.isnan().any() for g in pytree.tree_leaves(grads))
    jc8, _, jp8, _ = pair("mamba2-2.7b")
    _, _, jg8 = jax_loss_and_grads(jc8, jp8, b)
    leaves_close(tc, grads, jg8)
