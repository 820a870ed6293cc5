"""Training at the reference's layout, held to the JAX package's
single-device trainer, on the CPU over gloo: every ``wembed`` dim split
over ``data`` (FSDP, gathered at its use, its gradient reduce-scattered),
the heads, ffn and vocab dims over ``model`` (computed in parallel where
the port does, else gathered at their use).

One spawned world of 4 ranks (``launch.mesh.run_world``; the ranks are
``tests/torch_layout_ranks.py``, which imports no jax) runs every
scenario once, each on its own ``(data, model)`` fold, in a module
fixture:

* three steps from ``convert.state_from_jax`` against JAX's steps on the
  whole batch: qwen2.5-3b SMOKE at (2, 2), (4, 1) and (1, 4) (4 query
  heads over 4 ranks, one a rank, its 2 KV heads whole on every rank),
  granite-3-2b (tied embeddings: one vocab shard for the lookup and the
  head) and mamba2-2.7b (its mixer over its heads, ``in_proj``'s product
  gathered over ``model``) at (2, 2), and ``compress_grads`` at (2, 2);
* a checkpoint saved at (2, 2), restored at (4, 1) in the world and at
  (1, 1) in this process, with equal leaves, the losses continuing;
* the control: a model gather (dbrx-132b SMOKE's MoE router at (1, 4))
  whose backward sums the gradient over the group hands each rank M times
  its part.

Bounds (``torch_train_cases.steps_track_jax``): the step's metrics
within rtol 1e-4 of JAX's; parameters after three steps each within 2 ·
lr a step of JAX's, at most 1e-3 of the elements more than 1e-5 apart.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")     # held against the JAX package

from torch.utils import _pytree as pytree  # noqa: E402

import torch_layout_ranks as ranks  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.launch.mesh import run_world  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from torch_train_cases import (jax_train, results,  # noqa: E402
                               steps_track_jax)
from torch_train_ranks import OPT, RESUME_AT, _trainer, _losses  # noqa: E402

TRAIN = ("qwen_2x2", "qwen_4x1", "qwen_1x4", "granite_2x2", "mamba2_2x2",
         "compress_2x2")
SCENARIOS = TRAIN + ("ckpt_save_2x2", "ckpt_restore_4x1",
                     "model_gather_control")


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """(directory, JAX runs by case name)."""
    d = tmp_path_factory.mktemp("train_fsdp")
    runs, by_key = {}, {}
    for name in TRAIN:
        arch, _, accum, compress = ranks.CASES[name]
        key = (arch, accum, compress)
        if key not in by_key:
            by_key[key] = jax_train(arch, accum, compress, OPT)
        runs[name] = by_key[key]
    torch.save({"states": {n: r["state"] for n, r in runs.items()},
                "batches": {n: r["batches"] for n, r in runs.items()}},
               d / "inputs.pt")
    return d, runs


@pytest.fixture(scope="module")
def world(bundle):
    d = bundle[0]
    return run_world(ranks.run_scenarios, 4, backend="gloo",
                     init_file=str(d / "rendezvous"),
                     args=(str(d / "inputs.pt"), str(d / "ckpt"),
                           SCENARIOS), timeout=300)


# the plan's contractions of each case: qwen2.5-3b SMOKE's 4 query heads
# split over 2 and 4 ranks (its 2 KV heads over 2 but not 4); mamba2's
# mixer computes over its heads' parts
CONTRACT = {"qwen_2x2": ["ffn", "heads", "vocab"], "qwen_4x1": [],
            "qwen_1x4": ["ffn", "heads", "vocab"],
            "granite_2x2": ["ffn", "heads", "vocab"],
            "mamba2_2x2": ["ssm", "vocab"],
            "compress_2x2": ["ffn", "heads", "vocab"]}


@pytest.mark.parametrize("name", TRAIN)
def test_steps_track_jax(world, bundle, name):
    res = results(world, name)
    assert res[0]["contract"] == CONTRACT[name]
    _, (d, m), _, _ = ranks.CASES[name]
    assert [r["data"] for r in res] == [d] * 4
    assert [r["rows"] for r in res] == [8 // d] * 4
    for r in res[1:]:                # the ranks step in lockstep
        assert r["metrics"] == res[0]["metrics"]
        assert r["params"] is None   # gathered on the first rank only
    steps_track_jax(res[0]["metrics"], res[0]["params"], bundle[1][name])
    assert all(w["jax_loaded"] == [] for w in world)


@pytest.mark.parametrize("name", TRAIN)
def test_collectives_cross_the_split_axes(world, name):
    """Each step gathers over ``data`` exactly when the layout splits
    ``wembed`` over it (and then reduce-scatters a gradient for every
    gather of the forward), and gathers over ``model`` exactly where the
    plan's ``uses`` gather a split dim whose use is replicated, or where
    mamba2's mixer gathers its split ``in_proj``'s product (whose
    gradient it then reduce-scatters over ``model``)."""
    res = results(world, name)
    _, (d, m), _, _ = ranks.CASES[name]
    gathered = any("model" in spec for spec in pytree.tree_leaves(
        res[0]["uses"], is_leaf=lambda x: isinstance(x, tuple)))
    mixer = "ssm" in res[0]["contract"]
    assert not gathered      # no split leaf is gathered over model here
    for step in res[0]["collectives"]:
        assert (step.get("all-gather:data", 0) > 0) == (d > 1)
        assert (step.get("reduce-scatter:data", 0) > 0) == (d > 1)
        assert (step.get("all-gather:model", 0) > 0) == (gathered or mixer)
        assert ("reduce-scatter:model" in step) == mixer
    assert all(r["collectives"] == res[0]["collectives"] for r in res)


def test_checkpoint_at_2x2_restores_at_4x1_and_1x1(world, bundle):
    """4 steps at (2, 2), saved: restored at (4, 1) and in this process at
    (1, 1) the leaves are the saved ones bit for bit; 4 more steps at (4,
    1) and at (1, 1) give the losses of an uninterrupted run at (2, 2)."""
    saved = results(world, "ckpt_save_2x2")
    whole = saved[0]["whole"]
    assert saved[0]["split"] > 0
    for r in saved:
        np.testing.assert_allclose(r["cut"], whole[:RESUME_AT], rtol=1e-4)
    path = ckpt.latest_step_dir(str(bundle[0] / "ckpt" / "fsdp"))
    tr = _trainer(None, str(bundle[0] / "ckpt" / "fsdp"), [])
    assert tr.step == RESUME_AT
    full, _ = ckpt.restore(path, tr.state)
    back = results(world, "ckpt_restore_4x1")
    assert back[0]["shape"] == {"data": 4, "model": 1}
    a = pytree.tree_flatten_with_path(back[0]["restored"])[0]
    b = dict(pytree.tree_flatten_with_path(full["params"])[0])
    assert len(a) == len(b)
    assert all(torch.equal(t, b[p]) for p, t in a)
    for r in back:
        assert r["resumed_at"] == RESUME_AT
        np.testing.assert_allclose(r["losses"], whole[RESUME_AT:],
                                   rtol=1e-4)
    tr.run(len(whole) - RESUME_AT)
    np.testing.assert_allclose(_losses(tr), whole[RESUME_AT:], rtol=1e-4)


def _flat(tree):
    return {pytree.keystr(p): t for p, t in
            pytree.tree_flatten_with_path(tree)[0]}


def test_model_gather_backward_is_the_part_and_a_sum_is_m_times(world):
    """dbrx-132b SMOKE's MoE block at (1, 4): its router computes
    replicated on every rank, split over ``model`` and gathered at its
    use: each rank's gradient is its part of the whole block's, every
    leaf; a backward that sums over the group hands each rank 4 times its
    part on the gathered leaf, and the right gradient on the rest."""
    res = results(world, "model_gather_control")
    m = len(res)
    whole = _flat(res[0]["whole"])
    spec = {pytree.keystr(p): s for p, s in pytree.tree_flatten_with_path(
        res[0]["specs"], is_leaf=lambda x: isinstance(x, tuple))[0]}
    use = {pytree.keystr(p): s for p, s in pytree.tree_flatten_with_path(
        res[0]["uses"], is_leaf=lambda x: isinstance(x, tuple))[0]}
    gathered = {k for k, s in use.items() if "model" in s}
    assert gathered == {"['moe']['router']"}
    for key, want in whole.items():
        for which in ("shard", "summed"):
            parts = [_flat(r[which])[key] for r in res]
            got = torch.cat(parts, spec[key].index("model")) \
                if "model" in spec[key] else parts[0]
            ratio = float(m) if which == "summed" and key in gathered \
                else 1.0
            torch.testing.assert_close(got, ratio * want, atol=2e-5,
                                       rtol=2e-5)


ONE = [(a, c) for a in ("qwen2.5-3b", "dbrx-132b", "granite-3-2b")
       for c in (False, True)]


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    d = tmp_path_factory.mktemp("world_of_one")
    return run_world(ranks.world_of_one, 1, backend="gloo",
                     init_file=str(d / "rendezvous"), args=(ONE,),
                     timeout=120)[0]


@pytest.mark.parametrize("arch,compress", ONE)
def test_every_hook_over_a_world_of_one_equals_the_plain_step(
        world1, arch, compress):
    """The gathers (data, and model: dbrx's router), their backward
    reduce-scatters and parts, the heads, ffn, vocab and experts
    contractions, and the KV
    heads read in part (``whole_kv``: their slice and their leaves'
    gradient sum), each over a world of one gloo rank (a copy): 2 fp32
    SMOKE steps equal the plain step's losses and state bit for bit, the
    vocab-parallel loss and lookup, the expert-parallel combine and the
    tied embeddings included. A step sums 6 times a dense layer (heads and
    ffn: 2 forward, 2 backward, the attention's again in the recompute,
    and the KV leaves' gradients), 7 times an MoE layer (the attention's
    4; the combine's sum, and in backward its expert rows' and gate
    weights' gradient sums) and 6 times for the vocab."""
    losses, equal, reduces, colls = world1[arch, compress]
    assert all(a == b for a, b in losses) and equal
    cfg = ranks.cfg_of(arch)
    per_layer = [7 if k == "attn_moe" else 6 for k in tfm.layer_kinds(cfg)]
    assert reduces == 2 * (sum(per_layer) + 6)
    assert colls["all-gather:data"] > 0
    assert colls["reduce-scatter:data"] > 0
    # a (2, 4) plan gathers only dbrx's MoE router over model: every other
    # split computes in parallel
    assert (colls.get("all-gather:model", 0) > 0) == (arch == "dbrx-132b")
