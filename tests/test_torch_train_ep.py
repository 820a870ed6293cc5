"""Expert-parallel training at the reference's layout, held to the JAX
package's single-device trainer and to the port's whole MoE block, on the
CPU over gloo: dbrx-132b SMOKE (4 experts) with its experts split over
``model`` (a rank runs 2 of them and the combine sums the ranks' outputs),
its router split and gathered at its use, every ``wembed`` dim over
``data``.

Two spawned worlds (``launch.mesh.run_world``; the ranks are
``tests/torch_layout_ranks.py``): one of 2 ranks at (data 1, model 2) runs
the block, whole against shard by shard, and three steps; one of 4 ranks
at (2, 2) three steps with ``grad_accum`` 2, each replica's micro-batch
its half of the global one. Steps start from ``convert.state_from_jax``
and are held to JAX's on the whole batch
(``torch_train_cases.steps_track_jax``: metrics within rtol 1e-4,
parameters within 2 · lr a step); the block at atol = rtol = 2e-5.
"""
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")     # held against the JAX package

from torch.utils import _pytree as pytree  # noqa: E402

import torch_layout_ranks as ranks  # noqa: E402
from repro_torch.launch.mesh import run_world  # noqa: E402
from torch_train_cases import (jax_train, results,  # noqa: E402
                               steps_track_jax)
from torch_train_ranks import OPT  # noqa: E402

WORLDS = {2: ("moe_block", "dbrx_1x2"), 4: ("dbrx_2x2_accum2",)}
F32 = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """(directory, JAX runs by case name)."""
    d = tmp_path_factory.mktemp("train_ep")
    runs = {}
    for name in ("dbrx_1x2", "dbrx_2x2_accum2"):
        arch, _, accum, compress = ranks.CASES[name]
        runs[name] = jax_train(arch, accum, compress, OPT)
    torch.save({"states": {n: r["state"] for n, r in runs.items()},
                "batches": {n: r["batches"] for n, r in runs.items()}},
               d / "inputs.pt")
    return d, runs


def _world(bundle, n):
    d = bundle[0]
    return run_world(ranks.run_scenarios, n, backend="gloo",
                     init_file=str(d / f"rendezvous{n}"),
                     args=(str(d / "inputs.pt"), str(d / "ckpt"),
                           WORLDS[n]), timeout=300)


@pytest.fixture(scope="module")
def world2(bundle):
    return _world(bundle, 2)


@pytest.fixture(scope="module")
def world4(bundle):
    return _world(bundle, 4)


def _flat(tree):
    return {pytree.keystr(p): t for p, t in
            pytree.tree_flatten_with_path(tree)[0]}


def _specs(tree):
    return {pytree.keystr(p): s for p, s in pytree.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, tuple))[0]}


def test_moe_block_shards_equal_the_whole_block(world2):
    """Each rank's output is the whole block's, each leaf's gradient its
    part of the whole's (the experts' and the router's split over
    ``model``), and the input's whole on every rank. The contraction
    through ``torch.distributed.nn.functional.all_reduce`` (its backward
    sums a gradient that is the same on every rank) hands every expert
    weight twice its gradient."""
    res = results(world2, "moe_block")
    assert res[0]["contract"] == ["experts", "heads", "vocab"]
    spec = _specs(res[0]["specs"])
    assert spec["['moe']['wi']"] == ("model",)
    assert spec["['moe']['router']"] == (None, "model")
    whole = _flat(res[0]["whole"][1])
    for r in res:
        torch.testing.assert_close(r["shard"][0], res[0]["whole"][0], **F32)
        torch.testing.assert_close(r["shard"][2][0], res[0]["whole"][2][0],
                                   **F32)
    for key, want in whole.items():
        for which, ratio in (("shard", 1.0), ("naive", 2.0)):
            parts = [_flat(r[which][1])[key] for r in res]
            got = torch.cat(parts, spec[key].index("model")) \
                if "model" in spec[key] else parts[0]
            if which == "naive" and not key.startswith("['moe']['w"):
                continue
            torch.testing.assert_close(got, ratio * want, **F32)


@pytest.mark.parametrize("n,name", [(2, "dbrx_1x2"), (4, "dbrx_2x2_accum2")])
def test_expert_parallel_steps_track_jax(world2, world4, bundle, n, name):
    res = results({2: world2, 4: world4}[n], name)
    _, (d, m), _, _ = ranks.CASES[name]
    assert res[0]["contract"] == ["experts", "heads", "vocab"]
    assert [r["data"] for r in res] == [d] * n
    for r in res[1:]:                # every rank's losses are equal
        assert r["metrics"] == res[0]["metrics"]
        assert r["params"] is None
    for step in res[0]["collectives"]:
        assert step["all-gather:model"] > 0         # the routers
        assert (step.get("reduce-scatter:data", 0) > 0) == (d > 1)
    steps_track_jax(res[0]["metrics"], res[0]["params"], bundle[1][name])
    assert all(w["jax_loaded"] == [] for w in world2)
