"""Context-parallel training held to the JAX package, on the CPU over gloo:
the sequence split over ``model`` (``tp.train_plan(table={"seq":
"model"})``: the reference's ``Rules(mesh, {"seq": "model"})``), every
rank on its block of each row's sequence.

One spawned world of 2 ranks at (data 1, model 2) (``launch.mesh.
run_world``; the ranks are ``tests/torch_cp_ranks.py``, which imports no
jax) runs in a module fixture: the loss and every gradient leaf of all ten
archs' SMOKE configs (B 2, S 32) against JAX ``api.loss_fn``'s on the
whole batch, within rtol 1e-4 (loss and aux) and 1e-4 of each leaf's
largest JAX magnitude (``torch_train_cases.leaves_close``), and the
negative control below. Steps, data parallelism and checkpoints are in
``tests/test_torch_train_cp_steps.py``. A world of 1 gloo rank takes
every context-parallel hook over one rank (a copy): two steps and a
prefill equal the plain path's bit for bit.

The control: under context parallelism a leaf gathered over ``model``
must reduce-scatter its gradient with a sum. A gather whose backward
takes the rank's part with no sum (right without a sequence split, where
every rank computed the same whole gradient) hands each rank its own
tokens' share: on a sequence of one repeated row under a read-out that
weighs every position alike, exactly 1/M of a weight's gradient where
that gradient sums over the queries.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")     # held against the JAX package

from torch.utils import _pytree as pytree  # noqa: E402

import torch_cp_ranks as ranks  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.launch.mesh import run_world  # noqa: E402
from torch_train_cases import (batch, jax_loss_and_grads,  # noqa: E402,F401
                               leaves_close, one_thread, pair, results)
from torch_train_ranks import cfg_of  # noqa: E402

B, S = 2, 32


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """The directory of the ranks' inputs."""
    d = tmp_path_factory.mktemp("train_cp")
    grads = {}
    for arch in ARCHS:
        _, tc, _, tp = pair(arch)
        grads[arch] = {"cfg": tc, "params": tp, "batch": batch(tc, B, S)}
    rng = np.random.default_rng(1)
    cfg = cfg_of("qwen2.5-3b")
    row = rng.standard_normal((1, 1, cfg.d_model)).astype(np.float32)
    control = {"block": pair("qwen2.5-3b")[3]["blocks"][0],
               "x": torch.from_numpy(np.repeat(row, 16, 1).repeat(2, 0)),
               "w": torch.from_numpy(rng.standard_normal(
                   (1, 1, cfg.d_model)).astype(np.float32))}
    torch.save({"grads": grads, "control": control}, d / "inputs.pt")
    return d


@pytest.fixture(scope="module")
def world2(bundle):
    return run_world(ranks.run_scenarios, 2, backend="gloo",
                     init_file=str(bundle / "rendezvous"),
                     args=(str(bundle / "inputs.pt"), str(bundle),
                           ("grads", "gather_control")), timeout=300)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_of_every_arch_equal_jax(world2, arch):
    """Each rank's loss is the whole sequence's (the label losses and
    counts summed over the ranks), and its gradients, made the step's and
    gathered, are JAX's: attention over the gathered keys at the rank's
    query offset, the mixers' whole scans, the MoE's capacity ranks over
    whole dispatch groups, the vlm's frontend rows and the encoder's."""
    res = results(world2, "grads")
    jc, tc, jp, _ = pair(arch)
    jl, jaux, jg = jax_loss_and_grads(jc, jp, batch(jc, B, S))
    for r in res:
        loss, aux, _ = r[arch]
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
        for k in aux:
            np.testing.assert_allclose(float(aux[k]), float(jaux[k]),
                                       rtol=1e-4, atol=1e-7)
    leaves_close(tc, res[0][arch][2], jg)
    assert res[1][arch][2] is None          # gathered on the first rank
    assert all(w["jax_loaded"] == [] for w in world2)


def _flat(tree):
    return {pytree.keystr(p): t for p, t in
            pytree.tree_flatten_with_path(tree)[0]}


def test_model_gather_without_a_sum_gives_1_over_m(world2):
    """The plan's gathers sum their gradient over the ranks: each rank's
    part of every leaf is its part of the whole block's gradient. A
    gather that takes the rank's part with no sum gives each rank its own
    tokens' share: on the repeated row, every query's output and
    gradient are alike, so the out-projection's and the MLP's weights,
    whose gradients are sums over the queries, get exactly 1/M of theirs
    (M = 2); the value projection's, a sum over keys that later rows see
    more of, gets another share, also wrong. The leaves ``model`` does not
    split (the norms, which the step sums) get the whole gradient."""
    res = results(world2, "gather_control")
    whole = _flat(res[0]["whole"])
    spec = {pytree.keystr(p): s for p, s in pytree.tree_flatten_with_path(
        res[0]["specs"], is_leaf=lambda x: isinstance(x, tuple))[0]}
    use = {pytree.keystr(p): s for p, s in pytree.tree_flatten_with_path(
        res[0]["uses"], is_leaf=lambda x: isinstance(x, tuple))[0]}
    gathered = {k for k, s in use.items() if "model" in s}
    by_query = {"['attn']['wo']", "['mlp']['wi']", "['mlp']['wg']",
                "['mlp']['wo']"}
    by_key = {"['attn']['wv']", "['attn']['bv']"}
    assert by_query | by_key <= gathered
    for key, want in whole.items():
        parts = {which: [_flat(r[which])[key] for r in res]
                 for which in ("shard", "nosum")}
        got = {which: torch.cat(p, spec[key].index("model"))
               if "model" in spec[key] else p[0]
               for which, p in parts.items()}
        torch.testing.assert_close(got["shard"], want, atol=2e-5, rtol=2e-5)
        if key in by_query:
            torch.testing.assert_close(got["nosum"], want / 2, atol=2e-5,
                                       rtol=2e-5)
            assert want.abs().max().item() > 1e-2
        elif key in by_key:
            assert (got["nosum"] - want).abs().max().item() \
                > 0.1 * want.abs().max().item()
        elif key not in gathered:
            torch.testing.assert_close(got["nosum"], want, atol=2e-5,
                                       rtol=2e-5)


ONE = ("qwen2.5-3b", "mamba2-2.7b", "dbrx-132b", "recurrentgemma-9b")


def world_of_one(rank, archs):
    import torch.distributed as dist
    return {a: ranks.forced_cp_steps(a, dist.group.WORLD, "cpu")
            for a in archs}


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    d = tmp_path_factory.mktemp("cp_world_of_one")
    return run_world(world_of_one, 1, backend="gloo",
                     init_file=str(d / "rendezvous"), args=(ONE,),
                     timeout=300)[0]


@pytest.mark.parametrize("arch", ONE)
def test_every_cp_hook_over_a_world_of_one_equals_the_plain_path(world1,
                                                                 arch):
    """``torch_cp_ranks.forced_cp_rules`` over one gloo rank: the sequence's
    gathers and their summing reduce-scatters, every leaf's gathers
    (a (data 2, model 4) plan's), the loss's and the step's sums, the
    MoE's dispatch scatter and expert gather, the lanes' owner write and
    the merge. 2 fp32 SMOKE steps give the plain step's losses and state
    bit for bit, the prefill its logits bit for bit; 4 greedy decode
    steps (plain attention merged, where the plain path runs the kernel's
    plain version) its tokens, logits within 1e-5 of their scale."""
    losses, equal, prefill_equal, (ta, tc), err, colls = world1[arch]
    assert all(a == b for a, b in losses) and equal
    assert prefill_equal and ta == tc and err <= 1e-5
    assert colls["reduce-scatter:model"] > 0 and colls["all-reduce:model"] > 0
