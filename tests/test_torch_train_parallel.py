"""Model-parallel training of the port, held to the JAX package's
single-device trainer (the contract of the reference's ``rules=`` with a
mesh) and to the port's own whole layers, on the CPU over gloo.

Spawned worlds of 2 and 4 ranks (``launch.mesh.run_world``; the ranks are
``tests/torch_train_ranks.py``, which imports no jax and reads its inputs
from a ``torch.save`` file) each run all their scenarios once, in a module
fixture, and each test asserts on one scenario's result on every rank:

* one block, whole against shard by shard (``TrainRules``' two sums): the
  output and every gradient, sharded leaves gathered, replicated leaves
  and the inputs on every rank; the contraction through
  ``torch.distributed.nn.functional.all_reduce`` must get the
  out-projection's gradient M times too large;
* three steps (plain, ``grad_accum=4``, ``compress_grads``; at 2 ranks also
  recurrentgemma-9b, whose one KV head is whole on every rank and whose
  RG-LRU runs over its channels' parts, and dbrx-132b, whose MoE runs
  expert-parallel, also with ``grad_accum=2``) from
  ``convert.state_from_jax``
  against JAX's steps, and the all-reduces of a step;
* ``compressed_psum`` bit for bit against the reference's under
  ``jax.vmap``; ``gpipe`` against the sequential stack;
* the launcher's ``--model-parallel``.

Data parallelism and checkpoints across meshes are
``tests/test_torch_train_parallel_dp.py``'s.

Bounds: layers at atol = rtol = 2e-5 (the same fp32 products, summed in
another order); losses and the step's metrics within rtol 1e-4 of JAX's;
parameters after three steps each within 2 · lr a step of JAX's, at most
1e-3 of the elements more than 1e-5 apart
(``tests/test_torch_train_loop.py``'s bound).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")     # held against the JAX package

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

import torch_train_ranks as ranks  # noqa: E402
from repro.parallel import compression as jcomp  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import run_world  # noqa: E402
from repro_torch.parallel.pipeline import bubble_fraction  # noqa: E402
from torch_train_cases import jax_train, results  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
F32 = dict(atol=2e-5, rtol=2e-5)
WORLD_SCENARIOS = {
    2: ("block_attn_mlp", "block_dec",
        *(f"train_{n}" for n in ranks.TRAIN_CASES)),
    4: ("block_attn_mlp", "block_dec", "psum", "gpipe",
        "train_plain", "train_accum4", "train_compress"),
}
GPIPE = dict(S=4, M=8, mb=2, d=8)


# ---------------------------------------------------------------------------
# the JAX side, the ranks' inputs, the worlds
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """(directory, JAX runs by case, the ranks' inputs)."""
    d = tmp_path_factory.mktemp("train_parallel")
    runs = {name: jax_train(*ranks.TRAIN_CASES[name], ranks.OPT)
            for name in ranks.TRAIN_CASES}
    rng = np.random.default_rng(7)
    g = GPIPE
    inputs = {
        "states": {n: r["state"] for n, r in runs.items()},
        "batches": {n: r["batches"] for n, r in runs.items()},
        # four ranks' values at scales 10^-1..10^2, so the shared scale
        # comes from one rank
        "psum": torch.from_numpy((rng.standard_normal((4, 3, 5, 7))
                                  * 10.0 ** np.arange(-1, 3)[:, None, None,
                                                             None]
                                  ).astype(np.float32)),
        "gpipe": {k: torch.from_numpy(v) for k, v in {
            "w": (rng.standard_normal((g["S"], g["d"], g["d"])) * 0.5
                  ).astype(np.float32),
            "b": (rng.standard_normal((g["S"], g["d"])) * 0.1
                  ).astype(np.float32),
            "xs": rng.standard_normal((g["M"], g["mb"], g["d"])
                                      ).astype(np.float32)}.items()},
    }
    torch.save(inputs, d / "inputs.pt")
    return d, runs, inputs


def _world(bundle, n):
    d = bundle[0]
    return run_world(ranks.run_scenarios, n, backend="gloo",
                     init_file=str(d / f"rendezvous{n}"),
                     args=(str(d / "inputs.pt"), str(d / "ckpt"),
                           WORLD_SCENARIOS[n]), timeout=300)


@pytest.fixture(scope="module")
def world2(bundle):
    return _world(bundle, 2)


@pytest.fixture(scope="module")
def world4(bundle):
    return _world(bundle, 4)


@pytest.fixture
def worlds(world2, world4):
    return {2: world2, 4: world4}


# ---------------------------------------------------------------------------
# one block: whole against shard by shard
# ---------------------------------------------------------------------------


def _flat(tree):
    return {pytree.keystr(p): t for p, t in
            pytree.tree_flatten_with_path(tree)[0]}


def _spec_of(specs):
    """{keystr: spec} of a spec tree (dict leaves are tuples)."""
    out = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, prefix + f"[{k!r}]")
        else:
            out[prefix] = t
    walk(specs, "")
    return out


def _mismatches(res, which):
    """The leaves (and inputs) where ``which`` ("shard" or "naive") parts
    from the whole block, with the ratio of their largest magnitudes."""
    whole = _flat(res[0]["whole"][1])
    spec = _spec_of(res[0]["specs"])
    bad = {}
    for key, want in whole.items():
        parts = [_flat(r[which][1])[key] for r in res]
        if "model" in spec[key]:
            got = [torch.cat(parts, spec[key].index("model"))]
        else:
            got = parts                      # every rank holds it whole
        for g in got:
            if not torch.allclose(g, want, **F32):
                bad[key] = (g.abs().max() / want.abs().max()).item()
    for i, want in enumerate(res[0]["whole"][2]):
        for r in res:
            if not torch.allclose(r[which][2][i], want, **F32):
                bad[f"input {i}"] = (r[which][2][i].abs().max()
                                     / want.abs().max()).item()
    return bad


@pytest.mark.parametrize("block", ["attn_mlp", "dec"])
@pytest.mark.parametrize("n", [2, 4])
def test_block_shards_equal_the_whole_block(worlds, n, block):
    res = results(worlds[n], f"block_{block}")
    assert res[0]["contract"] == ["ffn", "heads", "vocab"]
    for r in res:
        torch.testing.assert_close(r["shard"][0], r["whole"][0], **F32)
    assert _mismatches(res, "shard") == {}
    # the all-reduce at the contraction alone (its backward sums the
    # gradient that is the same on every rank): the out- and
    # down-projections' gradients come out n times too large
    bad = _mismatches(res, "naive")
    for key in _flat(res[0]["whole"][1]):
        if key.endswith("['wo']"):
            assert bad[key] == pytest.approx(n, rel=1e-4), key
    assert all(w["jax_loaded"] == [] for w in worlds[n])


# ---------------------------------------------------------------------------
# three steps against the JAX trainer
# ---------------------------------------------------------------------------


# which sums each case's plan contracts at each world: qwen2.5-3b SMOKE's
# 4 query heads split over 2 and 4 ranks (its 2 KV heads over 2, not 4:
# they are then whole on every rank); recurrentgemma's query heads split,
# its one KV head never does, and its RG-LRU runs over its 64 channels'
# parts; an MoE stack runs its experts in parallel; every head is
# vocab-parallel
CONTRACT = {(2, "plain"): ["ffn", "heads", "vocab"],
            (4, "plain"): ["ffn", "heads", "vocab"],
            (2, "rgemma"): ["ffn", "heads", "rglru", "vocab"],
            (2, "dbrx"): ["experts", "heads", "vocab"],
            (2, "dbrx_accum2"): ["experts", "heads", "vocab"]}


@pytest.mark.parametrize("n,name", [(2, n) for n in ranks.TRAIN_CASES]
                         + [(4, "plain"), (4, "accum4"), (4, "compress")])
def test_train_steps_track_jax(worlds, bundle, n, name):
    res = results(worlds[n], f"train_{name}")
    want = bundle[1][name]
    arch = ranks.TRAIN_CASES[name][0]
    key = (n, name if arch != ranks.QWEN else "plain")
    assert res[0]["contract"] == CONTRACT[key]
    assert res[0]["n_sharded"] > 0
    for r in res[1:]:                # the ranks step in lockstep
        assert r["metrics"] == res[0]["metrics"]
        assert r["params"] is None   # gathered on the first rank only
    for got, jm in zip(res[0]["metrics"], want["metrics"]):
        assert set(got) == set(jm)
        for k in got:
            np.testing.assert_allclose(got[k], jm[k], rtol=1e-4)
    lrs = [m["lr"] for m in want["metrics"]]
    a = pytree.tree_leaves(res[0]["params"])
    b = pytree.tree_leaves(want["params"])
    assert len(a) == len(b)
    d = torch.cat([(x - y).abs().flatten() for x, y in zip(a, b)])
    assert d.max().item() <= 2 * sum(lrs)
    assert (d > 1e-5).float().mean().item() <= 1e-3


@pytest.mark.parametrize("n", [2, 4])
def test_all_reduces_a_step(worlds, n):
    """Per layer: each sharded sublayer's sum in forward and its input's in
    backward, and under remat "full" the recompute's sums up to the last
    tensor the backward saved: the attention's (its output feeds the second
    norm, whose input is saved), not the MLP's (the block's last op); at 4
    ranks, where the 2 KV heads are whole on every rank, the sum of their
    leaves' gradients. And a loss's vocab-parallel sums: the embedding
    lookup's, the loss input's gradient's, and the loss chunk's two in
    forward and again in its recompute. A micro-batch of ``grad_accum`` is
    a whole step's worth."""
    cfg = ranks.cfg_of(ranks.QWEN)
    assert cfg.remat == "full"
    for name, micro in (("plain", 1), ("accum4", 4)):
        res = results(worlds[n], f"train_{name}")
        contract = res[0]["contract"]
        assert res[0]["whole_kv"] == (n == 4)
        layer = [a for a in contract if a != "vocab"]
        per_layer = 2 * len(layer) + ("heads" in layer) \
            + res[0]["whole_kv"]
        vocab = 6 if "vocab" in contract else 0
        for r in res:
            assert r["reduces"] == [micro * (cfg.num_layers * per_layer
                                             + vocab)] * 3


# ---------------------------------------------------------------------------
# compressed_psum, gpipe
# ---------------------------------------------------------------------------


def test_compressed_psum_equals_jax_bit_for_bit(world4, bundle):
    xs = bundle[2]["psum"]
    want = np.asarray(jax.vmap(lambda x: jcomp.compressed_psum(x, "i"),
                               axis_name="i")(jnp.asarray(xs.numpy())))
    got = results(world4, "psum")
    for r, g in enumerate(got):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), want[r])


def test_gpipe_matches_the_sequential_stack(world4, bundle):
    pp = {k: jnp.asarray(v.numpy()) for k, v in bundle[2]["gpipe"].items()}
    want = pp["xs"]
    for s in range(GPIPE["S"]):
        want = jnp.tanh(want @ pp["w"][s] + pp["b"][s])
    for got in results(world4, "gpipe"):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    assert abs(bubble_fraction(8, 4) - 3 / 11) < 1e-9


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launch_train_model_parallel_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen2.5-3b", "--smoke", "--steps", "3", "--seq", "16",
         "--model-parallel", "2", "--device", "cpu"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    # rank 0 alone prints: the reference launcher's two lines
    lines = r.stdout.splitlines()
    assert len(lines) == 2, r.stdout
    assert lines[0].startswith("[launch.train] qwen2.5-smoke: 0.1M params")
    assert lines[0].endswith("model-parallel over 2 ranks")
    assert lines[1] == ("[launch.train] done at step 3; 0 straggler-flagged "
                        "steps")


def test_launch_train_model_parallel_needs_a_card_a_rank(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "qwen2.5-3b", "--smoke",
                           "--model-parallel", "2"])
    # one card for two ranks: refused, naming both counts, before any rank
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="needs 2 CUDA devices.*have 1"):
        launch_train.main(["--arch", "qwen2.5-3b", "--smoke",
                           "--model-parallel", "2"])
    with pytest.raises(SystemExit, match="--data-parallel 2 needs 4 CUDA "
                       "devices.*have 1"):
        launch_train.main(["--arch", "qwen2.5-3b", "--smoke",
                           "--model-parallel", "2", "--data-parallel", "2"])
