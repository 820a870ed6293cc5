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
  recurrentgemma-9b, whose attention falls back, and dbrx-132b, whose MoE
  runs expert-parallel, also with ``grad_accum=2``) from
  ``convert.state_from_jax``
  against JAX's steps, and the all-reduces of a step;
* ``compressed_psum`` bit for bit against the reference's under
  ``jax.vmap``; ``gpipe`` against the sequential stack;
* data parallelism: a world of 2 as (data 2, model 1) and one of 4 as
  (data 2, model 2), each rank on its replica's half of the global batch,
  three steps (plain, ``compress_grads``, and dbrx-132b's MoE, whose
  replicas route as halves of the global batch's dispatch groups, also
  with ``grad_accum`` 2) against JAX's on the whole batch, the replicas'
  parameters equal bit for bit; a checkpoint saved at (2, 2) restored in
  one process;
* checkpoints across meshes (``tests/test_elastic_restore.py``'s
  contract) and the launcher's ``--model-parallel`` and
  ``--data-parallel``.

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
from repro.data import synthetic as jdata  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.parallel import compression as jcomp  # noqa: E402
from repro.runtime import trainer as jtrainer  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.convert import params_from_jax, state_from_jax  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import run_world  # noqa: E402
from repro_torch.parallel.pipeline import bubble_fraction  # noqa: E402
from torch_train_cases import pair, results  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
F32 = dict(atol=2e-5, rtol=2e-5)
WORLD_SCENARIOS = {
    2: ("block_attn_mlp", "block_dec", "ckpt_save",
        *(f"train_{n}" for n in ranks.TRAIN_CASES),
        *(f"dp_{n}" for n in ranks.DP_CASES)),
    4: ("block_attn_mlp", "block_dec", "psum", "gpipe", "ckpt_restore",
        "train_plain", "train_accum4", "train_compress",
        *(f"dp_{n}" for n in ranks.DP_CASES), "dp_ckpt_save"),
}
GPIPE = dict(S=4, M=8, mb=2, d=8)


# ---------------------------------------------------------------------------
# the JAX side, the ranks' inputs, the worlds
# ---------------------------------------------------------------------------


def _jax_case(name):
    """The case's fp32 configs, the JAX initial state (moved over), its
    three batches, JAX's metrics at each step and its final parameters
    (moved over)."""
    arch, accum, compress = ranks.TRAIN_CASES[name]
    jc, tc, _, _ = pair(arch)
    opt = jadamw.AdamWConfig(**ranks.OPT)
    js = jtrainer.init_state(jc, opt, jax.random.key(0),
                             compress_grads=compress)
    ts = state_from_jax(tc, jax.tree.map(np.asarray, js), device="cpu")
    jstep = jax.jit(jtrainer.make_train_step(
        jc, opt, grad_accum=accum, compress_grads=compress))
    ds = jdata.SyntheticDataset(jdata.DataConfig(vocab=jc.vocab, seq_len=32,
                                                 global_batch=8))
    batches, metrics = [], []
    for _ in range(ranks.STEPS):
        b = ds.next_batch()
        batches.append(b)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in jm.items()})
    final = params_from_jax(tc, jax.tree.map(np.asarray, js["params"]),
                            device="cpu")
    return {"state": ts, "batches": batches, "metrics": metrics,
            "params": final}


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """(directory, JAX runs by case, the ranks' inputs)."""
    d = tmp_path_factory.mktemp("train_parallel")
    runs = {name: _jax_case(name) for name in ranks.TRAIN_CASES}
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
def world4(bundle, world2):     # restores what the world of 2 saved
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
# 2 KV heads shard over 2 ranks, not 4 (its query heads are then gathered
# at their use); recurrentgemma's one KV head never shards; an MoE stack
# runs its experts in parallel; every head is vocab-parallel
CONTRACT = {(2, "plain"): ["ffn", "heads", "vocab"],
            (4, "plain"): ["ffn", "vocab"],
            (2, "rgemma"): ["ffn", "vocab"],
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


def _params_track_jax(got, want):
    """The parameter bound of ``test_train_steps_track_jax``."""
    lrs = [m["lr"] for m in want["metrics"]]
    a = pytree.tree_leaves(got)
    b = pytree.tree_leaves(want["params"])
    assert len(a) == len(b)
    d = torch.cat([(x - y).abs().flatten() for x, y in zip(a, b)])
    assert d.max().item() <= 2 * sum(lrs)
    assert (d > 1e-5).float().mean().item() <= 1e-3


@pytest.mark.parametrize("name", ranks.DP_CASES)
@pytest.mark.parametrize("n", [2, 4])
def test_data_parallel_steps_track_jax_on_the_global_batch(worlds, bundle,
                                                           n, name):
    """Each replica steps on 4 of the 8 rows and averages the gradients
    over the data axis: the single-device step on all 8, every rank. On
    dbrx-132b's MoE the replicas route their rows as their halves of the
    global batch's dispatch groups, with the load-balance loss over the
    global batch; with ``grad_accum`` 2 each replica's micro-batch is its
    half of the global one. Every ``wembed`` dim is split over the
    replicas (FSDP) and gathered on the world's first rank; the leaves
    that replicate over data (norms, biases) take the same averaged
    update on both replicas, so their parts are equal bit for bit."""
    res = results(worlds[n], f"dp_{name}")
    want = bundle[1][name]
    moe = ranks.TRAIN_CASES[name][0] != ranks.QWEN
    assert [r["data"] for r in res] == [2] * n
    assert [r["rows"] for r in res] == [4] * n
    assert res[0]["contract"] == (
        [] if n == 2 else ["experts", "heads", "vocab"] if moe
        else ["ffn", "heads", "vocab"])
    for r in res[1:]:
        assert r["metrics"] == res[0]["metrics"]
    assert [r["params"] is None for r in res] == [i != 0 for i in range(n)]
    for got, jm in zip(res[0]["metrics"], want["metrics"]):
        assert set(got) == set(jm)
        for k in got:
            np.testing.assert_allclose(got[k], jm[k], rtol=1e-4)
    _params_track_jax(res[0]["params"], want)
    m = n // 2
    for i in range(m):              # replica 0 and 1 of model column i
        a, b = res[i]["replicated"], res[m + i]["replicated"]
        assert a and set(a) == set(b)
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_checkpoint_at_2x2_restores_at_1x1(world2, world4, bundle):
    """4 steps at (data 2, model 2), saved; resumed in this process with no
    mesh for 4 more: the losses of an uninterrupted run at (1, model 2)."""
    saved = results(world4, "dp_ckpt_save")
    whole = results(world2, "ckpt_save")[0]["whole"]
    for r in saved:
        assert r["shape"] == {"data": 2, "model": 2} and r["data"] == 2
        np.testing.assert_allclose(r["losses"], whole[:ranks.RESUME_AT],
                                   rtol=1e-4)
    log = []
    tr = ranks._trainer(None, str(bundle[0] / "ckpt" / "dp"), log)
    assert tr.step == ranks.RESUME_AT
    tr.run(ranks.RESUME_STEPS - ranks.RESUME_AT)
    np.testing.assert_allclose(ranks._losses(tr), whole[ranks.RESUME_AT:],
                               rtol=1e-4)
    assert any("resumed from" in ln for ln in log)


@pytest.mark.parametrize("n", [2, 4])
def test_all_reduces_a_step(worlds, n):
    """Per layer: each sharded sublayer's sum in forward and its input's in
    backward, and under remat "full" the recompute's sums up to the last
    tensor the backward saved: the attention's (its output feeds the second
    norm, whose input is saved), not the MLP's (the block's last op). And
    a loss's vocab-parallel sums: the embedding lookup's, the loss input's
    gradient's, and the loss chunk's two in forward and again in its
    recompute. A micro-batch of ``grad_accum`` is a whole step's worth."""
    cfg = ranks.cfg_of(ranks.QWEN)
    assert cfg.remat == "full"
    for name, micro in (("plain", 1), ("accum4", 4)):
        res = results(worlds[n], f"train_{name}")
        contract = res[0]["contract"]
        layer = [a for a in contract if a != "vocab"]
        per_layer = 2 * len(layer) + ("heads" in layer)
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
# checkpoints across meshes
# ---------------------------------------------------------------------------


WANT_W = torch.arange(64.0).reshape(8, 8)


def test_restore_at_one_rank_is_bitwise(world2, bundle):
    """A bf16 leaf saved from 2 ranks' halves restores whole into an fp32
    ``like`` (the single-device format)."""
    results(world2, "ckpt_save")
    got, extra = ckpt.restore(
        str(bundle[0] / "ckpt" / "elastic" / "step_00000001"),
        {"w": torch.zeros(8, 8)})
    assert extra["step"] == 1
    assert got["w"].dtype == torch.float32
    assert torch.equal(got["w"], WANT_W)


def test_restore_at_four_ranks_is_bitwise(world4):
    for r, res in enumerate(results(world4, "ckpt_restore")):
        assert res["extra"]["step"] == 1
        assert torch.equal(res["part"], WANT_W[:, 2 * r:2 * r + 2])


def test_resume_at_another_width_continues_the_losses(world2, world4):
    """4 steps at 2 ranks (attention, MLP and vocab sharded), saved;
    resumed at 4 ranks (the MLP and vocab computed sharded, the query
    heads split and gathered) for 4 more: the losses of an
    uninterrupted run at 2 ranks, the data cursor continued."""
    saved = results(world2, "ckpt_save")
    whole = saved[0]["whole"]
    assert len(whole) == ranks.RESUME_STEPS
    for r in saved:
        np.testing.assert_allclose(r["cut"], whole[:ranks.RESUME_AT],
                                   rtol=1e-4)
    for r in results(world4, "ckpt_restore"):
        assert r["contract"] == ["ffn", "vocab"]
        assert r["resumed_at"] == ranks.RESUME_AT
        assert r["data_step"] == ranks.RESUME_STEPS
        np.testing.assert_allclose(r["losses"], whole[ranks.RESUME_AT:],
                                   rtol=1e-4)
    assert any("resumed from" in ln for ln in saved[0]["log"] + results(
        world4, "ckpt_restore")[0]["log"])


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


def test_launch_train_data_parallel_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen2.5-3b", "--smoke", "--steps", "3", "--seq", "16",
         "--data-parallel", "2", "--device", "cpu"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    lines = r.stdout.splitlines()
    assert len(lines) == 2, r.stdout
    assert lines[0].endswith("data-parallel over 2 replicas")
    assert "model-parallel" not in lines[0]
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
