"""Data-parallel training of the port and checkpoints across meshes,
held to the JAX package's single-device trainer (the contract of the
reference's ``rules=`` with a mesh) on the CPU over gloo: the half of the
model- and data-parallel training tests that
``tests/test_torch_train_parallel.py`` does not hold.

Spawned worlds of 2 and 4 ranks (``launch.mesh.run_world``; the ranks are
``tests/torch_train_ranks.py``, which imports no jax and reads its inputs
from a ``torch.save`` file) each run all their scenarios once, in a module
fixture, and each test asserts on one scenario's result on every rank:

* data parallelism: a world of 2 as (data 2, model 1) and one of 4 as
  (data 2, model 2), each rank on its replica's half of the global batch,
  three steps (plain, ``compress_grads``, and dbrx-132b's MoE, whose
  replicas route as halves of the global batch's dispatch groups, also
  with ``grad_accum`` 2) against JAX's on the whole batch, the replicas'
  parameters equal bit for bit; a checkpoint saved at (2, 2) restored in
  one process;
* checkpoints across meshes (``tests/test_elastic_restore.py``'s
  contract) and the launcher's ``--data-parallel``.

Bounds: losses and the step's metrics within rtol 1e-4 of JAX's;
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

from torch.utils import _pytree as pytree  # noqa: E402

import torch_train_ranks as ranks  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.launch.mesh import run_world  # noqa: E402
from torch_train_cases import jax_train, results  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
WORLD_SCENARIOS = {
    2: ("ckpt_save", *(f"dp_{n}" for n in ranks.DP_CASES)),
    4: ("ckpt_restore", *(f"dp_{n}" for n in ranks.DP_CASES),
        "dp_ckpt_save"),
}


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """(directory, JAX runs by case)."""
    d = tmp_path_factory.mktemp("train_parallel_dp")
    runs = {name: jax_train(*ranks.TRAIN_CASES[name], ranks.OPT)
            for name in ranks.DP_CASES}
    torch.save({"states": {n: r["state"] for n, r in runs.items()},
                "batches": {n: r["batches"] for n, r in runs.items()}},
               d / "inputs.pt")
    return d, runs


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
    resumed at 4 ranks (the query heads, MLP and vocab computed sharded,
    the 2 KV heads whole on every rank) for 4 more: the losses of an
    uninterrupted run at 2 ranks, the data cursor continued."""
    saved = results(world2, "ckpt_save")
    whole = saved[0]["whole"]
    assert len(whole) == ranks.RESUME_STEPS
    for r in saved:
        np.testing.assert_allclose(r["cut"], whole[:ranks.RESUME_AT],
                                   rtol=1e-4)
    for r in results(world4, "ckpt_restore"):
        assert r["contract"] == ["ffn", "heads", "vocab"]
        assert r["resumed_at"] == ranks.RESUME_AT
        assert r["data_step"] == ranks.RESUME_STEPS
        np.testing.assert_allclose(r["losses"], whole[ranks.RESUME_AT:],
                                   rtol=1e-4)
    assert any("resumed from" in ln for ln in saved[0]["log"] + results(
        world4, "ckpt_restore")[0]["log"])


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


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
