"""Context-parallel training steps held to the JAX package's
single-device trainer, on the CPU over gloo: the sequence split over
``model`` (``tp.train_plan(table={"seq": "model"})``,
``Trainer(rules_table=)``: the reference's ``Trainer(rules=Rules(mesh,
{"seq": "model"}))``), every rank on its block of each of its replica's
rows (``trainer.seq_rows``).

Two spawned worlds (``launch.mesh.run_world``; the ranks are
``tests/torch_cp_ranks.py``, which imports no jax), each running its
scenarios once in a module fixture: 2 ranks at (data 1, model 2) and 4 at
(data 2, model 2), three steps of qwen2.5-3b and dbrx-132b SMOKE (fp32, 8
rows of 32 tokens) from ``convert.state_from_jax``, held to the JAX
trainer's steps on the whole batch by ``torch_train_cases.
steps_track_jax`` (metrics within rtol 1e-4, parameters within 2 · lr a
step, at most 1e-3 of the elements more than 1e-5 apart); and at (2, 2) a
checkpoint saved under context parallelism that this process restores at
(1, 1) without it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")     # held against the JAX package

import torch_cp_ranks as ranks  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.launch.mesh import run_world  # noqa: E402
from torch_train_cases import (jax_train, one_thread,  # noqa: E402,F401
                               results, steps_track_jax)
from torch_train_ranks import OPT, RESUME_AT  # noqa: E402

STEPS = {"qwen_1x2": "qwen2.5-3b", "dbrx_1x2": "dbrx-132b",
         "qwen_2x2": "qwen2.5-3b", "dbrx_2x2": "dbrx-132b"}
WORLDS = {2: ("qwen_1x2", "dbrx_1x2"),
          4: ("qwen_2x2", "dbrx_2x2", "ckpt_save_cp")}


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """(directory, JAX step runs by scenario name)."""
    d = tmp_path_factory.mktemp("train_cp_steps")
    by_arch = {a: jax_train(a, 1, False, OPT) for a in set(STEPS.values())}
    runs = {name: by_arch[a] for name, a in STEPS.items()}
    torch.save({"states": {n: r["state"] for n, r in runs.items()},
                "batches": {n: r["batches"] for n, r in runs.items()},
                "steps": STEPS}, d / "inputs.pt")
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


@pytest.mark.parametrize("name", list(STEPS))
def test_steps_track_jax(world2, world4, bundle, name):
    res = results(world2 if name.endswith("1x2") else world4, name)
    want = ["experts"] if name.startswith("dbrx") else []
    for r in res:
        assert r["contract"] == want      # heads, ffn and vocab gathered
        assert r["metrics"] == res[0]["metrics"]
    steps_track_jax(res[0]["metrics"], res[0]["params"], bundle[1][name])
    for step in res[0]["collectives"]:
        assert step["all-gather:model"] > 0
        assert step["reduce-scatter:model"] > 0


def test_checkpoint_under_cp_at_2x2_restores_at_1x1(world4, bundle):
    """4 steps at (2, 2) with the sequence over ``model``, saved (full
    leaves, one rank writes); restored in this process at (1, 1) with no
    mesh, 4 more steps give the losses of an uninterrupted context-
    parallel run."""
    saved = results(world4, "ckpt_save_cp")
    whole = saved[0]["whole"]
    assert saved[0]["seq"] == "model" and saved[0]["cp"] == 2
    for r in saved:
        np.testing.assert_allclose(r["cut"], whole[:RESUME_AT], rtol=1e-4)
    d = str(bundle[0] / "ckpt" / "cp")
    assert ckpt.latest_step_dir(d) is not None
    tr = ranks._trainer(None, d, [], None)
    assert tr.step == RESUME_AT and tr.plan is None
    tr.run(len(whole) - RESUME_AT)
    np.testing.assert_allclose([h["loss"] for h in tr.history],
                               whole[RESUME_AT:], rtol=1e-4)
