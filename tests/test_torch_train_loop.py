"""The port's training step and loop on the CPU: three ``make_train_step``
steps against the JAX package's (plain, ``grad_accum=4``,
``compress_grads``) from one state (``convert.state_from_jax``), the port's
own version of each case in ``tests/test_training.py``, and the launcher.

Bounds. Losses within rtol 1e-4 of JAX's at every step.
Parameters after three steps: Adam normalises each element's step, so an
element whose gradient is all but zero can take its update with either sign
from a rounding difference; such an element moves by up to 2 · lr a step.
So the bound is that, and at most 1e-3 of the elements may differ by more
than 1e-5.
"""
import dataclasses
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

from repro.configs import get_smoke_config as jcfg  # noqa: E402
from repro.data import synthetic as jdata  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.parallel import compression as jcomp  # noqa: E402
from repro.runtime import trainer as jtrainer  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax, state_from_jax  # noqa: E402
from repro_torch.data.synthetic import (DataConfig,  # noqa: E402
                                        SyntheticDataset)
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import compression  # noqa: E402
from repro_torch.runtime.trainer import (StragglerMonitor,  # noqa: E402
                                         Trainer, init_state,
                                         make_train_step, stack_group)
from torch_train_cases import batch, one_thread, pair  # noqa: E402, F401

REPO = Path(__file__).resolve().parents[1]
# the reference launcher's optimizer at --steps 30
OPT = dict(lr=3e-3, warmup_steps=5, total_steps=30)


@pytest.mark.parametrize("grad_accum,compress", [(1, False), (4, False),
                                                 (1, True)],
                         ids=["plain", "accum4", "compress"])
def test_three_steps_track_jax(grad_accum, compress):
    jc, tc, _, _ = pair("qwen2.5-3b")
    js = jtrainer.init_state(jc, jadamw.AdamWConfig(**OPT),
                             jax.random.key(0), compress_grads=compress)
    ts = state_from_jax(tc, jax.tree.map(np.asarray, js), device="cpu")
    jstep = jax.jit(jtrainer.make_train_step(
        jc, jadamw.AdamWConfig(**OPT), grad_accum=grad_accum,
        compress_grads=compress))
    tstep = make_train_step(tc, adamw.AdamWConfig(**OPT),
                            grad_accum=grad_accum, compress_grads=compress)
    ds = jdata.SyntheticDataset(jdata.DataConfig(vocab=jc.vocab, seq_len=32,
                                                 global_batch=8))
    lrs = []
    for _ in range(3):
        b = ds.next_batch()
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tm = tstep(ts, {k: torch.from_numpy(v) for k, v in b.items()})
        assert set(tm) == set(jm)
        for k in tm:
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-4)
        lrs.append(float(jm["lr"]))
    want = params_from_jax(tc, jax.tree.map(np.asarray, js["params"]),
                           device="cpu")
    d = torch.cat([(a - b).abs().flatten()
                   for a, b in zip(pytree.tree_leaves(ts["params"]),
                                   pytree.tree_leaves(want))])
    assert d.max().item() <= 2 * sum(lrs)
    assert (d > 1e-5).float().mean().item() <= 1e-3
    assert int(ts["opt"]["step"]) == 3


@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b",
                                  "seamless-m4t-large-v2"])
def test_compress_tree_shares_the_reference_leaf_scales(arch):
    """Gradients moved over per layer and grouped by ``stack_group``
    compress to the reference's stacked-leaf values bit for bit (the same
    numbers on both sides, normal draws in the params' shapes with each
    layer at its own scale, so a per-layer scale would differ): llama4's
    two-kind period interleaves its stacks; seamless's encoder blocks are
    one stack."""
    jc = dataclasses.replace(jcfg(arch), dtype="float32")
    tc = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    rng = np.random.default_rng(4)
    jg = jax.tree.map(lambda x: jnp.asarray(
        rng.standard_normal(x.shape) * rng.uniform(0.1, 10, x.shape[:1] +
                                                   (1,) * (x.ndim - 1)),
        jnp.float32), japi.param_shapes(jc))
    zeros = jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32), jg)
    want = params_from_jax(tc, jax.tree.map(
        np.asarray, jax.jit(jcomp.compress_tree)(jg, zeros)[0]), device="cpu")
    g = params_from_jax(tc, jax.tree.map(np.asarray, jg), device="cpu")
    got, _ = compression.compress_tree(
        g, compression.init_error_tree(g), stack_group(tc))
    for a, b in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the port's own versions of tests/test_training.py
# ---------------------------------------------------------------------------


def _mk_trainer(tmp, **kw):
    cfg = get_smoke_config("qwen2.5-3b")
    dc = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8)
    opt = adamw.AdamWConfig(lr=3e-3, warmup_steps=10,
                            moment_dtype=cfg.moment_dtype)
    return Trainer(cfg, opt, SyntheticDataset(dc),
                   ckpt_dir=str(tmp) if tmp else None,
                   log_fn=lambda s: None, device="cpu", **kw)


def test_loss_decreases():
    tr = _mk_trainer(None, save_every=0, log_every=1)
    tr.run(40)
    first = np.mean([h["loss"] for h in tr.history[:5]])
    last = np.mean([h["loss"] for h in tr.history[-5:]])
    assert last < first - 0.3, (first, last)
    assert {"loss", "ce", "grad_norm", "lr", "dt"} <= set(tr.history[-1])


def test_grad_accum_matches_full_batch():
    cfg = get_smoke_config("granite-3-2b")
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=0)
    ds = SyntheticDataset(DataConfig(vocab=cfg.vocab, seq_len=16,
                                     global_batch=8))
    b = {k: torch.from_numpy(v) for k, v in next(iter(ds)).items()}
    gen = torch.Generator().manual_seed(0)
    s0 = init_state(cfg, opt, gen, device="cpu")
    sa = pytree.tree_map(torch.clone, s0)
    sf, mf = make_train_step(cfg, opt)(s0, b)
    sa, ma = make_train_step(cfg, opt, grad_accum=4)(sa, b)
    np.testing.assert_allclose(mf["loss"].item(), ma["loss"].item(),
                               rtol=2e-2)
    diffs = [(a.float() - c.float()).abs().max().item() for a, c in
             zip(pytree.tree_leaves(sf["params"]),
                 pytree.tree_leaves(sa["params"]))]
    assert max(diffs) < 5e-2


def test_checkpoint_roundtrip(tmp_path):
    cfg = get_smoke_config("yi-6b")
    state = init_state(cfg, adamw.AdamWConfig(),
                       torch.Generator().manual_seed(0), device="cpu",
                       compress_grads=True)
    path = os.path.join(tmp_path, "step_00000001")
    ckpt.save(path, state, extra={"step": 1, "data": {"step": 1}})
    restored, extra = ckpt.restore(path, state)
    assert extra["step"] == 1
    for a, b in zip(pytree.tree_leaves(state), pytree.tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_preemption_resume(tmp_path):
    """Stop after 10 steps, restart, confirm the step counter and data
    cursor resume and training reaches the state of an uninterrupted run
    (every parameter leaf within 1e-5)."""
    t1 = _mk_trainer(tmp_path, save_every=10, log_every=5)
    t1.run(10)
    t1.checkpointer.wait()
    del t1
    t2 = _mk_trainer(tmp_path, save_every=10, log_every=5)
    assert t2.step == 10                      # resumed
    assert t2.dataset.step == 10              # data cursor restored
    assert int(t2.state["opt"]["step"]) == 10
    t2.run(5)
    t3 = _mk_trainer(None, save_every=0, log_every=5)
    t3.run(15)
    for a, b in zip(pytree.tree_leaves(t2.state["params"]),
                    pytree.tree_leaves(t3.state["params"])):
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=1e-5)


def test_async_checkpointer_atomic(tmp_path):
    state = {"x": torch.arange(10)}
    c = ckpt.AsyncCheckpointer()
    p = os.path.join(tmp_path, "step_00000005")
    c.save(p, state, extra={"step": 5})
    c.wait()
    assert ckpt.latest_step_dir(str(tmp_path)).endswith("step_00000005")
    assert not [d for d in os.listdir(tmp_path) if "tmp" in d]


def test_straggler_monitor_flags_slow_steps():
    m = StragglerMonitor(alpha=0.5, threshold=2.0)
    assert not m.observe(0.1)
    assert not m.observe(0.1)
    assert m.observe(1.0)          # 10x slower
    assert m.slow_steps == 1


def test_bf16_moments_stay_bf16():
    """llama4's SMOKE config keeps bf16 moments through a step."""
    cfg = get_smoke_config("llama4-maverick-400b-a17b")
    assert cfg.moment_dtype == "bfloat16"
    opt = adamw.AdamWConfig(moment_dtype=cfg.moment_dtype, warmup_steps=1)
    st = init_state(cfg, opt, torch.Generator().manual_seed(0), device="cpu")
    b = {k: torch.from_numpy(v) for k, v in batch(cfg, 2, 8).items()}
    st, m = make_train_step(cfg, opt)(st, b)
    assert torch.isfinite(m["loss"])
    assert all(t.dtype == torch.bfloat16
               for t in pytree.tree_leaves(st["opt"]["m"]))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launch_train_runs_and_resumes(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device",
           "cpu", "--arch", "qwen2.5-3b", "--smoke", "--steps", "3",
           "--seq", "16", "--ckpt-dir", str(tmp_path)]
    r = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "done at step 3" in r.stdout
    assert ckpt.latest_step_dir(str(tmp_path)).endswith("step_00000003")
    r = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "resumed from" in r.stdout and "done at step 6" in r.stdout


def test_launch_train_refuses_a_missing_card_and_model_parallel():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "qwen2.5-3b", "--smoke", "--steps",
                           "1"])
    # --model-parallel runs (tests/test_torch_train_parallel.py), and on
    # CUDA needs the card as much as one rank does
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "qwen2.5-3b", "--smoke",
                           "--model-parallel", "2"])


def test_trainer_logs_and_state_dtypes():
    cfg = dataclasses.replace(get_smoke_config("qwen2.5-3b"),
                              dtype="bfloat16")
    lines = []
    tr = Trainer(cfg, adamw.AdamWConfig(), SyntheticDataset(DataConfig(
        vocab=cfg.vocab, seq_len=8, global_batch=2)), log_every=2,
        log_fn=lines.append, device="cpu")
    tr.run(4)
    assert [ln.split()[:3] for ln in lines] == [["[train]", "step", "2"],
                                               ["[train]", "step", "4"]]
    assert tr.state["params"]["embed"].dtype == torch.bfloat16
    assert tr.state["opt"]["m"]["embed"].dtype == torch.float32
