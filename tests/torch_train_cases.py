"""Shared inputs of the port's training tests on the CPU
(``tests/test_torch_train_*.py``): fp32 SMOKE configs of both packages with
the JAX package's params moved over by ``repro_torch.convert``, and numpy
batches made from a seed, so both packages see the same numbers;
``one_thread``, the autouse fixture each training test module imports.

Tolerances (the same fp32 arithmetic, summed in other orders): a loss, its
``ce`` and the MoE aux losses within rtol 1e-5 of JAX's; every gradient
leaf within 1e-4 of that leaf's largest JAX magnitude, plus 1e-7 for a
leaf whose gradient is all but zero.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as jcfg
from repro.models import api as japi
from repro_torch.configs import get_smoke_config as tcfg
from repro_torch.convert import params_from_jax
from repro_torch.runtime.trainer import loss_and_grads


@pytest.fixture(autouse=True)
def one_thread():
    """The SMOKE steps are hundreds of tiny ops: one intra-op thread runs
    them as fast alone and keeps them from spinning against the threads of
    other test workers on the same cores (tens of times slower there with
    torch's default thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LOSS_RTOL = 1e-5
GRAD_REL, GRAD_ABS = 1e-4, 1e-7

_PAIRS = {}


def _fields(cfg, over):
    """``over`` for ``cfg``'s package: a sub-config (a dataclass) made
    again as the class ``cfg`` holds there, from its fields."""
    return {k: type(getattr(cfg, k))(**dataclasses.asdict(v))
            if dataclasses.is_dataclass(v) else v for k, v in over.items()}


def pair(arch, **over):
    """(jax cfg, port cfg, jax params, port params on the CPU), fp32, the
    configs with ``over`` replaced (a sub-config given as either package's
    dataclass); made once per (arch, over)."""
    key = (arch, tuple(sorted(over.items())))
    if key not in _PAIRS:
        jc = dataclasses.replace(jcfg(arch), dtype="float32",
                                 **_fields(jcfg(arch), over))
        tc = dataclasses.replace(tcfg(arch), dtype="float32",
                                 **_fields(tcfg(arch), over))
        jp = japi.init_params(jc, jax.random.key(0))
        _PAIRS[key] = (jc, tc, jp, params_from_jax(
            tc, jax.tree.map(np.asarray, jp), device="cpu"))
    return _PAIRS[key]


def batch(cfg, B, S, seed=0):
    """numpy {"tokens", "labels"} (a few labels -1, carrying no loss), plus
    a vlm's 4 frontend embeddings or an encoder-decoder's 24 frames."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    out["labels"][0, :3] = -1
    if cfg.frontend == "patch":
        out["frontend_embeds"] = rng.standard_normal(
            (B, 4, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        out["enc_embeds"] = rng.standard_normal(
            (B, 24, cfg.d_model)).astype(np.float32)
    return out


def jax_loss_and_grads(jc, jp, b):
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (loss, aux), g = jax.jit(jax.value_and_grad(
        lambda p, x: japi.loss_fn(jc, p, x), has_aux=True))(jp, jb)
    return loss, aux, g


def torch_batch(b, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def leaves_close(tc, got, want_jax, rel=GRAD_REL, abs_=GRAD_ABS):
    """Every leaf of the port tree ``got`` within rel * max|want| + abs_ of
    the JAX tree ``want_jax`` (moved over like params). Returns the worst
    error over its limit."""
    want = params_from_jax(tc, jax.tree.map(np.asarray, want_jax),
                           device="cpu")
    want_of = dict(pytree.tree_flatten_with_path(want)[0])
    worst = 0.0
    for path, a in pytree.tree_flatten_with_path(got)[0]:
        b = want_of[path]
        assert a.shape == b.shape, path
        lim = rel * b.abs().max().item() + abs_
        err = (a.float() - b.float()).abs().max().item()
        assert err <= lim, (pytree.keystr(path), err, lim)
        worst = max(worst, err / lim)
    return worst


def check_loss_and_grads(arch, B, S, **over):
    jc, tc, jp, tp = pair(arch, **over)
    b = batch(jc, B, S)
    jl, jaux, jg = jax_loss_and_grads(jc, jp, b)
    loss, aux, grads = loss_and_grads(tc, tp, torch_batch(b))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    assert set(aux) == set(jaux) == {"ce", "lb_loss", "z_loss"}
    for k in aux:
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    leaves_close(tc, grads, jg)
    return aux


def jax_train(arch, accum, compress, opt, *, steps=3, seq_len=32,
              global_batch=8, **over):
    """The JAX trainer's run of ``steps`` steps of the fp32 SMOKE config
    (with ``over`` replaced; ``repro.runtime.trainer``, jitted) on the
    synthetic stream: {"state": its initial state moved over
    (``convert.state_from_jax``), "batches": the numpy batches, "metrics":
    each step's, "params": its final parameters moved over}."""
    from repro.data import synthetic as jdata
    from repro.optim import adamw as jadamw
    from repro.runtime import trainer as jtrainer
    from repro_torch.convert import state_from_jax
    jc, tc, _, _ = pair(arch, **over)
    jopt = jadamw.AdamWConfig(**opt)
    js = jtrainer.init_state(jc, jopt, jax.random.key(0),
                             compress_grads=compress)
    ts = state_from_jax(tc, jax.tree.map(np.asarray, js), device="cpu")
    jstep = jax.jit(jtrainer.make_train_step(
        jc, jopt, grad_accum=accum, compress_grads=compress))
    ds = jdata.SyntheticDataset(jdata.DataConfig(
        vocab=jc.vocab, seq_len=seq_len, global_batch=global_batch))
    batches, metrics = [], []
    for _ in range(steps):
        b = ds.next_batch()
        batches.append(b)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in jm.items()})
    final = params_from_jax(tc, jax.tree.map(np.asarray, js["params"]),
                            device="cpu")
    return {"state": ts, "batches": batches, "metrics": metrics,
            "params": final}


def steps_track_jax(got_metrics, got_params, want):
    """Three steps against ``jax_train``'s run: every metric within rtol
    1e-4 at every step; every parameter within 2 · lr a step of JAX's, at
    most 1e-3 of the elements more than 1e-5 apart."""
    for got, jm in zip(got_metrics, want["metrics"]):
        assert set(got) == set(jm)
        for k in got:
            np.testing.assert_allclose(got[k], jm[k], rtol=1e-4)
    lrs = [m["lr"] for m in want["metrics"]]
    a = pytree.tree_leaves(got_params)
    b = pytree.tree_leaves(want["params"])
    assert len(a) == len(b)
    d = torch.cat([(x - y).abs().flatten() for x, y in zip(a, b)])
    assert d.max().item() <= 2 * sum(lrs)
    assert (d > 1e-5).float().mean().item() <= 1e-3


def results(world, name):
    """Scenario ``name``'s result on every rank of a ``run_world`` world
    whose ranks return {name: result or {"error": traceback}} (arrays as
    tensors again), after checking none failed."""
    out = [r[name] for r in world]
    for rank, res in enumerate(out):
        assert not (isinstance(res, dict) and "error" in res), \
            f"rank {rank}:\n{res['error']}"
    return [pytree.tree_map(lambda a: torch.from_numpy(a) if isinstance(
        a, np.ndarray) else a, res) for res in out]


def joined(res, which):
    """The whole gradient tree from every rank's ``res[r][which]["grads"]``
    (its part of each leaf split over ``model``, joined along that dim; a
    whole leaf from the first rank), by ``pytree.keystr``; and {keystr:
    each rank's part} of the whole leaves."""
    specs = {pytree.keystr(p): s for p, s in pytree.tree_flatten_with_path(
        res[0]["specs"], is_leaf=lambda x: isinstance(x, tuple))[0]}
    parts = [dict((pytree.keystr(p), t) for p, t in
                  pytree.tree_flatten_with_path(r[which]["grads"])[0])
             for r in res]
    out, whole = {}, {}
    for key, spec in specs.items():
        if "model" in spec:
            out[key] = torch.cat([p[key] for p in parts],
                                 spec.index("model"))
        else:
            out[key] = parts[0][key]
            whole[key] = [p[key] for p in parts]
    return out, whole


def grads_against_jax(res, arch, batch_np, partial, **over):
    """A world's gradients (``torch_heads_ranks``' ``grads_*`` scenario)
    against JAX's at the same parameters and batch: the plan's, joined,
    within the gradient bounds of every leaf, each whole leaf equal on
    every rank; the control's (no ``partial`` sum) apart from JAX's on
    every rank exactly on the leaves whose keystr ends with one of
    ``partial``, where the ranks' shares add up to JAX's, and equal to the
    plan's on every other leaf."""
    jc, tc, jp, _ = pair(arch, **over)
    jl, _, jg = jax_loss_and_grads(jc, jp, batch_np)
    want = params_from_jax(tc, jax.tree.map(np.asarray, jg), device="cpu")
    want = {pytree.keystr(p): t for p, t in
            pytree.tree_flatten_with_path(want)[0]}
    got, whole = joined(res, "plan")
    ctl, ctl_whole = joined(res, "control")
    assert set(got) == set(want)
    for r in res:
        np.testing.assert_allclose(r["plan"]["loss"], float(jl),
                                   rtol=LOSS_RTOL)
    hit = set()
    for key, w in want.items():
        lim = GRAD_REL * w.abs().max().item() + GRAD_ABS
        assert (got[key] - w).abs().max().item() <= lim, key
        if key in whole:
            assert all(torch.equal(t, whole[key][0]) for t in whole[key])
        if key.endswith(partial):
            hit.add(key)
            shares = ctl_whole[key]
            assert all((t - w).abs().max().item() > lim for t in shares), \
                key
            assert (sum(shares) - w).abs().max().item() <= lim, key
        else:
            assert torch.equal(ctl[key], got[key]), key
    return hit
