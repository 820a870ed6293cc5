"""The port's optimizer, gradient compression, data stream and train-state
bridge against the JAX package's, and the kernel wrappers' refusal to be
differentiated, on the CPU.

``adamw.apply`` sees the reference's inputs exactly (numpy params, grads
and moments from a seed), so it is held tightly: fp32 results within rtol
1e-6 (the same fp32 arithmetic; XLA may contract a multiply-add), a bf16
leaf within one bf16 rounding (2^-8 relative), moments likewise in their
dtype. ``compress`` is held bit for bit (the same fp32 division and
round-half-to-even), ``SyntheticDataset`` batch for batch.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")     # held against the JAX package

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.data import synthetic as jdata  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.parallel import compression as jcomp  # noqa: E402
from repro.runtime import trainer as jtrainer  # noqa: E402
from repro_torch.convert import _tensor, state_from_jax  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import attention as mha_kernel  # noqa: E402
from repro_torch.kernels import conv_im2col, gemm_os, maxpool  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as paged_kernel  # noqa: E402
from repro_torch.kernels import reshuffle, sampler  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import compression  # noqa: E402
from repro_torch.runtime.trainer import loss_and_grads  # noqa: E402
from torch_train_cases import (one_thread, batch,  # noqa: E402, F401
                               pair, torch_batch)

SHAPES = {"a": ((6, 5), np.float32), "b": ((7,), np.float32),
          "c": ((4, 3), ml_dtypes.bfloat16)}


def _np(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _close(got, want, dtype):
    got = np.asarray(_np(got), np.float32)
    want = np.asarray(want, np.float32)
    rtol = 2.0 ** -8 if dtype in ("bfloat16", ml_dtypes.bfloat16) else 1e-6
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-12)


@pytest.mark.parametrize("step0", [0, 6, 150], ids=["first", "warmup",
                                                    "cosine"])
@pytest.mark.parametrize("clip", [1.0, 0.0], ids=["clip", "noclip"])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_apply_equals_jax(moment_dtype, clip, step0):
    """One update from step ``step0`` (warm-up 10 of 200 steps), gradients
    of norm ~7 (clipped to 1 when ``clip``), moments from earlier steps
    (zero at the first), one bf16 parameter leaf."""
    cfg = dict(lr=1e-2, warmup_steps=10, total_steps=200, clip_norm=clip,
               moment_dtype=moment_dtype)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
    rng = np.random.default_rng(step0)
    mdt = ml_dtypes.bfloat16 if moment_dtype == "bfloat16" else np.float32
    p, g, m, v = {}, {}, {}, {}
    for k, (shape, dt) in SHAPES.items():
        p[k] = rng.standard_normal(shape).astype(dt)
        g[k] = rng.standard_normal(shape).astype(dt)
        m[k] = (0.1 * rng.standard_normal(shape) * (step0 > 0)).astype(mdt)
        v[k] = (0.1 * rng.random(shape) * (step0 > 0)).astype(mdt)
    jstate = {"m": jax.tree.map(jnp.asarray, m),
              "v": jax.tree.map(jnp.asarray, v),
              "step": jnp.asarray(step0, jnp.int32)}
    jp, jopt, jmet = jadamw.apply(jcfg, jax.tree.map(jnp.asarray, g), jstate,
                                  jax.tree.map(jnp.asarray, p))
    cpu = torch.device("cpu")
    tp = {k: _tensor(a, cpu) for k, a in p.items()}
    topt = {"m": {k: _tensor(a, cpu) for k, a in m.items()},
            "v": {k: _tensor(a, cpu) for k, a in v.items()},
            "step": torch.tensor(step0, dtype=torch.int32)}
    met = adamw.apply(tcfg, {k: _tensor(a, cpu) for k, a in g.items()},
                      topt, tp)
    assert int(topt["step"]) == int(jopt["step"]) == step0 + 1
    np.testing.assert_allclose(met["grad_norm"].item(),
                               float(jmet["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(met["lr"].item(), float(jmet["lr"]),
                               rtol=1e-6)
    for k, (_, dt) in SHAPES.items():
        assert tp[k].dtype == (torch.float32 if dt is np.float32
                               else torch.bfloat16)
        _close(tp[k], jp[k], dt)
        _close(topt["m"][k], jopt["m"][k], moment_dtype)
        _close(topt["v"][k], jopt["v"][k], moment_dtype)
        assert str(topt["m"][k].dtype) == f"torch.{moment_dtype}"


def test_schedule_equals_jax():
    cfg = dict(lr=3e-3, warmup_steps=5, total_steps=30, min_lr_frac=0.1)
    steps = np.arange(0, 40, dtype=np.int32)
    want = jax.vmap(lambda s: jadamw.schedule(jadamw.AdamWConfig(**cfg), s))(
        jnp.asarray(steps))
    got = adamw.schedule(adamw.AdamWConfig(**cfg), torch.from_numpy(steps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_adamw_init_and_global_norm():
    params = {"w": torch.ones(3, 2, dtype=torch.bfloat16),
              "n": [torch.full((4,), 2.0)]}
    st = adamw.init(adamw.AdamWConfig(moment_dtype="bfloat16"), params)
    assert st["m"]["w"].dtype == torch.bfloat16 and st["v"]["n"][0].shape \
        == (4,) and st["step"].dtype == torch.int32 and int(st["step"]) == 0
    assert adamw.global_norm(params).item() == pytest.approx(
        (6 * 1 + 4 * 4) ** 0.5)


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["normal", "ties", "tiny"])
def test_compress_is_bit_equal_to_jax(case):
    """int8 values, scale and new error equal the reference's bit for bit;
    "ties": x / scale lands exactly on k + 0.5, rounded half to even
    (0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -0.5 -> 0, -2.5 -> -2)."""
    rng = np.random.default_rng(1)
    if case == "ties":
        x = np.array([127, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, 126.5],
                     np.float32)
        err = np.zeros_like(x)
    else:
        x = rng.standard_normal(300).astype(np.float32)
        if case == "tiny":
            x *= 1e-14
        err = (rng.standard_normal(300) * 1e-3).astype(np.float32)
    jq, js, je = jcomp.compress(jnp.asarray(x), jnp.asarray(err))
    q, s, e = compression.compress(torch.from_numpy(x), torch.from_numpy(err))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    if case == "ties":
        assert q.tolist()[:6] == [127, 0, 2, 2, 0, -2]


def test_compress_tree_equals_jax_and_keeps_dtypes():
    rng = np.random.default_rng(2)
    g = {"a": rng.standard_normal((5, 3)).astype(np.float32),
         "b": [rng.standard_normal(4).astype(ml_dtypes.bfloat16)]}
    e = {"a": np.zeros((5, 3), np.float32), "b": [np.full(4, 0.01,
                                                          np.float32)]}
    jg, je = jcomp.compress_tree(jax.tree.map(jnp.asarray, g),
                                 jax.tree.map(jnp.asarray, e))
    cpu = torch.device("cpu")
    tg, te = compression.compress_tree(
        {"a": _tensor(g["a"], cpu), "b": [_tensor(g["b"][0], cpu)]},
        {"a": _tensor(e["a"], cpu), "b": [_tensor(e["b"][0], cpu)]})
    assert tg["b"][0].dtype == torch.bfloat16 and te["b"][0].dtype == \
        torch.float32
    np.testing.assert_array_equal(_np(tg["a"]), np.asarray(jg["a"]))
    np.testing.assert_array_equal(_np(tg["b"][0]), np.asarray(jg["b"][0]))
    np.testing.assert_array_equal(te["b"][0].numpy(), np.asarray(je["b"][0]))
    z = compression.init_error_tree({"w": torch.ones(2, dtype=torch.bfloat16)})
    assert z["w"].dtype == torch.float32 and not z["w"].any()


def test_compression_error_feedback_converges():
    """The port's version of the reference's test: int8 compression with
    error feedback carries the quantization error, so the accumulated
    compressed signal tracks the true sum."""
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(256)
                         .astype(np.float32)) * 1e-3
    err = torch.zeros_like(g)
    total = torch.zeros_like(g)
    for _ in range(50):
        q, scale, err = compression.compress(g, err)
        total = total + q.float() * scale
    np.testing.assert_allclose(total.numpy(), g.numpy() * 50, rtol=0.05,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# data, the state bridge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, {"learnable": False},
                                {"num_hosts": 2, "host_id": 1, "seed": 7}])
def test_synthetic_batches_equal_reference(kw):
    jd = jdata.SyntheticDataset(jdata.DataConfig(vocab=300, seq_len=17,
                                                 global_batch=4, **kw))
    td = synthetic.SyntheticDataset(synthetic.DataConfig(
        vocab=300, seq_len=17, global_batch=4, **kw))
    for _ in range(3):
        a, b = jd.next_batch(), td.next_batch()
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
    assert td.state_dict() == jd.state_dict() == {"step": 3}
    td.load_state_dict({"step": 1})
    jd.load_state_dict({"step": 1})
    np.testing.assert_array_equal(td.next_batch()["tokens"],
                                  jd.next_batch()["tokens"])
    with pytest.raises(ValueError, match="hosts"):
        synthetic.SyntheticDataset(synthetic.DataConfig(
            vocab=3, seq_len=2, global_batch=3, num_hosts=2))


def test_state_from_jax_carries_every_leaf():
    """llama4's SMOKE state (bf16 moments, a two-kind period, compression):
    params, moments and error tree hold the JAX state's values, unstacked
    alike; the step is a 0-dim int32."""
    jc, tc, _, _ = pair("llama4-maverick-400b-a17b")
    opt = jadamw.AdamWConfig(moment_dtype="bfloat16")
    js = jtrainer.init_state(jc, opt, jax.random.key(0), compress_grads=True)
    js["opt"]["step"] = jnp.asarray(3, jnp.int32)
    ts = state_from_jax(tc, jax.tree.map(np.asarray, js), device="cpu")
    assert set(ts) == {"params", "opt", "err"}
    assert ts["opt"]["step"].dtype == torch.int32 and int(
        ts["opt"]["step"]) == 3
    leaves = torch.utils._pytree.tree_leaves
    n = sum(a.size for a in jax.tree.leaves(js["params"]))
    for tree in (ts["params"], ts["opt"]["m"], ts["opt"]["v"], ts["err"]):
        assert sum(t.numel() for t in leaves(tree)) == n
        assert [t.shape for t in leaves(tree)] == [
            t.shape for t in leaves(ts["params"])]
    assert all(t.dtype == torch.bfloat16 for t in leaves(ts["opt"]["m"]))
    assert all(t.dtype == torch.float32 for t in leaves(ts["err"]))


# ---------------------------------------------------------------------------
# the kernels refuse to be differentiated; training reaches none
# ---------------------------------------------------------------------------


def _wrapper_calls():
    f = torch.zeros
    return {
        "mha": lambda x: mha_kernel.mha(x, f(1, 4, 2, 16), f(1, 4, 2, 16)),
        "paged_attention": lambda x: paged_kernel.paged_attention(
            x, f(2, 4, 2, 16), f(2, 4, 2, 16),
            torch.zeros(1, 1, dtype=torch.int32), [4]),
        "gemm_os": lambda x: gemm_os.gemm_os(x.reshape(8, 16), f(16, 8)),
        "conv_im2col": lambda x: conv_im2col.conv2d(
            x.reshape(1, 2, 4, 16), f(3, 3, 16, 8)),
        "maxpool": lambda x: maxpool.maxpool2d(x.reshape(1, 2, 4, 16)),
        "blocked_layout": lambda x: reshuffle.blocked_layout(
            x.reshape(2, 4, 16)),
        "tiled_transpose": lambda x: reshuffle.tiled_transpose(
            x.reshape(8, 16)),
        "sampler": lambda x: sampler.sampler_noise(
            x, torch.zeros(1, dtype=torch.int64),
            torch.zeros(1, dtype=torch.int64), 8, draw=0),
    }


@pytest.mark.parametrize("name", list(_wrapper_calls()))
def test_kernel_wrappers_refuse_grad_requiring_inputs(name):
    """Each wrapper checks for autograd before the device: a
    grad-requiring input under grad mode raises (the kernel's output would
    have no grad_fn, and a loss through it would silently give its inputs
    no gradient); without grad mode the same call reaches the device check
    (CPU tensors go through ops). The sampler takes integer tensors, which
    cannot require grad: a float stand-in shows the order of its checks."""
    call = _wrapper_calls()[name]
    x = torch.zeros(1, 4, 2, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match="has no backward"):
        call(x)
    with torch.no_grad(), pytest.raises((ValueError, RuntimeError),
                                        match="CUDA"):
        call(x)


def test_training_forward_reaches_no_kernel(monkeypatch):
    """loss_and_grads with every attention entry of ``ops`` made to raise:
    the training forward attends through ``layers.flash_attention``."""
    def boom(*a, **k):
        raise AssertionError("the training forward reached a kernel")
    for name in ("attention", "paged_attention", "matmul", "sampler_noise"):
        monkeypatch.setattr(ops, name, boom)
    for arch in ("qwen2.5-3b", "seamless-m4t-large-v2"):
        jc, tc, _, tp = pair(arch)
        loss, _, _ = loss_and_grads(tc, tp, torch_batch(batch(jc, 1, 8)))
        assert torch.isfinite(loss)
