"""The training forward's pieces against the JAX package's, on the CPU:
``layers.flash_attention`` and its gradient against the jnp one (chunked
and one-shot, GQA, causal, window, ``kv_valid``) and against the kernels'
plain version, ``moe_apply``'s aux losses, the three remat policies, and
``api.forward``'s last logits against ``api.prefill``'s. fp32, numpy
inputs from a seed.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")     # held against the JAX package

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jlayers  # noqa: E402
from repro_torch.models import api, layers  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.runtime.trainer import loss_and_grads  # noqa: E402
from torch_train_cases import (one_thread, batch,  # noqa: E402, F401
                               pair, torch_batch)


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

FLASH_CASES = {
    # name: (B, Sq, Sk, H, KV, D, kwargs)
    "causal_gqa_padded": (2, 300, 300, 4, 2, 16, {}),
    "window": (1, 530, 530, 4, 1, 16, {"window": 100}),
    "noncausal_cross": (2, 37, 600, 4, 4, 8, {"causal": False}),
    "kv_valid": (1, 64, 96, 2, 1, 16, {"causal": False, "kv_valid": 70}),
    "small_chunks": (1, 50, 50, 2, 2, 8, {"q_chunk": 16, "kv_chunk": 8}),
    "one_shot_window": (2, 40, 40, 4, 2, 16, {"chunked": False,
                                              "window": 7}),
    "one_shot_kv_valid": (1, 20, 30, 2, 2, 8, {"chunked": False,
                                               "causal": False,
                                               "kv_valid": 11}),
}


@pytest.mark.parametrize("name", list(FLASH_CASES))
def test_flash_attention_and_its_gradient_equal_jax(name):
    B, Sq, Sk, H, KV, D, kw = FLASH_CASES[name]
    rng = np.random.default_rng(len(name))
    q, k, v, cot = (rng.standard_normal(s).astype(np.float32) for s in (
        (B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D), (B, Sq, H, D)))
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))

    def jf(q, k, v):
        return jnp.sum(jlayers.flash_attention(q, k, v, **kw) * cot)

    want, jg = jax.value_and_grad(jf, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = layers.flash_attention(tq, tk, tv, **kw)
    want_out = jlayers.flash_attention(jq, jk, jv, **kw)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=2e-5, atol=2e-5)
    (out * torch.from_numpy(cot)).sum().backward()
    for t, g in zip((tq, tk, tv), jg):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=0,
                                   atol=1e-4 * np.abs(g).max() + 1e-7)


def test_flash_attention_equals_the_kernels_plain_version():
    """The training attention and serving's (``ref.mha_ref``, what the
    kernel is held to) compute one function."""
    from repro_torch.kernels import ref
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 70, 4, 16)).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 70, 2, 16)).astype(
        np.float32)) for _ in range(2))
    for kw in ({}, {"window": 9}, {"causal": False}):
        torch.testing.assert_close(
            layers.flash_attention(q, k, v, q_chunk=32, kv_chunk=16, **kw),
            ref.mha_ref(q, k, v, **kw), rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# remat policies, forward against prefill
# ---------------------------------------------------------------------------


def test_remat_policies_give_equal_gradients():
    """none / full / dots recompute the same layer, so the gradients agree
    (to the fp32 rounding of a recomputation, here none at all)."""
    jc, tc, jp, tp = pair("qwen2.5-3b")
    b = torch_batch(batch(jc, 2, 24))
    out = {}
    for remat in ("none", "full", "dots"):
        loss, _, g = loss_and_grads(dataclasses.replace(tc, remat=remat),
                                    tp, b)
        out[remat] = (loss, g)
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        for a, c in zip(torch.utils._pytree.tree_leaves(out[remat][1]),
                        torch.utils._pytree.tree_leaves(out["none"][1])):
            torch.testing.assert_close(a, c, rtol=1e-6, atol=1e-9)


def test_dots_policy_saves_plain_matmuls_only():
    from torch.utils.checkpoint import CheckpointPolicy
    pol = tfm._save_plain_matmuls
    assert pol(None, torch.ops.aten.mm.default) == CheckpointPolicy.MUST_SAVE
    for op in (torch.ops.aten.bmm.default, torch.ops.aten.exp.default):
        assert pol(None, op) == CheckpointPolicy.PREFER_RECOMPUTE
    with pytest.raises(ValueError, match="remat"):
        tfm._remat(dataclasses.replace(pair("qwen2.5-3b")[1],
                                       remat="some"), tfm.block_train)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "internvl2-2b"])
def test_forward_last_logits_equal_prefill(arch):
    """The training forward (plain attention) and serving's prefill (the
    kernel's plain version on the CPU) give one set of last-position
    logits."""
    jc, tc, _, tp = pair(arch)
    b = torch_batch(batch(jc, 2, 33))
    logits, aux = api.forward(tc, tp, b)
    want, _, _ = api.prefill(tc, tp, b["tokens"].long(),
                             frontend_embeds=b.get("frontend_embeds"))
    torch.testing.assert_close(logits[:, -1], want, rtol=1e-5, atol=1e-5)
    assert logits.shape[1] == 33 + (4 if "frontend_embeds" in b else 0)


def test_moe_apply_aux_equals_jax():
    """moe_apply's aux losses against the reference's at T = 64 (32
    groups), and the serving call (no aux) unchanged."""
    jc, tc, jp, tp = pair("dbrx-132b")
    j = tfm.pattern_for(tc).index("attn_moe")
    jm = jax.tree.map(lambda a: a[0], jp["blocks"]["scan"][str(j)]["moe"])
    x = np.random.default_rng(9).standard_normal(
        (2, 32, tc.d_model)).astype(np.float32)
    want, waux = jlayers.moe_apply(jc, jm, jnp.asarray(x))
    out, aux = layers.moe_apply(tc, tp["blocks"][j]["moe"],
                                torch.from_numpy(x), aux=True)
    assert torch.equal(out, layers.moe_apply(tc, tp["blocks"][j]["moe"],
                                             torch.from_numpy(x)))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(want)).max())
    for k in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(aux[k].item(), float(waux[k]), rtol=1e-5)
