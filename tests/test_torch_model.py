"""The port's model stack against the JAX package's, on the qwen2.5-3b SMOKE
config: layer functions, the weight bridge, prefill and paged decode logits.

Inputs and weights are made once, by the JAX package's init or by numpy
from a seed, and fed to both packages (weights through
``repro_torch.convert.params_from_jax``). Tolerances: fp32 atol = rtol =
2e-5 — the same fp32 arithmetic in another order; bf16: 2e-2 of the largest
logit — bf16 weights and activations round at 2^-8 relative in each of the
two layers, at other places in the two frameworks.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")     # held against the JAX package

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jcfg  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.configs import get_smoke_config as tcfg  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import api, layers  # noqa: E402

F32 = dict(atol=2e-5, rtol=2e-5)


def configs(dtype):
    return (dataclasses.replace(jcfg("qwen2.5-3b"), dtype=dtype),
            dataclasses.replace(tcfg("qwen2.5-3b"), dtype=dtype))


def bridged(dtype, seed=0):
    """JAX params (with nonzero QKV biases, so the bias path counts) and
    their port twin."""
    jc, tc = configs(dtype)
    tree = jax.tree.map(np.asarray, japi.init_params(jc, jax.random.key(0)))
    rng = np.random.default_rng(seed)
    attn = tree["blocks"]["scan"]["0"]["attn"]
    for name in ("bq", "bk", "bv"):
        attn[name] = (0.1 * rng.standard_normal(attn[name].shape)).astype(
            attn[name].dtype)
    jp = jax.tree.map(jnp.asarray, tree)
    return jc, tc, jp, params_from_jax(tc, tree)


def close(got, want, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32)
    else:
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_layer_functions_match_jax():
    rng = np.random.default_rng(1)
    jc, tc = configs("float32")
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    for kind in ("rmsnorm", "layernorm"):
        close(layers.norm_apply({"scale": torch.from_numpy(scale),
                                 "bias": torch.from_numpy(bias)},
                                torch.from_numpy(x), kind),
              jlayers.norm_apply({"scale": jnp.asarray(scale),
                                  "bias": jnp.asarray(bias)},
                                 jnp.asarray(x), kind), "float32")
    h = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [7, 100, 1000, 5000, 9999]], np.int32)
    close(layers.rope(torch.from_numpy(h), torch.from_numpy(pos), 1e6),
          jlayers.rope(jnp.asarray(h), jnp.asarray(pos), 1e6), "float32")
    mlp = {n: rng.standard_normal(s).astype(np.float32) * 0.1 for n, s in
           (("wi", (64, 128)), ("wg", (64, 128)), ("wo", (128, 64)))}
    for act, gated in (("silu", True), ("gelu", False)):
        tca = dataclasses.replace(tc, act=act, gated_ffn=gated)
        jca = dataclasses.replace(jc, act=act, gated_ffn=gated)
        close(layers.mlp_apply(tca, {k: torch.from_numpy(v) for k, v in
                                     mlp.items()}, torch.from_numpy(x)),
              jlayers.mlp_apply(jca, {k: jnp.asarray(v) for k, v in
                                      mlp.items()}, jnp.asarray(x)),
              "float32")
    q8 = dataclasses.replace(tc, kv_cache_dtype="int8")
    j8 = dataclasses.replace(jc, kv_cache_dtype="int8")
    kv = 3 * rng.standard_normal((2, 5, 2, 16)).astype(np.float32)
    got = layers.kv_quant(q8, torch.from_numpy(kv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jlayers.kv_quant(j8, jnp.asarray(kv))))
    close(layers.kv_dequant(q8, got, torch.float32),
          jlayers.kv_dequant(j8, jnp.asarray(got.numpy()), jnp.float32),
          "float32")


def test_bridge_unstacks_every_layer():
    jc, tc, jp, tp = bridged("float32")
    assert len(tp["blocks"]) == tc.num_layers
    for i, blk in enumerate(tp["blocks"]):
        want = np.asarray(jp["blocks"]["scan"]["0"]["attn"]["wq"][i])
        np.testing.assert_array_equal(blk["attn"]["wq"].numpy(), want)
    np.testing.assert_array_equal(tp["head"].numpy(), np.asarray(jp["head"]))


def test_init_params_matches_jax_tree():
    """The port's own init gives the JAX tree's names, shapes and dtypes
    (and the Maker's scales, to a statistical tolerance)."""
    jc, tc, jp, tp = bridged("bfloat16")
    gen = torch.Generator().manual_seed(0)
    mine = api.init_params(tc, gen, device="cpu")

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return (tuple(tree.shape), str(tree.dtype))

    assert shapes(mine) == shapes(tp)
    std = mine["blocks"][0]["mlp"]["wo"].float().std().item()
    assert abs(std - tc.d_ff ** -0.5) < 0.1 * tc.d_ff ** -0.5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_paged_decode_logits_match_jax(dtype):
    jc, tc, jp, tp = bridged(dtype)
    rng = np.random.default_rng(2)
    B, S, page, nb = 2, 16, 4, 8
    toks = rng.integers(0, jc.vocab, (B, S)).astype(np.int32)
    L = np.array([11, 16], np.int32)
    jl, jcache, _ = japi.prefill(jc, jp, {"tokens": jnp.asarray(toks)},
                                 length=jnp.asarray(L))
    tl, tcache, tpos = api.prefill(tc, tp, torch.from_numpy(toks).long(),
                                   length=torch.from_numpy(L))
    assert tl.shape == (B, 256) and torch.equal(tpos, torch.from_numpy(L))
    close(tl, jl, dtype)
    close(tcache[1]["k"].float(), jcache["scan"]["0"]["k"][1], dtype)

    # the JAX prefill's cache, laid out on pages by a shuffled table, then
    # one decode step (T = 1) and a T = 3 block in both packages
    P = 1 + B * nb
    table = rng.permutation(np.arange(1, P, dtype=np.int32)).reshape(B, nb)
    jk = np.asarray(jcache["scan"]["0"]["k"].astype(jnp.float32))
    jv = np.asarray(jcache["scan"]["0"]["v"].astype(jnp.float32))
    kp = np.zeros((tc.num_layers, P, page, 2, 16), np.float32)
    vp = np.zeros_like(kp)
    for b in range(B):
        for t in range(L[b]):
            kp[:, table[b, t // page], t % page] = jk[:, b, t]
            vp[:, table[b, t // page], t % page] = jv[:, b, t]
    for T in (1, 3):
        nxt = rng.integers(0, jc.vocab, (B, T)).astype(np.int32)
        # pools in the cache dtype (bf16 by default, whatever the model's)
        jdt = jnp.dtype(jc.kv_cache_dtype)
        jpools = {"scan": {"0": {"k": jnp.asarray(kp, jdt),
                                 "v": jnp.asarray(vp, jdt)}}, "tail": []}
        tdt = getattr(torch, tc.kv_cache_dtype)
        tpools = [{"k": torch.from_numpy(kp[i]).to(tdt),
                   "v": torch.from_numpy(vp[i]).to(tdt)}
                  for i in range(tc.num_layers)]
        jd, jnew = japi.decode_step(jc, jp, jpools, jnp.asarray(nxt),
                                    jnp.asarray(L),
                                    block_table=jnp.asarray(table))
        td, _ = api.decode_step(tc, tp, tpools, torch.from_numpy(nxt).long(),
                                torch.from_numpy(L),
                                block_table=torch.from_numpy(table))
        assert td.shape == ((B, 256) if T == 1 else (B, T, 256))
        close(td, jd, dtype)
        # the in-place scatter wrote the same rows the JAX step returns
        close(tpools[0]["k"].float(), jnew["scan"]["0"]["k"][0], dtype)


def test_decode_rows_past_the_table_go_to_scratch():
    """A position past the block table's capacity writes scratch page 0
    and no live page."""
    _, tc, _, tp = bridged("float32")
    page, nb = 4, 2
    pools = api.paged_cache_init(tc, 1 + nb, page, device="cpu")
    table = torch.tensor([[1, 2]], dtype=torch.int32)
    pos = torch.tensor([nb * page], dtype=torch.int32)   # one past the end
    api.decode_step(tc, tp, pools, torch.tensor([[3]]), pos,
                    block_table=table)
    for pool in pools:
        assert pool["k"][1:].abs().sum() == 0
        assert pool["k"][0].abs().sum() > 0
