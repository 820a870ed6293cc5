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
    return jc, tc, jp, params_from_jax(tc, tree, device="cpu")


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


def test_bridge_defaults_to_cuda_and_raises_without_it(monkeypatch):
    jc, tc = configs("float32")
    tree = jax.tree.map(np.asarray, japi.init_params(jc, jax.random.key(0)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax(tc, tree)


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


# ---------------------------------------------------------------------------
# The dense-gather decode baseline (cfg.paged_attn_impl == "gather")
# ---------------------------------------------------------------------------


def close_cache(got, want):
    """Cache rows in the cache dtype: fp32 k/v that differ in their last
    bits may round to neighbouring values, one bf16 step (2^-7 relative at
    most) or one int8 step."""
    tol = dict(rtol=0, atol=1) if got.dtype == torch.int8 \
        else dict(rtol=2 ** -7, atol=1e-6)
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    np.testing.assert_allclose(got, want, **tol)


ATTEND_CASES = [
    # (B, Tq, S, H, KV, D, window, kv_chunk, pos): row t of request b sits
    # at pos[b] + t and the cache holds the block, so pos + Tq <= S
    (2, 1, 32, 4, 2, 16, 0, 0, [5, 31]),
    (2, 3, 32, 4, 2, 16, 0, 8, [0, 20]),       # kv_chunk < S: 4 chunks
    (2, 1, 32, 4, 4, 16, 7, 8, [3, 30]),       # window, G = 1
    (3, 2, 24, 6, 3, 16, 5, 16, [1, 10, 22]),  # 16 does not divide 24
    (1, 4, 64, 8, 1, 32, 9, 16, [40]),         # window inside a T block
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ATTEND_CASES)
def test_attend_decode_matches_jax(case, dtype):
    B, Tq, S, H, KV, D, window, chunk, pos = case
    rng = np.random.default_rng(S + Tq)
    q, ck, cv = (rng.standard_normal(shape).astype(np.float32) for shape in
                 ((B, Tq, H, D), (B, S, KV, D), (B, S, KV, D)))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    pos = np.asarray(pos, np.int32)
    want = jlayers.attend_decode(
        *(jnp.asarray(a, jdt) for a in (q, ck, cv)), jnp.asarray(pos),
        window=window, kv_chunk=chunk)
    got = layers.attend_decode(
        *(torch.from_numpy(a).to(tdt) for a in (q, ck, cv)),
        torch.from_numpy(pos), window=window, kv_chunk=chunk)
    assert got.dtype == tdt and got.shape == (B, Tq, H, D)
    close(got.float(), want.astype(jnp.float32), dtype)


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("T", [1, 3])
def test_gather_decode_matches_jax_and_the_kernel_path(T, kv_dtype):
    """api.decode_step with cfg.paged_attn_impl "gather" (dense pool gather,
    kv_dequant, attend_decode in kv_chunk pieces) against the JAX package's
    gather branch, and against the port's kernel path (the plain
    flash-decode), on pages of a shuffled table; the scattered rows too."""
    jc, tc, jp, tp = bridged("float32")
    jc, tc = (dataclasses.replace(c, kv_cache_dtype=kv_dtype,
                                  decode_kv_chunk=8) for c in (jc, tc))
    rng = np.random.default_rng(3 + T)
    B, page, nb = 2, 4, 8
    P = 1 + B * nb
    table = rng.permutation(np.arange(1, P, dtype=np.int32)).reshape(B, nb)
    L = np.array([9, 23], np.int32)
    kp = 2 * rng.standard_normal((tc.num_layers, P, page, 2, 16))
    vp = 2 * rng.standard_normal((tc.num_layers, P, page, 2, 16))
    if kv_dtype == "int8":
        kp, vp = (np.clip(np.round(a * 127 / tc.kv_scale), -127, 127)
                  for a in (kp, vp))
    jdt, tdt = jnp.dtype(kv_dtype), getattr(torch, kv_dtype)
    toks = rng.integers(0, jc.vocab, (B, T)).astype(np.int32)
    jpools = {"scan": {"0": {"k": jnp.asarray(kp, jdt),
                             "v": jnp.asarray(vp, jdt)}}, "tail": []}
    want, jnew = japi.decode_step(
        dataclasses.replace(jc, paged_attn_impl="gather"), jp, jpools,
        jnp.asarray(toks), jnp.asarray(L), block_table=jnp.asarray(table))
    out = {}
    for impl in ("gather", "kernel"):
        pools = [{"k": torch.from_numpy(kp[i]).to(tdt),
                  "v": torch.from_numpy(vp[i]).to(tdt)}
                 for i in range(tc.num_layers)]
        out[impl], _ = api.decode_step(
            dataclasses.replace(tc, paged_attn_impl=impl), tp, pools,
            torch.from_numpy(toks).long(), torch.from_numpy(L),
            block_table=torch.from_numpy(table))
        close_cache(pools[1]["v"], jnew["scan"]["0"]["v"][1])
    close(out["gather"], want, "float32")
    close(out["gather"], out["kernel"], "float32")


@pytest.mark.parametrize("arch", ["yi-6b", "qwen1.5-4b", "granite-3-2b"])
def test_new_configs_prefill_and_decode_logits_match_jax(arch):
    """The dense configs the port added after qwen2.5-3b, at their SMOKE
    sizes in fp32: GQA 2:1 at rope theta 5e6 (yi), MHA with QKV biases
    (qwen1.5), tied embeddings and a vocab of 250 padded to 256 (granite).
    Prefill logits, the cache, and one paged decode step's logits equal the
    JAX package's."""
    jc = dataclasses.replace(jcfg(arch), dtype="float32")
    tc = dataclasses.replace(tcfg(arch), dtype="float32")
    tree = jax.tree.map(np.asarray, japi.init_params(jc, jax.random.key(1)))
    tp = params_from_jax(tc, tree, device="cpu")
    jp = jax.tree.map(jnp.asarray, tree)
    assert ("head" in tp) == (not tc.tie_embeddings)
    rng = np.random.default_rng(4)
    B, S, page = 2, 16, 4
    toks = rng.integers(0, jc.vocab, (B, S)).astype(np.int32)
    L = np.array([13, 16], np.int32)
    jl, jcache, _ = japi.prefill(jc, jp, {"tokens": jnp.asarray(toks)},
                                 length=jnp.asarray(L))
    tl, tcache, _ = api.prefill(tc, tp, torch.from_numpy(toks).long(),
                                length=torch.from_numpy(L))
    assert tl.shape == (B, 256)
    close(tl, jl, "float32")
    close_cache(tcache[0]["v"], jcache["scan"]["0"]["v"][0])
    # the prefill's cache on pages in order, then one decode step
    nb = S // page + 1
    table = np.arange(1, 1 + B * nb, dtype=np.int32).reshape(B, nb)
    shape = (tc.num_layers, 1 + B * nb, page, tc.kv_heads, 16)
    kp, vp = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    for name, dst in (("k", kp), ("v", vp)):
        src = np.asarray(jcache["scan"]["0"][name].astype(jnp.float32))
        for b in range(B):
            for t in range(L[b]):
                dst[:, table[b, t // page], t % page] = src[:, b, t]
    nxt = rng.integers(0, jc.vocab, (B, 1)).astype(np.int32)
    jd, _ = japi.decode_step(
        jc, jp, {"scan": {"0": {"k": jnp.asarray(kp, jnp.bfloat16),
                                "v": jnp.asarray(vp, jnp.bfloat16)}},
                 "tail": []},
        jnp.asarray(nxt), jnp.asarray(L), block_table=jnp.asarray(table))
    td, _ = api.decode_step(
        tc, tp, [{"k": torch.from_numpy(kp[i]).bfloat16(),
                  "v": torch.from_numpy(vp[i]).bfloat16()}
                 for i in range(tc.num_layers)],
        torch.from_numpy(nxt).long(), torch.from_numpy(L),
        block_table=torch.from_numpy(table))
    close(td, jd, "float32")
