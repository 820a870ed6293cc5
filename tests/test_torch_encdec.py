"""The port's encoder-decoder stack (seamless-m4t-large-v2 SMOKE: 2 + 2
layers, d 64, layernorm, ungated tanh-gelu) and the dense lanes' decode
attention, against the JAX package on the CPU.

Held at the model level, as the reference can be: ``api.prefill`` with
``enc_embeds`` (the frames frontend stub's frame embeddings) and greedy
``api.decode_step``s on the prefill's own cache. Serving an
encoder-decoder fails in both packages' engines (the reference's dense
engine prefills tokens alone).

Tolerance, fp32: 1e-5 of the largest magnitude of the reference's output
(the same fp32 arithmetic in another order: the port's attention is
flash-MHA's plain version, the reference's a chunked online softmax);
greedy tokens equal. The int8 KV cache: the reference's own bounds
against fp32 (``tests/test_kv_int8.py``), and the two packages' int8
lanes within one quantization step.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")     # held against the JAX package

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs import get_smoke_config as jcfg  # noqa: E402
from repro.kernels import attention as jattention  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.runtime import serving as jserving  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import api, layers  # noqa: E402
from repro_torch.runtime.serving import (DenseServingEngine,  # noqa: E402
                                         PagedServingEngine, Request)

SEAMLESS = "seamless-m4t-large-v2"
REL = 1e-5
B, S, S_ENC, MAX_LEN = 2, 9, 13, 32


@functools.lru_cache(maxsize=None)
def pair(kv="float32"):
    over = dict(dtype="float32", kv_cache_dtype=kv, kv_scale=8.0)
    jc = dataclasses.replace(jcfg(SEAMLESS), **over)
    tc = dataclasses.replace(get_smoke_config(SEAMLESS), **over)
    jp = japi.init_params(jc, jax.random.key(0))
    return jc, tc, jp, params_from_jax(tc, jax.tree.map(np.asarray, jp),
                                       device="cpu")


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    d = get_smoke_config(SEAMLESS).d_model
    return (rng.integers(0, 256, (B, S)),
            rng.standard_normal((B, S_ENC, d)).astype(np.float32))


def close(got, want, rel=REL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


@functools.lru_cache(maxsize=None)
def runs(kv="float32", steps=8):
    """Both packages' prefill (max_len 32) then ``steps`` greedy decode
    steps on the prefill's own cache: {"prefill": (jax logits, port
    logits, jax cache, port cache), "decode": (jax logits, port logits,
    jax tokens, port tokens, jax cache, port cache)}; the port's prefill
    cache is cloned before the steps write its lanes in place."""
    jc, tc, jp, tp = pair(kv)
    toks, enc = inputs()
    jl, jcache, jpos = japi.prefill(
        jc, jp, {"tokens": jnp.asarray(toks, jnp.int32),
                 "enc_embeds": jnp.asarray(enc)}, max_len=MAX_LEN)
    tl, tcache, tpos = api.prefill(tc, tp, torch.from_numpy(toks),
                                   enc_embeds=torch.from_numpy(enc),
                                   max_len=MAX_LEN)
    assert tpos.tolist() == np.asarray(jpos).tolist() == [S] * B
    out = {"prefill": (jl, tl, jcache,
                       [{n: t.clone() for n, t in e.items()}
                        for e in tcache])}
    jls, tls, jts, tts = [np.asarray(jl)], [tl.numpy()], [], []
    for _ in range(steps):
        jt = np.asarray(jnp.argmax(jl[:, :jc.vocab], -1))
        tt = tl[:, :tc.vocab].argmax(-1)
        jts.append(jt)
        tts.append(tt.numpy())
        jl, jcache = japi.decode_step(jc, jp, jcache,
                                      jnp.asarray(jt[:, None], jnp.int32),
                                      jpos)
        tl, tcache = api.decode_step(tc, tp, tcache, tt[:, None], tpos)
        jpos, tpos = jpos + 1, tpos + 1
        jls.append(np.asarray(jl))
        tls.append(tl.numpy())
    out["decode"] = (np.stack(jls), np.stack(tls), np.stack(jts),
                     np.stack(tts), jcache, tcache)
    return out


def lanes(jcache, tcache, name):
    return (np.asarray(jcache["scan"]["0"][name]),
            np.stack([e[name].float().numpy() for e in tcache]))


def test_seamless_prefill_matches_jax():
    """The prefill's last-position logits and every decoder layer's lanes:
    self-attention k/v padded to max_len, cross-attention xk/xv of the
    encoder's S_enc frames."""
    jl, tl, jcache, tcache = runs()["prefill"]
    close(tl, jl)
    for name, rows in (("k", MAX_LEN), ("v", MAX_LEN), ("xk", S_ENC),
                       ("xv", S_ENC)):
        want, got = lanes(jcache, tcache, name)
        assert got.shape == want.shape == (2, B, rows, 4, 16)
        close(got, want)


def test_seamless_encoder_matches_jax():
    jc, tc, jp, tp = pair()
    _, enc = inputs(1)
    from repro.models.api import _encode
    want = _encode(jc, jp, jnp.asarray(enc), japi.NO_RULES)
    close(api.encode(tc, tp, torch.from_numpy(enc)), want)


def test_seamless_decode_steps_match_jax():
    """8 greedy decode steps on the prefill's cache: equal tokens, logits
    within tolerance at every step, and the lanes after the last step
    (the cross lanes unchanged by decode)."""
    run = runs()
    jl, tl, jt, tt, jcache, tcache = run["decode"]
    assert (jt == tt).all()
    for j, t in zip(jl, tl):
        close(t, j)
    for name in ("k", "v", "xk", "xv"):
        close(*lanes(jcache, tcache, name)[::-1])
    for e, f in zip(tcache, run["prefill"][3]):
        assert torch.equal(e["xk"], f["xk"]) and torch.equal(e["xv"],
                                                             f["xv"])


def test_seamless_int8_cache_tracks_fp32_and_jax():
    """The int8 KV cache (``kv_cache_dtype="int8"``): the lanes are int8,
    the logits track the fp32 cache's as the reference requires of its own
    (max abs error < 0.7, greedy agreement >= 0.8), the greedy tokens
    equal the JAX package's int8 run, and the two packages' lanes differ
    by at most one quantization step."""
    jl8, tl8, jt8, tt8, jcache, tcache = runs("int8")["decode"]
    tl32 = runs()["decode"][1]
    assert all(e[n].dtype == torch.int8 for e in tcache for n in e)
    assert np.abs(tl8 - tl32).max() < 0.7
    assert (tl8.argmax(-1) == tl32.argmax(-1)).mean() >= 0.8
    assert (jt8 == tt8).all()
    for name in ("k", "v", "xk", "xv"):
        want, got = lanes(jcache, tcache, name)
        assert np.abs(got - want.astype(np.float32)).max() <= 1


def test_seamless_params_and_counts_match_jax():
    """``init_params`` builds the reference's tree (the decoder blocks'
    ``lnx`` and ``cross``, the ``enc`` subtree), leaf for leaf in shape,
    and ``param_count`` (with its encoder branch) equals the reference's,
    for CONFIG and SMOKE."""
    jc, tc, jp, tp = pair()
    mine = api.init_params(tc, torch.Generator().manual_seed(0),
                           device="cpu")

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return tuple(tree.shape)
    assert shapes(mine) == shapes(tp)
    assert set(mine["blocks"][0]) == {"ln1", "attn", "lnx", "cross", "ln2",
                                      "mlp"}
    assert len(mine["enc"]["blocks"]) == tc.enc_layers
    n_port = sum(int(np.prod(s)) for s in jax.tree.leaves(
        shapes(mine), is_leaf=lambda x: isinstance(x, tuple)))
    assert n_port == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jp))
    for getter in (get_config, get_smoke_config):
        cfg = getter(SEAMLESS)
        want = getattr(jconfigs, getter.__name__)(SEAMLESS)
        assert cfg.param_count() == want.param_count()
        assert cfg.active_param_count() == want.active_param_count()
    # encoder and cross-attention counted: 24 + 24 layers, ~1.63 B
    assert get_config(SEAMLESS).param_count() == 1_632_006_144


def test_serving_seamless_fails_in_both_packages():
    """The reference's dense engine prefills tokens alone and its model
    raises ``KeyError('enc_embeds')``; the port's raises ``ValueError``
    naming enc_embeds. Both paged engines refuse the ``dec`` kind."""
    jc, tc, jp, tp = pair()
    jeng = jserving.DenseServingEngine(jc, jp, slots=2, max_len=32)
    with pytest.raises(KeyError, match="enc_embeds"):
        jeng.submit(jserving.Request(rid=0, prompt=[1, 2, 3], max_new=2))
    eng = DenseServingEngine(tc, tp, slots=2, max_len=32, device="cpu")
    with pytest.raises(ValueError, match="enc_embeds"):
        eng.submit(Request(rid=0, prompt=[1, 2, 3], max_new=2))
    for make, p in ((jserving.PagedServingEngine, jp),
                    (functools.partial(PagedServingEngine, device="cpu"),
                     tp)):
        with pytest.raises(ValueError, match="paged serving cannot host"):
            make(jc if p is jp else tc, p, slots=2, max_len=32)
    for cache_init, c in ((japi.paged_cache_init, jc),
                          (functools.partial(api.paged_cache_init,
                                             device="cpu"), tc)):
        with pytest.raises(ValueError, match="paged cache cannot host"):
            cache_init(c, 2, 4, 4) if cache_init is japi.paged_cache_init \
                else cache_init(c, 4, 4, slots=2)


def test_multi_token_decode_on_dense_lanes_raises_as_the_reference():
    jc, tc, jp, tp = pair()
    toks = np.ones((1, 3), np.int64)
    with pytest.raises(ValueError, match=r"\['dec'\]"):
        japi.decode_step(jc, jp, japi.cache_init(jc, 1, 16),
                         jnp.asarray(toks, jnp.int32),
                         jnp.zeros((1,), jnp.int32))
    with pytest.raises(ValueError, match=r"\['dec'\]"):
        api.decode_step(tc, tp, api.cache_init(tc, 1, 16, device="cpu"),
                        torch.from_numpy(toks),
                        torch.zeros((1,), dtype=torch.int32))


def test_cache_init_lanes_match_jax():
    """``cache_init``'s lanes, layer for layer, in shape and dtype: the
    ``dec`` kind's four, a dense stack's two, recurrentgemma's window
    rings and recurrent state."""
    for arch in (SEAMLESS, "qwen2.5-3b", "recurrentgemma-9b"):
        jc, tc = jcfg(arch), get_smoke_config(arch)
        want = japi.cache_init(jc, 3, 40)
        got = api.cache_init(tc, 3, 40, device="cpu")
        n_super = len(got) // len(want["scan"]) if want["scan"] else 0
        flat = [jax.tree.map(lambda a, s=s: a[s], want["scan"][str(j)])
                for s in range(n_super) for j in range(len(want["scan"]))]
        flat += want["tail"]
        assert len(flat) == len(got)
        for w, g in zip(flat, got):
            assert set(w) == set(g)
            for name in w:
                assert tuple(g[name].shape) == w[name].shape
                assert str(g[name].dtype)[6:] == str(w[name].dtype)


# ---------------------------------------------------------------------------
# the plain oracles of the dense lanes' attention
# ---------------------------------------------------------------------------

# (B, Sq, Sk, H, KV, D, kv_valid): one decode row a slot (the dense lanes;
# a ring's min(pos + 1, W) among the counts), and the cross prefill's
# Sq != Sk, non-causal
ORACLE_CASES = [(4, 1, 24, 4, 2, 16, [1, 7, 24, 13]),
                (3, 1, 16, 4, 4, 16, [16, 16, 2]),
                (2, 9, 13, 4, 4, 16, [13, 13]),
                (2, 20, 7, 8, 2, 32, [7, 3])]


def _qkv(case, seed):
    Bq, Sq, Sk, H, KV, D, _ = case
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((Bq, Sq, H, D)).astype(np.float32),
            rng.standard_normal((Bq, Sk, KV, D)).astype(np.float32),
            rng.standard_normal((Bq, Sk, KV, D)).astype(np.float32))


@pytest.mark.parametrize("case", ORACLE_CASES, ids=str)
def test_attention_non_causal_kv_valid_matches_jax_oracles(case):
    """``ops.attention(causal=False, kv_valid=(B,) tensor)`` on the CPU
    against the JAX package's ``ref.mha_ref`` (batch by batch, its kv_valid
    an int) and its Pallas mha in interpret mode."""
    q, k, v = _qkv(case, sum(case[:6]))
    valid = np.asarray(case[6], np.int32)
    got = ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=False,
                        kv_valid=torch.from_numpy(valid)).numpy()
    for b in range(q.shape[0]):
        want = jref.mha_ref(jnp.asarray(q[b:b + 1]), jnp.asarray(k[b:b + 1]),
                            jnp.asarray(v[b:b + 1]), causal=False,
                            kv_valid=int(valid[b]))
        np.testing.assert_allclose(got[b:b + 1], np.asarray(want),
                                   atol=2e-5, rtol=2e-5)
    pallas = jattention.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=False, kv_valid=jnp.asarray(valid),
                            interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("ring", [False, True])
def test_dense_decode_attention_equals_attend_decode(ring):
    """One decode row a slot over a lane: ``ops.attention(causal=False,
    kv_valid=min(pos + 1, S))`` (the dense engine's call) equals the
    reference's ``attend_decode`` (``ring=`` the lane's layout) and the
    port's copy of it, at positions below, at and past the lane length
    (a ring wraps; a contiguous lane sees all S rows)."""
    Bq, S, H, KV, D = 5, 16, 4, 2, 16
    q, k, v = _qkv((Bq, 1, S, H, KV, D, None), 3)
    pos = np.asarray([0, 5, 15, 16, 40], np.int32)
    n = torch.clamp(torch.from_numpy(pos) + 1, max=S).to(torch.int32)
    got = ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=False, kv_valid=n)
    want = jlayers.attend_decode(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(pos),
                                 ring=ring) if ring else \
        jlayers.attend_decode(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v),
                              jnp.asarray(np.minimum(pos, S - 1)))
    close(got, want)
    mine = layers.attend_decode(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), torch.from_numpy(pos),
                                ring=ring) if ring else \
        layers.attend_decode(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v),
                             torch.from_numpy(np.minimum(pos, S - 1)))
    close(mine, want)


def test_attend_decode_ring_is_single_token():
    q = torch.zeros((1, 2, 4, 16))
    kv = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="single-token"):
        layers.attend_decode(q, kv, kv, torch.zeros(1, dtype=torch.int32),
                             ring=True)


@pytest.mark.parametrize("window", [0, 6])
def test_dense_attention_decode_matches_jax(window):
    """The dense mode of ``attention_decode`` against the reference's (its
    one-hot write at ``pos % S`` on a window ring, ``min(pos, S - 1)``
    otherwise): the output and the lane after the write, at positions
    below and past the lane length."""
    cfg = dataclasses.replace(jcfg("qwen2.5-3b"), dtype="float32",
                              kv_cache_dtype="float32")
    tc = dataclasses.replace(get_smoke_config("qwen2.5-3b"),
                             dtype="float32", kv_cache_dtype="float32")
    rng = np.random.default_rng(window)
    d, h, kv, hd = tc.d_model, tc.num_heads, tc.kv_heads, 16
    shapes = {"wq": (d, h, hd), "wk": (d, kv, hd), "wv": (d, kv, hd),
              "wo": (h, hd, d), "bq": (h, hd), "bk": (kv, hd),
              "bv": (kv, hd)}
    weights = {k: (rng.standard_normal(sh) * 0.2).astype(np.float32)
               for k, sh in shapes.items()}
    jattn = {k: jnp.asarray(a) for k, a in weights.items()}
    tattn = {k: torch.from_numpy(a) for k, a in weights.items()}
    S = window or 12
    x = rng.standard_normal((4, 1, tc.d_model)).astype(np.float32)
    lane = rng.standard_normal((4, S, tc.kv_heads, 16)).astype(np.float32)
    pos = np.asarray([0, 3, S - 1, S + 7], np.int32)
    want, wc = jlayers.attention_decode(
        cfg, jattn, jnp.asarray(x), {"k": jnp.asarray(lane),
                                     "v": jnp.asarray(lane * 2)},
        jnp.asarray(pos), window=window)
    cache = {"k": torch.from_numpy(lane.copy()),
             "v": torch.from_numpy(lane * 2)}
    tpos = torch.from_numpy(pos)
    got, _ = layers.attention_decode(
        tc, tattn, torch.from_numpy(x), cache, tpos,
        rows=layers.dense_rows(tpos, S, window > 0), window=window)
    close(got, want)
    close(cache["k"], wc["k"])
    close(cache["v"], wc["v"])
