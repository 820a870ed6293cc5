"""The port's hybrid and recurrent layers against the JAX package's, at the
SMOKE configs (``rgemma-smoke``: 5 layers, window 16; ``mamba2-smoke``).

The same numpy-seeded inputs and JAX-initialised weights go through
``repro.models.griffin`` / ``repro.models.ssm`` and their port
(``repro_torch.models.griffin`` / ``.ssm``), the windowed flash-MHA's plain
version against ``layers.flash_attention(window=)``, the windowed paged
plain version against the JAX Pallas kernel in interpret mode, the
allocator's sliding-window half against the reference's tests, and the
whole hybrid models' prefill and decode logits against ``repro.models.api``.

Tolerance: fp32 atol 2e-5, rtol 1e-5 (``SCAN``). The port's RG-LRU
recurrence is a doubling scan and the reference's an associative scan,
and the SSD chunk products and conv sums run in other orders: the same
fp32 arithmetic in another order of the sums.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")     # held against the JAX package

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jcfg  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import griffin as jgriffin  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.layers import Maker, flash_attention  # noqa: E402
from repro_torch.configs import get_smoke_config as tcfg  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import griffin, ssm  # noqa: E402
from repro_torch.runtime.kv_cache import PageAllocator  # noqa: E402
from torch_cases import F32, mha_inputs, paged_case  # noqa: E402

SCAN = dict(atol=2e-5, rtol=1e-5)   # fp32, the scans' order of the sums
ARCHS = ("recurrentgemma-9b", "mamba2-2.7b")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _tree(tree):
    if isinstance(tree, dict):
        return {k: _tree(v) for k, v in tree.items()}
    return _t(tree)


def _close(got: torch.Tensor, want, **tol) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or SCAN))


def _f32(arch):
    """The SMOKE config at fp32, its KV cache too, in both packages."""
    over = dict(dtype="float32", kv_cache_dtype="float32")
    return (dataclasses.replace(jcfg(arch), **over),
            dataclasses.replace(tcfg(arch), **over))


def _mixer(arch):
    """(jax cfg, torch cfg, jax mixer params, torch mixer params, jax
    module, port module) at fp32."""
    jc, tc = _f32(arch)
    mk = Maker("init", jax.random.key(0), jnp.float32)
    if arch == "mamba2-2.7b":
        jp = jssm.ssm_init(mk, jc)
        return jc, tc, jp, _tree(jp), jssm, ssm
    jp = jgriffin.rglru_init(mk, jc)
    return jc, tc, jp, _tree(jp), jgriffin, griffin


def _apply(mod, name):
    return getattr(mod, "ssm_" + name if mod in (jssm, ssm)
                   else "rglru_" + name)


def _x(cfg, *shape, seed=1):
    return np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)


# ---------------------------------------------------------------------------
# The mixers: prefill and decode forms, against the JAX ones
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("length", [None, 11], ids=["exact", "padded"])
@pytest.mark.parametrize("arch", ARCHS)
def test_mixer_apply_matches_jax(arch, length):
    """The full-sequence form and its state at ``length`` (bucket padding
    past it), at a sequence of 19: ragged against the SSD chunk (8)."""
    jc, tc, jp, tp, jm, tm = _mixer(arch)
    x = _x(tc, 2, 19)
    jout, jst = _apply(jm, "apply")(jc, jp, jnp.asarray(x),
                                    return_state=True, length=length)
    tout, tst = _apply(tm, "apply")(tc, tp, _t(x), return_state=True,
                                    length=length)
    _close(tout, jout)
    assert set(tst) == set(jst)
    for name in jst:
        assert tst[name].dtype == torch.float32
        _close(tst[name], jst[name])


@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_mixer_decode_matches_jax(arch, T):
    """T = 1 plain states, T = 4 checkpointed ones, from a state that a
    prefill left."""
    jc, tc, jp, tp, jm, tm = _mixer(arch)
    x0, x = _x(tc, 2, 9), _x(tc, 2, T, seed=2)
    _, jst = _apply(jm, "apply")(jc, jp, jnp.asarray(x0), return_state=True)
    jout, jnew = _apply(jm, "decode")(jc, jp, jnp.asarray(x), jst)
    tout, tnew = _apply(tm, "decode")(tc, tp, _t(x), _tree(jst))
    _close(tout, jout)
    for name in jnew:
        assert tnew[name].shape == tuple(jnew[name].shape)
        _close(tnew[name], jnew[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_multitoken_checkpoints_equal_single_steps(arch):
    """A T > 1 block's checkpointed state t equals the state after t + 1
    single-token steps, and its outputs the steps' outputs (the port of
    tests/test_hybrid_paging.py's two checkpoint tests)."""
    _, tc, _, tp, _, tm = _mixer(arch)
    B, T = 2, 4
    x = _t(_x(tc, B, T))
    st = {name: torch.zeros(sh, dtype=dt) for name, (sh, dt) in
          api._state_shapes(tc, "ssm" if tm is ssm else "rglru",
                            B).items()}
    out_blk, ck = _apply(tm, "decode")(tc, tp, x, st)
    c = st
    for t in range(T):
        out_t, c = _apply(tm, "decode")(tc, tp, x[:, t:t + 1], c)
        torch.testing.assert_close(out_blk[:, t], out_t[:, 0], **SCAN)
        for name in c:
            torch.testing.assert_close(ck[name][:, t], c[name], **SCAN)


def test_doubling_scan_is_the_linear_recurrence():
    """``griffin._scan`` computes h_t = a_t h_{t-1} + b_t from 0 at lengths
    on both sides of a power of two."""
    rng = np.random.default_rng(3)
    for S in (1, 2, 7, 8, 9, 33):
        a = _t(rng.uniform(0.5, 1.0, (2, S, 5)).astype(np.float32))
        b = _t(rng.standard_normal((2, S, 5)).astype(np.float32))
        h, want = torch.zeros(2, 5), []
        for t in range(S):
            h = a[:, t] * h + b[:, t]
            want.append(h)
        torch.testing.assert_close(griffin._scan(a, b), torch.stack(want, 1),
                                   **SCAN)


@pytest.mark.parametrize("arch", ARCHS)
def test_padded_prefill_state_equals_exact_prefill(arch):
    """Bucket-padded prefill with ``length`` yields the exact-length
    prefill's logits and recurrent states (the port of
    tests/test_hybrid_paging.py's test of that name)."""
    jc, tc = _f32(arch)
    tp = params_from_jax(tc, jax.tree.map(
        np.asarray, japi.init_params(jc, jax.random.key(0))), device="cpu")
    toks = np.random.default_rng(1).integers(0, tc.vocab, (1, 11))
    lg_e, cache_e, _ = api.prefill(tc, tp, _t(toks))
    padded = np.pad(toks, ((0, 0), (0, 5)))
    lg_p, cache_p, pos_p = api.prefill(tc, tp, _t(padded),
                                       length=torch.tensor([11]))
    assert int(pos_p[0]) == 11
    torch.testing.assert_close(lg_e, lg_p, atol=1e-5, rtol=1e-5)
    checked = 0
    for e, p in zip(cache_e, cache_p):
        for name in set(e) & {"h", "conv", "ssm"}:
            torch.testing.assert_close(e[name], p[name], atol=1e-4,
                                       rtol=1e-4)
            checked += 1
    assert checked > 0


# ---------------------------------------------------------------------------
# Windowed attention: the plain versions against the JAX ones
# ---------------------------------------------------------------------------

WINDOW_MHA = [
    # (B, Sq, Sk, H, KV, D, window, q_offset)
    (2, 40, 40, 4, 1, 16, 16, 0),
    (1, 37, 37, 8, 2, 32, 5, 0),
    (1, 25, 62, 4, 1, 16, 16, 37),    # a suffix past an offset
    (2, 30, 70, 4, 2, 16, 1, 40),     # window 1: the diagonal alone
    (1, 64, 64, 4, 1, 256 // 8, 100, 0),   # window past every row
]


@pytest.mark.parametrize("case", WINDOW_MHA, ids=str)
def test_windowed_mha_plain_matches_flash_attention(case):
    """``ops.attention(window=, q_offset=)`` on the CPU (``ref.mha_ref``)
    equals the JAX package's ``layers.flash_attention(window=, q_offset=)``
    (the Pallas kernel has no window)."""
    B, Sq, Sk, H, KV, D, window, off = case
    q, k, v = mha_inputs(Sq + window, B, Sq, Sk, H, KV, D)
    got = ops.attention(_t(q), _t(k), _t(v), causal=True, q_offset=off,
                        window=window)
    want = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=True, window=window, q_offset=off,
                           q_chunk=16, kv_chunk=16)
    _close(got, want, **F32)
    # the band matters: one key wider moves the output
    wider = ops.attention(_t(q), _t(k), _t(v), causal=True, q_offset=off,
                          window=window + 1)
    if window < off + Sq:
        assert not torch.allclose(got, wider, **F32)


@pytest.mark.parametrize("T", [1, 5])
def test_windowed_paged_plain_matches_jax_kernel(T):
    """The windowed paged plain version against the JAX Pallas kernel in
    interpret mode, with every entry below the earliest row's window on a
    poisoned scratch page 0 (recycled, as the engine leaves them)."""
    B, H, KV, D, page, nb, window = 3, 8, 1, 16, 4, 12, 9
    lengths = [T + 2, 30, 47]
    q, kp, vp, table, lens = paged_case(40 + T, B, T, H, KV, D, page, nb,
                                        lengths, poison=True)
    for b, n in enumerate(lengths):
        dead = max(0, n - T - window + 1) // page
        table[b, :dead] = 0
    got = ops.paged_attention(*map(_t, (q, kp, vp, table, lens)),
                              window=window)
    want = jops.paged_attention(*map(jnp.asarray, (q, kp, vp, table, lens)),
                                window=window)
    _close(got, want, **F32)
    assert np.isfinite(got.numpy()).all()


# ---------------------------------------------------------------------------
# The allocator's sliding-window half (tests/test_hybrid_paging.py:46-122)
# ---------------------------------------------------------------------------


def test_allocate_with_base_blocks_skips_pre_window_pages():
    a = PageAllocator(8, 4)
    # 30-token prompt, window leaves blocks 0..4 dead: only 3 live pages
    t = a.allocate(0, 30, base_blocks=5)
    assert len(t) == 3 and a.allocated_pages == 3
    assert a.base_blocks(0) == 5
    assert a.tokens(0) == 30
    assert a.live_tokens == 30 - 5 * 4      # tokens resident in live pages
    a.check()


def test_release_prefix_recycles_and_preserves_logical_indexing():
    a = PageAllocator(8, 4)
    t = a.allocate(0, 16)                   # blocks 0..3
    assert a.release_prefix(0, 2) == 2      # blocks 0,1 slid out
    assert a.base_blocks(0) == 2
    assert a.block_table(0) == t[2:]
    assert a.free_pages == 6
    # extend_to keeps counting in absolute tokens: block 4 is next
    got = a.extend_to(0, 17)
    assert got not in (0, None)
    assert a.block_table(0) == t[2:] + [got]
    a.check()
    # recycled pages are reissued to others at once
    assert a.allocate(1, 20) is not None
    a.check()


def test_release_prefix_must_keep_one_block():
    a = PageAllocator(4, 4)
    a.allocate(0, 8)                        # 2 pages
    with pytest.raises(ValueError):
        a.release_prefix(0, 2)
    a.release_prefix(0, 1)
    a.check()


def test_truncate_respects_window_base():
    a = PageAllocator(8, 4)
    a.allocate(0, 24, base_blocks=3)        # blocks 3..5 live
    a.extend_to(0, 25)                      # block 6
    assert a.truncate_to(0, 24) == 1        # spec rollback drops block 6
    assert a.base_blocks(0) == 3 and len(a.block_table(0)) == 3
    with pytest.raises(ValueError):
        a.truncate_to(0, 8)                 # would roll back past the base
    a.check()
    a.free_request(0)
    assert a.allocated_pages == 0
    a.check()


def test_windowed_interleaving_keeps_invariants():
    """allocate/extend/release/truncate/free interleaving on a windowed
    table keeps every pool invariant and ends fully reclaimed."""
    page, window = 4, 10
    a = PageAllocator(6, page)
    a.allocate(0, 7)
    for pos in range(7, 40):
        # recycle blocks wholly below pos - window + 1, keeping >= 1
        dead = max(0, pos - window + 1) // page
        n = min(dead - a.base_blocks(0), len(a.block_table(0)) - 1)
        if n > 0:
            a.release_prefix(0, n)
        got = a.extend_to(0, pos + 1)
        assert got is not None, "recycling must keep the pool ahead"
        assert len(a.block_table(0)) <= window // page + 2
        a.check()
    a.free_request(0)
    assert a.allocated_pages == 0
    a.check()


# ---------------------------------------------------------------------------
# The models: prefill and decode logits against repro.models.api
# ---------------------------------------------------------------------------


def _models(arch):
    jc, tc = _f32(arch)
    jp = japi.init_params(jc, jax.random.key(0))
    return jc, tc, jp, params_from_jax(tc, jax.tree.map(np.asarray, jp),
                                       device="cpu")


def _per_layer(jc, cache):
    """A JAX cache tree ({"scan": {j: stacked}, "tail": [...]}) as the
    port's per-layer list of numpy dicts, in layer order."""
    kinds = japi.tfm.pattern_for(jc)
    n_super = jc.num_layers // len(kinds)
    flat = [{k: np.asarray(v[s]) for k, v in cache["scan"][str(j)].items()}
            for s in range(n_super) for j in range(len(kinds))]
    return flat + [{k: np.asarray(v) for k, v in e.items()}
                   for e in cache["tail"]]


def _jax_tree(jc, flat):
    """The port's per-layer cache list as the JAX cache tree."""
    kinds = japi.tfm.pattern_for(jc)
    n_super = jc.num_layers // len(kinds)
    scan = {str(j): {k: jnp.stack([jnp.asarray(flat[s * len(kinds) + j][k]
                                                .numpy())
                                   for s in range(n_super)])
                     for k in flat[j]}
            for j in range(len(kinds))}
    tail = [{k: jnp.asarray(v.numpy()) for k, v in e.items()}
            for e in flat[n_super * len(kinds):]]
    return {"scan": scan, "tail": tail}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_matches_the_converted_tree(arch):
    """``api.init_params`` builds the converted JAX tree's structure, leaf
    for leaf the same shapes and dtypes (fp32 ``lam``, ``A_log``, ``D``,
    ``dt_bias`` and norms), tail blocks included."""
    _, tc, _, tp = _models(arch)
    mine = api.init_params(tc, torch.Generator().manual_seed(0),
                           device="cpu")

    def leaves(t, path=""):
        if isinstance(t, dict):
            return sum((leaves(v, f"{path}/{k}") for k, v in t.items()), [])
        if isinstance(t, list):
            return sum((leaves(v, f"{path}/{i}") for i, v in enumerate(t)),
                       [])
        return [(path, tuple(t.shape), t.dtype)]
    assert sorted(leaves(mine)) == sorted(leaves(tp))
    assert len(tp["blocks"]) == tc.num_layers
    fp32 = {"lam", "A_log", "D", "dt_bias", "scale"}
    for path, _, dt in leaves(mine):
        if path.rsplit("/", 1)[-1] in fp32:
            assert dt == torch.float32, path


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_jax(arch):
    """``api.prefill`` (bucket-padded, with ``length``) and three
    ``api.decode_step`` steps through the paged layout (a window table for
    the local_attn layers, state slots for the recurrent ones) against
    the JAX model at fp32, on a prompt longer than the window."""
    jc, tc, jp, tp = _models(arch)
    L, bucket, page, steps = 21, 32, 4, 3
    toks = np.random.default_rng(5).integers(0, tc.vocab, (1, bucket))
    jl, jcache, _ = japi.prefill(jc, jp, {"tokens": jnp.asarray(toks)},
                                 length=L, paged_kv=True)
    tl, tcache, tpos = api.prefill(tc, tp, _t(toks),
                                   length=torch.tensor([L]))
    _close(tl, jl, atol=1e-4, rtol=1e-4)
    assert int(tpos[0]) == L
    # the paged caches: one request on pages 1.. of each pool, the
    # prefill's k/v and states in place
    nb = (L + steps) // page + 1
    table = np.arange(1, nb + 1, dtype=np.int32)[None]
    tpools = api.paged_cache_init(tc, nb + 1, page, slots=1, device="cpu")
    for e, pool in zip(_per_layer(jc, jcache), tpools):
        for name, t in pool.items():
            if name in ("k", "v"):
                t[1:] = _t(e[name][0, : nb * page]).reshape(
                    (nb, page) + t.shape[2:])
            else:
                t.copy_(_t(e[name]))
    jpools = _jax_tree(jc, tpools)
    jt = jnp.asarray(table)
    tt = _t(table)
    nxt = np.asarray([[int(np.argmax(np.asarray(jl)[0, : tc.vocab]))]])
    pos = L
    for _ in range(steps):
        jd, jpools = japi.decode_step(
            jc, jp, jpools, jnp.asarray(nxt), jnp.asarray([pos], jnp.int32),
            block_table=jt, win_block_table=jt)
        td, _ = api.decode_step(tc, tp, tpools, _t(nxt).long(),
                                torch.tensor([pos], dtype=torch.int32),
                                block_table=tt, win_block_table=tt)
        _close(td, jd, atol=1e-4, rtol=1e-4)
        nxt = np.asarray([[int(np.argmax(np.asarray(jd)[0, : tc.vocab]))]])
        pos += 1
