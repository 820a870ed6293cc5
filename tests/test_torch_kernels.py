"""The port's two kernels (paged flash-decode, flash-MHA) against the JAX
package's, on the cases of tests/test_paged_attention.py and
tests/test_kernels.py.

On the CPU the port's ``kernels.ops`` runs the plain PyTorch versions
(``repro_torch.kernels.ref``); they are held against the JAX Pallas kernels
in interpret mode (``repro.kernels.ops``) and the JAX oracles
(``repro.kernels.ref``) on the same numpy inputs. The CUDA kernels are held
against the plain versions on the same cases by tests/test_torch_gpu.py.

Tolerances (``F32``, ``BF16``) and cases are in tests/torch_cases.py.
"""
import functools
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")     # held against the JAX package

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import attention as mha_kernel  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as paged_kernel  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from torch_cases import (BF16, F32, MASK_PROBES, MHA_CASES,  # noqa: E402
                         PAGED_CASES, mha_inputs, paged_case, paged_inputs)


@pytest.mark.parametrize("name", sorted(PAGED_CASES))
def test_plain_paged_matches_jax_kernel_and_oracle(name):
    (q, kp, vp, table, lens), kw = paged_inputs(name)
    got = ops.paged_attention(*map(torch.from_numpy, (q, kp, vp, table,
                                                      lens)), **kw).numpy()
    jargs = tuple(map(jnp.asarray, (q, kp, vp, table, lens)))
    np.testing.assert_allclose(got, np.asarray(jops.paged_attention(
        *jargs, **kw)), **F32)
    np.testing.assert_allclose(got, np.asarray(jref.paged_attention_ref(
        *jargs, **kw)), **F32)


@functools.lru_cache(maxsize=None)
def jax_paged(name):
    """The JAX Pallas kernel's (interpret mode) and the JAX oracle's
    outputs on PAGED_CASES[name], computed once per case."""
    (q, kp, vp, table, lens), kw = paged_inputs(name)
    jargs = tuple(map(jnp.asarray, (q, kp, vp, table, lens)))
    return (np.asarray(jops.paged_attention(*jargs, **kw)),
            np.asarray(jref.paged_attention_ref(*jargs, **kw)))


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
@pytest.mark.parametrize("name", sorted(PAGED_CASES))
def test_split_paged_matches_jax_kernel_and_oracle(name, splits):
    """The kernel's summation structure (each request's live pages cut into
    ``splits`` ranges, per-range softmax partials merged in rank order) on
    every case: windows, T = 3 and 5, int8, poisoned pools, lengths 1 and
    7; at 8 splits some ranges are empty (fewer live pages than ranges)."""
    (q, kp, vp, table, lens), kw = paged_inputs(name)
    got = ref.paged_attention_split_ref(
        *map(torch.from_numpy, (q, kp, vp, table, lens)), splits=splits,
        **kw).numpy()
    for want in jax_paged(name):
        np.testing.assert_allclose(got, want, **F32)


def split_inputs(name):
    (q, kp, vp, table, lens), kw = paged_inputs(name)
    return tuple(map(torch.from_numpy, (q, kp, vp, table, lens))), kw


def fed_rows(lens, T, page, n_blocks, window, splits, rank):
    """(B, T) bool: the query rows that see at least one key of range
    ``rank``."""
    first, last = ref.live_pages(lens, T, page, n_blocks, window)
    lo, hi = ref.split_ranges(first, last, splits)[:, rank].unbind(-1)
    qlen = lens.long()[:, None] - T + torch.arange(T)[None, :] + 1
    start = qlen - window if window > 0 else torch.zeros_like(qlen)
    # keys [max(lo*page, start), min(hi*page, qlen)) must be non-empty
    return torch.maximum(lo[:, None] * page, start) < torch.minimum(
        hi[:, None] * page, qlen)


@pytest.mark.parametrize("name", sorted(PAGED_CASES))
def test_split_paged_dropped_range_is_caught(name):
    """Leaving one non-empty range's partial out of the merge moves every
    row that range fed by more than ref.ROW_TOL (fp32) and no other row at
    all: the tolerance the card holds the split kernel to has teeth."""
    (q, kp, vp, table, lens), kw = split_inputs(name)
    T = q.shape[1]
    page, n_blocks = kp.shape[1], table.shape[1]
    want = ref.paged_attention_split_ref(q, kp, vp, table, lens, splits=3,
                                         **kw)
    tested = 0
    for splits in (2, 3, 8):
        for rank in range(splits):
            fed = fed_rows(lens, T, page, n_blocks, kw.get("window", 0),
                           splits, rank)
            if not fed.any():
                continue
            wrong = ref.paged_attention_split_ref(
                q, kp, vp, table, lens, splits=splits, drop=rank, **kw)
            err = ref.row_error(wrong, want)                   # (B, T)
            assert (err[fed] > ref.ROW_TOL[torch.float32]).all(), \
                (splits, rank, err[fed].min().item())
            # rows the range fed no key are those of the undropped merge
            same = ref.paged_attention_split_ref(q, kp, vp, table, lens,
                                                 splits=splits, **kw)
            assert torch.equal(wrong[~fed], same[~fed])
            tested += 1
    assert tested >= 3


def test_split_ranges_cover_each_live_page_once():
    """Every live page lies in exactly one range, ranges are contiguous and
    in rank order, and a range holds at most one page more than another."""
    rng = np.random.default_rng(0)
    first = torch.from_numpy(rng.integers(0, 20, 64))
    last = first + torch.from_numpy(rng.integers(0, 40, 64))
    for splits in range(1, 9):
        r = ref.split_ranges(first, last, splits)
        assert torch.equal(r[:, 0, 0], first)
        assert torch.equal(r[:, -1, 1], last)
        assert torch.equal(r[:, 1:, 0], r[:, :-1, 1])      # contiguous
        size = r[..., 1] - r[..., 0]
        assert (size >= 0).all()
        assert (size.amax(1) - size.amin(1) <= 1).all()


def test_live_pages_skip_pages_below_the_window():
    lens = torch.tensor([1, 16, 17, 100, 100], dtype=torch.int32)
    first, last = ref.live_pages(lens, 1, 16, 8, window=0)
    assert first.tolist() == [0] * 5
    assert last.tolist() == [1, 1, 2, 7, 7]
    first, last = ref.live_pages(lens, 1, 16, 8, window=20)
    # base = 99, earliest visible key 80: pages 0-4 hold none
    assert first.tolist() == [0, 0, 0, 5, 5]


def test_split_plan_fills_the_card_from_shapes_alone():
    """``split_plan``: S = 1 once B * KV (times the row tiles) reaches the
    SMs, at most 8 (one cluster), enough CTAs for the SMs otherwise (up to
    2 a SM), at least 2 pages and 32 keys a range at the longest table; it
    takes shapes, never the lengths."""
    plan = paged_kernel.split_plan
    assert "lengths" not in inspect.signature(plan).parameters
    assert plan(8, 2, 64, 16, 8, 132) == 8           # serving: 128 CTAs
    assert plan(16, 2, 128, 16, 8, 132) == 5         # B = 16 x 2048
    assert plan(1, 2, 64, 16, 8, 132) == 8
    assert plan(8, 2, 4, 16, 8, 132) == 2            # 2 pages a range
    assert plan(8, 2, 64, 8, 8, 132) == 8
    assert plan(8, 2, 8, 4, 8, 132) == 1             # 32 keys in all
    for B in range(1, 300, 7):
        for KV in (1, 2, 4, 8):
            for n_blocks in (1, 2, 3, 16, 64, 129):
                for rows in (1, 8, 20, 32):
                    S = plan(B, KV, n_blocks, 16, rows, 132)
                    ctas = B * KV * -(-rows // 8)
                    assert 1 <= S <= paged_kernel.MAX_SPLITS
                    if B * KV >= 132:
                        assert S == 1
                    if S > 1:
                        assert n_blocks // S >= 2
                        assert ctas * S < 2 * 132
                        assert ctas * (S - 1) < 132
                    elif ctas < 132:
                        assert n_blocks < 4
    assert plan.cache_info().currsize > 0           # cached per shape


F32_WORK_SHAPES = [(1, 1024, 1024, 8), (2, 100, 100, 16), (3, 1, 77, 4),
                   (2, 257, 257, 4), (1, 96, 300, 2), (1, 1, 1, 1)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rg", [2, 4])
def test_f32_mha_work_covers_every_row_block_once(rg, causal):
    """``f32_ctas`` (the fp32 kernel's layout): every (b, h, q block of 16
    rg rows) exactly once over the CTAs; a CTA stays in one (b, h) and,
    causal, pairs block x with n - 1 - x."""
    for B, Sq, Sk, H in F32_WORK_SHAPES:
        ctas = mha_kernel.f32_ctas(B, Sq, Sk, H, causal, rg)
        n = -(-Sq // (16 * rg))
        assert sorted((b, h, blk) for cta in ctas for b, h, blk, _ in cta) \
            == [(b, h, i) for b in range(B) for h in range(H)
                for i in range(n)]
        for cta in ctas:
            assert len({(b, h) for b, h, *_ in cta}) == 1
            assert len(cta) == 1 or (causal and len(cta) == 2
                                     and cta[0][2] + cta[1][2] == n - 1)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rg", [2, 4])
def test_f32_mha_heaviest_matches_the_layout(rg, causal):
    """``f32_heaviest``, which the plan counts with, gives the rounds of the
    heaviest CTA of the layout ``f32_ctas`` models, at odd and even block
    counts and with Sk below, at and past Sq."""
    shapes = F32_WORK_SHAPES + [(1, Sq, Sk, 1) for Sq in (31, 32, 33, 95,
                                                          97, 1000, 4096)
                                for Sk in (1, 40, 128, 1000, 5000)]
    for B, Sq, Sk, H in shapes:
        want = max(mha_kernel.f32_rounds(cta, rg)
                   for cta in mha_kernel.f32_ctas(B, Sq, Sk, H, causal, rg))
        assert mha_kernel.f32_heaviest(Sq, Sk, causal, rg) == want, \
            (Sq, Sk)


@pytest.mark.parametrize("heads", [(8, 64), (16, 128)],
                         ids=["bench", "serve"])
def test_f32_mha_plan_balances_causal_ctas(heads):
    """At the kernel bench's row (B1 S1024 H8 KV2 D64) and at the serving
    heads (H16 KV2 D128), causal 1024 on 132 SMs: the plan fills the card
    with at most one CTA an SM, and the busiest CTA sweeps within one
    32-key tile, and one round, of the mean."""
    H, D = heads
    rg = mha_kernel.f32_plan(1, 1024, 1024, H, D, True, 132)
    assert rg == (2 if D == 64 else 4)
    ctas = mha_kernel.f32_ctas(1, 1024, 1024, H, True, rg)
    assert 120 <= len(ctas) <= 132
    tiles = [sum(-(-keys // 32) for *_, keys in cta) for cta in ctas]
    rounds = [mha_kernel.f32_rounds(cta, rg) for cta in ctas]
    assert max(tiles) - sum(tiles) / len(tiles) <= 1
    assert max(rounds) - sum(rounds) / len(rounds) <= 1


def test_f32_mha_plan_from_shapes_alone():
    """``f32_plan`` takes shapes and the SM count, never kv_valid; D = 128
    keeps 64-row blocks (two stages of a 4-split round would not fit in
    shared memory); where both layouts fill the card alike it keeps 64-row
    blocks, whose K/V tiles serve more rows."""
    plan = mha_kernel.f32_plan
    assert "kv_valid" not in inspect.signature(plan).parameters
    assert plan(1, 1024, 1024, 8, 128, True, 132) == 4
    assert plan(1, 1024, 1024, 8, 64, False, 132) == 4
    assert plan(8, 1024, 1024, 16, 64, True, 132) == 4
    for B, Sq, Sk, H in F32_WORK_SHAPES:
        for D in (16, 32, 64, 128):
            for causal in (True, False):
                assert plan(B, Sq, Sk, H, D, causal, 132) in \
                    ((2, 4) if D <= 64 else (4,))


@pytest.mark.parametrize("rg", [2, 4])
def test_f32_mha_windowed_plan_sweeps_about_the_window(rg):
    """With a band cutting the q blocks, the fp32 layout (``f32_ctas``)
    covers every block once, one block a CTA (no pairs), and each block
    sweeps at most window + its rows + a tile of keys, not all keys below
    it; the heaviest CTA (``f32_heaviest``) matches the layout."""
    bq = 16 * rg
    for B, Sq, H, window, off in ((1, 4096, 2, 2048, 0), (2, 1000, 3, 16, 0),
                                  (1, 300, 4, 100, 337), (1, 97, 1, 1, 5)):
        Sk = Sq + off
        assert not mha_kernel.f32_pairs(Sq, True, off, window)
        ctas = mha_kernel.f32_ctas(B, Sq, Sk, H, True, rg, off, window)
        n = -(-Sq // bq)
        assert sorted((b, h, blk) for cta in ctas for b, h, blk, _ in cta) \
            == [(b, h, i) for b in range(B) for h in range(H)
                for i in range(n)]
        assert all(len(cta) == 1 for cta in ctas)
        assert max(keys for cta in ctas for *_, keys in cta) \
            <= window + bq + 32
        want = max(mha_kernel.f32_rounds(cta, rg) for cta in ctas)
        assert mha_kernel.f32_heaviest(Sq, Sk, True, rg, off, window) == want
        plan = mha_kernel.f32_plan(B, Sq, Sk, H, 256, True, 132, off, window)
        assert plan == 4


def test_f32_mha_pairs_where_the_band_cuts_no_block():
    """A window at or past every row's position leaves the causal pairs
    (and the plan) as without one; non-causal never pairs."""
    assert mha_kernel.f32_pairs(1024, True, 0, 1024)
    assert mha_kernel.f32_pairs(1024, True, 0, 0)
    assert not mha_kernel.f32_pairs(1024, True, 0, 1023)
    assert not mha_kernel.f32_pairs(1024, False, 0, 0)
    for rg in (2, 4):
        assert mha_kernel.f32_ctas(1, 1024, 1024, 8, True, rg, 0, 1024) \
            == mha_kernel.f32_ctas(1, 1024, 1024, 8, True, rg)


def test_plain_paged_ignores_pool_garbage():
    """Poisoning the scratch page and every row past each length must not
    move the output at all."""
    clean = paged_case(3, 4, 2, 4, 2, 16, 8, 4, [2, 7, 9, 32])
    dirty = paged_case(3, 4, 2, 4, 2, 16, 8, 4, [2, 7, 9, 32], poison=True)
    a, b = (ops.paged_attention(*map(torch.from_numpy, c)) for c in
            (clean, dirty))
    assert torch.equal(a, b)


def test_plain_paged_single_token_is_the_3d_path():
    q, kp, vp, table, lens = map(torch.from_numpy, paged_case(
        14, 3, 1, 8, 2, 32, 16, 4, [5, 33, 64]))
    a = ops.paged_attention(q[:, 0], kp, vp, table, lens)
    b = ops.paged_attention(q, kp, vp, table, lens)
    assert a.shape == (3, 8, 32) and torch.equal(a, b[:, 0])


def test_plain_paged_bf16_matches_jax():
    q, kp, vp, table, lens = paged_case(21, 3, 2, 8, 2, 32, 16, 4,
                                        [3, 40, 64])
    got = ops.paged_attention(*(torch.from_numpy(x).to(torch.bfloat16)
                                for x in (q, kp, vp)),
                              torch.from_numpy(table),
                              torch.from_numpy(lens)).float().numpy()
    want = jref.paged_attention_ref(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, kp, vp)),
        jnp.asarray(table), jnp.asarray(lens))
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **BF16)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", MHA_CASES)
def test_plain_mha_matches_jax_kernel_and_oracle(shape, causal):
    q, k, v = mha_inputs(sum(shape), *shape)
    got = ops.attention(*map(torch.from_numpy, (q, k, v)),
                        causal=causal).numpy()
    jargs = tuple(map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(got, np.asarray(jops.attention(
        *jargs, causal=causal, bq=16, bk=16)), **F32)
    np.testing.assert_allclose(got, np.asarray(jref.mha_ref(
        *jargs, causal=causal)), **F32)


def test_plain_mha_kv_valid_per_batch():
    """A (B,) kv_valid: each batch row equals the JAX oracle at its own
    int kv_valid, and differs from attending to the whole cache."""
    q, k, v = mha_inputs(5, 2, 16, 64, 4, 2, 16)
    valid = np.array([33, 64], np.int32)
    got = ops.attention(*map(torch.from_numpy, (q, k, v)), causal=False,
                        kv_valid=torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got, np.asarray(jops.attention(
        *map(jnp.asarray, (q, k, v)), causal=False,
        kv_valid=jnp.asarray(valid), bq=8, bk=16)), **F32)
    for b, n in enumerate(valid):
        want = jref.mha_ref(*(jnp.asarray(x[b:b + 1]) for x in (q, k, v)),
                            causal=False, kv_valid=int(n))
        np.testing.assert_allclose(got[b:b + 1], np.asarray(want), **F32)
    full = jref.mha_ref(*map(jnp.asarray, (q, k, v)), causal=False)
    assert not np.allclose(got[0], np.asarray(full)[0], atol=1e-3)


def test_plain_mha_bf16_matches_jax():
    q, k, v = mha_inputs(6, 1, 32, 32, 4, 2, 32)
    got = ops.attention(*(torch.from_numpy(x).to(torch.bfloat16)
                          for x in (q, k, v))).float().numpy()
    want = jref.mha_ref(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **BF16)


@pytest.mark.parametrize("probe", MASK_PROBES)
def test_plain_mha_bf16_mask_shift_is_caught(probe):
    """On inputs whose scores peak on one key, the plain version agrees
    with the JAX oracle, and in bf16 a mask shifted by one key misses
    ref.ROW_TOL on every row (on random inputs such a shift stays under
    the bf16 tolerance): the tolerance the card holds the bf16 kernel to
    has teeth there."""
    kind, B, S, H, KV, D, valid = probe
    q, k, v = ref.peaked_mha_inputs(np.random.default_rng(S + D), B, S, H,
                                    KV, D, last_key=None if valid is None
                                    else [n - 1 for n in valid])
    causal = kind == "causal"
    got = ops.attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                        kv_valid=None if valid is None else
                        torch.tensor(valid, dtype=torch.int32))
    for b in range(B):    # the JAX oracle takes one int kv_valid
        np.testing.assert_allclose(got[b:b + 1].numpy(), np.asarray(
            jref.mha_ref(*(jnp.asarray(x[b:b + 1]) for x in (q, k, v)),
                         causal=causal,
                         kv_valid=None if valid is None else valid[b])),
            **F32)
    qb, kb, vb = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    if causal:
        want = ref.mha_ref(qb, kb, vb, causal=True)[:, 1:]
        shifted = ref.mha_ref(qb[:, 1:], kb[:, :-1], vb[:, :-1], causal=True)
    else:
        kv_valid = torch.tensor(valid, dtype=torch.int32)
        want = ref.mha_ref(qb, kb, vb, causal=False, kv_valid=kv_valid)
        shifted = ref.mha_ref(qb, kb, vb, causal=False,
                              kv_valid=kv_valid - 1)
    least = ref.row_error(shifted, want).min().item()
    assert least > ref.ROW_TOL[torch.bfloat16], least


def test_plain_mha_fully_masked_rows_are_zero():
    """kv_valid 0 masks every key: the kernels' floored denominator gives
    0, and the plain version matches that."""
    q, k, v = map(torch.from_numpy, mha_inputs(7, 1, 8, 8, 2, 1, 16))
    out = ops.attention(q, k, v, causal=False, kv_valid=0)
    assert torch.equal(out, torch.zeros_like(out))


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never fall back: a CPU tensor is an error there
    (kernels.ops routes CPU tensors to the plain versions instead)."""
    q, kp, vp, table, lens = map(torch.from_numpy, paged_case(
        1, 1, 1, 4, 2, 16, 8, 2, [5]))
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        paged_kernel.paged_attention(q, kp, vp, table, lens)
    with pytest.raises(ValueError, match="CUDA"):
        mha_kernel.mha(q, kp[:1], vp[:1])
    assert ops.launch_counts() == before


def test_mha_pool_probe_needs_a_card():
    """The fp32 mha and max-pool probe times kernels on the card: without
    one it stops before building anything."""
    from repro_torch.launch import mha_pool_probe
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="CUDA"):
        mha_pool_probe.main([])


def test_paged_probe_needs_a_card():
    """The probe times kernels on the card: without one it stops before
    building anything."""
    from repro_torch.launch import paged_probe
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="CUDA"):
        paged_probe.main([])
