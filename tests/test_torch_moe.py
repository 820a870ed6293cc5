"""The port's MoE and vlm stacks against the JAX package's, on the SMOKE
configs of dbrx-132b (4 experts, top-2), llama4-maverick (8 experts, top-1,
a shared expert, MoE every second layer) and internvl2-2b (the patch
frontend stub): ``layers.moe_apply`` and its routing, prefill and paged
decode logits, ``init_params``' MoE leaves, and the paged engine with decode
slots that die while others decode, against the JAX engine's tokens.

Weights are the JAX package's init, moved over by
``repro_torch.convert.params_from_jax``; inputs are numpy from a seed. fp32
throughout. Tolerance: 1e-5 of the largest magnitude of the reference's
output (the same fp32 arithmetic in another order; the routing itself,
which experts and which capacity slots, is discrete and must agree
exactly, or the outputs would differ by whole rows).
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
from repro.runtime.scheduler import Scheduler as JScheduler  # noqa: E402
from repro.runtime.serving import PagedServingEngine as JEngine  # noqa: E402
from repro.runtime.serving import Request as JRequest  # noqa: E402
from repro_torch.configs import get_smoke_config as tcfg  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import api, layers  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.runtime.scheduler import Scheduler  # noqa: E402
from repro_torch.runtime.serving import (PagedServingEngine,  # noqa: E402
                                         Request, last_occurrences)
from torch_cases import dying_traffic  # noqa: E402

DBRX, LLAMA4, VLM = "dbrx-132b", "llama4-maverick-400b-a17b", "internvl2-2b"
MOE_ARCHS = (DBRX, LLAMA4)
REL = 1e-5

_PAIRS = {}


def pair(arch):
    """(jax cfg, port cfg, jax params, port params) at fp32, made once."""
    if arch not in _PAIRS:
        jc = dataclasses.replace(jcfg(arch), dtype="float32")
        tc = dataclasses.replace(tcfg(arch), dtype="float32")
        jp = japi.init_params(jc, jax.random.key(0))
        _PAIRS[arch] = (jc, tc, jp, params_from_jax(
            tc, jax.tree.map(np.asarray, jp), device="cpu"))
    return _PAIRS[arch]


def close(got, want, rel=REL):
    if isinstance(got, torch.Tensor):
        got = got.float().numpy()
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


def moe_params(arch):
    """The first MoE block's ``moe`` leaves in both packages."""
    jc, tc, jp, tp = pair(arch)
    j = tfm.pattern_for(tc).index("attn_moe")
    jm = jax.tree.map(lambda a: a[0], jp["blocks"]["scan"][str(j)]["moe"])
    return jc, tc, jm, tp["blocks"][j]["moe"]


def both(jc, tc, jm, tm, x):
    want, _ = jlayers.moe_apply(jc, jm, jnp.asarray(x))
    return layers.moe_apply(tc, tm, torch.from_numpy(x)), want


# ---------------------------------------------------------------------------
# moe_apply and its routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,S", [(1, 8), (2, 32)], ids=["T8-G1", "T64-G32"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_matches_jax(arch, B, S):
    """One dispatch group at T = 8 (32 does not divide it), 32 groups of 2
    rows at T = 64, where capacity is per group (C = 4 each)."""
    jc, tc, jm, tm = moe_params(arch)
    G, _ = layers.moe_capacity(tc, B * S)
    assert G == (32 if B * S == 64 else 1)
    x = np.random.default_rng(B * S).standard_normal(
        (B, S, tc.d_model)).astype(np.float32)
    got, want = both(jc, tc, jm, tm, x)
    close(got, want)


def test_moe_capacity_floors_under_forced_overflow():
    """llama4 SMOKE's routing at T = 40 (E 8, top-1, cf 1.5, one group):
    the reference's capacity expression floors 40 * 1.5 / 8 = 7.5 to 7. A
    router whose column 0 is ones sends every positive row to expert 0:
    exactly the first 7 rows are kept (a ceiling would keep 8), and the
    output equals the JAX package's."""
    jc, tc, jm, tm = moe_params(LLAMA4)
    assert layers.moe_capacity(tc, 40) == (1, 7)
    router = np.zeros((tc.d_model, tc.moe.num_experts), np.float32)
    router[:, 0] = 1.0
    jm = dict(jm, router=jnp.asarray(router))
    tm = dict(tm, router=torch.from_numpy(router))
    x = np.abs(np.random.default_rng(5).standard_normal(
        (1, 40, tc.d_model))).astype(np.float32)
    _, gate_i, flat, keep = layers.moe_route(tc, tm, torch.from_numpy(x))
    assert (gate_i == 0).all()
    assert keep.sum().item() == 7 and keep[0, :7].all()
    assert flat[0, :7].tolist() == list(range(7))
    assert (flat[0, 7:] == tc.moe.num_experts * 7).all()
    got, want = both(jc, tc, jm, tm, x)
    close(got, want)


def test_moe_route_breaks_ties_to_the_lower_expert():
    """A zero router gives every expert the same probability: the top-2 are
    experts 0 and 1 on every row, as ``jax.lax.top_k`` picks them, with
    weights 1/2 each after the renormalisation."""
    jc, tc, jm, tm = moe_params(DBRX)
    zero = np.zeros((tc.d_model, tc.moe.num_experts), np.float32)
    jm = dict(jm, router=jnp.asarray(zero))
    tm = dict(tm, router=torch.from_numpy(zero))
    x = np.random.default_rng(6).standard_normal(
        (1, 8, tc.d_model)).astype(np.float32)
    gate_w, gate_i, _, _ = layers.moe_route(tc, tm, torch.from_numpy(x))
    assert gate_i.tolist() == [[0, 1]] * 8
    assert torch.equal(gate_w, torch.full((8, 2), 0.5))
    got, want = both(jc, tc, jm, tm, x)
    close(got, want)


def test_moe_apply_gives_the_same_bits_twice():
    _, tc, _, tm = moe_params(DBRX)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 32, tc.d_model)).astype(np.float32))
    assert torch.equal(layers.moe_apply(tc, tm, x),
                       layers.moe_apply(tc, tm, x))


# ---------------------------------------------------------------------------
# Model: init, prefill, paged decode, the patch frontend
# ---------------------------------------------------------------------------


def shapes(tree):
    if isinstance(tree, dict):
        return {k: shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [shapes(v) for v in tree]
    return (tuple(tree.shape), str(tree.dtype))


@pytest.mark.parametrize("arch", [DBRX, LLAMA4, VLM])
def test_init_params_matches_jax_tree(arch):
    """The port's own init gives the JAX tree's names, shapes and dtypes in
    bf16 (the router fp32, the shared expert where the config has one), and
    the expert weights the Maker's scale."""
    jc, tc = jcfg(arch), tcfg(arch)
    tree = jax.tree.map(np.asarray, japi.init_params(jc, jax.random.key(0)))
    want = params_from_jax(tc, tree, device="cpu")
    mine = api.init_params(tc, torch.Generator().manual_seed(0),
                           device="cpu")
    assert shapes(mine) == shapes(want)
    for blk in mine["blocks"]:
        if "moe" in blk:
            assert blk["moe"]["router"].dtype == torch.float32
            assert ("shared" in blk["moe"]) == tc.moe.shared_expert
            std = blk["moe"]["wi"].float().std().item()
            assert abs(std - tc.d_model ** -0.5) < 0.1 * tc.d_model ** -0.5


def jax_pools(jc, kp, vp):
    """Per-layer page pools (layer order) as the JAX cache tree: scan
    position j of super-block s is layer s * period + j."""
    period = len(tfm.pattern_for(jc))
    return {"scan": {str(j): {"k": jnp.asarray(kp[j::period]),
                              "v": jnp.asarray(vp[j::period])}
                     for j in range(period)}, "tail": []}


@pytest.mark.parametrize("arch", [DBRX, LLAMA4, VLM])
def test_prefill_and_paged_decode_logits_match_jax(arch):
    """Prefill logits at two real lengths of a 16-token bucket, then the
    prefill's cache laid out on pages by a shuffled table and a T = 1 step
    and a T = 3 block through the paged decode: logits and the written
    pool rows equal the JAX package's."""
    jc, tc, jp, tp = pair(arch)
    jc, tc = (dataclasses.replace(c, kv_cache_dtype="float32")
              for c in (jc, tc))
    rng = np.random.default_rng(8)
    B, S, page, nb = 2, 16, 4, 8
    toks = rng.integers(0, jc.vocab, (B, S)).astype(np.int32)
    L = np.array([11, 16], np.int32)
    jl, jcache, _ = japi.prefill(jc, jp, {"tokens": jnp.asarray(toks)},
                                 length=jnp.asarray(L))
    tl, tcache, _ = api.prefill(tc, tp, torch.from_numpy(toks).long(),
                                length=torch.from_numpy(L))
    close(tl, jl)
    n = tc.num_layers
    period = len(tfm.pattern_for(tc))
    hd = tc.resolved_head_dim
    P = 1 + B * nb
    table = rng.permutation(np.arange(1, P, dtype=np.int32)).reshape(B, nb)
    kp = np.zeros((n, P, page, tc.kv_heads, hd), np.float32)
    vp = np.zeros_like(kp)
    for i in range(n):
        close(tcache[i]["k"],
              jcache["scan"][str(i % period)]["k"][i // period])
        k, v = tcache[i]["k"].numpy(), tcache[i]["v"].numpy()
        for b in range(B):
            for t in range(L[b]):
                kp[i, table[b, t // page], t % page] = k[b, t]
                vp[i, table[b, t // page], t % page] = v[b, t]
    for T in (1, 3):
        nxt = rng.integers(0, jc.vocab, (B, T)).astype(np.int32)
        jd, jnew = japi.decode_step(jc, jp, jax_pools(jc, kp, vp),
                                    jnp.asarray(nxt), jnp.asarray(L),
                                    block_table=jnp.asarray(table))
        pools = [{"k": torch.from_numpy(kp[i].copy()),
                  "v": torch.from_numpy(vp[i].copy())} for i in range(n)]
        td, _ = api.decode_step(tc, tp, pools, torch.from_numpy(nxt).long(),
                                torch.from_numpy(L),
                                block_table=torch.from_numpy(table))
        close(td, jd)
        close(pools[n - 1]["v"],
              jnew["scan"][str((n - 1) % period)]["v"][(n - 1) // period])


def test_vlm_prefill_puts_patch_embeddings_before_the_tokens():
    """internvl2's patch frontend stub: ``frontend_embeds`` (B, 8, d) go
    before the token embeddings, as the reference's ``forward_hidden`` puts
    them; the position and ``length`` count them; without them the logits
    differ; a stack without a patch frontend refuses them."""
    jc, tc, jp, tp = pair(VLM)
    rng = np.random.default_rng(9)
    B, S, F = 2, 12, tc.frontend_tokens
    toks = rng.integers(0, jc.vocab, (B, S)).astype(np.int32)
    emb = rng.standard_normal((B, F, tc.d_model)).astype(np.float32)
    jl, jcache, jpos = japi.prefill(
        jc, jp, {"tokens": jnp.asarray(toks),
                 "frontend_embeds": jnp.asarray(emb)})
    tl, tcache, tpos = api.prefill(tc, tp, torch.from_numpy(toks).long(),
                                   frontend_embeds=torch.from_numpy(emb))
    close(tl, jl)
    assert tpos.tolist() == np.asarray(jpos).tolist() == [F + S] * B
    assert tcache[0]["k"].shape[1] == F + S
    close(tcache[1]["v"], jcache["scan"]["0"]["v"][1])
    L = np.array([F + 5, F + S], np.int32)
    jl2, _, _ = japi.prefill(
        jc, jp, {"tokens": jnp.asarray(toks),
                 "frontend_embeds": jnp.asarray(emb)},
        length=jnp.asarray(L))
    tl2, _, _ = api.prefill(tc, tp, torch.from_numpy(toks).long(),
                            length=torch.from_numpy(L),
                            frontend_embeds=torch.from_numpy(emb))
    close(tl2, jl2)
    plain, _, _ = api.prefill(tc, tp, torch.from_numpy(toks).long())
    assert not torch.allclose(plain, tl)
    _, qc, _, qp = pair(DBRX)
    with pytest.raises(ValueError, match="no patch frontend"):
        api.prefill(qc, qp, torch.from_numpy(toks).long(),
                    frontend_embeds=torch.from_numpy(emb))


# ---------------------------------------------------------------------------
# Dead decode slots compute what the reference's dead slots compute
# ---------------------------------------------------------------------------


def test_last_writer_write_leaves_the_last_rows_value():
    """Three dead rows (all-scratch tables) at one position write one
    scratch row in the same step: it holds the last row's k/v, the order
    the JAX engine's scatter leaves; a row past the table shares it too.
    The host-side dedupe of the prefill scatters keeps last occurrences."""
    _, tc, _, tp = pair(DBRX)
    page, nb = 4, 2
    attn = tp["blocks"][0]["attn"]
    x = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (3, 1, tc.d_model)).astype(np.float32))
    table = torch.zeros((3, nb), dtype=torch.int32)
    pos = torch.tensor([5, 5, 5], dtype=torch.int32)
    rows = layers.paged_rows(table, pos, 1, page)
    assert rows[2].tolist() == [[2], [2], [2]]
    pool = api.paged_cache_init(tc, 1 + nb, page, device="cpu")[0]
    layers.attention_decode(tc, attn, x, pool, pos, table, rows)
    alone = api.paged_cache_init(tc, 1 + nb, page, device="cpu")[0]
    layers.attention_decode(tc, attn, x[2:], alone, pos[2:], table[2:],
                            layers.paged_rows(table[2:], pos[2:], 1, page))
    assert torch.equal(pool["k"][0, 1], alone["k"][0, 1])
    assert torch.equal(pool["v"][0, 1], alone["v"][0, 1])
    assert not torch.equal(pool["k"][0, 1], torch.zeros_like(alone["k"][0, 1]))
    # a live row on page 1 and a row past its table (scratch row 0) beside
    # a dead row at position 4 (scratch row 0): the last of the two wins
    table = torch.tensor([[1, 2], [0, 0]], dtype=torch.int32)
    pos = torch.tensor([8, 4], dtype=torch.int32)
    _, _, last = layers.paged_rows(table, pos, 1, page)
    assert last.tolist() == [[1], [1]]
    assert last_occurrences(np.array([0, 3, 0, 5, 0])).tolist() == [1, 3, 4]


def _staggered(cls, slots, vocab):
    return [cls(rid=i, prompt=p, max_new=b)
            for i, (p, b) in enumerate(dying_traffic(slots, vocab))]


@pytest.mark.parametrize("attn_impl", ["kernel", "gather"])
@pytest.mark.parametrize("slots", [6, 8])
def test_dbrx_dying_slots_tokens_equal_jax_engine(slots, attn_impl):
    """dbrx SMOKE (4 experts, top-2, cf 1.5) at 6 and 8 slots: a decode
    step routes every slot's row, so C = max(4, floor(slots * 1.5 * 2 /
    4)) = 4 or 6 per expert against up to 6 or 8 picks of one expert, and
    dead rows (finished slots) take capacity beside the live ones. The port
    must keep each dead row's position and token as the reference does, or
    its dead rows route elsewhere and push other live tokens out: its
    greedy tokens must equal the JAX engine's under the same
    ``attn_impl``."""
    jc, tc, jp, tp = pair(DBRX)
    assert layers.moe_capacity(tc, slots)[1] == (4 if slots == 6 else 6)
    kw = dict(slots=slots, max_len=32, page_size=4, attn_impl=attn_impl)
    jeng = JEngine(jc, jp, **kw)
    jreqs = _staggered(JRequest, slots, jc.vocab)
    jsched = JScheduler(jeng)
    for r in jreqs:
        jsched.add(r)
    jsched.drain(max_steps=400)
    eng = PagedServingEngine(tc, tp, device="cpu", **kw)
    reqs = _staggered(Request, slots, tc.vocab)
    sched = Scheduler(eng)
    for r in reqs:
        sched.add(r)
    sched.drain(max_steps=400)
    assert len({len(r.generated) for r in reqs}) > 3    # staggered deaths
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    assert eng.alloc.allocated_pages == 0


def test_released_slot_keeps_position_and_token():
    """A finished slot keeps the position and token it died with (the
    reference's ``_release_slot`` never resets them) under an all-scratch
    table."""
    _, tc, _, tp = pair(DBRX)
    eng = PagedServingEngine(tc, tp, slots=2, max_len=32, page_size=4,
                             device="cpu")
    reqs = [Request(rid=0, prompt=[3, 1, 4, 1, 5], max_new=3),
            Request(rid=1, prompt=[2, 7], max_new=6)]
    eng.run_to_completion(reqs)
    assert eng.pos.tolist() == [5 + 3 - 1, 2 + 6 - 1]
    assert eng.cur_tok[:, 0].tolist() == [reqs[0].generated[-1],
                                          reqs[1].generated[-1]]
    assert not eng.block_table.any() and not eng.live_mask.any()
