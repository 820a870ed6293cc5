"""The port's prefix sharing against the JAX package's: the refcounted
allocator and the radix tree (``runtime/kv_cache.py``, ``runtime/
prefix_cache.py``, copies of the reference's) on the reference's cases;
flash-MHA with a query offset against ``layers.flash_attention(q_offset=)``;
suffix-only prefill logits against ``api.prefill(prefix_kv=, prefix_len=)``;
and the engine with ``prefix_cache=True`` against the JAX prefix-cache
engine (gather) and the port's no-share engine, token for token (qwen2.5-3b
SMOKE, fp32): full-page hits, a mid-page copy-on-write, an identical
prompt, eviction under pool pressure, preemption. Tolerances: fp32 atol =
rtol = 2e-5 (``torch_cases.F32``: the order of the sums differs); tokens
exact."""
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
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.runtime.kv_cache import PageAllocator, PoolStats  # noqa
from repro_torch.runtime.prefix_cache import PrefixCache  # noqa: E402
from repro_torch.runtime.scheduler import Scheduler  # noqa: E402
from repro_torch.runtime.serving import PagedServingEngine, Request  # noqa
from torch_cases import F32  # noqa: E402

# ---------------------------------------------------------------------------
# Refcounted allocator (the reference's cases, on the port's copy)
# ---------------------------------------------------------------------------


def test_allocate_shared_refcounts_and_frees_last_owner():
    a = PageAllocator(8, 4)
    t0 = a.allocate(0, 12)                 # 3 private pages
    t1 = a.allocate_shared(1, 12, t0[:2])  # shares 2, allocates 1
    assert t1[:2] == t0[:2] and t1[2] != t0[2]
    assert a.ref(t0[0]) == 2 and a.ref(t0[2]) == 1
    assert a.allocated_pages == 4          # 3 + 1 fresh, shared not doubled
    a.check()
    assert a.free_request(0) == 1          # only its private page freed
    assert a.ref(t1[0]) == 1
    a.check()
    assert a.free_request(1) == 3
    assert a.allocated_pages == 0
    assert PoolStats.of(a, 2, 64).shared_page_refs == 2
    a.check()


def test_allocate_shared_rejection_takes_no_refs():
    a = PageAllocator(3, 4)
    t0 = a.allocate(0, 8)                  # 2 pages, 1 free
    assert a.allocate_shared(1, 16, t0) is None    # needs 2 fresh, has 1
    assert a.ref(t0[0]) == 1
    a.check()


def test_cache_pin_keeps_page_after_owner_finishes():
    a = PageAllocator(4, 4)
    t = a.allocate(0, 8)
    a.cache_pin(t[0])
    assert a.is_pinned(t[0])
    assert a.free_request(0) == 1          # pinned page survives
    assert a.ref(t[0]) == 1 and a.allocated_pages == 1
    assert a.cached_idle_pages == 1
    assert PoolStats.of(a, 1, 16).cached_idle_pages == 1
    a.check()
    assert a.cache_unpin(t[0])             # unpin -> actually freed
    assert a.allocated_pages == 0
    a.check()


def test_replace_page_gives_private_copy():
    a = PageAllocator(6, 4)
    t0 = a.allocate(0, 8)
    a.allocate_shared(1, 8, t0[:1])
    old, new = a.replace_page(1, 0)
    assert old == t0[0] and new not in t0
    assert a.block_table(1)[0] == new
    assert a.ref(old) == 1 and a.ref(new) == 1
    a.check()
    a.check_no_aliasing()


def test_alloc_pinned_page_is_held_by_the_pin_alone():
    a = PageAllocator(2, 4)
    p = a.alloc_pinned_page()
    assert a.is_pinned(p) and a.ref(p) == 1 and a.cached_idle_pages == 1
    a.check()
    assert a.alloc_pinned_page() is not None
    assert a.alloc_pinned_page() is None   # the pool is dry


@pytest.mark.parametrize("corrupt", ["ref", "pin"])
def test_check_catches_refcount_drift(corrupt):
    a = PageAllocator(4, 4)
    t = a.allocate(0, 8)
    if corrupt == "ref":
        a._ref[t[0]] += 1
    else:
        a._pinned.add(t[1])                # a pin without its reference
    with pytest.raises(AssertionError):
        a.check()


# ---------------------------------------------------------------------------
# Radix tree (the reference's cases, on the port's copy)
# ---------------------------------------------------------------------------


def _setup(num_pages=32, page=4):
    a = PageAllocator(num_pages, page)
    return a, PrefixCache(a)


def test_match_walks_whole_pages_and_caps():
    a, px = _setup()
    toks = list(range(12))
    table = a.allocate(0, 12)
    assert px.insert(toks, table) == 3
    m = px.match(toks + [99], max_tokens=12)
    assert m.pages == table and m.tokens == 12 and m.partial_page is None
    m = px.match(toks, max_tokens=11)
    assert m.pages == table[:2]
    assert m.partial_page == table[2] and m.partial_tokens == 3
    assert m.tokens == 11


@pytest.mark.parametrize("query,pages,partial", [
    ([1, 2, 3, 4, 5, 6, 99, 98, 97], 1, 2),   # diverges in page 2
    ([1, 2, 99, 98], 0, 2)])                  # diverges in the first page
def test_match_divergence_inside_page_is_partial_hit(query, pages, partial):
    a, px = _setup()
    table = a.allocate(0, 8)
    px.insert([1, 2, 3, 4, 5, 6, 7, 8], table)
    m = px.match(query, max_tokens=len(query) - 1)
    assert m.pages == table[:pages]
    assert m.partial_page == table[pages] and m.partial_tokens == partial
    assert m.tokens == 4 * pages + partial


def test_match_is_pure_until_committed():
    a, px = _setup()
    toks = list(range(8))
    px.insert(toks, a.allocate(0, 8))
    for _ in range(5):
        m = px.match(toks, max_tokens=7)
    assert px.lookups == 0 and px.hits == 0 and px.hit_tokens == 0
    px.commit(m, 8)
    assert px.lookups == 1 and px.hits == 1 and px.hit_tokens == 7
    px.reset_hit_counters()
    assert px.lookups == px.hits == px.hit_tokens == 0
    assert px.cached_pages == 2


def test_insert_skips_duplicate_chunks():
    a, px = _setup()
    t0 = a.allocate(0, 4)
    t1 = a.allocate(1, 4)
    assert px.insert([5, 5, 5, 5], t0) == 1
    assert px.insert([5, 5, 5, 5], t1) == 0
    assert a.ref(t0[0]) == 2 and a.ref(t1[0]) == 1
    a.check()


def test_evict_lru_leaves_first_and_protect():
    a, px = _setup()
    ta = a.allocate(0, 8)
    px.insert([1, 2, 3, 4, 5, 6, 7, 8], ta)
    tb = a.allocate(1, 4)
    px.insert([9, 9, 9, 9], tb)
    a.free_request(0)
    a.free_request(1)
    assert a.cached_idle_pages == 3
    px.commit(px.match([1, 2, 3, 4, 5, 6, 7, 8]), 8)
    assert px.evict(1) == 1
    assert a.ref(tb[0]) == 0               # B was least recently used
    assert px.evict(1) == 1
    assert a.ref(ta[1]) == 0 and a.ref(ta[0]) == 1     # leaf first
    assert px.evict(1, protect={ta[0]}) == 0
    assert px.evict(1) == 1
    assert a.allocated_pages == 0
    a.check()


def test_evictable_count_is_a_dry_run_and_respects_structure():
    a, px = _setup()
    ta = a.allocate(0, 8)
    px.insert([1, 2, 3, 4, 5, 6, 7, 8], ta)
    tb = a.allocate(1, 4)
    px.insert([9, 9, 9, 9], tb)
    assert px.evictable_count() == 0
    a.free_request(1)
    assert px.evictable_count() == 1
    a.free_request(0)
    assert px.evictable_count() == 3
    assert px.evictable_count(protect={ta[0]}) == 2
    assert px.evictable_count(protect={ta[1]}) == 1
    assert px.cached_pages == 3
    a.check()


def test_evict_spares_pages_still_referenced():
    a, px = _setup()
    t0 = a.allocate(0, 4)
    px.insert([1, 2, 3, 4], t0)
    assert px.evict(5) == 0
    a.free_request(0)
    assert px.evict(5) == 1
    a.check()


# ---------------------------------------------------------------------------
# flash-MHA with a query offset, suffix-only prefill
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("offset", [0, 1, 15, 16, 37])
@pytest.mark.parametrize("Sq,extra", [(1, 0), (9, 5), (24, 0)])
def test_attention_q_offset_matches_flash_attention(offset, Sq, extra):
    """``ops.attention(q_offset=k)`` (the kernel's plain version on the
    CPU) against the JAX ``layers.flash_attention(q_offset=k)``: GQA 8 -> 2
    heads, keys running ``extra`` past the last query, fp32."""
    rng = np.random.default_rng(offset * 31 + Sq)
    Sk = offset + Sq + extra
    q = rng.standard_normal((2, Sq, 8, 16)).astype(np.float32)
    k = rng.standard_normal((2, Sk, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, Sk, 2, 16)).astype(np.float32)
    want = np.asarray(jlayers.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        q_offset=offset, q_chunk=8, kv_chunk=8))
    got = ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=True, q_offset=offset)
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.fixture(scope="module")
def pair():
    jc = dataclasses.replace(jcfg("qwen2.5-3b"), dtype="float32")
    tc = dataclasses.replace(tcfg("qwen2.5-3b"), dtype="float32")
    jp = japi.init_params(jc, jax.random.key(0))
    tp = params_from_jax(tc, jax.tree.map(np.asarray, jp), device="cpu")
    return jc, tc, jp, tp


@pytest.mark.parametrize("plen,Pb", [(8, 8), (6, 8), (13, 16)])
def test_suffix_prefill_logits_match_jax(pair, plen, Pb):
    """``api.prefill(prefix_kv=, prefix_len=)``: a bucket-padded suffix
    against a prefix buffer of Pb rows valid for plen (a whole-page hit, a
    copied partial page, a padded buffer), logits and suffix k/v against
    the JAX package's and against a whole-prompt prefill's (an fp32 KV
    cache here: a bf16 one rounds the prefix keys the whole prompt's
    prefill attends to unrounded)."""
    jc, tc, jp, tp = pair
    jc = dataclasses.replace(jc, kv_cache_dtype="float32")
    tc = dataclasses.replace(tc, kv_cache_dtype="float32")
    rng = np.random.default_rng(plen)
    toks = rng.integers(1, jc.vocab, plen + 5)
    full_logits, full_kv, _ = tapi.prefill(
        tc, tp, torch.from_numpy(toks[None]))
    # the prefix KV as the pools hold it, rows past plen garbage
    pk = [{n: torch.cat([e[n][:, :plen], torch.full(
        (1, Pb - plen) + e[n].shape[2:], 3.0, dtype=e[n].dtype)], 1)
        for n in ("k", "v")} for e in full_kv]
    sfx = np.zeros((1, 8), np.int64)
    sfx[0, :5] = toks[plen:]
    got, kv, _ = tapi.prefill(tc, tp, torch.from_numpy(sfx),
                              length=torch.tensor([5], dtype=torch.int32),
                              prefix_kv=pk, prefix_len=plen)
    jpk = {"scan": {"0": {n: jnp.stack([jnp.asarray(e[n].float().numpy())
                                        for e in pk]) for n in ("k", "v")}},
           "tail": []}
    want, jkv, _ = japi.prefill(jc, jp, {"tokens": jnp.asarray(sfx)},
                                length=5, prefix_kv=jpk, prefix_len=plen)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(got.numpy(), full_logits.numpy(), **F32)
    for j, e in enumerate(kv):
        np.testing.assert_allclose(
            e["k"][0, :5].float().numpy(),
            full_kv[j]["k"][0, plen:].float().numpy(), **F32)


# ---------------------------------------------------------------------------
# The engine against the JAX prefix-cache engine and the no-share engine
# ---------------------------------------------------------------------------

SYS = [7, 3, 9, 1, 4, 4, 2, 8, 6, 5]       # shared 10-token system prompt


def _mk_shared(cls, max_new=5):
    # rid 0/1: shared prefix, divergent tails (full-page hits + mid-page
    # CoW at page 4); rid 2: rid 0's prompt again (the capped full match);
    # rid 3: no overlap
    return [cls(rid=0, prompt=SYS + [11, 12], max_new=max_new),
            cls(rid=1, prompt=SYS + [13, 14, 15], max_new=max_new),
            cls(rid=2, prompt=SYS + [11, 12], max_new=max_new),
            cls(rid=3, prompt=[9, 8, 7, 6, 5], max_new=max_new)]


def _run(eng, reqs, sched_cls):
    sched = sched_cls(eng)
    for r in reqs:
        sched.add(r)
    sched.drain(max_steps=400)
    eng.check()
    return {r.rid: r.generated for r in reqs}, sched


CASES = {
    # name: (engine kwargs, max_new, what the run must show)
    "hits_and_cow": (dict(slots=2), 5, "cow"),
    "eviction": (dict(slots=2, num_pages=9), 6, "evict"),
    "preemption": (dict(slots=3, num_pages=8), 8, "preempt"),
}


@pytest.mark.parametrize("attn_impl", ["kernel", "gather"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_prefix_cache_tokens_equal_jax_and_noshare(pair, case,
                                                          attn_impl):
    """Tokens with sharing equal the JAX prefix-cache engine's (gather) and
    the port's no-share engine's: full-page hits and a mid-page CoW with an
    identical prompt; idle cached pages evicted under a small pool; and
    preemption with resumed requests re-matching their own prefix."""
    jc, tc, jp, tp = pair
    kw, max_new, shows = CASES[case]
    base = dict(max_len=32, page_size=4, **kw)
    want, _ = _run(JEngine(jc, jp, attn_impl="gather", prefix_cache=True,
                           **base), _mk_shared(JRequest, max_new),
                   JScheduler)
    noshare, _ = _run(PagedServingEngine(tc, tp, attn_impl=attn_impl,
                                         device="cpu", **base),
                      _mk_shared(Request, max_new), Scheduler)
    eng = PagedServingEngine(tc, tp, attn_impl=attn_impl, prefix_cache=True,
                             device="cpu", **base)
    got, sched = _run(eng, _mk_shared(Request, max_new), Scheduler)
    assert got == want == noshare
    ps = eng.prefix_stats()
    assert ps["hits"] >= 2 and ps["prefilled_tokens"] < ps["prompt_tokens"]
    assert ps["prefill_tokens_saved"] == ps["hit_tokens"]
    if shows == "cow":
        assert ps["cow_copies"] >= 1
    elif shows == "evict":
        assert eng.prefix.evicted_pages >= 1
    else:
        assert sched.preempted >= 1 and eng.alloc.live_requests == 0
    eng.alloc.check()


def test_prefix_cache_saves_peak_pages(pair):
    """With heavy prompt overlap, sharing serves the same trace with fewer
    peak pages and fewer prefilled tokens, the same tokens; reset_metrics
    keeps the tree and zeroes its counters."""
    _, tc, _, tp = pair
    sys16 = [(3 * j + 1) % tc.vocab for j in range(16)]

    def mk():
        return [Request(rid=i, prompt=sys16 + [50 + i], max_new=3)
                for i in range(4)]
    kw = dict(slots=4, max_len=32, page_size=4, device="cpu")
    base = PagedServingEngine(tc, tp, **kw)
    want, _ = _run(base, mk(), Scheduler)
    pref = PagedServingEngine(tc, tp, prefix_cache=True, **kw)
    got, _ = _run(pref, mk(), Scheduler)
    assert got == want
    assert pref.alloc.peak_pages < base.alloc.peak_pages
    assert pref.prefilled_tokens < base.prefilled_tokens
    m = pref.metrics()
    assert m["prefix.cached_pages"] >= 4 and m["pool.cached_idle_pages"] >= 4
    pref.reset_metrics()
    m = pref.metrics()
    assert m["prefix.hits"] == 0 and m["prefix.cached_pages"] >= 4
