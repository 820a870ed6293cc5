"""The port's host tier (``repro_torch.runtime.host_tier`` and the
allocator's host class) against the JAX package's: ``tests/test_host_tier.py``
case for case on the port's copies (allocator units, store round trips with
bf16 added, prefetch hit against demand fetch, the swap-record lifecycle
and cap, the window archive's FIFO, seeded tier-op interleavings against a
byte-level pool mimic), ``state_slot_export``/``import`` against the JAX
functions, the tiered engine's tokens against the JAX
``PagedServingEngine(host_tier=True, attn_impl="gather")`` and against its
own uncapped engine (capped pool, prefix cache, recurrentgemma, mamba2),
``persist_dir`` records read back by the reference's ``restore``, and a
sampled bf16-cache stream through a swap equal to the stream alone.

Engines run the SMOKE configs at fp32 with an fp32 KV cache, so greedy
tokens compare exactly (the same arithmetic, sums in another order); the
bf16 case compares the port with itself, bit for bit: a swap moves the
cache's bits and re-prefills nothing."""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")     # held against the JAX package

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.ckpt import restore as jrestore  # noqa: E402
from repro.configs import get_smoke_config as jcfg  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.runtime.scheduler import Scheduler as JScheduler  # noqa: E402
from repro.runtime.serving import PagedServingEngine as JEngine  # noqa: E402
from repro.runtime.serving import Request as JRequest  # noqa: E402
from repro_torch.checkpoint import ckpt as tckpt  # noqa: E402
from repro_torch.configs import get_smoke_config as tcfg  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.runtime import sampling as tsamp  # noqa: E402
from repro_torch.runtime.host_tier import (CopyStream,  # noqa: E402
                                           HostPageStore, HostTier,
                                           SwapRecord)
from repro_torch.runtime.kv_cache import PageAllocator  # noqa: E402
from repro_torch.runtime.scheduler import Scheduler  # noqa: E402
from repro_torch.runtime.serving import PagedServingEngine, Request  # noqa
from repro_torch.runtime.trace import Tracer  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
QWEN, RG, MAMBA = "qwen2.5-3b", "recurrentgemma-9b", "mamba2-2.7b"

# ---------------------------------------------------------------------------
# allocator host-class units
# ---------------------------------------------------------------------------


def test_demote_frees_pages_promote_rebuilds():
    a = PageAllocator(num_pages=4, page_size=4)
    t = a.allocate(1, 7)
    assert t is not None and len(t) == 2
    old = a.demote(1)
    assert old == t
    assert a.host_resident(1) and not a.live_requests
    assert a.free_pages == 4 and a.host_tokens(1) == 7
    assert a.demote_events == 1
    a.check()
    new = a.promote(1)
    assert new is not None and len(new) == 2
    assert not a.host_resident(1) and a.tokens(1) == 7
    assert a.promote_events == 1
    a.check()
    a.free_request(1)
    assert a.allocated_pages == 0


def test_demote_preserves_window_base():
    a = PageAllocator(num_pages=4, page_size=4)
    a.allocate(1, 13, base_blocks=2)        # blocks 0, 1 never allocated
    a.demote(1)
    assert a.host_base_blocks(1) == 2
    assert a.host_pages_needed(1) == a.pages_for(13) - 2
    a.check()
    t = a.promote(1)
    assert len(t) == a.pages_for(13) - 2
    assert a.base_blocks(1) == 2
    a.check()


def test_promote_refuses_when_pool_dry_state_unchanged():
    a = PageAllocator(num_pages=2, page_size=4)
    a.allocate(1, 8)
    a.demote(1)
    a.allocate(2, 8)                         # takes the whole pool back
    assert a.promote(1) is None
    assert a.host_resident(1)                # unchanged: still promotable
    a.check()
    a.free_request(2)
    assert a.promote(1) is not None
    a.check()


def test_demote_shared_page_survives_other_references():
    a = PageAllocator(num_pages=4, page_size=4)
    t1 = a.allocate(1, 4)
    a.allocate_shared(2, 8, t1)              # rid 2 shares rid 1's page
    a.demote(1)
    assert a.ref(t1[0]) == 1                 # rid 2's claim survives
    a.check()
    a.promote(1)                             # wholly private rebuild
    assert a.ref(t1[0]) == 1
    a.check()


def test_alloc_pinned_page_only_reference_is_the_pin():
    a = PageAllocator(num_pages=2, page_size=4)
    p = a.alloc_pinned_page()
    assert p is not None and a.is_pinned(p) and a.ref(p) == 1
    a.check()
    assert a.cache_unpin(p)                  # pin was the only ref -> free
    assert a.allocated_pages == 0
    a.check()


def test_demote_twice_and_check_catch_misuse():
    """A second demotion raises; ``check`` catches a rid both live and
    host-resident, and drop_host forgets a record."""
    a = PageAllocator(num_pages=4, page_size=4)
    a.allocate(1, 5)
    a.demote(1)
    with pytest.raises(ValueError, match="already host-resident"):
        a.demote(1)
    a.allocate(1, 3)                         # rid 1 live again: corrupt
    with pytest.raises(AssertionError, match="both live and host"):
        a.check()
    a.drop_host(1)
    a.check()


@pytest.mark.parametrize("n_tokens,free,want", [(4, 1, True), (5, 1, False),
                                                (8, 2, True), (1, 0, False)])
def test_can_admit_counts_pages(n_tokens, free, want):
    """``can_admit`` is the reference's: ``pages_for(n)`` within the free
    list (at least one page once admitted)."""
    a = PageAllocator(num_pages=4, page_size=4)
    if 4 - free:
        a.allocate(9, 4 * (4 - free))
    assert a.free_pages == free
    assert a.can_admit(n_tokens) is want


# ---------------------------------------------------------------------------
# host store / copy stream / tier units
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.int8, torch.float32,
                                   torch.bfloat16])
def test_store_round_trips_bitwise(dtype):
    store = HostPageStore()
    k = torch.arange(-8, 8).to(dtype).reshape(4, 4)
    if dtype == torch.bfloat16:              # bits no other dtype holds
        k = (k + torch.rand(4, 4, generator=torch.Generator().manual_seed(
            0))).to(dtype)
    blob = {"0": {"k": k.clone()}}
    h = store.put(blob)
    assert h in store and len(store) == 1 and store.pending == 1
    assert store.drain() == 1 and store.drain() == 0
    got = store.get(h)
    assert got["0"]["k"].dtype == dtype
    assert torch.equal(got["0"]["k"].view(torch.uint8),
                       k.view(torch.uint8))
    assert store.bytes_stored == k.numel() * k.element_size()
    store.pop(h)
    assert store.bytes_stored == 0 and h not in store


def test_pack_round_trips_mixed_dtypes_and_odd_sizes():
    """A CUDA blob travels as one byte buffer (``_pack``): every leaf at a
    16-byte boundary, read back as views (``_unpack``) bit for bit, in
    bf16, fp32 and int8, at sizes that are not multiples of 16 bytes."""
    from repro_torch.runtime.host_tier import _pack, _unpack
    g = torch.Generator().manual_seed(0)
    tree = {"0": {"k": torch.randn(3, 5, generator=g).to(torch.bfloat16),
                  "v": torch.randn(2, 3, generator=g)},
            "7": {"h": torch.arange(-5, 6, dtype=torch.int8)},
            "9": {"s": torch.randn(4, 4, generator=g)}}
    flat, layout = _pack(tree)
    assert flat.dtype == torch.uint8
    assert all(off % 16 == 0 for _, off, _, _ in layout)
    assert flat.numel() == 32 + 32 + 16 + 64
    back = _unpack(flat.clone(), layout)
    for j, e in tree.items():
        for name, t in e.items():
            assert back[j][name].dtype == t.dtype
            assert torch.equal(back[j][name].view(torch.uint8),
                               t.view(torch.uint8))


def test_stream_prefetch_hit_vs_demand_fetch():
    store = HostPageStore()
    stream = CopyStream(store)
    h1 = store.put({"k": torch.ones(2, 2)})
    h2 = store.put({"k": torch.zeros(2, 2)})
    stream.prefetch(h1)
    stream.prefetch(h1)                      # idempotent while in flight
    assert stream.prefetch_starts == 1
    assert torch.equal(stream.take(h1)["k"], torch.ones(2, 2))
    assert torch.equal(stream.take(h2)["k"], torch.zeros(2, 2))
    assert stream.prefetch_hits == 1 and stream.demand_fetches == 1
    stream.prefetch(999)                     # absent handle: no-op
    assert stream.prefetch_starts == 1


def test_demand_fetch_is_traced_as_a_stall():
    tr = Tracer(enabled=True)
    store = HostPageStore(tracer=tr)
    stream = CopyStream(store, tracer=tr)
    stream.take(store.put({"k": torch.ones(3)}))
    assert store.drain() == 1
    names = {e["name"] for e in tr.events()}
    assert {"h2d_demand_fetch", "d2h_finalize"} <= names


def test_tier_swap_record_lifecycle_and_cap():
    tier = HostTier(max_bytes=64)
    h = tier.store.put({"k": torch.zeros(8, dtype=torch.int8)})  # 8 bytes
    tier.record_swap(SwapRecord(rid=5, pos=12, full=h, full_pages=2))
    assert tier.has_swap(5) and tier.swap_outs == 1
    assert tier.swapped_rids() == [5]
    with pytest.raises(ValueError, match="already swapped"):
        tier.record_swap(SwapRecord(rid=5, pos=1))
    assert tier.can_accept(56) and not tier.can_accept(57)
    assert tier.refused_demotions == 1
    rec = tier.pop_swap(5)
    assert rec.pos == 12 and not tier.has_swap(5)
    assert tier.swap_ins == 1 and tier.reprefill_tokens_saved == 12
    assert tier.store.bytes_stored == 0


def test_tier_drop_swap_counts_no_resume():
    tier = HostTier()
    h = tier.store.put({"k": torch.zeros(4)})
    tier.stream.prefetch(h)
    tier.record_swap(SwapRecord(rid=2, pos=3, full=h))
    tier.drop_swap(2)
    assert tier.swap_ins == 0 and tier.reprefill_tokens_saved == 0
    assert len(tier.store) == 0 and not tier.stream._inflight


def test_tier_window_archive_cap_evicts_fifo():
    tier = HostTier(win_archive_pages=3)
    hs = [tier.store.put({"k": torch.zeros(2, 4)}) for _ in range(3)]
    for i, h in enumerate(hs):
        tier.archive_window(rid=1, base_block=2 * i, n_pages=2, handle=h)
    # 6 pages archived against a 3-page cap: the two oldest entries drop
    assert tier.win_archived_pages == 2 and tier.win_archive_drops == 2
    assert hs[0] not in tier.store and hs[2] in tier.store


def test_tier_stat_keys_and_reset_match_reference():
    from repro.runtime.host_tier import HostTier as JTier
    assert HostTier.STAT_KEYS == JTier.STAT_KEYS
    tier = HostTier()
    assert list(tier.stats()) == list(JTier().stats())
    h = tier.store.put({"k": torch.zeros(4)})
    tier.stream.take(h)
    tier.reset_counters()
    st = tier.stats()
    assert st["copy_stall_ticks"] == 0 and st["host_bytes"] == 16
    assert st["host_bytes_peak"] == 16       # rebased, contents survive


# ---------------------------------------------------------------------------
# seeded interleavings against a byte-level pool mimic
# ---------------------------------------------------------------------------

_P = 4          # page size
_N = 6          # usable pages: few, so ops collide and refuse often


def _val(rid: int, idx: int) -> float:
    """A cell value per (request, token): exact in int8, bf16 and fp32, so
    a clobbered or aliased row shows up as a mismatch."""
    return float((rid * 31 + idx * 7) % 251 - 125)


class _PoolMimic:
    """A torch stand-in for the device pool and the host store: demote
    gathers the table's page rows into a blob, promote scatters them into
    the fresh table (the engine's ``_gather_pages`` / ``_scatter_pages``
    contract), through the port's ``HostPageStore`` and ``CopyStream``."""

    def __init__(self, dtype):
        self.dtype = dtype
        self.pool = torch.zeros((_N + 1, _P), dtype=dtype)  # row 0 scratch
        self.tier = HostTier()
        self.handles: dict = {}

    def write(self, alloc, rid, lo, hi):
        base = alloc.base_blocks(rid)
        table = alloc.block_table(rid)
        for idx in range(max(lo, base * _P), hi):
            self.pool[table[idx // _P - base], idx % _P] = _val(rid, idx)

    def verify(self, alloc, rid):
        base = alloc.base_blocks(rid)
        table = alloc.block_table(rid)
        for idx in range(base * _P, alloc.tokens(rid)):
            got = float(self.pool[table[idx // _P - base], idx % _P])
            assert got == _val(rid, idx), \
                f"rid {rid} token {idx}: {got} (aliased/clobbered page)"

    def demote(self, alloc, rid):
        pages = alloc.block_table(rid)
        blob = {"0": {"k": self.pool[torch.tensor(pages)]}}  # gather first
        alloc.demote(rid)                                    # then free
        self.handles[rid] = self.tier.store.put(blob)

    def promote(self, alloc, rid) -> bool:
        table = alloc.promote(rid)
        if table is None:
            return False
        h = self.handles.pop(rid)
        self.pool[torch.tensor(table)] = self.tier.stream.take(h)["0"]["k"]
        self.tier.store.pop(h)
        return True


def _run_tiering_interleaving(dtype, ops):
    alloc = PageAllocator(num_pages=_N, page_size=_P)
    mimic = _PoolMimic(dtype)
    live, hosted = [], []
    next_rid = 0
    for op, a, b in ops:
        if op == 0 or not (live or hosted):                 # allocate
            rid = next_rid
            next_rid += 1
            base = (a % 2) if b % 3 == 0 else 0
            tokens = base * _P + 1 + a % (2 * _P)
            if alloc.allocate(rid, tokens, base_blocks=base) is not None:
                live.append(rid)
                mimic.write(alloc, rid, 0, tokens)
        elif op == 1 and live:                              # extend
            rid = live[a % len(live)]
            t0 = alloc.tokens(rid)
            if alloc.extend_to(rid, t0 + 1 + b % _P) is not None:
                mimic.write(alloc, rid, t0, alloc.tokens(rid))
        elif op == 2 and live:                              # truncate
            rid = live[a % len(live)]
            floor = alloc.base_blocks(rid) * _P + 1
            span = alloc.tokens(rid) - floor
            if span > 0:
                alloc.truncate_to(rid, floor + b % (span + 1))
        elif op == 3 and live:                              # demote
            rid = live.pop(a % len(live))
            mimic.demote(alloc, rid)
            hosted.append(rid)
        elif op == 4 and hosted:                            # promote
            rid = hosted[a % len(hosted)]
            if mimic.promote(alloc, rid):
                hosted.remove(rid)
                live.append(rid)
            else:
                assert alloc.host_resident(rid)             # unchanged
        elif op == 5 and live:                              # free
            alloc.free_request(live.pop(a % len(live)))
        if op % 2:
            mimic.tier.drain()                 # a tick boundary, sometimes
        alloc.check()
        assert not set(live) & set(hosted)
        for rid in live:
            mimic.verify(alloc, rid)
    for rid in list(hosted):           # promote-after-demote, at the end
        while not mimic.promote(alloc, rid):
            alloc.free_request(live.pop())                  # make room
        mimic.verify(alloc, rid)
        alloc.free_request(rid)
    for rid in live:
        alloc.free_request(rid)
    assert alloc.allocated_pages == 0
    assert mimic.tier.store.bytes_stored == 0
    alloc.check()


@pytest.mark.parametrize("seed", range(8))
def test_tiering_interleavings_keep_invariants(seed):
    """The reference's property test (hypothesis there, absent here) over
    eight seeded op sequences, in each pool dtype the port uses: the
    allocator's invariants after every op, the host class disjoint from
    the live tables, and every live request's rows intact."""
    rng = np.random.default_rng(seed)
    ops = [(int(o), int(a), int(b)) for o, a, b in zip(
        rng.integers(0, 6, 60), rng.integers(0, 1 << 16, 60),
        rng.integers(0, 1 << 16, 60))]
    for dtype in (torch.int8, torch.float32, torch.bfloat16):
        _run_tiering_interleaving(dtype, ops)


# ---------------------------------------------------------------------------
# state_slot_export / import against the JAX functions
# ---------------------------------------------------------------------------


def _per_layer(jc, tree):
    """A JAX (cache or export) tree ({"scan": {j: stacked}, "tail":
    [...] or {i: ...}}) as {layer index: {name: numpy}}, in layer order."""
    kinds = japi.tfm.pattern_for(jc)
    n_super = jc.num_layers // len(kinds)
    out = {}
    for j, e in tree["scan"].items():
        for s in range(n_super):
            out[s * len(kinds) + int(j)] = {k: np.asarray(v[s])
                                            for k, v in e.items()}
    tail = tree["tail"]
    items = tail.items() if isinstance(tail, dict) else enumerate(tail)
    for i, e in items:
        out[n_super * len(kinds) + int(i)] = {k: np.asarray(v)
                                              for k, v in e.items()}
    return out


@pytest.mark.parametrize("arch", [RG, MAMBA])
def test_state_slot_export_import_match_jax(arch):
    """On the same random cache (3 slots), slot 1's export equals the JAX
    export layer for layer, bit for bit, and importing a fresh random
    state into slot 2 leaves the two caches equal everywhere (the pools
    untouched, the other slots untouched, the dtypes cast back)."""
    jc = jcfg(arch)
    tc = tcfg(arch)
    rng = np.random.default_rng(0)

    def rand_like(leaf):
        return jnp.asarray(rng.standard_normal(leaf.shape), leaf.dtype)

    jcache = jax.tree.map(rand_like, japi.paged_cache_init(jc, 3, 5, 4))
    flat = _per_layer(jc, jcache)
    tcache = [{k: torch.from_numpy(np.array(v, np.float32)).to(
        getattr(torch, str(v.dtype))) for k, v in flat[i].items()}
        for i in range(jc.num_layers)]
    want = _per_layer(jc, japi.state_slot_export(jc, jcache, 1))
    got = tapi.state_slot_export(tc, tcache, 1)
    assert sorted(int(j) for j in got) == sorted(want)
    for j, e in got.items():
        for name, t in e.items():
            np.testing.assert_array_equal(t.float().numpy(),
                                          want[int(j)][name].astype(
                                              np.float32))
            t.add_(1)                        # a detached copy
    new = jax.tree.map(rand_like, japi.state_slot_export(jc, jcache, 0))
    jcache = japi.state_slot_import(jc, jcache, 2, new)
    new_flat = _per_layer(jc, new)
    out = tapi.state_slot_import(tc, tcache, 2, {
        str(j): {k: torch.from_numpy(v.astype(np.float64))
                 for k, v in e.items()} for j, e in new_flat.items()})
    assert out is tcache
    for i, e in _per_layer(jc, jcache).items():
        for name, v in e.items():
            assert tcache[i][name].dtype == getattr(torch, str(v.dtype))
            np.testing.assert_array_equal(tcache[i][name].float().numpy(),
                                          v.astype(np.float32))


# ---------------------------------------------------------------------------
# the tiered engine against the JAX tiered engine and its own uncapped run
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _pair(arch):
    over = dict(dtype="float32", kv_cache_dtype="float32")
    jc = dataclasses.replace(jcfg(arch), **over)
    tc = dataclasses.replace(tcfg(arch), **over)
    jp = japi.init_params(jc, jax.random.key(0))
    return jc, tc, jp, params_from_jax(tc, jax.tree.map(np.asarray, jp),
                                       device="cpu")


def _mixed(n=3, max_new=8, cls=Request, vocab=256):
    # prompt + max_new <= 16 tokens = 4 pages: each request fits the capped
    # engine's 4-page pool, two at once do not, so decode must swap
    return [cls(rid=i, prompt=[(7 * i + 3 * j) % vocab
                               for j in range(3 + 2 * i)], max_new=max_new)
            for i in range(n)]


def _shared(cls=Request):
    pre_a = [7, 7, 7, 7, 3, 3, 3, 3]
    pre_b = [9, 9, 9, 9, 5, 5, 5, 5]
    return [cls(rid=0, prompt=pre_a + [1], max_new=6),
            cls(rid=1, prompt=pre_b + [1], max_new=6),
            cls(rid=2, prompt=pre_a + [2], max_new=6)]


def _hybrid(vocab, window, cls=Request):
    return [cls(rid=i, prompt=[(5 * i + j) % vocab
                               for j in range(window // 2 + 5 * i)],
                max_new=8)
            for i in range(3)]


def _jax_drain(eng, reqs):
    sched = JScheduler(eng)
    for r in reqs:
        sched.add(r)
    sched.drain(max_steps=600)
    return [list(r.generated) for r in reqs]


def _drain(eng, reqs):
    """The port's engine, ticked by hand with ``check()`` after each
    tick."""
    sched = Scheduler(eng)
    for r in reqs:
        sched.add(r)
    while sched.pending or eng.has_live():
        sched.tick()
        eng.check()
        assert sched.steps < 600
    return [list(r.generated) for r in reqs]


def _assert_tier_done(eng, base_prefilled):
    assert eng.prefilled_tokens == base_prefilled      # zero re-prefill
    assert len(eng.tier.store) == 0 and eng.tier.store.bytes_stored == 0
    assert not eng.tier.swapped_rids()
    assert eng.alloc.allocated_pages == 0
    eng.alloc.check()


@pytest.mark.parametrize("impl", ["gather", "kernel"])
def test_tiered_engine_matches_jax_and_unconstrained(impl):
    """A pool capped far below the working set: swap-out / swap-in emits
    the uncapped engine's tokens and the JAX tiered gather engine's, with
    as many swaps as JAX and no extra prefill (evict-only would re-prefill
    prompt + generated)."""
    jc, tc, jp, tp = _pair(QWEN)
    jeng = JEngine(jc, jp, slots=2, max_len=32, page_size=4, num_pages=4,
                   attn_impl="gather", host_tier=True)
    want = _jax_drain(jeng, _mixed(cls=JRequest))
    base = PagedServingEngine(tc, tp, slots=2, max_len=32, page_size=4,
                              num_pages=32, attn_impl=impl, device="cpu")
    assert _drain(base, _mixed()) == want
    eng = PagedServingEngine(tc, tp, slots=2, max_len=32, page_size=4,
                             num_pages=4, attn_impl=impl, host_tier=True,
                             device="cpu")
    reqs = _mixed()
    assert _drain(eng, reqs) == want
    t = eng.tier
    assert t.swap_outs > 0 and t.swap_ins == t.swap_outs
    assert t.swap_outs == jeng.tier.swap_outs
    assert sum(r.preemptions for r in reqs) == t.swap_outs
    assert t.reprefill_tokens_saved == jeng.tier.reprefill_tokens_saved > 0
    assert eng.tier_stats()["prefetch_hit_rate"] == 1.0
    _assert_tier_done(eng, base.prefilled_tokens)


def test_tiered_dbrx_engine_matches_jax_and_unconstrained():
    """An MoE stack (dbrx SMOKE) through swap-out / swap-in: a swapped-out
    slot is a dead row of the steps it misses, at the position it was
    swapped at, as in the reference, so the tokens equal the JAX tiered
    engine's and the uncapped run's."""
    jc, tc, jp, tp = _pair("dbrx-132b")
    jeng = JEngine(jc, jp, slots=2, max_len=32, page_size=4, num_pages=4,
                   attn_impl="gather", host_tier=True)
    want = _jax_drain(jeng, _mixed(cls=JRequest))
    base = PagedServingEngine(tc, tp, slots=2, max_len=32, page_size=4,
                              num_pages=32, attn_impl="kernel", device="cpu")
    assert _drain(base, _mixed()) == want
    eng = PagedServingEngine(tc, tp, slots=2, max_len=32, page_size=4,
                             num_pages=4, attn_impl="kernel", host_tier=True,
                             device="cpu")
    assert _drain(eng, _mixed()) == want
    assert eng.tier.swap_outs == jeng.tier.swap_outs > 0
    _assert_tier_done(eng, base.prefilled_tokens)


def test_evict_only_engine_reprefills_what_the_tier_does_not():
    """The same capped pool without the tier: the same tokens, at the cost
    of re-prefilling each preempted request; the tiered engine prefills
    what the uncapped one does."""
    _, tc, _, tp = _pair(QWEN)
    kw = dict(slots=2, max_len=32, page_size=4, attn_impl="gather",
              device="cpu")
    base = PagedServingEngine(tc, tp, num_pages=32, **kw)
    want = _drain(base, _mixed())
    evict = PagedServingEngine(tc, tp, num_pages=4, **kw)
    tiered = PagedServingEngine(tc, tp, num_pages=4, host_tier=True, **kw)
    assert _drain(evict, _mixed()) == _drain(tiered, _mixed()) == want
    assert evict.tier is None and evict.tier_stats()["host_tier"] == 0.0
    assert evict.prefilled_tokens > base.prefilled_tokens \
        == tiered.prefilled_tokens
    assert tiered.tier.reprefill_tokens_saved > 0


def test_tiered_prefix_cache_demotes_and_promotes():
    """Idle radix nodes demote to host under pressure; a later match on a
    host-resident node promotes it (prefetched by the scheduler's hook)
    instead of re-prefilling: the JAX tiered engine's tokens, counters and
    prefill."""
    jc, tc, jp, tp = _pair(QWEN)
    jeng = JEngine(jc, jp, slots=1, max_len=32, page_size=4, num_pages=5,
                   attn_impl="gather", prefix_cache=True, host_tier=True)
    want = _jax_drain(jeng, _shared(JRequest))
    base = PagedServingEngine(tc, tp, slots=1, max_len=32, page_size=4,
                              num_pages=32, attn_impl="gather",
                              prefix_cache=True, device="cpu")
    assert _drain(base, _shared()) == want
    eng = PagedServingEngine(tc, tp, slots=1, max_len=32, page_size=4,
                             num_pages=5, attn_impl="gather",
                             prefix_cache=True, host_tier=True,
                             device="cpu")
    assert _drain(eng, _shared()) == want
    t = eng.tier
    for k in ("cache_demotions", "cache_promotions"):
        assert getattr(t, k) == getattr(jeng.tier, k) > 0
    assert t.stream.prefetch_hits > 0              # the streamer ran ahead
    assert eng.prefilled_tokens == base.prefilled_tokens \
        == jeng.prefilled_tokens
    assert eng.prefix.stats()["host_nodes"] == t.cache_demotions \
        - t.cache_promotions
    eng.alloc.check()


def test_tiered_hybrid_swaps_window_pages_and_state():
    """recurrentgemma: a preempted request swaps its window pages AND its
    recurrent state out and resumes with both (no re-prefill), as the JAX
    tiered engine does; slid-out window pages are archived."""
    jc, tc, jp, tp = _pair(RG)
    window = jc.hybrid.window
    jeng = JEngine(jc, jp, slots=2, max_len=32, page_size=4, num_pages=6,
                   attn_impl="gather", host_tier=True)
    want = _jax_drain(jeng, _hybrid(jc.vocab, window, JRequest))
    base = PagedServingEngine(tc, tp, slots=2, max_len=32, page_size=4,
                              num_pages=32, attn_impl="gather",
                              device="cpu")
    assert _drain(base, _hybrid(tc.vocab, window)) == want
    eng = PagedServingEngine(tc, tp, slots=2, max_len=32, page_size=4,
                             num_pages=6, attn_impl="kernel",
                             host_tier=True, device="cpu")
    assert _drain(eng, _hybrid(tc.vocab, window)) == want
    t = eng.tier
    assert t.swap_outs == jeng.tier.swap_outs > 0
    assert t.swap_ins == t.swap_outs
    assert t.win_archived_pages == jeng.tier.win_archived_pages
    # the archive keeps its blobs (capped); nothing else is left behind
    assert len(t.store) == sum(len(v) for v in t._win_archive.values())
    assert eng.prefilled_tokens == base.prefilled_tokens
    assert eng.alloc.allocated_pages == 0
    eng.alloc.check()


def test_mamba2_swap_by_hand_resumes_without_reprefill():
    """mamba2 holds no pages, so nothing preempts it on its own: swapped
    out by hand mid-decode (its state slot goes to host), another request
    prefilled into the freed slot, swapped back in: the tokens of a run
    never preempted (JAX's), and no token prefilled twice."""
    jc, tc, jp, tp = _pair(MAMBA)
    prompts = [[5, 4, 3, 2, 1, 6, 7] * 3, [9, 8] * 7]
    jeng = JEngine(jc, jp, slots=1, max_len=64, page_size=4,
                   attn_impl="gather")
    want = _jax_drain(jeng, [JRequest(rid=i, prompt=p, max_new=12)
                             for i, p in enumerate(prompts)])
    eng = PagedServingEngine(tc, tp, slots=1, max_len=64, page_size=4,
                             host_tier=True, device="cpu")
    a, b = (Request(rid=i, prompt=list(p), max_new=12)
            for i, p in enumerate(prompts))
    assert eng.submit(a)
    for _ in range(4):
        eng.step()
    assert eng._swap_out_slot(0) is a and a.preemptions == 1
    assert eng.tier.has_swap(0) and eng.live == [None]
    assert eng.submit(b)                     # writes slot 0's state whole
    while eng.has_live():
        eng.step()
    eng.prefetch_pending([a])
    assert eng.submit(a)                     # swap-in
    while eng.has_live():
        eng.step()
    assert [a.generated, b.generated] == want
    assert eng.prefilled_tokens == sum(len(p) for p in prompts)
    assert eng.tier.swap_outs == eng.tier.swap_ins == 1
    assert eng.tier.stream.prefetch_hits == 1 and len(eng.tier.store) == 0


# ---------------------------------------------------------------------------
# persist_dir, and the bf16 stream through a swap
# ---------------------------------------------------------------------------


def test_persist_writes_records_the_reference_restores(tmp_path):
    """A swap record persisted by the port reads back through
    ``repro.checkpoint.ckpt.restore`` bit for bit, bf16 leaves included
    (stored as uint16 bits, the dtype named in the manifest), and through
    the port's own ``restore``."""
    tier = HostTier(persist_dir=str(tmp_path))
    g = torch.Generator().manual_seed(0)
    blob = {"0": {"k": torch.randn(2, 4, generator=g).to(torch.bfloat16),
                  "v": torch.arange(8, dtype=torch.int8).reshape(2, 4)},
            "3": {"h": torch.randn(3, generator=g)}}
    h = tier.store.put(blob)
    tier.record_swap(SwapRecord(rid=3, pos=9, full=h, full_pages=2))
    tier._ckpt.wait()
    like = {str(h): {"0": {"k": jnp.zeros((2, 4), jnp.bfloat16),
                           "v": jnp.zeros((2, 4), jnp.int8)},
                     "3": {"h": jnp.zeros((3,), jnp.float32)}}}
    got, extra = jrestore(str(tmp_path / "swap_3"), like)
    assert extra["rid"] == 3 and extra["pos"] == 9
    assert extra["full_pages"] == 2
    k = np.asarray(got[str(h)]["0"]["k"])
    assert k.dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        k.view(np.uint16), blob["0"]["k"].view(torch.int16).numpy()
        .view(np.uint16))
    np.testing.assert_array_equal(np.asarray(got[str(h)]["0"]["v"]),
                                  blob["0"]["v"].numpy())
    np.testing.assert_array_equal(np.asarray(got[str(h)]["3"]["h"]),
                                  blob["3"]["h"].numpy())
    back, _ = tckpt.restore(str(tmp_path / "swap_3"), {str(h): blob})
    for name in ("k", "v"):
        assert torch.equal(back[str(h)]["0"][name], blob["0"][name])
    assert tckpt.latest_step_dir(str(tmp_path)) is None


def test_persist_failure_raises_on_drain(tmp_path):
    """A failing persist surfaces on the tier's next ``drain()`` (the once
    a tick hook), once."""
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("")
    tier = HostTier(persist_dir=str(blocker / "swaps"))
    h = tier.store.put({"k": torch.zeros((2, 4), dtype=torch.int8)})
    tier.record_swap(SwapRecord(rid=1, pos=4, full=h, full_pages=1))
    tier._ckpt._thread.join()                           # let the save die
    with pytest.raises(OSError):
        tier.drain()
    assert tier._ckpt.failed_saves == 1
    tier.drain()                                        # consumed: clean


def test_ckpt_save_restore_and_latest_step(tmp_path):
    """The port's ``save``/``restore`` on a tree with a list, and the
    reference's ``latest_step_dir`` rule (``.tmp`` and non-numbers
    ignored)."""
    state = {"w": [torch.ones(2), torch.zeros(3, dtype=torch.bfloat16)],
             "step": torch.tensor(7)}
    for n in (1, 12, 3):
        tckpt.save(str(tmp_path / f"step_{n}"), state, extra={"n": n})
    os.makedirs(tmp_path / "step_99.tmp")
    os.makedirs(tmp_path / "step_x")
    latest = tckpt.latest_step_dir(str(tmp_path))
    assert latest == str(tmp_path / "step_12")
    back, extra = tckpt.restore(latest, state)
    assert extra == {"n": 12} and back["w"][1].dtype == torch.bfloat16
    assert torch.equal(back["w"][0], state["w"][0])
    assert int(back["step"]) == 7
    with pytest.raises(KeyError):
        tckpt.restore(latest, {"missing": torch.zeros(1)})


def test_bf16_sampled_stream_through_a_swap_equals_it_alone():
    """bf16 weights and a bf16 KV cache, sampled policies: two requests
    through a pool that forces a swap emit, bit for bit, what each emits
    alone (nothing is re-prefilled, so nothing rounds anew)."""
    tc = tcfg(QWEN)
    assert tc.dtype == "bfloat16" and tc.kv_cache_dtype == "bfloat16"
    tp = tapi.init_params(tc, torch.Generator().manual_seed(0),
                          device="cpu")
    pols = [tsamp.SamplingParams(0.9, 0, 0.95), tsamp.SamplingParams(
        1.0, 5, 1.0, 7)]
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(1, 200, n)] for n in (9, 12)]

    def serve(idx, **kw):
        eng = PagedServingEngine(tc, tp, slots=2, max_len=64, page_size=4,
                                 device="cpu", **kw)
        reqs = [Request(rid=i, prompt=prompts[i], max_new=16,
                        params=pols[i]) for i in idx]
        return _drain(eng, reqs), eng

    alone = [serve([i])[0][0] for i in range(2)]
    cap = 1 + max(-(-(len(p) + 16) // 4) for p in prompts)
    got, eng = serve([0, 1], num_pages=cap, host_tier=True)
    assert eng.tier.swap_outs >= 1
    assert got == alone
    assert len({tuple(t) for t in alone}) == 2


# ---------------------------------------------------------------------------
# the scheduler hook, the metrics surface, the launcher and the bench
# ---------------------------------------------------------------------------


def test_tier_spans_and_metrics_keys():
    """The tiered engine's trace carries the tier's spans (``swap_out``,
    ``swap_in``, ``prefetch``, ``tier_drain``, ``d2h_finalize``) and its
    ``metrics()`` the reference's ``tier.*`` keys, ``host_tier`` 1."""
    _, tc, _, tp = _pair(QWEN)
    tr = Tracer(enabled=True)
    eng = PagedServingEngine(tc, tp, slots=2, max_len=32, page_size=4,
                             num_pages=4, host_tier=True, tracer=tr,
                             device="cpu")
    _drain(eng, _mixed())
    names = {e["name"] for e in tr.events()}
    assert {"swap_out", "swap_in", "prefetch", "tier_drain",
            "d2h_finalize", "h2d_prefetch", "h2d_hit"} <= names
    m = eng.metrics()
    assert m["tier.host_tier"] == 1.0 and m["tier.swap_outs"] > 0
    from repro.runtime.host_tier import HostTier as JTier
    assert [k for k in m if k.startswith("tier.")] == \
        ["tier.host_tier"] + [f"tier.{k}" for k in JTier.STAT_KEYS]
    eng.reset_metrics()
    assert eng.tier_stats()["swap_outs"] == 0.0


def _module(mod, *args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, "-m", mod, *args], env=env,
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)


def test_launcher_host_tier_on_cpu():
    r = _module("repro_torch.launch.serve", "--arch", QWEN, "--smoke",
                "--device", "cpu", "--slots", "2", "--requests", "5",
                "--max-new", "6", "--max-len", "64", "--page-size", "4",
                "--num-pages", "8", "--host-tier")
    assert r.returncode == 0, r.stdout + r.stderr
    line = next(ln for ln in r.stdout.splitlines()
                if ln.startswith("[launch.serve] host tier:"))
    words = line.split()
    outs, ins = int(words[3]), int(words[6])
    assert outs == ins > 0, line
    assert "5/5 requests" in r.stdout


def test_serve_bench_oversubscribe_on_cpu():
    """The oversubscribe scenario's rows at smoke size: every capped row
    emits the uncapped engine's tokens, the tiered rows re-prefill nothing
    the evict rows did not, and the gate passes but for the columns of
    the scenarios not in the CSV."""
    from repro_torch.launch import check_csv
    r = _module("repro_torch.launch.serve_bench", "--smoke", "--device",
                "cpu", "--scenario", "oversubscribe", "--dtype", "float32")
    assert r.returncode == 0, r.stdout + r.stderr
    rows = [row for _, rs in check_csv.parse_sections(r.stdout)
            for row in rs]
    names = [row["engine"] for row in rows]
    assert names == [
        "paged[gather,uncapped]", "paged[gather,evict@cap]",
        "paged[gather,tiered@cap]", "paged[kernel,uncapped]",
        "paged[kernel,evict@cap]", "paged[kernel,tiered@cap]",
        "paged[kernel,prefix,uncapped]", "paged[kernel,prefix,tiered@cap]",
        "paged[hybrid,uncapped]", "paged[hybrid,tiered@cap]"]
    for row in rows:
        if "@cap" in row["engine"]:
            assert row["tokens_match_unconstrained"] == "1", row
        if row["engine"] in ("paged[gather,tiered@cap]",
                             "paged[kernel,tiered@cap]"):
            assert row["reprefill_tokens"] == "0", row
            assert float(row["swap_outs"]) > 0, row
    for impl in ("gather", "kernel"):
        ev = next(r for r in rows if r["engine"] == f"paged[{impl},evict@cap]")
        ti = next(r for r in rows
                  if r["engine"] == f"paged[{impl},tiered@cap]")
        assert int(ev["reprefill_tokens"]) > 0
        assert int(ti["reprefill_tokens_saved"]) == int(
            ev["reprefill_tokens"])
    # the sampling scenario's column is not in this CSV either
    assert check_csv.check(r.stdout) == check_csv.missing_scenario_errors(
        ("tokens_match_tp1", "tokens_match_greedy"))
    assert check_csv.UNPORTED == ()


@pytest.mark.parametrize("prefetch", [True, False])
def test_swap_race_schedule_resumes_exactly_on_cpu(prefetch):
    """The card's copy-stream race check (``test_torch_gpu.swap_race``) on
    the CPU: swap out, prefill another request into the freed pages, swap
    back in by prefetch or demand fetch; both requests' tokens equal the
    schedule without the swap."""
    from test_torch_gpu import smoke_fp32, swap_race
    cfg, params = smoke_fp32()
    want, _ = swap_race(cfg, params, "cpu", None)
    got, eng = swap_race(cfg, params, "cpu", prefetch)
    assert got == want
    assert eng.tier.stream.prefetch_hits == int(prefetch)
    assert eng.tier.stream.demand_fetches == int(not prefetch)
