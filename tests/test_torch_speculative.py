"""The port's speculative decode against the JAX package's: n-gram drafting
and the allocator's rollback (``truncate_to``) on the reference's cases;
the engine with ``spec_k`` (n-gram drafts, and a draft model drafting for
itself) against the T = 1 engine and the JAX speculative engine (gather),
token for token (qwen2.5-3b SMOKE, fp32): through preemption, the prefix
cache and the max_len cap; the draft model's rollback and replay; and the
loud failure of a drafter without ``spec_k``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")     # held against the JAX package

import jax  # noqa: E402

from repro.configs import get_smoke_config as jcfg  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.runtime.drafter import DraftModelDrafter as JDraft  # noqa: E402
from repro.runtime.drafter import ngram_propose as jngram  # noqa: E402
from repro.runtime.scheduler import Scheduler as JScheduler  # noqa: E402
from repro.runtime.serving import PagedServingEngine as JEngine  # noqa: E402
from repro.runtime.serving import Request as JRequest  # noqa: E402
from repro_torch.configs import get_smoke_config as tcfg  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.runtime.drafter import (DraftModelDrafter,  # noqa: E402
                                         NgramDrafter, ngram_propose)
from repro_torch.runtime.kv_cache import PageAllocator  # noqa: E402
from repro_torch.runtime.scheduler import Scheduler  # noqa: E402
from repro_torch.runtime.serving import PagedServingEngine, Request  # noqa

# ---------------------------------------------------------------------------
# Drafter and rollback allocator (host-side)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ctx,k,want", [
    ([1, 2, 7, 8, 1, 2, 9, 9, 1, 2], 2, [9, 9]),   # most recent wins
    ([2, 3, 5, 4, 2, 3], 1, [5]),                    # longest n-gram first
    ([1, 2, 3, 4, 5, 1, 2], 2, [3, 4]),              # k caps
    ([1, 2, 3, 4, 5, 1, 2], 10, [3, 4, 5, 1, 2]),    # runs out of context
    ([1, 2, 3, 4, 5], 4, []),                        # nothing repeats
    ([7], 4, []),                                    # too short
    ([1, 2, 1, 2], 0, []),                           # k = 0
    ([5, 1, 9, 5], 2, [1, 9])])                      # unigram fallback
def test_ngram_propose_equals_reference(ctx, k, want):
    assert ngram_propose(ctx, k) == jngram(ctx, k) == want
    assert NgramDrafter().propose(0, ctx, k) == want


def test_truncate_drops_whole_pages_past_accept_point():
    a = PageAllocator(8, 4)
    t = a.allocate(0, 14)
    assert a.truncate_to(0, 9) == 1
    assert a.block_table(0) == t[:3] and a.tokens(0) == 9
    assert a.free_pages == 5
    a.check_no_aliasing()
    assert a.extend_to(0, 13) == t[3]      # LIFO: the hottest page again
    a.check_no_aliasing()


def test_truncate_within_page_drops_nothing():
    a = PageAllocator(4, 8)
    a.allocate(0, 10)
    assert a.truncate_to(0, 9) == 0
    assert a.tokens(0) == 9
    a.check_no_aliasing()


def test_truncate_is_refcount_safe_for_shared_and_pinned_pages():
    a = PageAllocator(8, 4)
    t0 = a.allocate(0, 12)
    a.cache_pin(t0[2])
    t1 = a.allocate_shared(1, 12, t0)
    assert a.truncate_to(1, 5) == 1
    assert a.truncate_to(1, 4) == 1
    assert a.ref(t0[1]) == 1 and a.ref(t0[2]) == 2
    assert a.free_pages == 5
    a.check()
    a.free_request(0)
    assert a.ref(t0[2]) == 1
    assert t1[0] == t0[0] and a.ref(t0[0]) == 1
    a.check()


@pytest.mark.parametrize("n", [7, 0])
def test_truncate_rejects_growth_and_zero(n):
    a = PageAllocator(4, 4)
    a.allocate(0, 6)
    with pytest.raises(ValueError, match="truncate_to"):
        a.truncate_to(0, n)


def test_truncate_interleavings_keep_invariants():
    """Seeded random allocate / extend / truncate / free interleavings keep
    every pool invariant and the page accounting (the reference's property
    test, drawn from numpy)."""
    rng = np.random.default_rng(0)
    for _ in range(30):
        page = int(rng.choice([4, 8]))
        a = PageAllocator(int(rng.integers(8, 25)), page)
        live, nxt = {}, 0
        for _ in range(int(rng.integers(1, 41))):
            op = rng.choice(["alloc", "extend", "truncate", "free"])
            if op == "alloc" or not live:
                n = int(rng.integers(1, 3 * page + 1))
                if a.allocate(nxt, n) is not None:
                    live[nxt] = n
                nxt += 1
                continue
            rid = int(rng.choice(sorted(live)))
            if op == "extend":
                n = live[rid] + int(rng.integers(1, page + 1))
                if a.extend_to(rid, n) is not None:
                    live[rid] = n
            elif op == "truncate":
                live[rid] = int(rng.integers(1, live[rid] + 1))
                a.truncate_to(rid, live[rid])
            else:
                a.free_request(rid)
                del live[rid]
            a.check_no_aliasing()
            assert a.allocated_pages == sum(a.pages_for(n)
                                            for n in live.values())


# ---------------------------------------------------------------------------
# The engine against the T = 1 engine and the JAX speculative engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    jc = dataclasses.replace(jcfg("qwen2.5-3b"), dtype="float32")
    tc = dataclasses.replace(tcfg("qwen2.5-3b"), dtype="float32")
    jp = japi.init_params(jc, jax.random.key(0))
    tp = params_from_jax(tc, jax.tree.map(np.asarray, jp), device="cpu")
    return jc, tc, jp, tp


def _reqs(cls, n=4, max_new=6):
    return [cls(rid=i, prompt=[2 + i, 9, 4, 1 + i, 7, 2 + i, 9], max_new=max_new)
            for i in range(n)]


def _run(eng, reqs, sched_cls):
    sched = sched_cls(eng)
    for r in reqs:
        sched.add(r)
    sched.drain(max_steps=400)
    eng.check()
    return {r.rid: r.generated for r in reqs}, sched


SYS = [7, 3, 9, 1, 4, 4, 2, 8, 6, 5]
CASES = {
    # name: (engine kwargs, requests)
    "plain": (dict(max_len=64, page_size=8), lambda c: _reqs(c)),
    "preemption": (dict(max_len=32, page_size=4, num_pages=6),
                   lambda c: _reqs(c, n=2, max_new=8)),
    "prefix_cache": (dict(max_len=32, page_size=4, prefix_cache=True),
                     lambda c: [c(rid=0, prompt=SYS + [11, 12], max_new=6),
                                c(rid=1, prompt=SYS + [13, 14, 15],
                                  max_new=6),
                                c(rid=2, prompt=SYS + [11, 12], max_new=6)]),
    "max_len_cap": (dict(max_len=16, page_size=4),
                    lambda c: [c(rid=0, prompt=[5, 4, 3, 2, 1], max_new=1000),
                               c(rid=1, prompt=[1, 2, 1, 2, 1, 2],
                                 max_new=1000)]),
}


@pytest.mark.parametrize("drafter", ["ngram", "model"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_spec_greedy_equals_plain_and_jax_spec(pair, case, drafter):
    """spec_k > 0 changes when tokens are computed, never which: the port's
    speculative engine emits its T = 1 engine's tokens and the JAX
    speculative engine's (gather, same drafter), through preemption, the
    prefix cache and the max_len cap, and leaks no page."""
    jc, tc, jp, tp = pair
    kw, mk = CASES[case]
    kw = dict(dict(slots=2), **kw)
    k = 3

    def draft(jax_side):
        if drafter == "ngram":
            return None
        cls, cfg, params = (JDraft, jc, jp) if jax_side else \
            (DraftModelDrafter, tc, tp)
        extra = {} if jax_side else {"device": "cpu"}
        return cls(cfg, params, page_size=4, num_pages=64, max_len=64,
                   **extra)

    plain, _ = _run(PagedServingEngine(tc, tp, device="cpu", **kw),
                    mk(Request), Scheduler)
    want, _ = _run(JEngine(jc, jp, attn_impl="gather", spec_k=k,
                           drafter=draft(True), **kw), mk(JRequest),
                   JScheduler)
    eng = PagedServingEngine(tc, tp, device="cpu", spec_k=k,
                             drafter=draft(False), **kw)
    got, sched = _run(eng, mk(Request), Scheduler)
    assert got == want == plain
    ss = eng.spec_stats()
    assert ss["spec_drafted"] > 0
    assert ss["drafter"] == drafter
    assert eng.alloc.allocated_pages == 0 or case == "prefix_cache"
    if case == "preemption":
        assert sched.preempted >= 1
    if case == "max_len_cap":
        assert all(0 < len(g) < 16 for g in got.values())
    if drafter == "model":
        assert eng.sampling_stats()["draft_proposed"] > 0
        assert ss["accepted_per_step"] > 1.0    # it drafts for itself


def test_draft_model_drafter_rollback_and_replay(pair):
    """A rejected draft rolls the draft cache back to the common prefix
    (a sub-page truncate_to), and replaying a context reproduces the
    proposal; the JAX drafter proposes the same tokens."""
    jc, tc, jp, tp = pair
    dr = DraftModelDrafter(tc, tp, page_size=4, num_pages=16, max_len=64,
                           device="cpu")
    jdr = JDraft(jc, jp, page_size=4, num_pages=16, max_len=64)
    ctx = [5, 3, 8, 1, 2, 9]
    d1 = dr.propose(0, ctx, 3)
    assert d1 == jdr.propose(0, ctx, 3) and len(d1) == 3
    ctx2 = ctx + [d1[0], (d1[1] + 1) % tc.vocab]
    d2 = dr.propose(0, ctx2, 3)
    assert d2 == jdr.propose(0, ctx2, 3)
    assert dr.alloc.tokens(0) == len(ctx2) + len(d2) - 1
    dr.alloc.check_no_aliasing()
    assert dr.propose(0, list(ctx2), 3) == d2
    dr.drop(0)
    assert dr.alloc.allocated_pages == 0


def test_draft_model_drafter_degrades_on_pool_exhaustion(pair):
    _, tc, _, tp = pair
    dr = DraftModelDrafter(tc, tp, page_size=4, num_pages=1, max_len=64,
                           device="cpu")
    assert dr.propose(0, [5, 3, 8, 1, 2, 9], 2) == []
    assert dr.stats()["draft_pool_rejects"] == 1.0
    assert dr.alloc.allocated_pages == 0


def test_drafter_requires_spec_k(pair):
    _, tc, _, tp = pair
    with pytest.raises(ValueError, match="spec_k"):
        PagedServingEngine(tc, tp, drafter=NgramDrafter(), device="cpu")
    with pytest.raises(ValueError, match="spec_k"):
        PagedServingEngine(tc, tp, spec_k=-1, device="cpu")
