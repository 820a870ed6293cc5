"""Hybrid and recurrent stacks on the port's paged engine, against the JAX
``PagedServingEngine(attn_impl="gather")`` at fp32 (SMOKE configs:
``rgemma-smoke``, RG-LRU + local attention with window 16; ``mamba2-smoke``),
plus the launcher and the serve bench's hybrid scenario on the CPU.

Prompts straddle the window (28 and 24 tokens against 16), the pool is
small enough to force preemptions, and every tick checks the engine's
invariants (no slot over ``win_pages_bound``). Greedy tokens are compared
exactly: the same fp32 arithmetic, sums in another order, and no near tie
on these prompts.
"""
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

from repro.configs import get_smoke_config as jcfg  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.runtime.scheduler import Scheduler as JScheduler  # noqa: E402
from repro.runtime.serving import PagedServingEngine as JEngine  # noqa: E402
from repro.runtime.serving import Request as JRequest  # noqa: E402
from repro_torch.configs import get_smoke_config as tcfg  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.runtime.kv_cache import SCRATCH_PAGE  # noqa: E402
from repro_torch.runtime.scheduler import Scheduler  # noqa: E402
from repro_torch.runtime.serving import PagedServingEngine, Request  # noqa

REPO = Path(__file__).resolve().parents[1]
RG, MAMBA = "recurrentgemma-9b", "mamba2-2.7b"
PROMPTS = [[5, 4, 3, 2, 1, 6, 7] * 4, [1, 2, 3, 4, 5, 6], [9, 8] * 12]
MAX_NEW = 20
# slots 2, max_len 64, page 4: win_pages_bound(64) = 6 pages a request, so
# a pool of 8 holds one request at its bound but not two
ENGINE = dict(slots=2, max_len=64, page_size=4, num_pages=8)


@functools.lru_cache(maxsize=None)
def _pair(arch):
    over = dict(dtype="float32", kv_cache_dtype="float32")
    jc = dataclasses.replace(jcfg(arch), **over)
    tc = dataclasses.replace(tcfg(arch), **over)
    jp = japi.init_params(jc, jax.random.key(0))
    return jc, tc, jp, params_from_jax(tc, jax.tree.map(np.asarray, jp),
                                       device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_run(arch, spec_k=0):
    """The JAX gather engine's tokens, recycled pages and preemptions."""
    jc, _, jp, _ = _pair(arch)
    eng = JEngine(jc, jp, attn_impl="gather", spec_k=spec_k, **ENGINE)
    reqs = [JRequest(rid=i, prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(PROMPTS)]
    sched = JScheduler(eng)
    for r in reqs:
        sched.add(r)
    sched.drain(max_steps=500)
    return ([list(r.generated) for r in reqs], eng.win_recycled_pages,
            sched.preempted)


def _run(arch, prompts=PROMPTS, **kw):
    """The port's engine over ``prompts``, ticked by hand with its
    invariants checked after every tick. Returns (engine, scheduler,
    requests)."""
    _, tc, _, tp = _pair(arch)
    eng = PagedServingEngine(tc, tp, device="cpu", **{**ENGINE, **kw})
    reqs = [Request(rid=i, prompt=list(p), max_new=MAX_NEW)
            for i, p in enumerate(prompts)]
    sched = Scheduler(eng)
    for r in reqs:
        sched.add(r)
    while sched.pending or eng.has_live():
        sched.tick()
        eng.check()
        if eng.has_win:
            for r in eng.live:
                if r is not None:
                    assert len(eng.alloc.block_table(("win", r.rid))) \
                        <= eng.win_pages_bound(eng.max_len)
        assert sched.steps < 500
    return eng, sched, reqs


@pytest.mark.parametrize("arch,attn_impl", [(RG, "kernel"), (RG, "gather"),
                                            (MAMBA, "kernel")])
def test_tokens_equal_jax_engine_through_preemption(arch, attn_impl):
    """Greedy tokens equal the JAX gather engine's, on prompts longer than
    the window; recurrentgemma recycles as many window pages as JAX (more
    than 0) and is preempted and resumes as JAX is; the pool ends empty."""
    want, recycled, preempted = _jax_run(arch)
    before = ops.launch_counts()
    eng, sched, reqs = _run(arch, attn_impl=attn_impl)
    assert [r.generated for r in reqs] == want
    assert all(len(r.generated) == MAX_NEW and r.done for r in reqs)
    assert eng.win_recycled_pages == recycled
    assert sched.preempted == preempted
    if arch == RG:
        assert recycled > 0 and preempted >= 1
        assert 0 < eng.win_peak_live <= eng.win_pages_bound(eng.max_len)
    assert eng.alloc.allocated_pages == 0
    eng.alloc.check()
    assert ops.launch_counts() == before     # CPU: no kernel launched


class _OracleDrafter:
    """Drafts from known greedy streams: at an even generated count all
    ``k`` drafts right, at an odd one the first right and the rest wrong,
    so verify steps accept all, some and (at the stream's end) none of
    their drafts, and every rollback point between occurs."""
    kind = "oracle"

    def __init__(self, streams):
        self.streams = streams

    def propose(self, rid, ctx, k):
        want = self.streams[rid]
        n = len(ctx) - len(PROMPTS[rid])
        good = want[n:n + k]
        if n % 2:
            good = good[:1] + [(t + 1) % 256 for t in good[1:]]
        return good

    def drop(self, rid):
        pass

    def stats(self):
        return {}


@pytest.mark.parametrize("arch", [RG, MAMBA])
def test_speculative_tokens_equal_plain_greedy(arch):
    """spec_k = 3 emits the plain engine's greedy tokens, whatever the
    drafts: the verify step's checkpointed states roll back to each slot's
    accepted row (one select a step), the window table past it to
    scratch. n-gram drafts on these prompts are all rejected; drafts from
    the known streams are accepted in part and in whole."""
    want, _, _ = _jax_run(arch)
    eng, _, reqs = _run(arch, spec_k=3)
    assert [r.generated for r in reqs] == want
    assert eng.state_selects == eng.decode_steps
    eng, _, reqs = _run(arch, spec_k=3, drafter=_OracleDrafter(want))
    assert [r.generated for r in reqs] == want
    assert 0 < eng.spec_accepted < eng.spec_drafted
    assert eng.state_selects == eng.decode_steps
    assert eng.alloc.allocated_pages == 0


@pytest.mark.parametrize("arch", [RG, MAMBA])
def test_reused_slot_gives_a_fresh_engines_tokens(arch):
    """A request served in a slot that another request used before emits
    what a fresh engine emits for it alone: admission overwrites every
    leaf of the slot's state, and the window table's row."""
    _, _, reqs = _run(arch, prompts=PROMPTS[:2], slots=1)
    _, _, fresh = _run(arch, prompts=PROMPTS[1:2], slots=1)
    assert reqs[1].generated == fresh[0].generated


def test_preempted_recurrent_request_resumes_by_reprefill():
    """mamba2 holds no pages, so nothing preempts it on its own: a request
    evicted by hand mid-decode and resubmitted re-prefills its prompt and
    what it generated, which rebuilds its state, and ends with the tokens
    of a run that was never preempted."""
    _, tc, _, tp = _pair(MAMBA)
    want, _, _ = _jax_run(MAMBA)
    eng = PagedServingEngine(tc, tp, device="cpu", **ENGINE)
    req = Request(rid=0, prompt=list(PROMPTS[0]), max_new=MAX_NEW)
    assert eng.submit(req)
    for _ in range(5):
        eng.step()
    back = eng._evict_slot(0)
    assert back is req and req.preemptions == 1
    assert eng.submit(req)
    while eng.has_live():
        eng.step()
    assert req.generated == want[0]


def test_long_prompt_is_admitted_without_its_pre_window_pages():
    """A 40-token prompt against window 16, page 4: blocks 0..5 lie wholly
    below every later query's window, so they are never allocated (base 6,
    4 live pages) and the window table holds scratch there."""
    _, tc, _, tp = _pair(RG)
    eng = PagedServingEngine(tc, tp, device="cpu", **ENGINE)
    assert eng.submit(Request(rid=7, prompt=list(range(1, 41)), max_new=4))
    assert eng.alloc.base_blocks(("win", 7)) == (40 - 16 + 1) // 4
    table = eng.alloc.block_table(("win", 7))
    assert len(table) == 10 - 6
    row = eng.win_table[0].tolist()
    assert row[:6] == [SCRATCH_PAGE] * 6 and row[6:10] == table
    assert not eng.block_table.any()        # no full-attention layer
    eng.check()


@pytest.mark.parametrize("arch", [RG, MAMBA])
def test_prefix_cache_is_refused_on_hybrid_stacks(arch):
    _, tc, _, tp = _pair(arch)
    with pytest.raises(ValueError, match="attention-only"):
        PagedServingEngine(tc, tp, prefix_cache=True, device="cpu")


def test_state_slots_and_their_bytes():
    """Per-slot recurrent state: recurrentgemma-smoke's 4 RG-LRU layers
    hold h (64 fp32) and conv (3 x 64 fp32) a slot; the engine's fixed
    state tensors have one row per slot."""
    _, tc, _, tp = _pair(RG)
    eng = PagedServingEngine(tc, tp, device="cpu", **ENGINE)
    assert eng.has_win and eng.has_state and not eng.has_full
    assert eng.state_slot_bytes() == 4 * (64 + 3 * 64) * 4
    assert all(t.shape[0] == ENGINE["slots"]
               for _, e in eng._state for t in e.values())


# ---------------------------------------------------------------------------
# The launcher and the serve bench's hybrid scenario, on the CPU
# ---------------------------------------------------------------------------


def _module(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, "-m", *args], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("arch", [RG, MAMBA])
def test_launcher_serves_the_hybrid_archs_on_the_cpu(arch):
    r = _module("repro_torch.launch.serve", "--arch", arch, "--smoke",
                "--device", "cpu", "--requests", "3", "--max-new", "6",
                "--slots", "2", "--max-len", "64")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "3/3 requests" in r.stdout
    assert "state slots:" in r.stdout
    if arch == RG:
        assert "sliding window (16 tokens):" in r.stdout


def test_serve_bench_hybrid_scenario_rows():
    """The reference's hybrid scenario at fp32: the dense engine's row, the
    gather and kernel rows with their recycled pages and window bound, the
    three engines' greedy tokens equal, and the paged/dense ratio row."""
    from repro_torch.launch import check_csv
    r = _module("repro_torch.launch.serve_bench", "--smoke", "--device",
                "cpu", "--scenario", "hybrid", "--dtype", "float32")
    assert r.returncode == 0, r.stdout + r.stderr
    rows = [row for _, rs in check_csv.parse_sections(r.stdout)
            for row in rs]
    names = [row["engine"] for row in rows]
    assert names == ["dense[hybrid]", "paged[gather,hybrid]",
                     "paged[kernel,hybrid]", "paged/dense[hybrid]"]
    for row in rows[1:3]:
        assert int(row["win_recycled_pages"]) > 0
        assert int(row["win_page_bound"]) > 0
    for row in rows[:3]:
        assert row["tokens_match_hybrid"] == "1"
        assert row["requests_done"] == "4"
    # the dense engine reserves every lane; the paged ones hold fewer
    assert int(rows[3]["peak_kv_tokens"]) < 0
    assert check_csv.check(r.stdout) == check_csv.missing_scenario_errors(
        check_csv.REQUIRED)
