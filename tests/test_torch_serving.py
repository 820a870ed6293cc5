"""The port's serving runtime: allocator, greedy paged engine against the JAX
PagedServingEngine (token for token, through preemption and resume), and
the launcher (runs on the CPU when asked; raises without CUDA otherwise)."""
import dataclasses
import json
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
from repro_torch.runtime.kv_cache import (SCRATCH_PAGE,  # noqa: E402
                                          PageAllocator, PoolStats)
from repro_torch.runtime.scheduler import (Scheduler,  # noqa: E402
                                           SchedulerExhausted)
from repro_torch.runtime.serving import PagedServingEngine, Request  # noqa

REPO = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# Allocator (the copy of repro.runtime.kv_cache's core)
# ---------------------------------------------------------------------------


def test_allocator_tracks_live_tokens_and_reclaims():
    a = PageAllocator(8, 16)
    t0 = a.allocate(0, 40)                  # 3 pages
    a.allocate(1, 17)                       # 2 pages
    assert a.allocated_pages == 5 and a.live_tokens == 57
    st = PoolStats.of(a, 4, 256)
    assert st.dense_equiv_tokens == 1024
    assert st.utilization == pytest.approx(57 / 80)
    assert a.extend_to(1, 20) == 0          # inside the page: nothing new
    assert a.extend_to(1, 33) not in (0, None)
    assert a.free_request(0) == 3
    t2 = a.allocate(2, 33)                  # LIFO reuse of rid 0's pages
    assert set(t2) & set(t0)
    a.check_no_aliasing()
    assert all(SCRATCH_PAGE not in a.block_table(r) for r in (1, 2))


def test_allocator_exhaustion_leaves_state_unchanged():
    a = PageAllocator(3, 4)
    a.allocate(0, 8)
    assert a.allocate(1, 9) is None         # needs 3, 1 free
    a.allocate(1, 4)
    assert a.extend_to(1, 5) is None
    assert a.tokens(1) == 4 and a.free_pages == 0
    a.check()
    with pytest.raises(ValueError):
        a.allocate(0, 1)                    # already admitted


# ---------------------------------------------------------------------------
# Engine vs the JAX engine (fp32 so the tokens are exact)
# ---------------------------------------------------------------------------


def _prompts():
    return [[5, 4, 3, 2, 1, 6, 7], [1, 2, 3, 4, 5, 6]]


def _fp32_pair(arch="qwen2.5-3b"):
    jc = dataclasses.replace(jcfg(arch), dtype="float32")
    tc = dataclasses.replace(tcfg(arch), dtype="float32")
    jp = japi.init_params(jc, jax.random.key(0))
    tp = params_from_jax(tc, jax.tree.map(np.asarray, jp), device="cpu")
    return jc, tc, jp, tp


# every arch of the port's registry under both decode attention impls
# (qwen2.5-3b's cases keep their ids: "kernel", "gather")
ENGINE_CASES = [pytest.param(arch, impl, id=impl if arch == "qwen2.5-3b"
                             else f"{arch}-{impl}")
                for arch in ("qwen2.5-3b", "yi-6b", "qwen1.5-4b",
                             "granite-3-2b")
                for impl in ("kernel", "gather")]


@pytest.mark.parametrize("arch,attn_impl", ENGINE_CASES)
def test_greedy_tokens_equal_jax_engine_through_preemption(arch, attn_impl):
    """The scenario of tests/test_paged_attention.py's fp32 engine test:
    two requests, page 4, a 4-page pool that forces a preemption. The port
    (plain attention on the CPU) must emit the JAX engine's tokens under
    the same ``attn_impl``, and its pool must end empty and unaliased."""
    jc, tc, jp, tp = _fp32_pair(arch)
    jeng = JEngine(jc, jp, slots=2, max_len=32, page_size=4, num_pages=4,
                   attn_impl=attn_impl)
    jreqs = [JRequest(rid=i, prompt=p, max_new=8)
             for i, p in enumerate(_prompts())]
    jsched = JScheduler(jeng)
    for r in jreqs:
        jsched.add(r)
    jsched.drain(max_steps=400)

    eng = PagedServingEngine(tc, tp, slots=2, max_len=32, page_size=4,
                             num_pages=4, attn_impl=attn_impl, device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new=8)
            for i, p in enumerate(_prompts())]
    sched = Scheduler(eng)
    for r in reqs:
        sched.add(r)
    sched.drain(max_steps=400)
    assert sched.preempted >= 1 and jsched.preempted >= 1
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    assert all(len(r.generated) == 8 and r.done for r in reqs)
    eng.alloc.check_no_aliasing()
    assert eng.alloc.allocated_pages == 0
    # one prefill per admission, the re-prefill of the preempted one too
    assert eng.prefills == len(reqs) + sched.preempted


def test_engine_counts_and_drops_unservable_requests():
    _, tc, _, tp = _fp32_pair()
    eng = PagedServingEngine(tc, tp, slots=2, max_len=16, page_size=4,
                             device="cpu")
    before = ops.launch_counts()
    reqs = [Request(rid=0, prompt=list(range(3)), max_new=20),
            Request(rid=1, prompt=list(range(15)), max_new=4),   # too long
            Request(rid=2, prompt=[7], max_new=1)]
    done = eng.run_to_completion(reqs, max_steps=100)
    assert [r.rid for r in done] == [0, 1, 2]
    # rid 0 stops at max_len - 1 = 15 positions; rid 1 never prefilled
    assert len(reqs[0].generated) == 15 - 3 + 1
    assert reqs[1].generated == [] and len(reqs[2].generated) == 1
    assert eng.prefills == 2 and eng.decode_steps == 12
    assert ops.launch_counts() == before     # CPU: no kernel launched
    m = eng.metrics()
    assert m["latency.requests"] == 2.0 and m["engine.prefill_traces"] == 1
    assert eng.alloc.allocated_pages == 0
    # released slots: all-scratch tables at position 0 (one scratch page
    # for the decode kernel to walk)
    assert eng.pos.tolist() == [0, 0]
    assert not eng.block_table.any()


def test_eos_token_ends_a_request_early():
    """eos_id stops a request at the first EOS it emits (the token is kept)
    and frees its slot for the queue; the others run to max_new."""
    _, tc, _, tp = _fp32_pair()

    def run(eos):
        eng = PagedServingEngine(tc, tp, slots=1, max_len=32, page_size=4,
                                 eos_id=eos, device="cpu")
        reqs = [Request(rid=i, prompt=p, max_new=8)
                for i, p in enumerate(_prompts())]
        eng.run_to_completion(reqs, max_steps=100)
        return [r.generated for r in reqs]

    free = run(-1)
    eos = free[0][3]
    stop = free[0].index(eos) + 1
    got = run(eos)
    assert got[0] == free[0][:stop]
    want1 = free[1][:free[1].index(eos) + 1] if eos in free[1] else free[1]
    assert got[1] == want1


def test_scheduler_raises_when_budget_exhausted():
    _, tc, _, tp = _fp32_pair()
    eng = PagedServingEngine(tc, tp, slots=1, max_len=32, page_size=4,
                             device="cpu")
    sched = Scheduler(eng)
    sched.add(Request(rid=0, prompt=[1, 2, 3], max_new=10))
    with pytest.raises(SchedulerExhausted):
        sched.drain(max_steps=3)


def test_engine_refuses_cuda_without_a_device_and_bad_page_size():
    _, tc, _, tp = _fp32_pair()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PagedServingEngine(tc, tp)
    with pytest.raises(ValueError, match="power of two"):
        PagedServingEngine(tc, tp, page_size=6, device="cpu")


def test_engine_validates_attn_impl_and_sets_it_on_its_config():
    _, tc, _, tp = _fp32_pair()
    with pytest.raises(ValueError, match="kernel|gather"):
        PagedServingEngine(tc, tp, attn_impl="dense", device="cpu")
    eng = PagedServingEngine(tc, tp, attn_impl="gather", device="cpu")
    assert eng.attn_impl == eng.cfg.paged_attn_impl == "gather"
    assert tc.paged_attn_impl == "kernel"          # the caller's config


def test_scheduler_caps_admissions_per_tick():
    """max_admits_per_step bounds the prefills of one tick; a request
    dropped as done (prompt too long) does not spend the budget."""
    _, tc, _, tp = _fp32_pair()
    eng = PagedServingEngine(tc, tp, slots=4, max_len=16, page_size=4,
                             device="cpu")
    sched = Scheduler(eng, max_admits_per_step=1)
    reqs = [Request(rid=0, prompt=list(range(15)), max_new=2)] + [
        Request(rid=i, prompt=[i, 2, 3], max_new=3) for i in (1, 2, 3)]
    for r in reqs:
        sched.add(r)
    sched.tick()
    assert sched.admitted == 2 and eng.prefills == 1
    assert [r.rid for r in sched.pending] == [2, 3]
    sched.drain(max_steps=100)
    assert sched.admitted == 4 and all(r.done for r in reqs)
    assert [len(r.generated) for r in reqs] == [0, 3, 3, 3]


def test_scheduler_drain_can_warn_instead_of_raising():
    _, tc, _, tp = _fp32_pair()
    eng = PagedServingEngine(tc, tp, slots=1, max_len=32, page_size=4,
                             device="cpu")
    sched = Scheduler(eng)
    sched.add(Request(rid=0, prompt=[1, 2, 3], max_new=10))
    with pytest.warns(UserWarning, match="exhausted"):
        sched.drain(max_steps=3, on_exhaust="warn")
    assert sched.exhausted
    with pytest.raises(ValueError, match="raise|warn"):
        sched.drain(on_exhaust="ignore")


# ---------------------------------------------------------------------------
# Launcher
# ---------------------------------------------------------------------------


def _launch(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen2.5-3b", "--smoke", *args], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=300)


def test_launcher_serves_on_cpu_when_asked():
    r = _launch("--device", "cpu", "--slots", "2", "--requests", "3",
                "--max-new", "4", "--max-len", "64")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "3/3 requests, 12 tokens" in r.stdout
    assert "kernel launches: paged_attention 0" in r.stdout


def test_launcher_gather_baseline_and_trace_on_cpu(tmp_path):
    """--paged-attn gather serves the same tokens count; --trace prints the
    per-phase walls and writes a trace that validates."""
    path = tmp_path / "trace.json"
    r = _launch("--device", "cpu", "--slots", "2", "--requests", "3",
                "--max-new", "4", "--max-len", "64", "--paged-attn",
                "gather", "--trace", str(path))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "PagedServingEngine[gather]" in r.stdout
    assert "3/3 requests, 12 tokens" in r.stdout
    assert "decode_tick" in r.stdout and "host_sync" in r.stdout
    from repro_torch.runtime.trace import validate_trace
    assert validate_trace(json.loads(path.read_text())) == []


def test_launcher_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    r = _launch("--requests", "1")
    assert r.returncode != 0
    assert "no CUDA device is available" in r.stderr


# ---------------------------------------------------------------------------
# The serving bench port
# ---------------------------------------------------------------------------


def _bench(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_bench", *args],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)


def test_serve_bench_smoke_on_cpu_has_the_references_columns(tmp_path):
    """The mixed scenario's CSV: the reference's ``_drive`` columns in its
    order, the gather and kernel rows and their ratio, every request done,
    and the reference gate's verdict (which the port's copy shares): alone,
    it passes but for the three scenarios that carry the equivalence
    columns."""
    from benchmarks import check_csv as jcheck
    from benchmarks.serve_bench import _drive as jdrive
    from repro_torch.launch import check_csv

    trace = tmp_path / "trace.json"
    r = _bench("--smoke", "--device", "cpu", "--scenario", "mixed",
               "--trace-out", str(trace))
    assert r.returncode == 0, r.stdout + r.stderr
    text = r.stdout.strip()
    lines = text.splitlines()
    jc, _, jp, _ = _fp32_pair()
    jeng = JEngine(jc, jp, slots=2, max_len=32, attn_impl="gather")
    want = list(jdrive(jeng, [JRequest(rid=0, prompt=[1, 2, 3],
                                       max_new=2)], 50, jc))
    assert lines[0].split(",") == want
    rows = [dict(zip(want, line.split(","))) for line in lines[1:]]
    assert [row["engine"] for row in rows] == [
        "PagedServingEngine[gather]", "PagedServingEngine[kernel]",
        "kernel/gather"]
    assert rows[0]["requests_done"] == rows[1]["requests_done"] == "4"
    assert rows[0]["sched_exhausted"] == rows[1]["sched_exhausted"] == "0"
    assert rows[2]["requests_done"] == rows[2]["tokens"] == "0"
    errors = jcheck.check(text)
    assert errors == check_csv.check(text) \
        == check_csv.missing_scenario_errors(check_csv.REQUIRED)
    from repro_torch.runtime.trace import validate_trace
    assert validate_trace(json.loads(trace.read_text())) == []


def test_serve_bench_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    r = _bench("--smoke")
    assert r.returncode != 0
    assert "no CUDA device is available" in r.stderr
