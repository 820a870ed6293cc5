"""The port's metrics surface (``ServingMetricsMixin`` in
``repro_torch.runtime.serving``) against the reference engine's: the same
flat key set, the same subsystem key sets, the same counters on the same
traffic, TTFT with queue wait, ``reset_metrics`` as the single reset point,
and an engine-driven trace that validates."""
import dataclasses

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
from repro_torch.runtime.scheduler import Scheduler  # noqa: E402
from repro_torch.runtime.serving import PagedServingEngine, Request  # noqa
from repro_torch.runtime.trace import NULL_TRACER, Tracer  # noqa: E402
from repro_torch.runtime.trace import validate_trace  # noqa: E402

SLOTS, MAX_LEN, MAX_NEW = 2, 32, 3
SUBSYSTEMS = ("pool_stats", "spec_stats", "prefix_stats", "tier_stats",
              "shard_stats", "sampling_stats")
# the one counter that differs by design: the reference counts jit traces of
# its step (1), the port captures of its CUDA graph (none on the CPU)
STEP_TRACES = "sampling.step_traces"


def _prompts(n=3):
    return [[2 + 3 * i + j for j in range(2 + 2 * i)] for i in range(n)]


@pytest.fixture(scope="module")
def models():
    jc = dataclasses.replace(jcfg("qwen2.5-3b"), dtype="float32")
    tc = dataclasses.replace(tcfg("qwen2.5-3b"), dtype="float32")
    jp = japi.init_params(jc, jax.random.key(0))
    tp = params_from_jax(tc, jax.tree.map(np.asarray, jp), device="cpu")
    return jc, jp, tc, tp


def _drive(sched_cls, eng, req_cls, n=3):
    reqs = [req_cls(rid=i, prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(_prompts(n))]
    sched = sched_cls(eng)
    for r in reqs:
        sched.add(r)
    sched.drain(max_steps=200)
    return reqs


@pytest.fixture(scope="module")
def reference(models):
    jc, jp, _, _ = models
    eng = JEngine(jc, jp, slots=SLOTS, max_len=MAX_LEN, attn_impl="gather")
    _drive(JScheduler, eng, JRequest)
    return eng


@pytest.fixture(scope="module", params=["kernel", "gather"])
def driven(models, request):
    _, _, tc, tp = models
    eng = PagedServingEngine(tc, tp, slots=SLOTS, max_len=MAX_LEN,
                             attn_impl=request.param, device="cpu")
    _drive(Scheduler, eng, Request)
    return eng


def test_metrics_key_set_equals_the_reference_engines(driven, reference):
    got, want = set(driven.metrics()), set(reference.metrics())
    assert got == want, (sorted(got - want), sorted(want - got))
    assert "engine.prefills" not in got and "engine.prefill_buckets" \
        not in got


@pytest.mark.parametrize("method", SUBSYSTEMS)
def test_subsystem_key_sets_equal_the_reference_engines(driven, reference,
                                                        method):
    def keys(st):
        return set(st) if isinstance(st, dict) else set(vars(st))
    assert keys(getattr(driven, method)()) == \
        keys(getattr(reference, method)())


def test_counters_equal_the_reference_engines_on_the_same_traffic(
        driven, reference):
    """Every key but the wall clocks reads the same on the same traffic
    (the subsystems the port lacks read as the reference's switched-off
    ones, the pools hold the same bytes); the value types match too."""
    got, want = driven.metrics(), reference.metrics()
    for k, v in want.items():
        if k.startswith(("latency.", "util.")) and k != "latency.requests":
            continue
        if k == STEP_TRACES:
            continue
        assert type(got[k]) is type(v), k
        assert got[k] == v, (k, got[k], v)
    assert (got[STEP_TRACES], want[STEP_TRACES]) == (0.0, 1.0)


def test_latency_and_utilization_sane(driven):
    m = driven.metrics()
    assert m["latency.requests"] == 3.0
    assert m["latency.ttft_p50_s"] > 0.0
    assert m["latency.ttft_p95_s"] >= m["latency.ttft_p50_s"]
    assert m["latency.tpot_p50_s"] > 0.0
    assert m["latency.tpot_p95_s"] >= m["latency.tpot_p50_s"]
    assert 0.0 < m["util.temporal"] <= 1.0
    assert m["util.step_wall_s"] <= m["util.tick_wall_s"]
    assert m["engine.decoded_tokens"] >= 3 * (MAX_NEW - 1)
    assert m["engine.kind"] == "PagedServingEngine"


def test_ttft_includes_queue_wait(models):
    """Arrival is stamped at Scheduler.add: a request queued behind a full
    engine accrues TTFT while it waits."""
    _, _, tc, tp = models
    eng = PagedServingEngine(tc, tp, slots=1, max_len=MAX_LEN, device="cpu")
    reqs = _drive(Scheduler, eng, Request)
    ttfts = sorted(eng.first_token_at[r.rid] - eng._arrival_at[r.rid]
                   for r in reqs)
    assert ttfts[-1] > ttfts[0]
    m = eng.metrics()
    assert m["latency.ttft_p95_s"] >= m["latency.ttft_p50_s"]


def test_reset_metrics_is_the_single_reset_point(models):
    _, _, tc, tp = models
    eng = PagedServingEngine(tc, tp, slots=SLOTS, max_len=MAX_LEN,
                             device="cpu")
    _drive(Scheduler, eng, Request)
    assert eng.decode_steps > 0 and eng.prefilled_tokens > 0
    traces = eng.prefill_traces
    eng.reset_metrics()
    m = eng.metrics()
    assert m["engine.decode_steps"] == 0.0
    assert m["engine.decoded_tokens"] == 0.0
    assert m["latency.requests"] == 0.0 and m["latency.ttft_p50_s"] == 0.0
    assert m["util.step_wall_s"] == 0.0 and m["util.temporal"] == 0.0
    assert eng.prefilled_tokens == 0 and eng.prompt_tokens == 0
    assert eng.prefills == 0 and m["sampling.greedy_tokens"] == 0.0
    assert m["pool.peak_pages"] == m["pool.allocated_pages"] == 0.0
    # lifetime facts survive
    assert eng.prefill_traces == traces
    reqs = _drive(Scheduler, eng, Request)
    assert all(len(r.generated) == MAX_NEW for r in reqs)
    assert eng.metrics()["latency.requests"] == 3.0


def test_engine_without_tracer_uses_null_tracer(driven):
    assert driven.trace is NULL_TRACER


def test_engine_run_produces_valid_trace(models):
    _, _, tc, tp = models
    tr = Tracer(enabled=True)
    eng = PagedServingEngine(tc, tp, slots=SLOTS, max_len=MAX_LEN,
                             tracer=tr, device="cpu")
    reqs = _drive(Scheduler, eng, Request)
    obj = tr.to_dict()
    assert validate_trace(obj) == []
    evs = obj["traceEvents"]
    spans = {e["name"] for e in evs if e.get("ph") == "X"}
    assert {"admit", "prefill_dispatch", "decode_tick", "device_dispatch",
            "host_sync", "ensure_capacity", "tick", "admit_loop"} <= spans
    assert "first_token" in {e["name"] for e in evs if e.get("ph") == "i"}
    begins = [e["id"] for e in evs if e.get("ph") == "b"]
    ends = [e["id"] for e in evs if e.get("ph") == "e"]
    assert sorted(begins) == sorted(ends) == [str(r.rid) for r in reqs]
    assert any(e.get("ph") == "C" and e["name"] == "pool_pages" for e in evs)
