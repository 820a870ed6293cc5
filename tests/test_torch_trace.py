"""The port's tracer (``repro_torch.runtime.trace``, its own copy of
``repro.runtime.trace``): the reference's unit cases (Chrome Trace Event
schema, ring-buffer bounds, the disabled tracer's no-op contract, the
validator), its verdicts against the reference validator's on the same
objects, and a traced engine run whose spans cover each step's host
work."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.runtime import trace as jtrace  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.runtime.scheduler import Scheduler  # noqa: E402
from repro_torch.runtime.serving import PagedServingEngine, Request  # noqa
from repro_torch.runtime.trace import (NOOP_SPAN, NULL_TRACER,  # noqa: E402
                                       Tracer, default_tracer, percentile,
                                       set_default_tracer, validate_trace)

REPO = Path(__file__).resolve().parents[1]


# -- schema / export ------------------------------------------------------

def test_export_validates_and_round_trips(tmp_path):
    tr = Tracer(enabled=True)
    with tr.span("decode_tick"):
        with tr.span("device_dispatch"):
            pass
        with tr.span("host_sync"):
            pass
    tr.instant("first_token", args={"rid": 0})
    tr.counter("pool_pages", {"allocated": 3.0, "free": 5.0})
    tr.begin_async("request", 0)
    tr.end_async("request", 0)
    path = tmp_path / "trace.json"
    tr.export(str(path))
    obj = json.loads(path.read_text())
    assert validate_trace(obj) == []
    evs = obj["traceEvents"]
    assert any(e["ph"] == "M" and e["name"] == "process_name" for e in evs)
    tnames = {e["args"]["name"] for e in evs
              if e["ph"] == "M" and e["name"] == "thread_name"}
    assert {"engine", "requests"} <= tnames
    names = {e["name"] for e in evs if e["ph"] == "X"}
    assert {"decode_tick", "device_dispatch", "host_sync"} <= names
    assert obj["otherData"]["dropped_events"] == 0


def test_spans_record_at_exit_with_nonneg_duration():
    tr = Tracer(enabled=True)
    with tr.span("outer"):
        assert tr.events() == []          # complete events land on exit
        with tr.span("inner"):
            pass
    inner, outer = tr.events()
    assert inner["name"] == "inner" and outer["name"] == "outer"
    for ev in (inner, outer):
        assert ev["ph"] == "X"
        assert isinstance(ev["ts"], int) and ev["ts"] >= 0
        assert isinstance(ev["dur"], int) and ev["dur"] >= 0
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_phase_walls_aggregates_by_name():
    tr = Tracer(enabled=True)
    for _ in range(3):
        with tr.span("tick"):
            pass
    walls = tr.phase_walls()
    assert walls["tick"][0] == 3 and walls["tick"][1] >= 0.0
    assert "tick" in tr.format_phase_walls()


# -- ring buffer ----------------------------------------------------------

def test_ring_buffer_drops_oldest_without_corrupting_output(tmp_path):
    tr = Tracer(enabled=True, capacity=4)
    for i in range(10):
        with tr.span(f"s{i}"):
            pass
    assert tr.dropped_events == 6
    assert [e["name"] for e in tr.events()] == ["s6", "s7", "s8", "s9"]
    path = tmp_path / "trace.json"
    tr.export(str(path))
    obj = json.loads(path.read_text())
    assert validate_trace(obj) == []
    assert obj["otherData"]["dropped_events"] == 6


def test_dropped_async_begin_does_not_fail_validation():
    tr = Tracer(enabled=True, capacity=2)
    tr.begin_async("request", 0)
    with tr.span("a"):                    # evicts the 'b' row
        pass
    with tr.span("b"):
        pass
    tr.end_async("request", 0)            # orphaned 'e', but declared
    assert tr.dropped_events > 0
    assert validate_trace(tr.to_dict()) == []


# -- the disabled tracer --------------------------------------------------

def test_disabled_tracer_allocates_nothing():
    tr = Tracer(enabled=False)
    assert not tr
    assert tr.span("x") is NOOP_SPAN
    assert tr.span("y", tid="tier") is NOOP_SPAN
    with tr.span("x"):
        pass
    tr.instant("i")
    tr.counter("c", {"v": 1.0})
    tr.begin_async("request", 1)
    tr.end_async("request", 1)
    assert tr.events() == [] and tr.events_recorded == 0
    assert NULL_TRACER.span("z") is NOOP_SPAN


def test_default_tracer_install_and_restore():
    assert default_tracer() is NULL_TRACER
    tr = Tracer(enabled=True)
    set_default_tracer(tr)
    try:
        assert default_tracer() is tr
        eng = PagedServingEngine(*_smoke(), slots=1, max_len=32,
                                 device="cpu")
        assert eng.trace is tr            # engines take the default
    finally:
        set_default_tracer(None)
    assert default_tracer() is NULL_TRACER


# -- the validator --------------------------------------------------------

_BASE = {"pid": 0, "tid": 0, "ts": 0}
_MALFORMED = [
    [],
    {"events": []},
    {"traceEvents": "nope"},
    {"traceEvents": [dict(_BASE, ph="Z", name="x")]},
    {"traceEvents": [dict(_BASE, ph="X", name="x")]},
    {"traceEvents": [dict(_BASE, ph="X", name="x", dur=-1)]},
    {"traceEvents": [dict(_BASE, ph="X", dur=1)]},
    {"traceEvents": [{"ph": "X", "name": "x", "ts": 0, "dur": 1,
                      "tid": 0}]},
    {"traceEvents": [dict(_BASE, ph="C", name="c")]},
    {"traceEvents": [dict(_BASE, ph="e", name="r")]},
    {"traceEvents": [{"ph": "X", "name": "a", "ts": 0, "dur": 10,
                      "pid": 0, "tid": 0},
                     {"ph": "X", "name": "b", "ts": 5, "dur": 10,
                      "pid": 0, "tid": 0}]},
    {"traceEvents": [{"ph": "e", "name": "request", "cat": "request",
                      "id": "7", "ts": 0, "pid": 0, "tid": 0}]},
]


@pytest.mark.parametrize("obj", _MALFORMED)
def test_validator_rejects_what_the_reference_rejects(obj):
    """Each malformed trace fails, with the reference validator's own
    messages."""
    errors = validate_trace(obj)
    assert errors != []
    assert errors == jtrace.validate_trace(obj)


def test_validator_partial_overlap_only_on_one_track():
    evs = [{"ph": "X", "name": "a", "ts": 0, "dur": 10, "pid": 0, "tid": 0},
           {"ph": "X", "name": "b", "ts": 5, "dur": 10, "pid": 0, "tid": 0}]
    assert any("must nest" in e for e in validate_trace({"traceEvents": evs}))
    evs[1]["tid"] = 1
    assert validate_trace({"traceEvents": evs}) == []


def test_percentile():
    assert percentile([], 0.5) == 0.0
    assert percentile([3.0], 0.95) == 3.0
    xs = [1.0, 2.0, 3.0, 4.0]
    assert percentile(xs, 0.0) == 1.0 and percentile(xs, 1.0) == 4.0
    assert percentile(xs, 0.5) == 2.5
    assert percentile(list(reversed(xs)), 0.5) == 2.5


# -- a traced engine run ----------------------------------------------------

def _smoke():
    cfg = dataclasses.replace(get_smoke_config("qwen2.5-3b"),
                              dtype="float32")
    return cfg, api.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")


@pytest.mark.parametrize("attn_impl", ["kernel", "gather"])
def test_engine_spans_cover_each_steps_host_work(attn_impl):
    """Every decode step is one ``decode_tick`` holding, in order,
    ``ensure_capacity``, ``device_dispatch`` and ``host_sync``, and the
    three cover the step's host work bar the bookkeeping after the copy;
    each admission is one ``admit`` holding one ``prefill_dispatch``. The
    trace validates under both the port's and the reference's
    validator."""
    cfg, params = _smoke()
    tr = Tracer(enabled=True)
    eng = PagedServingEngine(cfg, params, slots=2, max_len=32, page_size=4,
                             num_pages=4, attn_impl=attn_impl, tracer=tr,
                             device="cpu")
    sched = Scheduler(eng)
    reqs = [Request(rid=i, prompt=p, max_new=8) for i, p in
            enumerate([[5, 4, 3, 2, 1, 6, 7], [1, 2, 3, 4, 5, 6]])]
    for r in reqs:
        sched.add(r)
    sched.drain(max_steps=400)
    obj = tr.to_dict()
    assert validate_trace(obj) == [] == jtrace.validate_trace(obj)
    spans = [e for e in obj["traceEvents"] if e.get("ph") == "X"]
    ticks = [e for e in spans if e["name"] == "decode_tick"]
    assert len(ticks) == eng.decode_steps
    for t in ticks:
        inner = [e for e in spans if e["tid"] == t["tid"]
                 and e is not t and t["ts"] <= e["ts"]
                 and e["ts"] + e["dur"] <= t["ts"] + t["dur"]]
        assert [e["name"] for e in inner] == [
            "ensure_capacity", "device_dispatch", "host_sync"]
        # spans are whole microseconds: each child loses < 1 to rounding
        assert sum(e["dur"] for e in inner) <= t["dur"] + len(inner)
    # one prefill a successful admission; a rejected one (no free slot)
    # is an admit span without a prefill
    assert sum(e["name"] == "prefill_dispatch" for e in spans) \
        == eng.prefills == len(reqs) + sched.preempted
    assert sum(e["name"] == "admit" for e in spans) >= eng.prefills
    walls = tr.phase_walls()
    assert walls["decode_tick"][0] == eng.decode_steps
    assert walls["host_sync"][0] == eng.decode_steps
    assert sum(e["name"] == "tick" for e in spans) == sched.steps
    assert sum(1 for e in obj["traceEvents"]
               if e.get("ph") == "i" and e["name"] == "preempt") \
        == sched.preempted >= 1


def test_validator_module_entry_point(tmp_path):
    tr = Tracer(enabled=True)
    with tr.span("decode_tick"):
        pass
    good = tmp_path / "good.json"
    tr.export(str(good))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [dict(_BASE, ph="Z")]}))
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    run = [sys.executable, "-m", "repro_torch.runtime.trace"]
    ok = subprocess.run(run + [str(good)], env=env, capture_output=True,
                        text=True, timeout=120)
    assert ok.returncode == 0 and "validate_trace: OK" in ok.stdout
    no = subprocess.run(run + ["--validate", str(bad)], env=env,
                        capture_output=True, text=True, timeout=120)
    assert no.returncode == 1 and "FAIL" in no.stderr
