"""Near-zero-overhead serving tracer with Chrome Trace Event export.

A copy of ``repro.runtime.trace`` (the port imports nothing of the JAX
package; this module is pure stdlib). Every phase of a request's life and
of a decode tick records a span, and the result exports as Chrome Trace
Event Format JSON, loadable in Perfetto (https://ui.perfetto.dev) or
``chrome://tracing``.

Design constraints, in order:

* **Disabled is free.** ``Tracer(enabled=False)`` (and the shared
  module-level ``NULL_TRACER``) allocates nothing per call: ``span()``
  returns one process-wide no-op context manager, ``instant``/
  ``counter``/``begin_async`` return at once. Engines hold a tracer
  unconditionally; the decode loop pays one attribute load and one
  branch per phase.
* **Bounded memory.** Events land in a ring buffer (``capacity``
  events, drop-oldest). A span is recorded at exit, so an enclosing span
  is always younger in the buffer than everything it encloses: evicting
  the oldest never breaks nesting. The dropped count is exported under
  ``otherData.dropped_events``.
* **Host clock only.** Timestamps are ``time.perf_counter_ns`` µs
  relative to the tracer's creation. Device work shows as the host spans
  around it: ``device_dispatch`` is the enqueue of the decode step (one
  CUDA graph replay on the card), ``host_sync`` the wait for its one
  device->host copy.

Span taxonomy of the port's engine and scheduler (tids group the timeline
rows):

* tid ``engine``  — ``admit`` (``prefill_dispatch``), ``decode_tick``
  (``ensure_capacity``, ``device_dispatch``, ``host_sync``), the
  ``pool_pages`` counter, instants ``first_token``, ``preempt``,
  ``reset_metrics``.
* tid ``sched``   — ``tick`` (``admit_loop``).
* cat ``request`` — async ``b``/``e`` pairs per request id (enqueue ->
  done), so per-request latency reads off the timeline.

Usage::

    tr = Tracer(enabled=True)
    with tr.span("decode_tick"):
        with tr.span("device_dispatch"):
            ...
    tr.export("trace.json")           # open in Perfetto

Validation: ``validate_trace(obj)`` checks the schema (ph/ts/dur/
pid/tid fields, per-tid span nesting, async pairing), also as
``python -m repro_torch.runtime.trace trace.json``.
"""
from __future__ import annotations

import json
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple


class _NoopSpan:
    """The shared do-nothing context manager a disabled tracer returns."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP_SPAN = _NoopSpan()


class _Span:
    """A live span: records one Chrome 'complete' (ph=X) event on exit."""
    __slots__ = ("_tr", "name", "cat", "tid", "args", "_t0")

    def __init__(self, tr: "Tracer", name: str, cat: str, tid: int,
                 args: Optional[Dict[str, Any]]):
        self._tr = tr
        self.name, self.cat, self.tid, self.args = name, cat, tid, args

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        tr = self._tr
        ev = {"name": self.name, "cat": self.cat, "ph": "X",
              "ts": (self._t0 - tr._epoch) // 1000,
              "dur": (t1 - self._t0) // 1000,
              "pid": tr.pid, "tid": self.tid}
        if self.args:
            ev["args"] = self.args
        tr._push(ev)
        return False


class Tracer:
    """Bounded-ring-buffer span/counter recorder with Chrome-trace export.

    ``enabled=False`` is the hot-path no-op mode: every recording method
    returns immediately (``span`` hands back the shared ``NOOP_SPAN``),
    nothing is allocated, and ``bool(tracer)`` is False so callers can
    guard arg-dict construction with ``if tr:``.
    """

    def __init__(self, *, enabled: bool = True, capacity: int = 1 << 18,
                 pid: int = 0, process_name: str = "repro-torch-serve"):
        assert capacity >= 1
        self.enabled = enabled
        self.capacity = capacity
        self.pid = pid
        self.process_name = process_name
        self._epoch = time.perf_counter_ns()
        self._events: deque = deque(maxlen=capacity)
        self.events_recorded = 0             # lifetime (incl. dropped)
        self._tids: Dict[str, int] = {}      # thread name -> tid int

    # -- recording --------------------------------------------------------

    def __bool__(self) -> bool:
        return self.enabled

    def _push(self, ev: Dict[str, Any]) -> None:
        self._events.append(ev)
        self.events_recorded += 1

    def _now(self) -> int:
        return (time.perf_counter_ns() - self._epoch) // 1000

    def _tid(self, name: str) -> int:
        tid = self._tids.get(name)
        if tid is None:
            tid = self._tids[name] = len(self._tids)
        return tid

    def span(self, name: str, *, tid: str = "engine", cat: str = "serve",
             args: Optional[Dict[str, Any]] = None):
        """Context manager timing a phase (Chrome 'complete' event).
        Spans on the same tid must nest (context-manager discipline in
        single-threaded host code gives this for free)."""
        if not self.enabled:
            return NOOP_SPAN
        return _Span(self, name, cat, self._tid(tid), args)

    def instant(self, name: str, *, tid: str = "engine",
                cat: str = "serve",
                args: Optional[Dict[str, Any]] = None) -> None:
        """A zero-duration marker (Chrome 'instant' event, thread scope)."""
        if not self.enabled:
            return
        ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
              "ts": self._now(), "pid": self.pid, "tid": self._tid(tid)}
        if args:
            ev["args"] = args
        self._push(ev)

    def counter(self, name: str, values: Dict[str, float], *,
                tid: str = "engine", cat: str = "serve") -> None:
        """A monotonic/utilization counter sample (Chrome 'C' event);
        Perfetto renders each key in ``values`` as a track series."""
        if not self.enabled:
            return
        self._push({"name": name, "cat": cat, "ph": "C",
                    "ts": self._now(), "pid": self.pid,
                    "tid": self._tid(tid), "args": values})

    def begin_async(self, name: str, aid, *, cat: str = "request",
                    args: Optional[Dict[str, Any]] = None) -> None:
        """Open an async interval (ph 'b') — request lifecycles span many
        ticks and interleave, which synchronous spans cannot express."""
        if not self.enabled:
            return
        ev = {"name": name, "cat": cat, "ph": "b", "id": str(aid),
              "ts": self._now(), "pid": self.pid,
              "tid": self._tid("requests")}
        if args:
            ev["args"] = args
        self._push(ev)

    def end_async(self, name: str, aid, *, cat: str = "request",
                  args: Optional[Dict[str, Any]] = None) -> None:
        if not self.enabled:
            return
        ev = {"name": name, "cat": cat, "ph": "e", "id": str(aid),
              "ts": self._now(), "pid": self.pid,
              "tid": self._tid("requests")}
        if args:
            ev["args"] = args
        self._push(ev)

    # -- inspection / export ----------------------------------------------

    @property
    def dropped_events(self) -> int:
        return self.events_recorded - len(self._events)

    def events(self) -> List[Dict[str, Any]]:
        return list(self._events)

    def clear(self) -> None:
        self._events.clear()
        self.events_recorded = 0

    def phase_walls(self) -> Dict[str, Tuple[int, float]]:
        """Aggregate wall time by span name: ``{name: (count, secs)}``,
        sorted by total descending. Nested spans overlap their parents
        (``decode_tick`` contains ``device_dispatch``), so rows are a
        breakdown to read top-down, not a partition that sums to 1."""
        acc: Dict[str, List[float]] = {}
        for ev in self._events:
            if ev.get("ph") != "X":
                continue
            c = acc.setdefault(ev["name"], [0, 0.0])
            c[0] += 1
            c[1] += ev["dur"] / 1e6
        return {k: (int(v[0]), v[1]) for k, v in
                sorted(acc.items(), key=lambda kv: -kv[1][1])}

    def format_phase_walls(self, prefix: str = "  ") -> str:
        lines = [f"{prefix}{name:<22s} {n:>7d} x {secs:>9.4f} s"
                 for name, (n, secs) in self.phase_walls().items()]
        return "\n".join(lines) if lines else f"{prefix}(no spans recorded)"

    def to_dict(self) -> Dict[str, Any]:
        """The Chrome Trace Event Format object: ring-buffer events plus
        process/thread-name metadata rows so Perfetto labels the tracks."""
        meta: List[Dict[str, Any]] = [{
            "name": "process_name", "ph": "M", "pid": self.pid, "tid": 0,
            "args": {"name": self.process_name}}]
        for tname, tid in self._tids.items():
            meta.append({"name": "thread_name", "ph": "M", "pid": self.pid,
                         "tid": tid, "args": {"name": tname}})
        return {
            "traceEvents": meta + list(self._events),
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped_events,
                          "events_recorded": self.events_recorded},
        }

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)


#: The process-wide disabled tracer every engine defaults to.
NULL_TRACER = Tracer(enabled=False, capacity=1)

_default: Tracer = NULL_TRACER


def set_default_tracer(tracer: Optional[Tracer]) -> None:
    """Install the tracer engines pick up when built without an explicit
    ``tracer=`` (benchmark harness / launcher convenience: one call turns
    on tracing for every engine a scenario constructs). ``None`` restores
    the disabled ``NULL_TRACER``."""
    global _default
    _default = tracer if tracer is not None else NULL_TRACER


def default_tracer() -> Tracer:
    return _default


# -- percentiles (metrics helpers; host-side, no numpy dependency) --------

def percentile(xs: List[float], q: float) -> float:
    """Nearest-rank-with-interpolation percentile; 0.0 on empty input so
    metric key sets stay stable when nothing was measured."""
    if not xs:
        return 0.0
    s = sorted(xs)
    if len(s) == 1:
        return s[0]
    pos = (len(s) - 1) * q
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


# -- schema validation (the CI gate over exported traces) -----------------

_VALID_PH = {"X", "B", "E", "i", "I", "C", "M", "b", "e", "n", "s", "t",
             "f"}


def validate_trace(obj: Any) -> List[str]:
    """Validate a Chrome Trace Event Format object (the JSON-object
    flavor Perfetto and chrome://tracing load). Returns violations
    (empty list = valid):

    * top level must be ``{"traceEvents": [...]}``;
    * every event needs ``ph`` (known phase) and ``pid``; non-metadata
      events need integer ``ts`` >= 0 and ``tid``; ``X`` events need
      integer ``dur`` >= 0 and a ``name``;
    * per (pid, tid), ``X`` spans must NEST — two spans may share a
      timeline row only if one contains the other or they are disjoint;
    * async ``b``/``e`` events need ``id`` + ``cat``; an ``e`` without a
      prior ``b`` for its (cat, id, name) is flagged — unless the trace
      declares dropped events (ring-buffer eviction removes the oldest
      ``b`` rows first, legitimately orphaning their ``e``).
    """
    errors: List[str] = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["top level must be an object with a 'traceEvents' array"]
    events = obj["traceEvents"]
    if not isinstance(events, list):
        return ["'traceEvents' must be an array"]
    dropped = 0
    other = obj.get("otherData")
    if isinstance(other, dict):
        dropped = int(other.get("dropped_events", 0) or 0)

    spans: Dict[Tuple[Any, Any], List[Tuple[int, int, str]]] = {}
    async_open: Dict[Tuple[Any, Any, Any], int] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _VALID_PH:
            errors.append(f"event {i}: unknown ph {ph!r}")
            continue
        if "pid" not in ev:
            errors.append(f"event {i} (ph={ph}): missing pid")
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, int) or ts < 0:
            errors.append(f"event {i} (ph={ph}): ts must be a "
                          f"non-negative integer, got {ts!r}")
            continue
        if "tid" not in ev:
            errors.append(f"event {i} (ph={ph}): missing tid")
            continue
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, int) or dur < 0:
                errors.append(f"event {i}: X event dur must be a "
                              f"non-negative integer, got {dur!r}")
                continue
            if not ev.get("name"):
                errors.append(f"event {i}: X event missing name")
                continue
            spans.setdefault((ev.get("pid"), ev["tid"]), []).append(
                (ts, dur, ev["name"]))
        elif ph == "C":
            if not isinstance(ev.get("args"), dict):
                errors.append(f"event {i}: counter event needs an args "
                              f"object of series values")
        elif ph in ("b", "e", "n"):
            if "id" not in ev or "cat" not in ev:
                errors.append(f"event {i}: async {ph} event needs id "
                              f"and cat")
                continue
            key = (ev["cat"], ev["id"], ev.get("name"))
            if ph == "b":
                async_open[key] = async_open.get(key, 0) + 1
            elif ph == "e":
                if async_open.get(key, 0) > 0:
                    async_open[key] -= 1
                elif dropped == 0:
                    errors.append(
                        f"event {i}: async end without matching begin "
                        f"for {key} (and no dropped events declared)")

    # per-track nesting: sweep spans by (start, -dur) and keep a stack of
    # open intervals — a span starting inside the top must also end
    # inside it
    for (pid, tid), ivs in spans.items():
        ivs.sort(key=lambda x: (x[0], -x[1]))
        stack: List[Tuple[int, int, str]] = []
        for ts, dur, name in ivs:
            while stack and ts >= stack[-1][0] + stack[-1][1]:
                stack.pop()
            if stack and ts + dur > stack[-1][0] + stack[-1][1]:
                top = stack[-1]
                errors.append(
                    f"tid {tid} (pid {pid}): span {name!r} "
                    f"[{ts}, {ts + dur}) partially overlaps "
                    f"{top[2]!r} [{top[0]}, {top[0] + top[1]}) — spans "
                    f"on one track must nest")
                continue
            stack.append((ts, dur, name))
    return errors


def _main() -> None:
    import argparse
    import sys
    ap = argparse.ArgumentParser(
        description="Validate a Chrome Trace Event JSON file (a "
                    "serve --trace or serve_bench --trace-out artifact)")
    ap.add_argument("trace", help="trace JSON file to validate")
    ap.add_argument("--validate", action="store_true",
                    help="(default and only mode; kept for readability "
                         "at the call site)")
    args = ap.parse_args()
    with open(args.trace) as f:
        obj = json.load(f)
    errors = validate_trace(obj)
    if errors:
        for e in errors:
            print(f"FAIL: {e}", file=sys.stderr)
        raise SystemExit(1)
    events = obj["traceEvents"]
    n_spans = sum(1 for e in events if isinstance(e, dict)
                  and e.get("ph") == "X")
    names = sorted({e["name"] for e in events if isinstance(e, dict)
                    and e.get("ph") == "X"})
    print(f"validate_trace: OK — {len(events)} events, {n_spans} spans "
          f"({', '.join(names[:12])}{'...' if len(names) > 12 else ''})")


if __name__ == "__main__":
    _main()
