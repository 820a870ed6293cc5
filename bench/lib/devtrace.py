"""``torch.profiler`` over the last seconds of the measured window (the
traced run only; read once the window has closed): the device's operations with
their host-clock times, its busy seconds (the union of the operations'
intervals), the idle gaps between them, and which program span was open
in each gap."""
from __future__ import annotations

import time
from types import SimpleNamespace
from typing import List, Optional, Tuple

MARK = "bench.clock"


def prime() -> None:
    """One short session before the window: a process's first profiler
    start sets up the device tracing, which takes seconds, and must not
    fall inside the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(1, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        (x + 1).sum().item()


class SubWindow:
    """The profiler over the window's last ``length`` seconds: opened at
    the first tick boundary past ``start`` s into the window, stopped when
    the window closes, read after it. A session that recorded no device
    operation leaves ``result`` None."""

    def __init__(self, start: float, length: float):
        self.start, self.length = start, length
        self.window_t0: Optional[float] = None
        self._prof = None
        self.result: Optional[SimpleNamespace] = None

    def on_tick(self, now: float) -> None:
        if self._prof is None and self.result is None \
                and now - self.window_t0 >= self.start:
            self._open()

    def _open(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        torch.cuda.synchronize()
        t = time.perf_counter()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        with record_function(MARK):
            self._mark = time.perf_counter()
        self.t_open = time.perf_counter()
        self.open_s = self.t_open - t

    def close(self) -> None:
        """Stop the session and read it."""
        import torch
        if self._prof is None:
            return
        torch.cuda.synchronize()
        t_close = time.perf_counter()
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        res = read(prof, self._mark, self.t_open, t_close)
        if res.events:
            self.result = res


def read(prof, mark: float, t0: float, t1: float) -> SimpleNamespace:
    """Device operations (name, start s, duration s) on the host clock,
    clipped to [t0, t1], and their busy seconds."""
    raw = prof.profiler.kineto_results.events()
    offset = None
    dev: List[Tuple[str, float, float]] = []
    for ev in raw:
        name = ev.name()
        start, dur = ev.start_ns(), ev.duration_ns()
        kind = str(ev.device_type())
        if name == MARK and "CPU" in kind:
            offset = mark - start * 1e-9
        elif "CUDA" in kind:
            dev.append((name, start * 1e-9, dur * 1e-9))
    if offset is None:
        raise RuntimeError("the profiler lost its clock mark")
    events = []
    for name, s, d in dev:
        a, b = max(s + offset, t0), min(s + offset + d, t1)
        if b > a:
            events.append((name, a, b - a))
    events.sort(key=lambda e: e[1])
    busy, gaps, end = 0.0, [], t0
    for _, a, d in events:
        if a > end:
            gaps.append((end, a - end))
        busy += max(0.0, a + d - max(a, end))
        end = max(end, a + d)
    if t1 > end:
        gaps.append((end, t1 - end))
    return SimpleNamespace(t0=t0, t1=t1, window_s=t1 - t0, events=events,
                           busy_s=busy, gaps=gaps)


def breakdown(res: SimpleNamespace, spans) -> dict:
    """The ten device operations that took most time, and the ten longest
    idle gaps, each named by the innermost program span open at its
    middle (``spans``: (name, start s, duration s) on the host clock)."""
    by_name = {}
    for name, _, d in res.events:
        by_name[name] = by_name.get(name, 0.0) + d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = []
    for a, d in sorted(res.gaps, key=lambda g: -g[1])[:10]:
        mid = a + d / 2
        open_ = [s for s in spans if s[1] <= mid <= s[1] + s[2]]
        label = min(open_, key=lambda s: s[2])[0] if open_ else "harness"
        gaps.append([label, d])
    return {"device_ops": [[n, t] for n, t in ops], "idle_gaps": gaps}
