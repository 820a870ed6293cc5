"""Request scheduler: admission control + prefill/decode interleaving.

Counterpart of ``repro.runtime.scheduler``. Each tick admits as many pending
requests as slots, pages and ``max_admits_per_step`` allow (prefill), then
advances every live request one token (decode); the engine's step tops up
pages itself and reports whom it had to preempt, and those re-enter the
queue ahead of fresh arrivals and resume by re-prefilling prompt +
generated-so-far.
"""
from __future__ import annotations

import warnings
from collections import deque
from typing import Deque, Optional

from repro_torch.runtime.serving import Request
from repro_torch.runtime.trace import NULL_TRACER


class SchedulerExhausted(RuntimeError):
    """drain() ran out of its step budget with work still in flight — the
    engine is wedged or the budget was too small; outputs are truncated."""


class Scheduler:
    def __init__(self, engine, *, max_admits_per_step: Optional[int] = None):
        self.engine = engine
        self.pending: Deque[Request] = deque()
        self.max_admits_per_step = max_admits_per_step
        self.steps = 0
        self.admitted = 0
        self.preempted = 0
        self.exhausted = False          # drain hit its budget with work left

    def add(self, req: Request) -> None:
        # a malformed decode policy (negative temperature, top_p = 0, ...)
        # fails here, at enqueue, where the caller still sees which request
        # it was — not mid-tick with other requests in flight
        params = getattr(req, "params", None)
        if params is not None:
            params.validate()
        # stamp arrival at enqueue so TTFT includes queue wait (getattr:
        # stub engines without the metrics mixin drive it too)
        note = getattr(self.engine, "note_arrival", None)
        if note is not None:
            note(req.rid)
        self.pending.append(req)

    def _admit(self) -> None:
        budget = self.max_admits_per_step
        while self.pending and (budget is None or budget > 0):
            req = self.pending[0]
            gen_before = len(req.generated)
            if not self.engine.submit(req):
                break                       # out of slots or pages
            self.pending.popleft()
            self.admitted += 1
            # only an admission that prefilled (its first token landed)
            # spends the budget: a request dropped as done never touched
            # the device
            if budget is not None and len(req.generated) > gen_before:
                budget -= 1

    def tick(self) -> None:
        """One scheduling round: admit, then decode."""
        tr = getattr(self.engine, "trace", NULL_TRACER)
        with tr.span("tick", tid="sched",
                     args={"pending": len(self.pending)} if tr else None):
            with tr.span("admit_loop", tid="sched"):
                self._admit()
            evicted = self.engine.step() or []
            if evicted:
                self.preempted += len(evicted)
                # evicted[] is youngest-first: pushing it front to back
                # leaves the oldest evictee at the head of the queue
                for r in evicted:
                    self.pending.appendleft(r)
        self.steps += 1

    def drain(self, max_steps: int = 10_000, *,
              on_exhaust: str = "raise") -> None:
        """Tick until every request finishes or ``max_steps`` is spent.
        With work left, ``on_exhaust="raise"`` raises SchedulerExhausted;
        ``"warn"`` warns and sets ``self.exhausted`` for benches to
        report."""
        if on_exhaust not in ("raise", "warn"):
            raise ValueError(f"on_exhaust must be raise|warn: {on_exhaust}")
        while (self.pending or self.engine.has_live()) \
                and self.steps < max_steps:
            self.tick()
        if self.pending or self.engine.has_live():
            self.exhausted = True
            live = sum(1 for r in getattr(self.engine, "live", [])
                       if r is not None)
            msg = (f"drain() exhausted its {max_steps}-step budget with "
                   f"{len(self.pending)} pending and {live} live requests "
                   f"— outputs are truncated")
            if on_exhaust == "raise":
                raise SchedulerExhausted(msg)
            warnings.warn(msg, stacklevel=2)
