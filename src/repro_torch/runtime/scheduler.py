"""Request scheduler: admission control + prefill/decode interleaving.

Counterpart of ``repro.runtime.scheduler``. Each tick admits as many pending
requests as slots and pages allow (prefill), then advances every live
request one token (decode); the engine's step tops up pages itself and
reports whom it had to preempt, and those re-enter the queue ahead of fresh
arrivals and resume by re-prefilling prompt + generated-so-far.
"""
from __future__ import annotations

from collections import deque
from typing import Deque

from repro_torch.runtime.serving import Request


class SchedulerExhausted(RuntimeError):
    """drain() ran out of its step budget with work still in flight — the
    engine is wedged or the budget was too small; outputs are truncated."""


class Scheduler:
    def __init__(self, engine):
        self.engine = engine
        self.pending: Deque[Request] = deque()
        self.steps = 0
        self.preempted = 0

    def add(self, req: Request) -> None:
        # stamp arrival at enqueue so TTFT includes queue wait
        self.engine.note_arrival(req.rid)
        self.pending.append(req)

    def _admit(self) -> None:
        while self.pending and self.engine.submit(self.pending[0]):
            self.pending.popleft()          # stops when out of slots/pages

    def tick(self) -> None:
        """One scheduling round: admit, then decode."""
        self._admit()
        evicted = self.engine.step() or []
        if evicted:
            self.preempted += len(evicted)
            # evicted[] is youngest-first: pushing it front to back leaves
            # the oldest evictee at the head of the queue
            for r in evicted:
                self.pending.appendleft(r)
        self.steps += 1

    def drain(self, max_steps: int = 10_000) -> None:
        """Tick until every request finishes; raises SchedulerExhausted if
        ``max_steps`` ticks leave requests pending or live."""
        while (self.pending or self.engine.has_live()) \
                and self.steps < max_steps:
            self.tick()
        if self.pending or self.engine.has_live():
            live = sum(1 for r in self.engine.live if r is not None)
            raise SchedulerExhausted(
                f"drain() exhausted its {max_steps}-step budget with "
                f"{len(self.pending)} pending and {live} live requests — "
                f"outputs are truncated")
