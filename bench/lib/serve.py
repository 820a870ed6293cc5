"""Drives the port's serving path as a closed loop of clients:
``repro_torch.runtime.scheduler.Scheduler`` (``add``, ``tick``) over
``PagedServingEngine(attn_impl="kernel")``.

Each client keeps one request in flight and sends its next one when it
sees the last one done. A request's tokens are stamped by the client's
own clock as they reach it (``Stamped``, the list the engine appends
them to). The loop records every tick: its host start and end, the true
prompt length of each prefill in it, and the keys each decode row
attended, which the frozen counts turn into operations and bytes."""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

from bench.lib import traffic as tr
from bench.lib.stats import Record


class Stamped(list):
    """A request's generated tokens, stamping the host time of each."""

    def __init__(self):
        super().__init__()
        self.times: List[float] = []

    def append(self, tok) -> None:
        super().append(tok)
        self.times.append(time.perf_counter())


@dataclasses.dataclass
class Tick:
    t0: float
    t1: float
    prefills: List[int]          # true prompt lengths admitted
    rows: List[int]              # keys attended by each decode row


def make_engine(port_cfg, params, mix: dict, seed: int, tracer, device):
    from repro_torch.runtime.scheduler import Scheduler
    from repro_torch.runtime.serving import PagedServingEngine
    eng = PagedServingEngine(
        port_cfg, params, slots=mix["slots"], max_len=mix["max_len"],
        page_size=mix["page_size"], eos_id=-1, seed=seed & 0x7FFFFFFF,
        attn_impl="kernel", prefix_cache=False, tracer=tracer,
        device=device)
    return eng, Scheduler(eng)


def _params(card: tr.Card, mix: dict, seed: int):
    from repro_torch.runtime.sampling import SamplingParams
    s = mix.get("sampled")
    if card.greedy or not s:
        return SamplingParams()
    return SamplingParams(temperature=s["temperature"], top_k=s["top_k"],
                          top_p=s["top_p"],
                          seed=tr.sampled_seed(seed, card.rid))


def warm(eng, mix: dict, vocab: int, seed: int) -> None:
    """One prefill in every bucket the mix fills, and one decode step (the
    graph's capture), before anything is timed."""
    from repro_torch.runtime.serving import Request
    warm_card = tr.Card(rid=0, prompt_len=0, output_len=0,
                        greedy=mix.get("sampled") is None)
    for i, b in enumerate(tr.buckets(mix)):
        L = b - 1 if b > 2 else b
        req = Request(rid=(1 << 30) + i,
                      prompt=tr.prompt_tokens(seed, (1 << 30) + i, L, vocab),
                      max_new=2 if i == 0 else 1,
                      params=_params(warm_card, mix, seed))
        if not eng.submit(req):
            raise RuntimeError(f"warm-up prefill of {L} tokens refused")
        while eng.has_live():
            eng.step()


class ClosedLoop:
    def __init__(self, eng, sched, mix: dict, seed: int, vocab: int):
        self.eng, self.sched, self.mix = eng, sched, mix
        self.seed, self.vocab = seed, vocab
        self.deck = tr.Deck(mix, seed)
        self.records: List[Record] = []
        self.ticks: List[Tick] = []
        self._flight: Dict[int, tuple] = {}     # client -> (record, req, seen)

    def _send(self, client: int, card: tr.Card) -> None:
        from repro_torch.runtime.serving import Request
        req = Request(rid=card.rid,
                      prompt=tr.prompt_tokens(self.seed, card.rid,
                                              card.prompt_len, self.vocab),
                      max_new=card.output_len, generated=Stamped(),
                      params=_params(card, self.mix, self.seed))
        rec = Record(rid=card.rid, client=client, sent=time.perf_counter(),
                     prompt_len=card.prompt_len, max_new=card.output_len,
                     greedy=card.greedy, stamps=req.generated.times,
                     tokens=req.generated)
        self.records.append(rec)
        self._flight[client] = (rec, req, 0)
        self.sched.add(req)

    def tick(self) -> Tick:
        t0 = time.perf_counter()
        self.sched.tick()
        t1 = time.perf_counter()
        tick = Tick(t0, t1, [], [])
        for client, (rec, req, seen) in list(self._flight.items()):
            n = len(req.generated)
            if seen == 0 and n >= 1:
                tick.prefills.append(rec.prompt_len)
            tick.rows.extend(rec.prompt_len + i
                             for i in range(max(seen, 1), n))
            self._flight[client] = (rec, req, n)
            if req.done:
                rec.done = True
                self._send(client, self.deck.next())
        self.ticks.append(tick)
        return tick

    def ramp(self) -> None:
        """Every client's first request, admitted in one tick."""
        for client, card in enumerate(self.deck.first()):
            self._send(client, card)
        first = list(self.records)
        self.tick()
        waiting = sum(1 for r in first if not r.stamps)
        if waiting:
            raise RuntimeError(f"{waiting} first requests not admitted: "
                               f"slots or pages too few")

    def window(self, seconds: float,
               on_tick: Optional[Callable[[float], None]] = None):
        """Ticks until ``seconds`` have passed; then more, outside the
        window, until every request sent inside it has its first token.
        Returns (t0, t1, the window's ticks)."""
        t0 = time.perf_counter()
        first = len(self.ticks)
        while True:
            tick = self.tick()
            if on_tick is not None:
                on_tick(tick.t1)
            if tick.t1 >= t0 + seconds:
                break
        t1 = tick.t1
        inside = self.ticks[first:]
        while any(t0 <= r.sent < t1 and not r.stamps for r in self.records):
            self.tick()
        return t0, t1, inside
