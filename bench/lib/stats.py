"""The end-to-end arithmetic over the client's own stamps.

``percentile`` is a copy of the port's ``runtime/trace.percentile``
(linear interpolation between closest ranks). A request's record holds
its send time and the host time at which each of its tokens reached it.
The window is [t0, t1]: tokens stamped inside it count for
``output_tok_s``; a request's TPOT is the mean gap between its tokens
inside the window (two or more); a TTFT is send to first token, of every
request sent inside the window."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


def percentile(xs: List[float], q: float) -> float:
    if not xs:
        return 0.0
    s = sorted(xs)
    if len(s) == 1:
        return s[0]
    pos = (len(s) - 1) * q
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


@dataclasses.dataclass
class Record:
    rid: int
    client: int
    sent: float
    prompt_len: int
    max_new: int
    greedy: bool
    stamps: List[float]
    tokens: List[int]
    done: bool = False


def _inside(rec: Record, t0: float, t1: float) -> List[float]:
    return [t for t in rec.stamps if t0 <= t <= t1]


def output_tok_s(recs: List[Record], t0: float, t1: float) -> float:
    return sum(len(_inside(r, t0, t1)) for r in recs) / (t1 - t0)


def tpots(recs: List[Record], t0: float, t1: float) -> List[float]:
    out = []
    for r in recs:
        s = _inside(r, t0, t1)
        if len(s) >= 2:
            out.append((s[-1] - s[0]) / (len(s) - 1))
    return out


def ttfts(recs: List[Record], t0: float, t1: float) -> List[float]:
    return [r.stamps[0] - r.sent for r in recs
            if t0 <= r.sent < t1 and r.stamps]


TAILS = (50, 90, 95, 99)


def end_to_end(recs: List[Record], t0: float, t1: float
               ) -> Dict[str, Optional[float]]:
    """Every end-to-end number a run can give (tokens/s; TPOT and TTFT
    percentiles ``tpot_p<q>_ms``, ``ttft_p<q>_ms``), with the sample
    counts beside them."""
    out = {"output_tok_s": output_tok_s(recs, t0, t1)}
    for name, xs in (("tpot", tpots(recs, t0, t1)),
                     ("ttft", ttfts(recs, t0, t1))):
        out[f"{name}_samples"] = len(xs)
        for q in TAILS:
            out[f"{name}_p{q}_ms"] = percentile(xs, q / 100) * 1e3 \
                if xs else None
    return out
