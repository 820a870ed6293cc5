"""Whether the served tokens are right, judged by the plain reference.

Two samples, drawn from ``--seed`` among the finished requests: the
greedy ones and, where the mix samples, the sampled ones. Each holds the
longest request of its kind whole, then others in an order drawn from
the seed until ``check_tokens`` served tokens (greedy) or
``check_sampled_tokens`` (sampled) are in it; with ``check_requests``
at most that many requests, one a client, and with ``check_slice`` the
others judged over their first that many tokens, so that the sample
spans more of the slots.

The reference scores each request's prompt and judged tokens once
(``reference.model.served_logits``). A token's gap is how far it lies
from the draw of the request's own rule under the reference's logits
(``reference.sampling.gaps``): for a greedy token, how far its logit lies
below the best; for a sampled one, by the same Gumbel noise, how far its
score lies below the best score of the nucleus, and how far it lies
outside the nucleus. The control puts the reference in fp8 in the
program's place: at each position of the same prompts and tokens, the
token that its logits draw, judged by the same gap.

``judge`` gives the numbers of the program and of the control under the
same names; ``verdict`` holds either side's against a cell's limits."""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from bench.lib import traffic as tr
from bench.lib.stats import Record
from bench.reference import model as ref
from bench.reference import sampling as rs
from bench.reference.dims import Dims

# the numbers a cell's limits may hold (bench/cells/<cell>.json)
COMPARED = ("logit_gap", "logit_mean", "sampled_gap")
# the nucleus's mass may differ by this much under the program's bf16
# rounding of the logits (reference.sampling.gaps)
NUCLEUS_SLACK = 0.005


def sample(recs: List[Record], seed: int, greedy: bool, tokens: int,
           requests: int = 0, cut: int = 0) -> List[Tuple[Record, int]]:
    """(record, tokens judged) of the sample of one kind."""
    done = [r for r in recs if r.done and r.greedy == greedy
            and len(r.tokens) == r.max_new]
    if not done:
        return []
    done.sort(key=lambda r: (-len(r.tokens), r.rid))
    rng = np.random.default_rng([seed % 2**64, 0xC4EC if greedy else 0xC4ED])
    out, n = [(done[0], len(done[0].tokens))], len(done[0].tokens)
    clients = {done[0].client}
    for i in rng.permutation(len(done) - 1) + 1:
        r = done[i]
        if n >= tokens or (requests and len(out) >= requests):
            break
        if requests and r.client in clients:
            continue
        k = min(cut, len(r.tokens)) if cut else len(r.tokens)
        out.append((r, k))
        clients.add(r.client)
        n += k
    return out


def _bucket(mix: dict, L: int) -> int:
    page = mix["page_size"]
    return tr.bucket(L, page, -(-mix["max_len"] // page) * page)


def _rule(mix: dict, seed: int, rec: Record):
    """(sampler seed, temperature, top_p) of the request's policy."""
    s = mix.get("sampled")
    if rec.greedy or not s:
        return 0, 0.0, 1.0
    if s.get("top_k", 0):
        raise ValueError("the reference follows top_p alone, not top_k")
    return tr.sampled_seed(seed, rec.rid), float(s["temperature"]), \
        float(s["top_p"])


def gaps(dm: Dims, w: Dict, mix: dict, seed: int, rec: Record, n: int,
         control: bool = False) -> Dict[str, torch.Tensor]:
    """Per judged token of ``rec`` (its first ``n``): its gap under the fp32
    reference (``logit``) and, with ``control``, that of the token the fp8
    control draws there (``control``)."""
    prompt = tr.prompt_tokens(seed, rec.rid, rec.prompt_len, dm.vocab)
    served = list(rec.tokens)[:n]
    args = (dm, w, prompt, served, _bucket(mix, rec.prompt_len),
            mix["slots"])
    s_seed, temp, top_p = _rule(mix, seed, rec)
    rule = (s_seed, rec.rid, temp, top_p, NUCLEUS_SLACK)
    with torch.no_grad():
        z = ref.served_logits(*args)
        idx = torch.tensor(served, device=z.device)
        out = {"logit": rs.gaps(z, idx, *rule).cpu()}
        if control:
            z8 = ref.served_logits(*args, precision="fp8")
            pick = rs.draw(z8, s_seed, rec.rid, temp, top_p)
            del z8
            out["control"] = rs.gaps(z, pick, *rule).cpu()
    return out


def summarize(g: torch.Tensor, prefix: str) -> Dict[str, float]:
    """The widest gap and the mean gap; beside them, as readings that no
    cell compares, the 99th percentile and the share of tokens off the
    rule's draw."""
    return {f"{prefix}_gap": float(g.max()), f"{prefix}_mean": float(g.mean()),
            f"{prefix}_q99": float(torch.quantile(g.double(), 0.99)),
            f"{prefix}_miss": float((g > 0).float().mean())}


def judge(dm: Dims, w: Dict, mix: dict, seed: int, recs: List[Record],
          control: bool = False) -> Dict[str, Dict[str, float]]:
    """``{"program": numbers, "control": numbers}`` (the control with
    ``control``): ``logit_*`` over the greedy sample, ``sampled_*`` over
    the sampled one where the mix samples, and the counts judged. With
    nothing to compare, a number is infinite."""
    kinds = [("logit", True, mix["check_tokens"])]
    if mix.get("sampled"):
        kinds.append(("sampled", False, mix["check_sampled_tokens"]))
    sides = ("program",) + (("control",) if control else ())
    out = {s: {} for s in sides}
    counts = {"requests": 0, "tokens": 0}
    for prefix, greedy, tokens in kinds:
        picked = sample(recs, seed, greedy, tokens,
                        mix.get("check_requests", 0), mix.get("check_slice", 0))
        per = [gaps(dm, w, mix, seed, r, k, control) for r, k in picked]
        counts["requests"] += len(picked)
        counts["tokens"] += sum(k for _, k in picked)
        for side, key in (("program", "logit"), ("control", "control")):
            if side not in out:
                continue
            if per:
                out[side].update(summarize(torch.cat([p[key] for p in per]),
                                           prefix))
            else:
                out[side].update({f"{prefix}_{n}": float("inf")
                                  for n in ("gap", "mean", "q99", "miss")})
    for side in out.values():
        side.update(counts)
    return out


def verdict(numbers: Dict[str, float], limits: dict
            ) -> Tuple[bool, Dict[str, dict]]:
    """(correct, checks): each number that the cell's limits name, beside
    its limit. Correct only where at least one is compared and none is
    over its limit."""
    checks = {k: {"value": numbers[k], "limit": float(limits[k])}
              for k in COMPARED if k in limits}
    ok = bool(checks) and all(c["value"] <= c["limit"]
                              for c in checks.values())
    return ok, checks
