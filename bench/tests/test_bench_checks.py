"""The correctness check's control and faults, at a size a test run holds
(the CPU, tiny widths): the fp8 control, put through the harness's own
check, reads wider than the program and comes out not correct under
limits between the two; a run with a token altered where the sampler
produces it, or drawn at the wrong temperature or outside the nucleus,
comes out not correct, and the same run unaltered comes out correct. On
the card the control is held to each cell's own limits
(``test_bench_card.py``)."""
import time
from types import SimpleNamespace

import pytest
import torch

from bench.control import readings
from bench.lib import correct, harness, spec
from bench_tiny import CELLS, MIXES, config

# limits between the tiny program's readings and the tiny control's: the
# widest gap on the dense stack, the mean gap where a router's near-ties
# flip, the widest sampled gap where the mix samples
LIMITS = {"reason": {"logit_gap": 0.03, "sampled_gap": 0.03},
          "chat": {"logit_mean": 0.03}}


def _run(which, seed, seconds=1.5):
    name, cell = CELLS[which]
    return harness.run_cell(config(name), MIXES[which], LIMITS[which],
                            spec.end_to_end(cell), spec.per_layer(cell),
                            seed, seconds, False, time.perf_counter(),
                            device="cpu")


def _readings(which, seeds):
    name, cell = CELLS[which]
    return readings(cell, seeds, 1.5, device="cpu", out=lambda s: None,
                    cfg=config(name), mix=MIXES[which], limits=LIMITS[which])


@pytest.mark.parametrize("which", ["reason", "chat"])
def test_control_reads_wider_than_the_program(which):
    rows = _readings(which, [11, 12, 13])
    prog = [r["control"]["program"] for r in rows]
    ctrl = [r["control"]["numbers"] for r in rows]
    assert all(p["tokens"] > 0 for p in prog)
    # at this size a seed's sample can hold no near-tie: the control must
    # read wider than the program on the seeds together
    for number in LIMITS[which]:
        assert max(c[number] for c in ctrl) > 3 * max(p[number] for p in prog)


@pytest.mark.parametrize("which", ["reason", "chat"])
def test_the_control_is_not_correct_through_the_harness(which):
    rows = _readings(which, [12])
    r = rows[0]
    assert r["correct"], r["checks"]
    assert r["control"]["correct"] is False, r["control"]["checks"]
    assert set(r["control"]["checks"]) == set(LIMITS[which])
    assert any(c["value"] > c["limit"]
               for c in r["control"]["checks"].values())


def test_verdict_holds_named_numbers_only():
    ok, checks = correct.verdict({"logit_gap": 0.1, "logit_mean": 9.0},
                                 {"logit_gap": 0.2, "readings": {}})
    assert ok and set(checks) == {"logit_gap"}
    ok, _ = correct.verdict({"logit_gap": 0.3}, {"logit_gap": 0.2})
    assert not ok
    ok, checks = correct.verdict({"logit_gap": 0.0}, {})
    assert not ok and not checks


@pytest.mark.parametrize("which", ["reason", "chat"])
def test_a_sound_run_is_correct(which):
    out = _run(which, 21)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"


def _patched(monkeypatch, change):
    from repro_torch.runtime import serving
    real = serving.sample_rows

    def altered(logits, pol, offset=0):
        return change(real, logits, pol, offset)

    monkeypatch.setattr(serving, "sample_rows", altered)


@pytest.mark.parametrize("which", ["reason", "chat"])
def test_an_altered_token_is_not_correct(which, monkeypatch):
    _patched(monkeypatch, lambda real, z, pol, off:
             (real(z, pol, off) + 1) % z.shape[-1])
    out = _run(which, 21)
    assert not out["correct"]
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def _policy(pol, **over):
    fields = dict(temp=pol.temp, top_k=pol.top_k, top_p=pol.top_p,
                  seed=pol.seed, rid=pol.rid, idx=pol.idx)
    fields.update({k: f(pol) for k, f in over.items()})
    return SimpleNamespace(**fields)


@pytest.mark.parametrize("fault", ["temperature", "nucleus"])
def test_a_wrong_sampler_is_not_correct(fault, monkeypatch):
    # sampled rows drawn at temperature 1, or from the whole vocabulary:
    # the greedy rows stay right, the sampled check must fail
    over = {"temperature": dict(temp=lambda p: torch.where(
                p.temp > 0, torch.ones_like(p.temp), p.temp)),
            "nucleus": dict(top_p=lambda p: torch.ones_like(p.top_p))}
    _patched(monkeypatch, lambda real, z, pol, off:
             real(z, _policy(pol, **over[fault]), off))
    out = _run("reason", 21)
    assert not out["correct"]
    assert out["checks"]["logit_gap"]["value"] <= LIMITS["reason"]["logit_gap"]
    assert out["checks"]["sampled_gap"]["value"] \
        > LIMITS["reason"]["sampled_gap"]


def test_the_run_refuses_without_a_card(monkeypatch):
    import subprocess
    import sys
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, str(spec.BENCH / "run.py"),
                        "--workload", "qwen2.5-3b.reason", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and r.stdout.strip() == ""
