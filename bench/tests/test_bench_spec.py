"""The harness finds cells, mixes, configurations, limits and metric
readers by name, and BENCHMARK.json keeps to the format the runner reads."""
import json
import re

import pytest

from bench.lib import correct, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_name_resolves():
    b = spec.benchmark()
    for w in b["workloads"]:
        assert spec.cell(w["name"]) is w
        spec.config(w["config"])
        mix = spec.traffic(w["traffic"])
        assert mix["clients"] == mix["slots"]
        lim = spec.limits(w["name"])
        assert any(float(lim[k]) > 0 for k in correct.COMPARED if k in lim)
        assert spec.end_to_end(w["name"])
        assert spec.per_layer(w["name"])
        assert "setup_s" in {m["name"] for m in spec.end_to_end(w["name"])}
    for m in b["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        spec.cell("no-such-cell")
    with pytest.raises(FileNotFoundError):
        spec.traffic("no-such-mix")


def test_benchmark_json_format():
    b = spec.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for c in m["workloads"]:
            assert c in cells
            assert m["moves"] in {x["name"] for x in spec.end_to_end(c)}
    for c in b["configs"]:
        assert c["file"].startswith("bench/")
        cfg = json.load(open(spec.ROOT / c["file"]))
        assert set(c["reduced"]) == set(cfg["reduced"])
    assert len(json.dumps(b)) < 64 * 1024


def test_each_cell_reports_a_rate_a_setup_and_a_layer():
    for w in spec.benchmark()["workloads"]:
        e2e = {m["name"] for m in spec.end_to_end(w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.per_layer(w["name"])


def test_a_reader_serves_the_names_split_by_their_tail():
    m = spec.BENCH / "metrics"
    assert spec.reader_path("prefill_ms.rag") == m / "prefill_ms.py"
    assert spec.reader_path("mfu.prefill.rag4k") == m / "mfu.prefill.py"
    assert spec.reader_path("mfu.decode") == m / "mfu.decode.py"
    assert spec.reader_path("idle_pct") == m / "idle_pct.py"
    with pytest.raises(FileNotFoundError):
        spec.reader_path("no_such_metric.rag")
