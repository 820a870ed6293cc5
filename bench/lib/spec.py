"""Finds what BENCHMARK.json names, each by its name: a cell's entry, its
configuration file, its traffic mix (``bench/traffic/<mix>.json``), its
correctness limits (``bench/cells/<cell>.json``) and the reader of each
per-layer metric (``reader_path``). A later cell, mix, configuration or
metric is a new file and a new entry; nothing here changes for it."""
from __future__ import annotations

import importlib.util
import json
from functools import lru_cache
from pathlib import Path
from typing import Callable, Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@lru_cache(maxsize=None)
def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as fh:
        return json.load(fh)


def _named(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json names no {what} {name!r}")


def cell(name: str) -> dict:
    return _named(benchmark()["workloads"], name, "workload")


def config(name: str) -> dict:
    entry = _named(benchmark()["configs"], name, "config")
    with open(ROOT / entry["file"]) as fh:
        cfg = json.load(fh)
    cfg["name"] = name
    return cfg


def traffic(name: str) -> dict:
    with open(BENCH / "traffic" / f"{name}.json") as fh:
        mix = json.load(fh)
    mix["name"] = name
    return mix


def limits(cell_name: str) -> dict:
    with open(BENCH / "cells" / f"{cell_name}.json") as fh:
        return json.load(fh)


def _applies(metric: dict, cell_name: str, moves_ok: bool) -> bool:
    listed = metric.get("workloads")
    return cell_name in listed if listed is not None else moves_ok


def end_to_end(cell_name: str) -> List[dict]:
    """The cell's end-to-end metrics: those that list it, and those that
    list no cells."""
    return [m for m in benchmark()["end_to_end"]
            if _applies(m, cell_name, True)]


def per_layer(cell_name: str) -> List[dict]:
    """The cell's per-layer metrics: those that list it, and those without
    a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end(cell_name)}
    return [m for m in benchmark()["per_layer"]
            if _applies(m, cell_name, m["moves"] in e2e)]


def reader_path(metric: str) -> Path:
    """``bench/metrics/<metric>.py``, or where there is none, the reader of
    the name less its last ``.part``: one reader serves a quantity that is
    split by the tail it moves (``prefill_ms.rag``, ``prefill_ms.rag4k``
    -> ``prefill_ms.py``)."""
    path = BENCH / "metrics" / f"{metric}.py"
    if not path.exists() and "." in metric:
        path = BENCH / "metrics" / f"{metric.rsplit('.', 1)[0]}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader for the metric {metric!r}")
    return path


@lru_cache(maxsize=None)
def reader(metric: str) -> Callable[[object], object]:
    """``read(ctx)`` of the metric's reader (``reader_path``): the metric's
    value, or None where the run has nothing for it to read."""
    path = reader_path(metric)
    mod_name = "bench_metric_" + "".join(c if c.isalnum() else "_"
                                         for c in path.stem)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def all_names() -> Dict[str, List[str]]:
    b = benchmark()
    return {"workloads": [w["name"] for w in b["workloads"]],
            "configs": [c["name"] for c in b["configs"]],
            "per_layer": [m["name"] for m in b["per_layer"]]}
