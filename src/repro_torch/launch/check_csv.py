"""Gate over a serving-bench CSV: equivalence and metrics columns must hold.

A copy of ``benchmarks/check_csv.py`` (the port imports nothing of the JAX
package's side), applied by ``chip_smoke.py`` to the CSV of
``repro_torch.launch.serve_bench``. Rules, applied to every section:

* every non-empty ``tokens_match_*`` cell must be exactly ``1``;
* each REQUIRED equivalence column must appear with at least one ``1``
  somewhere in the file (a scenario that did not run must not pass by
  absence);
* each unified metrics column (``ttft_p50`` / ``ttft_p95`` / ``tpot_p50``
  / ``tpot_p95`` / ``temporal_util``) must appear with at least one
  numeric cell, and every ``temporal_util`` must lie in [0, 1].

The port runs the reference's ``mixed``, ``shared-prefix``,
``speculative``, ``sampling``, ``hybrid`` and ``oversubscribe`` scenarios;
``sampling`` carries ``tokens_match_greedy``, ``oversubscribe``
``tokens_match_unconstrained``, ``hybrid`` (at fp32) its own
``tokens_match_hybrid`` over its dense, gather and kernel rows; the dense
engine's rows and the ``kernel/dense`` and ``paged/dense[hybrid]`` ratio
rows are gated like any other (their metrics cells parse, their
``temporal_util`` lies in [0, 1]); ``sharded`` carries ``tokens_match_tp1``
on every shard count that ran (a count beyond the devices is a note row
with no cells to gate). A full CSV of the port must pass every rule.

  python -m repro_torch.launch.check_csv bench.csv
"""
from __future__ import annotations

import argparse
import csv
import io
import sys
from typing import Dict, List, Tuple

REQUIRED = ("tokens_match_tp1", "tokens_match_unconstrained",
            "tokens_match_greedy")

# unified latency/utilization columns: every serve scenario row
# must carry them, so the artifact must contain each with at least one
# non-empty (float-parsable) cell — a metrics() surface that silently
# stopped flowing into the CSV must fail the gate, not upload zeros-by-
# absence. temporal_util is a ratio by construction: any parsed value
# outside [0, 1] is a broken timer, not a data point.
REQUIRED_METRICS = ("ttft_p50", "ttft_p95", "tpot_p50", "tpot_p95",
                    "temporal_util")


def parse_sections(text: str) -> List[Tuple[str, List[Dict[str, str]]]]:
    """Split a run.py artifact into (section_name, rows) pairs. Lines
    starting with ``#`` delimit sections; the first non-comment line of
    each section is its header. Cells are RFC-4180 CSV (``emit()`` quotes
    fields with embedded commas — engine names like ``paged[kernel,tp2]``,
    skip notes)."""
    sections: List[Tuple[str, List[Dict[str, str]]]] = []
    name, header, rows = "", None, []

    def flush():
        if header is not None:
            sections.append((name, rows))

    for line in text.splitlines():
        if not line.strip():
            continue
        if line.lstrip().startswith("#"):
            flush()
            name = line.strip().strip("#= ").strip() or name
            header, rows = None, []
            continue
        cells = next(csv.reader(io.StringIO(line)))
        if header is None:
            header = cells
        else:
            # short rows pad with "" (emit() never writes them, but be
            # liberal in what we accept from hand-concatenated artifacts)
            cells += [""] * (len(header) - len(cells))
            rows.append(dict(zip(header, cells)))
    flush()
    return sections


def check(text: str) -> List[str]:
    """Return the list of violations (empty = gate passes)."""
    errors: List[str] = []
    seen_ok: Dict[str, int] = {k: 0 for k in REQUIRED}
    seen_metric: Dict[str, int] = {k: 0 for k in REQUIRED_METRICS}
    sections = parse_sections(text)
    if not any(rows for _, rows in sections):
        return ["no CSV rows found — empty or truncated artifact"]
    for name, rows in sections:
        for i, row in enumerate(rows):
            for col, val in row.items():
                if col in seen_metric and val != "":
                    eng = row.get("engine", f"row {i}")
                    try:
                        x = float(val)
                    except ValueError:
                        errors.append(
                            f"[{name or 'csv'}] {eng}: {col}={val!r} is "
                            f"not a number")
                        continue
                    if col == "temporal_util" and not 0.0 <= x <= 1.0:
                        errors.append(
                            f"[{name or 'csv'}] {eng}: temporal_util={x} "
                            f"outside [0, 1] — step wall exceeded tick "
                            f"wall, the timers are broken")
                        continue
                    seen_metric[col] += 1
                if not col.startswith("tokens_match_"):
                    continue
                if val == "":
                    continue
                if val == "1":
                    if col in seen_ok:
                        seen_ok[col] += 1
                    continue
                eng = row.get("engine", f"row {i}")
                errors.append(
                    f"[{name or 'csv'}] {eng}: {col}={val!r} — capped/"
                    f"sharded replay diverged from its baseline tokens")
    for col, n in seen_ok.items():
        if n == 0:
            errors.append(
                f"required equivalence column {col!r} never passed "
                f"(missing column or every leg skipped) — the scenario "
                f"that enforces it did not run")
    for col, n in seen_metric.items():
        if n == 0:
            errors.append(
                f"required metrics column {col!r} missing or empty — the "
                f"unified engine.metrics() surface did not reach the CSV")
    return errors


# the REQUIRED columns whose scenarios the port has not ported: none
UNPORTED: Tuple[str, ...] = ()


def missing_scenario_errors(cols=UNPORTED) -> List[str]:
    """The violations ``check`` reports for a CSV without the scenarios
    that carry ``cols`` (by default those the port lacks: none), in
    ``REQUIRED``'s order."""
    cols = [c for c in REQUIRED if c in cols]
    return [f"required equivalence column {col!r} never passed "
            f"(missing column or every leg skipped) — the scenario "
            f"that enforces it did not run" for col in cols]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("csv", help="bench CSV artifact (run.py --out format)")
    args = ap.parse_args()
    with open(args.csv) as f:
        text = f.read()
    errors = check(text)
    if errors:
        for e in errors:
            print(f"FAIL: {e}", file=sys.stderr)
        raise SystemExit(1)
    n = sum(len(rows) for _, rows in parse_sections(text))
    print(f"check_csv: OK — {n} rows, equivalence columns "
          f"{', '.join(REQUIRED)} all green, metrics columns "
          f"{', '.join(REQUIRED_METRICS)} present")


if __name__ == "__main__":
    main()
