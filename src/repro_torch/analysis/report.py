"""Aggregate the port's dry-run JSONs into the roofline table.

A copy of ``repro.analysis.report`` that reads ``experiments/dryrun_torch/``
(``launch/dryrun.py``'s records), so the port's records never mix with the
reference's ``experiments/dryrun/``. Usage:
``python -m repro_torch.analysis.report [MESH]``.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional

DRYRUN_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "experiments", "dryrun_torch")


def load_cells(dryrun_dir: str = DRYRUN_DIR, mesh: Optional[str] = None,
               tag: str = "") -> List[Dict]:
    rows = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if mesh and rec.get("mesh") != mesh:
            continue
        cell_tag = rec.get("cell", "").split("__")[3:]
        if (cell_tag[0] if cell_tag else "") != tag:
            continue
        rows.append(rec)
    return rows


def fmt_bytes(n: float) -> str:
    return f"{n / 2**30:.2f}"


def roofline_table(rows: List[Dict]) -> str:
    """Markdown table: one row per ok cell."""
    hdr = ("| arch | shape | mesh | mem/dev GiB | t_comp s | t_mem s | "
           "t_coll s | bottleneck | useful_flops | roofline_frac |\n"
           "|---|---|---|---|---|---|---|---|---|---|")
    out = [hdr]
    for r in rows:
        if r.get("status") == "skipped":
            out.append(f"| {r['cell'].split('__')[0]} | "
                       f"{r['cell'].split('__')[1]} | "
                       f"{r['cell'].split('__')[2]} | — | — | — | — | "
                       f"SKIP ({r['reason'][:40]}…) | — | — |")
            continue
        if r.get("status") != "ok":
            out.append(f"| {r.get('arch')} | {r.get('shape')} | "
                       f"{r.get('mesh')} | — | — | — | — | "
                       f"ERROR {r.get('error', '')[:40]} | — | — |")
            continue
        rl = r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{fmt_bytes(r['memory']['total_bytes_per_device'])} | "
            f"{rl['t_compute_s']:.4f} | {rl['t_memory_s']:.4f} | "
            f"{rl['t_collective_s']:.4f} | {rl['bottleneck']} | "
            f"{rl['useful_flops_frac']:.3f} | {rl['roofline_frac']:.3f} |")
    return "\n".join(out)


def summary(rows: List[Dict]) -> Dict:
    ok = [r for r in rows if r.get("status") == "ok"]
    skip = [r for r in rows if r.get("status") == "skipped"]
    err = [r for r in rows if r.get("status") == "error"]
    bn = {}
    for r in ok:
        b = r["roofline"]["bottleneck"]
        bn[b] = bn.get(b, 0) + 1
    return {"ok": len(ok), "skipped": len(skip), "error": len(err),
            "bottlenecks": bn}


if __name__ == "__main__":
    import sys
    mesh = sys.argv[1] if len(sys.argv) > 1 else None
    rows = load_cells(mesh=mesh)
    print(roofline_table(rows))
    print()
    print(summary(rows))
