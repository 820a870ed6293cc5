"""The dry-run: trace every (arch x shape x mesh) cell's step on fake tensors.

Counterpart of ``repro.launch.dryrun``, which lowers and compiles each
cell for a 256- or 512-chip TPU mesh. The port traces one rank's step
(``launch.steps.make_step``: its shard of the parameters and state, its
rows of the batch) inside a ``FakeTensorMode`` on the CPU device, so every
kernel seam takes its plain version (counted as its kernel, below),
nothing is allocated, nothing is launched and no GPU is needed, under
``analysis.op_cost.CostMode``; then
an H100 roofline (``analysis.roofline``). A step that reads a value back
to the host (``.item()``, ``.tolist()``, ``.cpu()`` of a fake) fails its
trace, as ``jax.jit`` fails on a concretisation: such a cell is an
error.

A train cell deeper than two periods of its layer pattern (the pattern's
length: the lcm of a hybrid pattern's length and ``moe.moe_every``; an
encoder-decoder's two stacks scale together) is traced at one and at two
periods (plus the tail) and extrapolated linearly to its depth, every
cost and memory field alike: the port's counterpart of the reference's
loop trip counts. The CLI traces its cells in processes of their own, all
at once.

A kernel seam counts as its CUDA kernel (``op_cost``'s ``seams=
"kernel"``): prefill and decode cells read what the card runs (the
flash-MHA kernel, which holds no (Sq, Sk) scores), not the plain
version the CPU fakes take. The train step reaches no kernel (its
attention is the plain chunked ``layers.flash_attention`` on the card
too). A decode cell is the reference's: ``api.decode_step`` on dense
lanes, each slot's whole lane read (the serving engines decode from
pages through another kernel).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \\
      --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod-too]
One JSON per cell under experiments/dryrun_torch/ (``analysis.report``
tabulates them): the reference's keys, with ``lower_s`` / ``compile_s``
as ``trace_s`` and ``hlo_bytes`` as ``ops`` (the aten ops traced), plus
``cost`` (dot FLOPs, transcendentals, collective bytes by axis),
``reduces`` (model-axis sums a step), ``depths`` (the depths traced) and
``seams`` (how a kernel seam counted).
Exits 1 if any cell failed.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import multiprocessing
import os
import time
import traceback
import warnings
from typing import Dict, Optional, Tuple

from repro_torch.analysis import op_cost
from repro_torch.analysis import roofline as rl
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import SHAPES, ShapeConfig, cell_runnable
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import make_step
from repro_torch.models import transformer as tfm
from repro_torch.parallel.sharding import Rules

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")


def period(cfg) -> int:
    """Layers in one period of the stack's pattern."""
    return len(tfm.pattern_for(cfg))


def depths(cfg) -> Optional[Tuple[dict, dict, int]]:
    """(config fields at one period, at two, periods beyond the first)
    for the extrapolation, or None when the stack is too shallow (or an
    encoder-decoder's stacks do not scale together)."""
    p = period(cfg)
    n, r = divmod(cfg.num_layers, p)
    if n <= 2:
        return None
    one, two = {"num_layers": p + r}, {"num_layers": 2 * p + r}
    if cfg.is_encdec:
        if cfg.enc_layers % n:
            return None
        e = cfg.enc_layers // n
        one["enc_layers"], two["enc_layers"] = e, 2 * e
    return one, two, n - 1


def _trace(cfg, shape, rules, seams: str = "kernel") -> op_cost.Trace:
    """One rank's trace of the step at ``cfg``'s whole depth."""
    with warnings.catch_warnings(), op_cost.fake_mode():
        # the plan's and the rules' replication fallbacks warn on most
        # cells of a 16-way model axis; the record shows what sharded
        warnings.simplefilter("ignore", UserWarning)
        fn, args, rank = make_step(cfg, shape, rules, device="cpu")
        return op_cost.trace(fn, args, rank, seams=seams)


def trace_cell(cfg, shape: ShapeConfig, mesh, *, rules_table=None,
               seams: str = "kernel") -> Tuple[op_cost.Trace, list]:
    """One rank's ``op_cost.Trace`` of the cell's step, and the depths
    traced. A train cell deeper than two periods is extrapolated from
    traces at one and two periods. ``seams``: "kernel" (the card's path:
    a kernel seam counts as its kernel) or "plain" (the plain versions'
    ops, what the JAX dry-run on a CPU host counts); see
    ``analysis.op_cost``."""
    rules = Rules(mesh, rules_table)
    plan = depths(cfg) if shape.kind == "train" else None
    if plan is None:
        return _trace(cfg, shape, rules, seams), [cfg.num_layers]
    one, two, k = plan
    a, b = (_trace(dataclasses.replace(cfg, **d), shape, rules, seams)
            for d in (one, two))

    def lin(x, y):
        return x + k * (y - x)

    return (op_cost.Trace(a.cost.extrapolate(b.cost, k),
                          {key: lin(a.memory[key], b.memory[key])
                           for key in a.memory},
                          lin(a.ops, b.ops), lin(a.reduces, b.reduces)),
            [one["num_layers"], two["num_layers"]])


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             rules_table=None, out_dir: str = OUT_DIR, tag: str = "",
             donate_cache: bool = False, cfg_patch=None,
             verbose: bool = True) -> Dict:
    """Trace one cell and write its record (``<cell>.json`` in
    ``out_dir``). ``donate_cache`` is recorded only: the port's decode
    always writes the cache in place (``memory.alias_bytes``).
    ``rules_table`` maps logical axes over ``DEFAULT_TABLE`` as the
    reference's does: ``{"seq": "model"}`` is context parallelism
    (``launch.steps.make_step``). The record carries ``rules_table`` and
    ``cfg_patch`` as given."""
    cfg = get_config(arch)
    if cfg_patch:
        cfg = dataclasses.replace(cfg, **cfg_patch)
    shape = SHAPES[shape_name]
    ok, why = cell_runnable(cfg, shape)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cell = f"{arch}__{shape_name}__{mesh_name}" + (f"__{tag}" if tag else "")
    if not ok:
        return {"cell": cell, "status": "skipped", "reason": why}
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = sum(len(row) for row in mesh.devices)
    rec = {"cell": cell, "arch": arch, "shape": shape_name,
           "mesh": mesh_name, "chips": chips, "donate_cache": donate_cache,
           "rules_table": rules_table, "cfg_patch": cfg_patch}
    t0 = time.time()
    try:
        tr, traced = trace_cell(cfg, shape, mesh, rules_table=rules_table)
        t_trace = time.time() - t0
        r = rl.analyze(tr.cost, chips=chips,
                       model_flops=rl.model_flops_for(cfg, shape),
                       axis_sizes=mesh.shape)
        rec.update({
            "status": "ok",
            "trace_s": round(t_trace, 2),
            "memory": tr.memory,
            "roofline": r.to_dict(),
            "ops": tr.ops,
            "cost": {"dot_flops": tr.cost.dot_flops,
                     "transcendentals": tr.cost.transcendentals,
                     "coll_bytes": tr.cost.coll_bytes},
            "reduces": tr.reduces,
            "depths": traced,
            "seams": "kernel",
        })
        if verbose:
            mm = rec["memory"]["total_bytes_per_device"] / 2**30
            print(f"[dryrun] {cell}: OK trace={t_trace:.1f}s "
                  f"mem/dev={mm:.2f}GiB bottleneck={r.bottleneck} "
                  f"t=({r.t_compute:.4f},{r.t_memory:.4f},"
                  f"{r.t_collective:.4f})s", flush=True)
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec.update({"status": "error", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()})
        if verbose:
            print(f"[dryrun] {cell}: FAIL {type(e).__name__}: {e}",
                  flush=True)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, cell + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def optimized_kwargs(shape_name: str) -> dict:
    """The reference's tuned options (its ``optimized_kwargs``): context
    parallelism (the sequence over ``model``) with one-shot attention for
    batch steps; context-parallel caches, aliased, with single-pass decode
    attention for decode steps."""
    if SHAPES[shape_name].kind == "decode":
        return {"rules_table": {"seq": "model"}, "donate_cache": True,
                "cfg_patch": {"decode_kv_chunk": 0}}
    return {"rules_table": {"seq": "model"},
            "cfg_patch": {"flash_chunking": False}}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCHS)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="use the 2x16x16 multi-pod mesh")
    ap.add_argument("--multi-pod-too", action="store_true",
                    help="run each cell on both meshes")
    ap.add_argument("--optimized", action="store_true",
                    help="apply the reference's tuned options (context "
                    "parallelism, one-shot and single-pass attention)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)

    archs = ARCHS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = [False, True] if args.multi_pod_too else [args.multi_pod]
    todo = [(arch, shape, dict(multi_pod=mp, out_dir=args.out, tag=args.tag,
                               **(optimized_kwargs(shape) if args.optimized
                                  else {})))
            for arch in archs for shape in shapes for mp in meshes]
    if len(todo) == 1:
        cells = [run_cell(todo[0][0], todo[0][1], **todo[0][2])]
    else:       # the cells are independent: one process each, at once
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(
                min(len(todo), os.cpu_count() or 1), mp_context=ctx) as ex:
            cells = [f.result() for f in [
                ex.submit(run_cell, arch, shape, **kw)
                for arch, shape, kw in todo]]
    n_fail = sum(r["status"] == "error" for r in cells)
    n_ok = sum(r["status"] == "ok" for r in cells)
    n_skip = sum(r["status"] == "skipped" for r in cells)
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_fail} failed "
          f"of {len(cells)} cells")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
