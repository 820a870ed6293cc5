"""The readings a cell's correctness limits are set from: on each seed, one
run of the cell through the harness (its traffic, its load, the timed
path, the check), with the fp8 control judged beside the program under
the cell's limits (``harness.run_cell(control=True)``), in one process.

    python bench/control.py --workload <cell> --seconds <s> --seeds 1 2 3

Prints one JSON line a seed: the program's verdict and numbers, and the
control's. The benchmark's own runs never run this."""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def readings(cell: str, seeds, seconds: float, device="cuda", out=print,
             cfg=None, mix=None, limits=None):
    """A row a seed: ``correct`` and ``checks`` of the program, the
    control's (``control``), and every number judged on either side.
    ``cfg``, ``mix`` and ``limits`` stand in for the cell's own files."""
    import gc

    import torch
    from bench.lib import harness, spec
    c = spec.cell(cell)
    cfg = cfg or spec.config(c["config"])
    mix = mix or spec.traffic(c["traffic"])
    limits = limits if limits is not None else spec.limits(cell)
    rows = []
    for seed in seeds:
        t = time.perf_counter()
        res = harness.run_cell(cfg, mix, limits, spec.end_to_end(cell), [],
                               seed, seconds, False, t, device, control=True)
        row = {"seed": seed, "correct": res["correct"],
               "checks": res["checks"], "control": res["control"],
               "seconds": time.perf_counter() - t}
        out(json.dumps(row))
        rows.append(row)
        del res
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    readings(args.workload, args.seeds, args.seconds,
             out=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
