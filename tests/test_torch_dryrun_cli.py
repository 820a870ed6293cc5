"""The port's dry-run CLI at full width on the CPU: a record with the
reference's keys (``lower_s`` / ``compile_s`` as ``trace_s``,
``hlo_bytes`` as ``ops``), nothing allocated (the process's peak resident
set far below the cell's memory); a ``pod16x16`` train cell by the period
extrapolation."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")     # held against the JAX package

from repro.analysis import roofline as jrl  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


REF_KEYS = {"cell", "arch", "shape", "mesh", "chips", "status", "memory",
            "roofline"}
MEM_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
            "total_bytes_per_device"}


# the CLI's main, printing at exit the largest peak resident set size of
# its process and of the processes it traced in. Linux keeps a process's
# ru_maxrss across exec, so this process's own would count the peak of the
# test process it was started from: its own peak is its address space's
# (VmHWM). The children, started from it, carry its size at their start.
_RUN = ("import resource, sys\n"
        "from repro_torch.launch import dryrun\n"
        "try:\n"
        "    dryrun.main(sys.argv[1:])\n"
        "finally:\n"
        "    hwm = [int(ln.split()[1]) for ln in open('/proc/self/status')\n"
        "           if ln.startswith('VmHWM:')]\n"
        "    print('MAXRSS_KB', max(hwm + [resource.getrusage(\n"
        "        resource.RUSAGE_CHILDREN).ru_maxrss]), file=sys.stderr)\n")


def _cli(tmp_path, *args):
    """(the completed CLI run, its peak RSS in bytes)."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", _RUN, *args, "--out",
                        str(tmp_path)], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    kb = [ln.split()[1] for ln in r.stderr.splitlines()
          if ln.startswith("MAXRSS_KB")]
    return r, int(kb[-1]) * 1024


def test_cli_decode_cell_at_full_width(tmp_path):
    r, rss = _cli(tmp_path, "--arch", "qwen2.5-3b", "--shape", "decode_32k")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "[dryrun] done: 1 ok, 0 skipped, 0 failed of 1 cells" in r.stdout
    rec = json.loads((tmp_path / "qwen2.5-3b__decode_32k__pod16x16.json"
                      ).read_text())
    assert REF_KEYS | {"trace_s", "ops"} <= set(rec)
    assert not {"lower_s", "compile_s", "hlo_bytes"} & set(rec)
    assert set(rec["memory"]) == MEM_KEYS
    assert set(jrl.Roofline(1, 1, 1, 1, {}).to_dict()) <= set(rec["roofline"])
    assert rec["status"] == "ok" and rec["chips"] == 256
    mem = rec["memory"]
    # the rank's cache (8 rows of 32k, 2 KV heads, whole on every rank:
    # they do not split over 16) is written in place
    kv = 36 * 2 * 8 * 32768 * 2 * 128 * 2
    assert mem["alias_bytes"] == kv
    # nothing allocated: the process stayed far below the cell's memory
    assert mem["total_bytes_per_device"] > 8 * 2**30
    assert rss < 2 * 2**30, rss
    # the out-projection's and the MLP's sums a layer (the 16 query heads
    # split over 16, one a rank; the 2 KV heads are whole on every rank),
    # and the vocab-parallel embedding lookup's
    assert rec["reduces"] == 36 * 2 + 1
    assert rec["roofline"]["collective_link"] == "nic"


def test_cli_train_cell_by_extrapolation(tmp_path):
    """mamba2-2.7b's train_4k on pod16x16 (16 x 4096 tokens a rank): two
    traces, at 1 and 2 layers, extrapolated to 64."""
    r, rss = _cli(tmp_path, "--arch", "mamba2-2.7b", "--shape", "train_4k")
    assert r.returncode == 0, r.stdout + r.stderr
    assert rss < 2 * 2**30, rss
    rec = json.loads((tmp_path / "mamba2-2.7b__train_4k__pod16x16.json"
                      ).read_text())
    cfg = get_config("mamba2-2.7b")
    assert rec["depths"] == [1, 2]
    assert rec["roofline"]["model_flops"] == 6.0 * cfg.active_param_count(
    ) * 256 * 4096
    # every chip's FLOPs together exceed 6 N T: the recompute, the
    # attention, and what replicates over the model axis
    assert 0 < rec["roofline"]["useful_flops_frac"] < 1
    assert rec["cost"]["coll_bytes"]["all-reduce:data"] > 0
