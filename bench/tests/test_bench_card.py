"""On the card (marked ``gpu``; skipped without one): a short run of each
cell drives the timed path and the check, and prints the result line's
keys; the fp8 control, put through the harness's check at the cell's own
size, comes out not correct under the cell's own limits where the
program comes out correct. The full cells run through ``bench/run.py``;
the control's readings, on a dozen seeds, through ``bench/control.py``."""
import subprocess
import sys
import json

import pytest

from bench.lib import spec


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", spec.all_names()["workloads"])
def test_a_short_run_of_each_cell(cell):
    _card()
    r = subprocess.run([sys.executable, str(spec.BENCH / "run.py"),
                        "--workload", cell, "--seed", "77", "--seconds", "5",
                        "--trace", "1"],
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["busy_s"] > 0
    assert list(out)[-1] == "checks"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", spec.all_names()["workloads"])
def test_the_control_fails_each_cells_limits(cell):
    _card()
    import torch
    from bench.control import readings
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = readings(cell, [78], 20.0, out=lambda s: None)
    assert rows[0]["correct"], rows[0]["checks"]
    assert rows[0]["control"]["correct"] is False, rows[0]["control"]
