"""The port's configs equal the JAX package's field for field, and importing
the port loads neither jax nor any module of the JAX package."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")     # held against the JAX package

from repro import configs as jconfigs  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_configs_equal_field_for_field(arch, getter):
    want = dataclasses.asdict(getattr(jconfigs, getter)(arch))
    got = dataclasses.asdict(getattr(tconfigs, getter)(arch))
    assert arch in jconfigs.ARCHS
    assert got == want


def test_param_count_matches_jax():
    for arch in tconfigs.ARCHS:
        assert (tconfigs.get_config(arch).param_count()
                == jconfigs.get_config(arch).param_count())


def test_import_loads_no_jax_and_no_repro_module():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.convert\n"
        "import repro_torch.runtime.serving, repro_torch.runtime.scheduler\n"
        "import repro_torch.launch.serve, repro_torch.kernels.ops\n"
        "import repro_torch.launch.kernel_bench, repro_torch.kernels.gemm_os\n"
        "import repro_torch.launch.host_cost, repro_torch.launch.gemm_probe\n"
        "import repro_torch.launch.paged_probe\n"
        "import repro_torch.launch.mha_pool_probe\n"
        "import repro_torch.runtime.trace, repro_torch.launch.serve_bench\n"
        "import repro_torch.launch.check_csv, repro_torch.models.layers\n"
        "from repro_torch.configs import ARCHS, get_config\n"
        "[get_config(a) for a in ARCHS]\n"
        "import repro_torch.kernels.conv_im2col, repro_torch.kernels.maxpool\n"
        "import repro_torch.kernels.reshuffle, repro_torch.kernels.build\n"
        "import repro_torch.kernels.sampler, repro_torch.runtime.sampling\n"
        "import repro_torch.runtime.prefix_cache, repro_torch.runtime.drafter\n"
        "import repro_torch.launch.sampler_probe\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
