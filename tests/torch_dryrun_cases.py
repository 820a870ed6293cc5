"""The dry-run FLOP comparisons' shared half
(``tests/test_torch_dryrun_flops*.py``): the JAX dry-run's matmul FLOPs of
a SMOKE step (``repro.launch.steps.make_step`` compiled on a one-device
host mesh, ``repro.analysis.hlo_cost``), each compile made once a module,
and the port's (``launch.steps.make_step`` traced by ``analysis.op_cost``
on fake tensors, each kernel seam through its plain version, as XLA's
attention stands in for the Pallas kernels on a CPU host), at B 1,
S 1024."""
import dataclasses
import warnings

import pytest

import jax

from repro import compat
from repro.analysis import hlo_cost
from repro.configs import get_smoke_config as jsmoke
from repro.configs.base import ShapeConfig as JShape
from repro.launch.mesh import make_host_mesh as jmesh
from repro.launch.steps import make_step as jmake
from repro.parallel.sharding import Rules as JRules
from repro_torch.analysis import op_cost
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.parallel.sharding import Rules

B, S = 1, 1024


@pytest.fixture(scope="module")
def jax_flops():
    """(arch, kind) -> the JAX dry-run's dot FLOPs, compiled on first use."""
    cache = {}

    def get(arch, kind):
        if (arch, kind) not in cache:
            cfg = jsmoke(arch)
            mesh = jmesh()
            fn, args, in_sh, out_sh = jmake(cfg, JShape("x", S, B, kind),
                                            JRules(mesh))
            with warnings.catch_warnings(), compat.set_mesh(mesh):
                warnings.simplefilter("ignore")
                text = jax.jit(fn, in_shardings=in_sh,
                               out_shardings=out_sh).lower(*args).compile(
                ).as_text()
            cache[arch, kind] = hlo_cost.analyze_hlo(text).dot_flops
        return cache[arch, kind]
    return get


def port_flops(arch, kind, **over) -> float:
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    with op_cost.fake_mode():
        fn, args, rank = steps.make_step(
            cfg, ShapeConfig("x", S, B, kind),
            Rules(make_host_mesh(1, devices=["cpu"])))
        return op_cost.trace(fn, args, rank, seams="plain").cost.dot_flops
