"""The port's training layout against JAX's: every train-state leaf of the
ten full configs at the reference's per-rank shape on ``pod16x16``.

The JAX side runs in a subprocess with 256 forced host devices (as
``tests/test_elastic_restore.py`` forces 4): for each leaf of the
reference's train state (``repro.launch.steps.state_shapes`` /
``state_axes``), ``NamedSharding(mesh, Rules(mesh).spec(...)).
shard_shape``. The port's side is ``tp.train_plan`` on the described
``make_production_mesh()``: each leaf's rank part of its ``meta`` shape.
A JAX leaf stacked over layers (``layers`` maps to no axis) is held
against each of the port's per-layer leaves of its reference leaf
(``trainer.stack_group``), without the layers dim; a tail layer against
its tail leaf.

Then the dry-run: the rank's ``argument_bytes`` of qwen2.5-3b's and
dbrx-132b's ``train_4k`` cells (the storages of ``steps.make_step``'s
arguments, which ``op_cost.trace`` reports; at full depth, untraced)
equal those shards' bytes plus the rank's batch.
"""
import json
import os
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch.utils import _pytree as pytree  # noqa: E402

from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.analysis import op_cost  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.parallel import tp  # noqa: E402
from repro_torch.parallel.sharding import Rules  # noqa: E402
from repro_torch.runtime import trainer  # noqa: E402

REPO = Path(__file__).resolve().parents[1]

SCRIPT = textwrap.dedent("""
    import json, os, sys, warnings
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=256"
    import jax
    from jax.sharding import NamedSharding
    from repro.configs import ARCHS, get_config
    from repro.launch import steps
    from repro.launch.mesh import make_production_mesh
    from repro.parallel.sharding import Rules

    mesh = make_production_mesh()
    out = {}
    warnings.simplefilter("ignore")
    for arch in ARCHS:
        cfg = get_config(arch)
        rules = Rules(mesh)
        shapes = steps.state_shapes(cfg, steps.opt_config_for(cfg))
        axes = steps.state_axes(cfg)
        leaves = {}
        for (path, s), a in zip(
                jax.tree_util.tree_flatten_with_path(shapes)[0],
                jax.tree.leaves(axes)):
            key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                           for k in path)
            sh = NamedSharding(mesh, rules.spec(s.shape, a))
            leaves[key] = [list(s.shape), list(sh.shard_shape(s.shape))]
        out[arch] = leaves
    json.dump(out, sys.stdout)
""")


@pytest.fixture(scope="module")
def jax_shards():
    pytest.importorskip("jax")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = str(REPO / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    r = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout)


def _jax_key(cfg, path):
    """The reference leaf a port state leaf (key ``path``) is part of, as
    the JAX subprocess spells it, and whether that leaf is stacked over
    layers: a block's leaf goes by ``trainer.stack_group`` to its pattern
    position's stacked leaf (``blocks/scan/<j>``, an encoder's
    ``enc/blocks/scan/0``), a tail layer's to its ``blocks/tail/<i>``."""
    keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
    n = 1 if keys[0] == "params" else 2          # params, opt/m, opt/v
    prefix, inner = keys[:n], keys[n:]
    if not inner or inner[0] not in ("blocks", "enc") \
            or inner[:2] == ["enc", "final_norm"]:
        return "/".join(keys), False
    name = [str(k) for k in trainer.stack_group(cfg)(path[n:])]
    n_super, _ = tfm.layer_plan(cfg)
    first_tail = n_super * len(tfm.pattern_for(cfg))
    if name[0] == "enc":
        return "/".join(prefix + ["enc", "blocks", "scan", "0"]
                        + name[1:]), True
    if int(inner[1]) < first_tail:
        return "/".join(prefix + ["blocks", "scan"] + name[1:]), True
    return "/".join(prefix + ["blocks", "tail",
                              str(int(inner[1]) - first_tail)]
                    + inner[2:]), False


def port_shards(arch):
    """{path: (full shape, the rank's part, dtype)} of the port's train
    state on pod16x16, every leaf."""
    cfg = get_config(arch)
    mesh = make_production_mesh()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        plan = tp.train_plan(cfg, mesh)
    state = steps.state_shapes(cfg, steps.opt_config_for(cfg))
    specs = tp.state_specs(plan, state)
    out = {}
    for (path, t), spec in zip(pytree.tree_flatten_with_path(state)[0],
                               _spec_leaves(specs)):
        out[path] = (tuple(t.shape), tp._local(tuple(t.shape), spec, 16, 16),
                     t.dtype)
    return cfg, out


def _spec_leaves(specs):
    """A spec tree's leaves (tuples) in the state's flattening order."""
    return pytree.tree_leaves(specs, is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("arch", ARCHS)
def test_every_state_leaf_has_jax_shard_shape(jax_shards, arch):
    cfg, port = port_shards(arch)
    want = jax_shards[arch]
    seen = set()
    for path, (full, part, _) in port.items():
        key, stacked = _jax_key(cfg, path)
        assert key in want, key
        seen.add(key)
        jfull, jpart = want[key]
        if stacked:
            jfull, jpart = jfull[1:], jpart[1:]
            assert want[key][1][0] == want[key][0][0]   # layers unsplit
        assert list(full) == jfull, key
        assert list(part) == jpart, (key, part, jpart)
    assert seen == set(want)


# parameter bytes a rank on pod16x16 (GiB, 3 places; each leaf in its own
# dtype: the model dtype, norms and routers fp32): the reference's
# per-rank figures
REFERENCE_GIB = {"dbrx-132b": 1.016, "llama4-maverick-400b-a17b": 3.225,
                 "recurrentgemma-9b": 0.169, "mamba2-2.7b": 0.026,
                 "yi-6b": 0.060, "qwen1.5-4b": 0.145, "qwen2.5-3b": 0.029,
                 "internvl2-2b": 0.025, "granite-3-2b": 0.028,
                 "seamless-m4t-large-v2": 0.013}


@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_bytes_a_rank(arch):
    _, port = port_shards(arch)
    n = sum(torch.Size(part).numel() * dt.itemsize
            for path, (_, part, dt) in port.items()
            if str(getattr(path[0], "key", "")) == "params")
    assert round(n / 2**30, 3) == REFERENCE_GIB[arch]


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "dbrx-132b"])
def test_train_cell_argument_bytes_are_the_shards_and_the_batch(arch):
    cfg, port = port_shards(arch)
    state = sum(torch.Size(part).numel() * dt.itemsize
                for _, part, dt in port.values())
    shape = SHAPES["train_4k"]
    rows = shape.global_batch // 16                 # batch over data
    batch = 2 * rows * shape.seq_len * 8            # tokens, labels int64
    with op_cost.fake_mode():
        _, args, _ = steps.make_step(cfg, shape,
                                     Rules(make_production_mesh()))
    # what ``op_cost.trace`` reports as the cell's argument_bytes
    got = sum(op_cost._storage_bytes(op_cost._tensors(args)).values())
    assert got == state + batch
