"""The dry-run under context parallelism (the reference's ``--optimized``:
``rules_table`` {"seq": "model"}), on the CPU.

* ``run_cell(rules_table={"seq": "model"})`` and the CLI's
  ``--optimized`` trace qwen2.5-3b's runnable cells at full width on
  ``pod16x16``: ``status: ok`` records that carry the reference's
  ``optimized_kwargs`` (``rules_table``, ``cfg_patch``, ``donate_cache``);
* a rank's argument bytes equal the layout's reckoning with the batch's
  and the dense lanes' sequence split over ``model`` (SMOKE configs on a
  described (data 2, model 4) mesh: the parameters and optimizer state at
  the training layout, tokens, labels and the frontend's or encoder's
  embeddings at (B / 2, S / 4), each lane at (B / 2, S / 4), recurrent
  state replicated over ``model``);
* the dot FLOPs a rank of qwen2.5-3b SMOKE at ``model`` 4 (B 1, S 1024,
  the ``--optimized`` patches: one-shot attention, single-pass decode)
  against the JAX dry-run's: ``repro.launch.steps.make_step`` with
  ``Rules(mesh, {"seq": "model"})`` compiled on a 4-device host mesh in
  a subprocess (``XLA_FLAGS=--xla_force_host_platform_device_count=4``),
  read by ``repro.analysis.hlo_cost``. Each difference, written out
  exactly (SMOKE: L 2, d 64, H 4 over KV 2 of 16, d_ff 128, Vp 256):

  - prefill: the port counts 3/4 · 2 · B · d · Vp = 24,576 more. A rank
    computes the last position's logits whole (its row reaches every
    rank by a sum); GSPMD splits that product over the vocab.
  - decode: the port counts 3/4 · (L · 2 · d · (H · hd · 2 + 3 · d_ff) +
    2 · d · Vp) = 122,880 more. The new token is replicated over
    ``model`` (its sequence of 1 does not split), so a port rank projects
    q and the output, runs the MLP and the logits whole; GSPMD splits
    them over heads, ffn and vocab. K and V projections replicate in both
    (2 KV heads do not split 4 ways); the attention reads a quarter of
    each lane in both.
  - train: the JAX dry-run counts 2 · 2 · (256 - 128) · Vp · d = 8,388,608
    more. Its partition computes each 512-token cross-entropy chunk's
    input gradient (dlogits · headᵀ) on 256 rows a device, where a port
    rank computes its 128; every other product is a quarter of the
    single device's in both.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import warnings
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")     # held against the JAX package

from torch.utils import _pytree as pytree  # noqa: E402

from repro.launch import dryrun as jdryrun  # noqa: E402
from repro_torch.analysis import op_cost  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.configs.base import SHAPES, ShapeConfig, input_specs  # noqa: E402,E501
from repro_torch.launch import dryrun, steps  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_host_mesh  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.parallel import tp  # noqa: E402
from repro_torch.parallel.sharding import Rules  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CP = {"seq": "model"}
KINDS = ("prefill", "decode", "train")


def described(data, model):
    return Mesh(tuple((torch.device("meta"),) * model
                      for _ in range(data)), {"data": data, "model": model})


# ---------------------------------------------------------------------------
# the records
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_run_cell_with_the_sequence_over_model_is_ok(tmp_path, shape):
    kw = dryrun.optimized_kwargs(shape)
    assert kw == jdryrun.optimized_kwargs(shape)
    rec = dryrun.run_cell("qwen2.5-3b", shape, out_dir=str(tmp_path),
                          verbose=False, **kw)
    assert rec["status"] == "ok", rec.get("error")
    saved = json.loads((tmp_path / (rec["cell"] + ".json")).read_text())
    assert saved["rules_table"] == {"seq": "model"}
    assert saved["cfg_patch"] == kw["cfg_patch"]
    assert saved["donate_cache"] == kw.get("donate_cache", False)
    assert saved["memory"]["argument_bytes"] == reckoning(
        dataclasses.replace(get_config("qwen2.5-3b"), **kw["cfg_patch"]),
        SHAPES[shape], described(16, 16))
    # the sequence's gathers over model are recorded
    assert saved["cost"]["coll_bytes"].get("all-gather:model", 0) > 0


def test_cli_optimized_writes_ok_records(tmp_path):
    dryrun.main(["--arch", "qwen2.5-3b", "--shape", "decode_32k",
                 "--optimized", "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "qwen2.5-3b__decode_32k__pod16x16.json")
                     .read_text())
    assert rec["status"] == "ok"
    assert rec["rules_table"] == {"seq": "model"} and rec["donate_cache"]
    assert rec["cfg_patch"] == {"decode_kv_chunk": 0}


# ---------------------------------------------------------------------------
# argument bytes: the layout with the sequence split
# ---------------------------------------------------------------------------


def reckoning(cfg, shape, mesh) -> int:
    """A rank's argument bytes from the layout alone: each leaf of the
    train state (a train cell) or of the parameters at the rank's part of
    its shape under ``tp.train_plan``'s specs; the batch's leaves at
    (B / data, S / model) (a dim that does not divide whole); the dense
    lanes at (B / data, S / model), recurrent state at B / data."""
    m, d = mesh.shape["model"], tp.data_size(mesh)
    plan = tp.train_plan(cfg, mesh, CP)
    if shape.kind == "train":
        tree = steps.state_shapes(cfg, steps.opt_config_for(cfg))
        specs = tp.state_specs(plan, tree)
    else:
        tree, specs = api.empty_params(cfg), plan.param_specs(cfg)
    spec_leaves = pytree.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, tuple))
    total = sum(math.prod(tp._local(tuple(t.shape), sp, m, d))
                * t.element_size()
                for t, sp in zip(pytree.tree_leaves(tree), spec_leaves))

    def split(n, k):
        return n // k if n % k == 0 else n

    for name, v in input_specs(cfg, shape).items():
        if name == "cache":
            for e in v:
                for key, t in e.items():
                    dims = list(t.shape)
                    dims[0] = split(dims[0], d)
                    if key in ("k", "v", "xk", "xv"):
                        dims[1] = split(dims[1], m)
                    total += math.prod(dims) * t.element_size()
            continue
        dims = list(v.shape)
        dims[0] = split(dims[0], d)
        if name != "pos":
            dims[1] = split(dims[1], m)
        total += math.prod(dims) * v.element_size()
    return total


ARCHS = ("qwen2.5-3b", "dbrx-132b", "mamba2-2.7b", "internvl2-2b",
         "seamless-m4t-large-v2")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_equal_the_seq_split_reckoning(arch, kind):
    cfg = get_smoke_config(arch)
    shape = ShapeConfig("x", 64, 4, kind)
    mesh = described(2, 4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        tr, _ = dryrun.trace_cell(cfg, shape, mesh, rules_table=CP)
        want = reckoning(cfg, shape, mesh)
    assert tr.memory["argument_bytes"] == want
    # without the split the batch is whole over model; a decode cell's
    # lanes split over KV heads there where those divide (or are absent)
    plain, _ = dryrun.trace_cell(cfg, shape, mesh)
    if kind == "decode":
        assert plain.memory["argument_bytes"] >= want
    else:
        assert plain.memory["argument_bytes"] > want


# ---------------------------------------------------------------------------
# dot FLOPs a rank against the JAX dry-run's at model 4
# ---------------------------------------------------------------------------

_JAX = """
import json, sys, warnings, dataclasses
import jax
from repro import compat
from repro.analysis import hlo_cost
from repro.configs import get_smoke_config
from repro.configs.base import ShapeConfig
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import make_step
from repro.parallel.sharding import Rules
out = {}
for kind in ("prefill", "decode", "train"):
    cfg = dataclasses.replace(get_smoke_config("qwen2.5-3b"),
                              flash_chunking=False, decode_kv_chunk=0)
    mesh = make_host_mesh(4)
    fn, args, in_sh, out_sh = make_step(cfg, ShapeConfig("x", 1024, 1, kind),
                                        Rules(mesh, {"seq": "model"}))
    with warnings.catch_warnings(), compat.set_mesh(mesh):
        warnings.simplefilter("ignore")
        text = jax.jit(fn, in_shardings=in_sh,
                       out_shardings=out_sh).lower(*args).compile().as_text()
    out[kind] = hlo_cost.analyze_hlo(text).dot_flops
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_flops():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(REPO / "src"))
    done = subprocess.run([sys.executable, "-c", _JAX], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


def port_flops(kind) -> float:
    cfg = dataclasses.replace(get_smoke_config("qwen2.5-3b"),
                              flash_chunking=False, decode_kv_chunk=0)
    with warnings.catch_warnings(), op_cost.fake_mode():
        warnings.simplefilter("ignore", UserWarning)
        fn, args, rank = steps.make_step(
            cfg, ShapeConfig("x", 1024, 1, kind),
            Rules(make_host_mesh(4, devices=["cpu"] * 4), CP))
        return op_cost.trace(fn, args, rank, seams="plain").cost.dot_flops


def _diffs():
    c = get_smoke_config("qwen2.5-3b")
    d, vp, hd = c.d_model, 256, c.resolved_head_dim
    logits = 2 * d * vp
    return {
        "prefill": logits * 3 // 4,
        "decode": (c.num_layers * 2 * d * (c.num_heads * hd * 2
                                           + 3 * c.d_ff) + logits) * 3 // 4,
        "train": -(2 * 2 * (256 - 128) * vp * d),
    }


@pytest.mark.parametrize("kind", KINDS)
def test_dot_flops_a_rank_against_the_jax_dry_run(jax_flops, kind):
    diff = port_flops(kind) - jax_flops[kind]
    assert _diffs() == {"prefill": 24_576, "decode": 122_880,
                        "train": -8_388_608}
    assert diff == _diffs()[kind]
