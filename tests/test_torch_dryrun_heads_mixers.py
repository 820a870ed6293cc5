"""The dry-run's dot FLOPs a rank where attention's query heads split over
``model`` while its KV heads do not, and where the recurrent mixers compute
over their ``model`` dims, held to the JAX dry-run's at ``model`` 4.

The JAX side is ``repro.launch.steps.make_step`` with ``Rules(mesh)``
compiled on a 4-device host mesh in a subprocess
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``) and read by
``repro.analysis.hlo_cost``; the port's is ``launch.steps.make_step``
traced by ``analysis.op_cost`` on fake tensors at a described (data 1,
model 4) mesh, every kernel seam through its plain version, as XLA's
attention stands in for the Pallas kernels on a CPU host. SMOKE configs,
B 1, S 1024, the train, prefill and decode cells. The JAX subprocess
compiles while this process traces the port's cells.

recurrentgemma SMOKE is equal in all three cells. Each other difference,
written out exactly (L layers, d 64, head dim hd, m 4):

* qwen2.5-3b SMOKE (4 query heads over 2 KV heads of hd 16): train and
  decode are equal. Prefill: the port counts L · 2 · B · S · d · hd · (2 - 1)
  = 4,194,304 more. A port rank projects v at both KV heads, for the
  whole cache lanes it returns; GSPMD projects v at the rank's KV head
  only (its constraint keeps k whole, and its prefill's cache may leave
  split). In training both project v at the rank's KV head.
* mamba2 SMOKE (4 heads of 32 over 4, one group of 16 state dims, chunks
  Q 8, 128 a layer): a port rank computes the chunks' C Bᵀ products
  (2 · Q · Q · n a chunk) from the whole B and C, where GSPMD splits their
  contraction over the state dims 4 ways. Prefill: (1 - 1/m) · L · 128 ·
  2 · Q² · n = 393,216 more. Decode: the conv's product runs on the rank's
  32 x channels and all 32 B and C channels, where GSPMD splits its 160
  channels 4 ways: L · 2 · 4 · (64 - 40) = 384 more. Train: the C Bᵀ
  products' forward, recompute and two backward products, 4 · 393,216 =
  1,572,864 more, less what XLA counts more at one device
  (``tests/test_torch_dryrun_flops_ssm.py``: the scan body's dots) at the
  rank's one head, L · (128 · 2 · Q · 1 · 32 + 3 · 2 · 1 · 32 · 16 · Q) =
  180,224: 1,392,640 more.

Also: the new sums are recorded, and the mha seam of the prefill cell at a
rank's one query head over its one KV head counts that shape.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")     # held against the JAX package

from repro_torch.analysis import op_cost  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.parallel.sharding import Rules  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ARCHS = ("qwen2.5-3b", "recurrentgemma-9b", "mamba2-2.7b")
KINDS = ("prefill", "decode", "train")
B, S, M = 1, 1024, 4

_JAX = f"""
import json, warnings
import jax
from repro import compat
from repro.analysis import hlo_cost
from repro.configs import get_smoke_config
from repro.configs.base import ShapeConfig
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import make_step
from repro.parallel.sharding import Rules
out = {{}}
for arch in {ARCHS!r}:
    for kind in {KINDS!r}:
        mesh = make_host_mesh({M})
        fn, args, in_sh, out_sh = make_step(
            get_smoke_config(arch), ShapeConfig("x", {S}, {B}, kind),
            Rules(mesh))
        with warnings.catch_warnings(), compat.set_mesh(mesh):
            warnings.simplefilter("ignore")
            text = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh
                           ).lower(*args).compile().as_text()
        out[arch + "/" + kind] = hlo_cost.analyze_hlo(text).dot_flops
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_flops():
    """The JAX dry-run's dot FLOPs by "arch/kind", compiled in a
    subprocess while this process traces every port cell."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={M}",
               PYTHONPATH=str(REPO / "src"))
    proc = subprocess.Popen([sys.executable, "-c", _JAX], env=env, cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        for arch in ARCHS:
            for kind in KINDS:
                port_trace(arch, kind)
        out, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@functools.lru_cache(maxsize=None)
def port_trace(arch, kind, seams="plain"):
    cfg = get_smoke_config(arch)
    with warnings.catch_warnings(), op_cost.fake_mode():
        warnings.simplefilter("ignore", UserWarning)
        fn, args, rank = steps.make_step(
            cfg, ShapeConfig("x", S, B, kind),
            Rules(make_host_mesh(M, devices=["cpu"] * M)))
        return op_cost.trace(fn, args, rank, seams=seams), rank


def _diffs():
    q = get_smoke_config("qwen2.5-3b")
    mb = get_smoke_config("mamba2-2.7b")
    sc = mb.ssm
    Q, n, P = sc.chunk, sc.state_dim, sc.head_dim
    chunks = S // Q
    d_inner = sc.expand * mb.d_model
    heads = d_inner // P
    cb = mb.num_layers * chunks * 2 * Q * Q * n * B      # C Bᵀ, a rank
    conv_dim = d_inner + 2 * n
    xla = mb.num_layers * (chunks * 2 * Q * (heads // M) * P
                           + 3 * 2 * (heads // M) * P * n * Q)
    return {
        ("qwen2.5-3b", "prefill"): q.num_layers * 2 * B * S * q.d_model
        * q.resolved_head_dim * (q.kv_heads - 1),
        ("mamba2-2.7b", "prefill"): cb * (M - 1) // M,
        ("mamba2-2.7b", "decode"): mb.num_layers * 2 * sc.conv_width * (
            d_inner // M + 2 * n - conv_dim // M),
        ("mamba2-2.7b", "train"): 4 * cb * (M - 1) // M - xla,
    }


def test_the_differences_written_out():
    assert _diffs() == {("qwen2.5-3b", "prefill"): 4_194_304,
                        ("mamba2-2.7b", "prefill"): 393_216,
                        ("mamba2-2.7b", "decode"): 384,
                        ("mamba2-2.7b", "train"): 1_392_640}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_dot_flops_a_rank_against_the_jax_dry_run(jax_flops, arch, kind):
    want = jax_flops[f"{arch}/{kind}"]
    assert want > 0
    tr, _ = port_trace(arch, kind)
    assert tr.cost.dot_flops - want == _diffs().get((arch, kind), 0)


def test_the_new_sums_are_recorded():
    """qwen2.5-3b SMOKE's train step at model 4: a layer sums the
    out-projection's and the MLP's partials (forward, and the attention's
    again in the recompute), the inputs' gradients, and the whole KV
    leaves' gradients; mamba2's adds its norm's mean square both ways and
    its whole leaves' gradients. Every sum is recorded over ``model``."""
    cfg = get_smoke_config("qwen2.5-3b")
    tr, rank = port_trace("qwen2.5-3b", "train")
    vocab = 1 + 5 * (S // 512)
    assert rank.whole_kv
    assert tr.reduces == cfg.num_layers * 6 + vocab
    mb = get_smoke_config("mamba2-2.7b")
    tr, rank = port_trace("mamba2-2.7b", "train")
    # out_proj's sum (forward, recompute), x's gradient, the norm's sum
    # (forward, recompute, backward), the whole leaves' gradients
    assert tr.reduces == mb.num_layers * 7 + vocab
    assert rank.collectives["all-gather", "model"] == 2 * mb.num_layers
    assert rank.collectives["reduce-scatter", "model"] == mb.num_layers
    assert all(axis in ("model", "data") for axis, _ in rank.sums)


def test_the_mha_seam_counts_a_ranks_heads():
    """The prefill cell through the kernel seam: mha at the rank's one
    query head over its one KV head does the causal half of the plain
    products, 4 · hd · 1 · B · (S² - S (S + 1) / 2) fewer a layer."""
    cfg = get_smoke_config("qwen2.5-3b")
    kern, _ = port_trace("qwen2.5-3b", "prefill", seams="kernel")
    plain, _ = port_trace("qwen2.5-3b", "prefill", seams="plain")
    hd, heads = cfg.resolved_head_dim, cfg.num_heads // M
    assert plain.cost.dot_flops - kern.cost.dot_flops == \
        cfg.num_layers * 4 * hd * heads * B * (S * S - S * (S + 1) // 2)


def test_a_whole_in_proj_is_used_whole():
    """mamba2 SMOKE with 15 state dims at model 4: in_proj's 290 columns
    do not divide, so every rank projects all of them and gathers
    nothing."""
    cfg = get_smoke_config("mamba2-2.7b")
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                           state_dim=15))
    with warnings.catch_warnings(), op_cost.fake_mode():
        warnings.simplefilter("ignore", UserWarning)
        fn, args, rank = steps.make_step(
            cfg, ShapeConfig("x", 64, B, "train"),
            Rules(make_host_mesh(M, devices=["cpu"] * M)))
        op_cost.trace(fn, args, rank, seams="plain")
    assert "ssm" in rank.contract_axes
    assert ("all-gather", "model") not in rank.collectives
    assert args[0]["params"]["blocks"][0]["mixer"]["in_proj"].shape[-1] \
        == 290
