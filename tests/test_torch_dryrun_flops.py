"""The port's dry-run matmul FLOPs, held to the JAX dry-run's compiled HLO.

For SMOKE configs at B 1, S 1024, the port's ``op_cost`` trace of
``launch.steps.make_step`` (fake tensors, a one-device mesh) against
``repro.analysis.hlo_cost.analyze_hlo(...).dot_flops`` of the JAX
``repro.launch.steps.make_step`` compiled on a one-device host mesh.
S 1024 puts the blockwise cross-entropy over two chunks of 512: at one
chunk XLA drops the chunk's recompute, one logits product fewer.

Equal (relative 1e-12): prefill, decode and train of qwen2.5-3b and
seamless-m4t-large-v2; prefill and decode of dbrx-132b. The recurrent
stacks, whose traces are the longest, have files (workers) of their own:
``tests/test_torch_dryrun_flops_hybrid.py`` (recurrentgemma-9b, equal in
every step since the port remats whole periods of its pattern and leaves
the tail layers alone, as the reference's scan does) and
``tests/test_torch_dryrun_flops_ssm.py`` (mamba2-2.7b). Two train steps
part by what XLA counts, each difference written out exactly:

* dbrx-132b: the port counts 2 · T · K · d more a MoE layer. The
  gradient of the combine (``einsum("gkt,gktd->gtd")``) with respect to
  the expert rows is an outer product, a contraction of size 1, which
  XLA's algebraic simplifier turns into a multiply; torch runs it as a
  ``bmm``.
* mamba2-2.7b (``tests/test_torch_dryrun_flops_ssm.py``): XLA counts
  more; that file says where.

Every JAX compile is made once, in a module fixture (about 14 s an arch
for its three on one CPU).
"""
import ast
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")     # held against the JAX package

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from torch_dryrun_cases import B, S, jax_flops, port_flops  # noqa: E402,F401

REPO = Path(__file__).resolve().parents[1]
KINDS = ("prefill", "decode", "train")
EXACT = [("qwen2.5-3b", k) for k in KINDS] \
    + [("seamless-m4t-large-v2", k) for k in KINDS] \
    + [("dbrx-132b", k) for k in ("prefill", "decode")]


@pytest.mark.parametrize("arch,kind", EXACT)
def test_dot_flops_equal_the_jax_dry_run(jax_flops, arch, kind):  # noqa: F811
    want = jax_flops(arch, kind)
    assert want > 0
    assert port_flops(arch, kind) == pytest.approx(want, rel=1e-12, abs=0)


def test_dbrx_train_parts_by_the_combines_outer_product(jax_flops):  # noqa: F811
    cfg = get_smoke_config("dbrx-132b")
    moe_layers = tfm.layer_kinds(cfg).count("attn_moe")
    outer = 2 * (B * S) * cfg.moe.top_k * cfg.d_model
    diff = port_flops("dbrx-132b", "train") - jax_flops("dbrx-132b", "train")
    assert moe_layers == 2 and outer == 262_144
    assert diff == moe_layers * outer == 524_288


def test_chip_smoke_holds_the_card_to_these_numbers(jax_flops):  # noqa: F811
    """``chip_smoke.py`` traces qwen2.5-3b SMOKE at B 1, S 1024 on the
    card's machine (its torch) and holds the dot FLOPs to its
    ``SMOKE_DOT_FLOPS``: those must be the JAX dry-run's."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    table = next(ast.literal_eval(node.value) for node in tree.body
                 if isinstance(node, ast.Assign)
                 and getattr(node.targets[0], "id", "") == "SMOKE_DOT_FLOPS")
    assert set(table) == {f"qwen2.5-3b/{k}" for k in KINDS}
    for key, v in table.items():
        arch, kind = key.split("/")
        assert v == jax_flops(arch, kind)
