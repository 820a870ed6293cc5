"""mamba2-2.7b's dry-run matmul FLOPs, held to the JAX dry-run's compiled
HLO: ``tests/test_torch_dryrun_flops.py``'s comparison (SMOKE, B 1, S
1024, one device) for the SSM stack, whose 128 SSD chunks a layer make the
longest traces, in a file (a worker) of its own.

Prefill and decode are equal. The train step parts by what XLA counts: it
counts more, a layer: (a) one (Q, h) x P dot a chunk, the reference's
three-operand ``einsum("bqhn,bhq,bqhp->bhpn")``, whose backward takes the
weights' gradient as a batched dot where the port's ``wq * xq`` takes a
multiply and a sum; (b) three products of 2 · h · P · n · Q: the gradient
of the zero state entering chunk 0 and the backward of the last chunk's
state update, which reach no loss (autograd prunes them) but which the
reference's uniform scan body computes at every chunk.
"""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")     # held against the JAX package

from repro_torch.configs import get_smoke_config  # noqa: E402
from torch_dryrun_cases import B, S, jax_flops, port_flops  # noqa: E402,F401


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_dot_flops_equal_the_jax_dry_run(jax_flops, kind):  # noqa: F811
    want = jax_flops("mamba2-2.7b", kind)
    assert want > 0
    assert port_flops("mamba2-2.7b", kind) == pytest.approx(want, rel=1e-12,
                                                             abs=0)


def test_mamba2_train_parts_by_the_scan_bodys_dots(jax_flops):  # noqa: F811
    cfg = get_smoke_config("mamba2-2.7b")
    sc = cfg.ssm
    h = sc.expand * cfg.d_model // sc.head_dim
    P, n, Q = sc.head_dim, sc.state_dim, sc.chunk
    chunks = S // Q
    per_layer = chunks * 2 * Q * h * P + 3 * 2 * h * P * n * Q
    diff = jax_flops("mamba2-2.7b", "train") - port_flops("mamba2-2.7b",
                                                          "train")
    assert diff == cfg.num_layers * per_layer == 720_896
